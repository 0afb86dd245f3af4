from igcn_cf_tpu_torch.models.base import Model, get_model  # noqa: F401
# registers IGCN, IMF, LightGCN, NGCF, MF, Popularity
from igcn_cf_tpu_torch.models import inmo, knn, lightgcn, mf, ngcf  # noqa: F401
