from igcn_cf_tpu_torch.models.base import Model, get_model  # noqa: F401
# registers IGCN, IMF, LightGCN, NGCF
from igcn_cf_tpu_torch.models import inmo, lightgcn, ngcf  # noqa: F401
