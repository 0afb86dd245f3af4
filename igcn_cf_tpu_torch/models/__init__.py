from igcn_cf_tpu_torch.models.base import Model, get_model  # noqa: F401
# registers all eleven models of the JAX package
from igcn_cf_tpu_torch.models import (  # noqa: F401
    idcf,
    imcgae,
    inmo,
    knn,
    lightgcn,
    mf,
    multivae,
    neumf,
    ngcf,
)
