from igcn_cf_tpu_torch.data.dataset import Interactions  # noqa: F401
from igcn_cf_tpu_torch.data.transforms import dropit, dropui  # noqa: F401
