from igcn_cf_tpu_torch.data.dataset import Interactions, get_dataset  # noqa: F401
from igcn_cf_tpu_torch.data import loaders  # noqa: F401  (registers the loaders)
from igcn_cf_tpu_torch.data.transforms import dropit, dropui  # noqa: F401
