from igcn_cf_tpu_torch.train.trainer import BasicTrainer, get_trainer  # noqa: F401
from igcn_cf_tpu_torch.train import bpr  # noqa: F401
