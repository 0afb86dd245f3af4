from igcn_cf_tpu_torch.train.trainer import BasicTrainer, get_trainer  # noqa: F401
# registers BPRTrainer, IGCNTrainer, IDCFTrainer, MLTrainer, BCETrainer
from igcn_cf_tpu_torch.train import bce, bpr, ml  # noqa: F401
