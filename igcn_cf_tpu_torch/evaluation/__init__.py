from igcn_cf_tpu_torch.evaluation.evaluate import evaluate, recommend  # noqa: F401
from igcn_cf_tpu_torch.evaluation.metrics import (  # noqa: F401
    calculate_metrics,
    calculate_metrics_device,
    calculate_metrics_slow,
    format_metrics,
)
