"""Metric logging (port of ``igcn_cf_tpu/utils/logging.py``).

Keeps the reference's TensorBoard scalar names,
``{model}_{trainer}/{stage}_{metric}@{k}`` and ``{model}_{trainer}/train_loss``
(reference trainer.py:50-55,76-78), in the JAX package's JSONL records
(``{"tag", "value", "step", "ts"}`` a line in ``metrics.jsonl``), so runs
of either package diff mechanically. JSONL is the only sink.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step), "ts": time.time()})
                      + "\n")
        self._f.flush()

    def record(self, model_name: str, trainer_name: str, stage: str,
               metrics: Dict[str, Dict[int, float]], epoch: int) -> None:
        for metric, by_k in metrics.items():
            for k, v in by_k.items():
                self.add_scalar(
                    f"{model_name}_{trainer_name}/{stage}_{metric}@{k}", v,
                    epoch)

    def close(self) -> None:
        self._f.close()
