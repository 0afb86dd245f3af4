"""Small run utilities (port of ``igcn_cf_tpu/utils/meters.py``; reference
utils.py:126-151)."""

from __future__ import annotations

import os
import sys


class AverageMeter:
    def __init__(self):
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n=1):
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class Unbuffered:
    """Flush-on-write stream wrapper (reference utils.py:138-151)."""

    def __init__(self, stream):
        self.stream = stream

    def write(self, data):
        self.stream.write(data)
        self.stream.flush()

    def writelines(self, datas):
        self.stream.writelines(datas)
        self.stream.flush()

    def __getattr__(self, attr):
        return getattr(self.stream, attr)


def init_run(log_path: str, seed: int):
    """Seed and redirect stdout/stderr to <log_path>/log.txt unbuffered
    (reference utils.py:23-29). Returns the root ``KeySeq``."""
    from igcn_cf_tpu_torch.core.prng import set_seed

    keys = set_seed(seed)
    os.makedirs(log_path, exist_ok=True)
    f = Unbuffered(open(os.path.join(log_path, "log.txt"), "w"))
    sys.stderr = f
    sys.stdout = f
    return keys
