"""Scalar logging: JSONL always; TensorBoard when it is installed.

A copy of ``hashmodnffbanks_idr_tpu/utils/logging.py``.  Replaces the
reference's SummaryWriter usage (idr_train.py:225,325-328) with a
dependency-light JSONL stream (plus optional TB) so headless runs always
produce machine-readable training curves.
"""

from __future__ import annotations

import json
import os
import time


class ScalarLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except ImportError:  # no tensorboard package
                self._tb = None

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
