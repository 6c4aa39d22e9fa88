"""Scalar logging (counterpart of gantts_tpu/train/logging.py): the
reference's series names, mirrored to a ``scalars.jsonl`` sidecar, and to
TensorBoard through ``torch.utils.tensorboard`` where that is installed."""

from __future__ import annotations

import json
import os


class ScalarWriter:
    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is optional
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)

    def log_value(self, name, value, step):
        value = float(value)
        self._jsonl.write(json.dumps(
            {"tag": name, "value": value, "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
