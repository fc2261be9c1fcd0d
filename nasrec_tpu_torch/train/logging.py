"""Metrics sinks: JSONL always, TensorBoard when it imports (port of
`nasrec_tpu/train/logging.py`).

Reference observability is stdout, TensorBoard scalars and pickled log dicts
(ref: nasrec/utils/train_utils.py:334-338, :376-380, main_train.py:215-221).
Every scalar goes to `metrics.jsonl` in the logging dir, one JSON object a
line, and to TensorBoard under `tb/` where `torch.utils.tensorboard` imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsWriter:
    def __init__(self, logging_dir: Optional[str], use_tensorboard: bool = True):
        self._jsonl = None
        self._tb = None
        if not logging_dir:
            return
        os.makedirs(logging_dir, exist_ok=True)
        self._jsonl = open(os.path.join(logging_dir, "metrics.jsonl"), "a")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(logging_dir, "tb"))
            except Exception:      # tensorboard is not installed
                self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                          "step": int(step), "time": time.time()}) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
