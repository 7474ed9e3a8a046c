"""Meters and metric writers (ref itr/metricmodule/evaluation.py:15-72,
itr/metricmodule/__init__.py:1-5).

Scalars go to a JSONL event log per run (always) and to TensorBoard when a
writer backend is importable — same observability surface as the reference's
tensorboard_logger without a hard dependency.

The port's copy of itrx/utils/logging.py: the port imports nothing of the JAX
package, so it keeps its own copy of this stdlib/numpy module.
"""

from __future__ import annotations

import json
import os
import time
from collections import OrderedDict


def second2DHM(seconds):
    """seconds -> ('DdHhMm', ...) pretty duration (ref metricmodule/__init__.py)."""
    d = int(seconds // 86400)
    h = int((seconds % 86400) // 3600)
    m = int((seconds % 3600) // 60)
    return (f"{d}d{h}h{m}m",)


class AverageMeter:
    """Running stats (ref evaluation.py:15-40)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=0):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / (0.0001 + self.count)

    def __str__(self):
        if self.count == 0:
            return str(self.val)
        return "%.4f (%.4f)" % (self.val, self.avg)


class LogCollector:
    """Ordered meter dict (ref evaluation.py:43-72)."""

    def __init__(self):
        self.meters = OrderedDict()

    def update(self, k, v, n=0):
        if k not in self.meters:
            self.meters[k] = AverageMeter()
        self.meters[k].update(v, n)

    def __str__(self):
        parts = []
        for k, v in self.meters.items():
            s = "{:.3e}".format(v.val) if k == "lr" else str(v)
            parts.append(f"{k} {s}")
        return "  ".join(parts)


class MetricWriter:
    """JSONL scalar log + optional TensorBoard."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "events.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def log_value(self, name, value, step):
        self._f.write(
            json.dumps({"t": time.time(), "step": int(step), name: float(value)})
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(name, float(value), int(step))

    def log_dict(self, d, step):
        for k, v in d.items():
            self.log_value(k, v, step)
        self._f.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
