"""Training meters (mirrors Dassl/dassl/utils/meters.py:7-82)."""

from __future__ import annotations

import math
from collections import defaultdict


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self, ema: bool = False):
        self.ema = ema
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        if hasattr(val, "item"):
            val = float(val.item())
        self.val = val
        self.sum += val * n
        self.count += n
        if self.ema:
            self.avg = self.avg * 0.9 + self.val * 0.1
        else:
            self.avg = self.sum / self.count


class MetricMeter:
    """A collection of AverageMeters keyed by metric name."""

    def __init__(self, delimiter: str = " "):
        self.meters: dict[str, AverageMeter] = defaultdict(AverageMeter)
        self.delimiter = delimiter

    def update(self, input_dict):
        if input_dict is None:
            return
        if not isinstance(input_dict, dict):
            raise TypeError("MetricMeter.update() expects a dictionary")
        for k, v in input_dict.items():
            if hasattr(v, "item"):
                v = float(v.item())
            if isinstance(v, float) and math.isnan(v):
                continue  # reference filters NaNs (meters.py:69-70)
            self.meters[k].update(v)

    def __str__(self):
        return self.delimiter.join(
            f"{name} {m.val:.4f} ({m.avg:.4f})" for name, m in self.meters.items()
        )
