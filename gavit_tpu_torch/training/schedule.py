"""Per-step learning-rate schedule: linear warmup → cosine decay to 0
(counterpart of ``gavit_tpu/training/schedule.py``).

  step <  warmup: lr · step / warmup
  step >= warmup: lr · 0.5 · (1 + cos(π · (step - warmup) / (total - warmup)))

Stepped per batch; the first optimizer update runs at multiplier 0.
"""

from __future__ import annotations

import math


def warmup_cosine_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int):
    warmup_steps = max(1, int(warmup_steps))
    decay_span = max(1, int(total_steps) - warmup_steps)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / warmup_steps
        progress = (step - warmup_steps) / decay_span
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule
