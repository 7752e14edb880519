"""Learning-rate schedules (pure functions of the step counter): the port
of ``repro.optim.schedules``, in f32 tensors as the reference computes."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_ratio * lr``.  ``step`` is
    an int or a tensor; the result is a 0-d f32 tensor on its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, warmup_steps)
    prog = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
    prog = prog.clamp(0.0, 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(math.pi
                                                                 * prog))
    return lr * torch.where(step < warmup_steps, warm, cos)
