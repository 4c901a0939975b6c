"""Operand casts of the reference's convolutions and linear layers.

``exact`` leaves fp32 operands as they are: the reference itself.
``fp8`` rounds each operand to float8 e4m3 with one scale a tensor (its
largest magnitude at 448, e4m3's largest finite value) and back: the
control, one step below the bf16 trunk the configurations state.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    # straight-through: the rounding has no gradient of its own
    return t + (q - t).detach()


CASTS = {"exact": exact, "fp8": fp8}
