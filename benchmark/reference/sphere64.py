"""FedFR's sphere64 in plain fp32 PyTorch: the reference of the ``sphere64``
configuration.

The net of FedFR's ``backbones/sphnet.py``, after SphereFace (Liu et al.,
CVPR 2017), whose 64-layer net has one residual unit more in stage 2; the
configuration's ``layers`` give FedFR's units.  The state-dict layout is
also the one the measured program loads:

    layer{s}.0        3x3 stride-2 conv with bias, padding 1
    layer{s}.1        PReLU (one slope a channel)
    layer{s}.{2+b}    residual unit x + prelu2(conv2(prelu1(conv1(x))))
                      (3x3 convs, no bias)
    fc                Linear(C * h * w -> E) on the NCHW flattening

with ``layers`` units over ``filters`` channels in the four stages (the
configuration file gives both).  Every operand of a conv or the fc goes
through ``cast`` (``precision.CASTS``), so the same module is the
reference (``exact``) and the control (``fp8``).  Imports nothing of the
measured program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .precision import exact


def stage_out(size: int) -> int:
    return (size - 1) // 2 + 1


class Unit(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.prelu1 = nn.PReLU(c, 0.25)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.prelu2 = nn.PReLU(c, 0.25)


class Net(nn.Module):
    """(B, 3, S, S) fp32 in [-1, 1] -> (B, E) fp32."""

    def __init__(self, cfg: Dict):
        super().__init__()
        cin, hw = 3, int(cfg["image_size"])
        for s, (units, c) in enumerate(zip(cfg["layers"], cfg["filters"]), start=1):
            mods = [nn.Conv2d(cin, c, 3, stride=2, padding=1, bias=True),
                    nn.PReLU(c, 0.25)] + [Unit(c) for _ in range(units)]
            setattr(self, f"layer{s}", nn.Sequential(*mods))
            cin, hw = c, stage_out(hw)
        self.fc = nn.Linear(cin * hw * hw, int(cfg["embedding_size"]))
        self.cast: Callable = exact

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        b = conv.bias
        return F.conv2d(self.cast(x), self.cast(conv.weight), b, conv.stride,
                        conv.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for s in range(1, 5):
            layer = getattr(self, f"layer{s}")
            x = F.prelu(self._conv(layer[0], x), layer[1].weight)
            for u in layer[2:]:
                y = F.prelu(self._conv(u.conv1, x), u.prelu1.weight)
                x = x + F.prelu(self._conv(u.conv2, y), u.prelu2.weight)
        x = x.flatten(1)
        return F.linear(self.cast(x), self.cast(self.fc.weight), self.fc.bias)


def init_rule(name: str, shape: Tuple[int, ...]) -> Tuple[str, float]:
    """How the benchmark draws each weight from its seed, at the scales of
    FedFR's own initialisation: the stage convs and the fc xavier-normal,
    the unit convs N(0, 0.01), the PReLU slopes 0.25, the biases 0."""
    if name.endswith(".bias"):
        return "const", 0.0
    if "prelu" in name or (name.endswith(".1.weight") and len(shape) == 1):
        return "const", 0.25
    if ".conv" in name:
        return "normal", 0.01
    fan_in = math.prod(shape[1:])
    return "normal", math.sqrt(2.0 / (fan_in + shape[0]))
