"""iresnet100 in plain fp32 PyTorch: the reference of the ``iresnet100``
configuration.

InsightFace ``arcface_torch`` ``backbones/iresnet.py`` (``iresnet100``:
``layers`` [3, 13, 30, 3] over 64-512 channels), which is also the
state-dict layout the measured program loads:

    conv1, bn1, prelu                stem: 3x3 conv, BN, PReLU
    layer{s}.{b}                     y = bn3(conv2(prelu(bn2(conv1(bn1(x))))))
                                     + x or downsample(x); conv2 and the 1x1
                                     downsample stride 2 at b == 0
    bn2 -> flatten -> fc -> features BN1d whose scale stays 1 (no gradient)

BatchNorm: eps 1e-5, momentum 0.1; batch statistics in train mode, the
running ones in eval mode.  No dropout (the configuration's 0).  Every
operand of a conv or the fc goes through ``cast`` (``precision.CASTS``).
Imports nothing of the measured program.
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


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class Block(nn.Module):
    def __init__(self, cin: int, c: int, stride: int):
        super().__init__()
        self.bn1 = _bn(cin)
        self.conv1 = nn.Conv2d(cin, c, 3, padding=1, bias=False)
        self.bn2 = _bn(c)
        self.prelu = nn.PReLU(c, 0.25)
        self.conv2 = nn.Conv2d(c, c, 3, stride=stride, padding=1, bias=False)
        self.bn3 = _bn(c)
        self.downsample = None
        if stride != 1 or cin != c:
            self.downsample = nn.Sequential(nn.Conv2d(cin, c, 1, stride=stride, bias=False),
                                            _bn(c))


class Net(nn.Module):
    """(B, 3, S, S) fp32 in [-1, 1] -> (B, E) fp32."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, padding=1, bias=False)
        self.bn1 = _bn(64)
        self.prelu = nn.PReLU(64, 0.25)
        cin, hw = 64, int(cfg["image_size"])
        for s, (blocks, c) in enumerate(zip(cfg["layers"], cfg["filters"]), start=1):
            mods = [Block(cin, c, 2)] + [Block(c, c, 1) for _ in range(blocks - 1)]
            setattr(self, f"layer{s}", nn.Sequential(*mods))
            cin, hw = c, stage_out(hw)
        self.bn2 = _bn(cin)
        self.fc = nn.Linear(cin * hw * hw, int(cfg["embedding_size"]))
        self.features = nn.BatchNorm1d(int(cfg["embedding_size"]), eps=1e-5, momentum=0.1)
        self.cast: Callable = exact

    def _bn(self, bn, x):
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            self.training, bn.momentum, bn.eps)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(self.cast(x), self.cast(conv.weight), None, conv.stride,
                        conv.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.prelu(self._bn(self.bn1, self._conv(self.conv1, x)), self.prelu.weight)
        for s in range(1, 5):
            for blk in getattr(self, f"layer{s}"):
                y = self._conv(blk.conv1, self._bn(blk.bn1, x))
                y = F.prelu(self._bn(blk.bn2, y), blk.prelu.weight)
                y = self._bn(blk.bn3, self._conv(blk.conv2, y))
                if blk.downsample is not None:
                    x = self._bn(blk.downsample[1], self._conv(blk.downsample[0], x))
                x = y + x
        x = self._bn(self.bn2, x).flatten(1)
        x = F.linear(self.cast(x), self.cast(self.fc.weight), self.fc.bias)
        f = self.features
        return F.batch_norm(x, f.running_mean, f.running_var, f.weight.detach(), f.bias,
                            self.training, f.momentum, f.eps)


def init_rule(name: str, shape: Tuple[int, ...]) -> Tuple[str, float]:
    """How the benchmark draws each weight from its seed, at the scales of
    the measured program's own initialisation: convs N(0, 1 / fan_out), the
    fc LeCun-normal (1 / fan_in), BN scales 1 and shifts 0, PReLU slopes
    0.25, the fc bias 0, running means 0 and variances 1."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("running_mean", "bias", "num_batches_tracked"):
        return "const", 0.0
    if leaf == "running_var":
        return "const", 1.0
    if len(shape) == 1:  # BN scale or PReLU slope
        return "const", 0.25 if "prelu" in name else 1.0
    if len(shape) == 4:
        return "normal", math.sqrt(1.0 / (shape[0] * shape[2] * shape[3]))
    return "normal", math.sqrt(1.0 / shape[1])
