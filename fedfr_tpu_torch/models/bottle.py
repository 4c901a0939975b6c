"""Four-branch bottleneck MLP residual block (the alternate BCE converter).

Counterpart of ``fedfr_tpu/models/bottle.py`` (reference
backbones/bottle.py:11-47) with the reference key layout: four branches
``br{i}`` of Linear -> LeakyReLU(0.01) -> Linear -> LeakyReLU at
``in_dim / bottle_rate`` width, concatenated and projected back by
``concat_fc``, plus the input.  All fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import lecun_normal


class BottleBlock(nn.Module):
    def __init__(self, in_dim: int, bottle_rate: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width = in_dim // bottle_rate
        for i in range(1, 5):
            setattr(self, f"br{i}", nn.Sequential(
                nn.Linear(in_dim, width), nn.LeakyReLU(0.01),
                nn.Linear(width, width), nn.LeakyReLU(0.01)))
        self.concat_fc = nn.Linear(4 * width, in_dim)
        for m in self.modules():  # flax's Dense init
            if isinstance(m, nn.Linear):
                lecun_normal(m.weight, generator)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [getattr(self, f"br{i}")(x) for i in range(1, 5)]
        return x + self.concat_fc(torch.cat(branches, dim=-1))
