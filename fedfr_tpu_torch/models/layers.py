"""Shared layers for the face backbones (PyTorch, NCHW).

Counterpart of ``fedfr_tpu/models/layers.py``.  The JAX package's
``TorchBatchNorm`` reproduces torch's BatchNorm train semantics (momentum
0.1, biased variance to normalize, unbiased variance into the running
estimate), so the port uses ``nn.BatchNorm2d`` as it is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class PReLU(nn.PReLU):
    """Per-channel parametric ReLU, init 0.25 (``nn.PReLU`` and its
    state_dict key ``weight``).

    The fp32 slope is cast to the input's dtype, as the JAX layer does, so
    the layer runs in the bf16 trunk under autocast as one fused kernel.
    """

    def __init__(self, num_parameters: int):
        super().__init__(num_parameters, init=0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


def conv3x3(cin: int, cout: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    """3x3 conv, padding 1 (the JAX package's SAME-1 ``conv3x3``)."""
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


def batch_norm(features: int) -> nn.BatchNorm2d:
    """BatchNorm with the reference hyperparameters (momentum 0.1, eps 1e-5,
    iresnet.py:37-42)."""
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


def normal_init(tensor: torch.Tensor, stddev: float,
                generator: torch.Generator = None) -> torch.Tensor:
    with torch.no_grad():
        return tensor.normal_(0.0, stddev, generator=generator)


def lecun_normal(tensor: torch.Tensor,
                 generator: torch.Generator = None) -> torch.Tensor:
    """flax's default Dense kernel init for a torch ``(out, in)`` weight: a
    normal truncated at 2 sigma, rescaled to variance 1 / in."""
    std = math.sqrt(1.0 / tensor.shape[1]) / 0.87962566103423978
    return nn.init.trunc_normal_(tensor, std=std, a=-2.0 * std, b=2.0 * std,
                                 generator=generator)


def xavier_uniform(tensor: torch.Tensor,
                   generator: torch.Generator = None) -> torch.Tensor:
    return nn.init.xavier_uniform_(tensor, generator=generator)
