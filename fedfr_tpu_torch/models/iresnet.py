"""Insightface-style improved ResNet family (PyTorch, NCHW).

Counterpart of ``fedfr_tpu/models/iresnet.py`` with the reference module
layout (backbones/iresnet.py), so its state_dict keys are the ones
``fedfr_tpu.utils.torch_interop.iresnet_to_torch`` emits:

    conv1, bn1, prelu                     stem (3x3 conv, no pooling)
    layer{s}.{b}                          IBasicBlock: bn1, conv1, bn2, prelu,
                                          conv2 (stride 2 at b == 0), bn3,
                                          downsample.{0,1} (1x1 conv + BN, b == 0)
    bn2 -> flatten -> dropout -> fc       Linear(512 * h * w -> E), NCHW flatten
    features                              BatchNorm1d, scale fixed at 1

Depths 18/34/50/100/200.  With ``bf16`` the convolutions run under
``torch.autocast(bfloat16)``; every BatchNorm normalizes in fp32 and the
residual stream, the PReLUs, the fc and the BN1d stay fp32, as in the JAX
package (iresnet.py:101-148).

``freeze_bn`` keeps every BatchNorm in inference mode while the module
trains (``bn_train = train and not freeze_bn``, JAX iresnet.py:102):
``train()`` leaves the BN layers in eval mode, so they normalize with their
running statistics and never update them, while their affine parameters
still take gradients.

Dropout is the one random layer, and its randomness is injected: in train
mode with ``dropout > 0`` the forward takes an explicit ``torch.Generator``
(``dropout_gen``), or the keep mask drawn from one (``dropout_keep``, as
``draw_dropout_keep`` draws it), and raises without either.

``remat`` checkpoints every IBasicBlock (``layers.remat_call``; JAX
``remat_blocks``, iresnet.py:93-115): the same forward, BN running
statistics updated once, by the forward, and the same gradients.

Initialization: the JAX package (and the reference) draw the conv kernels
from N(0, 0.1).  With BN's initial running statistics (mean 0, var 1) that
grows the activations of an eval-mode forward by ~18-280x per block in
variance, so from iresnet100 on a fresh backbone's eval-mode features
overflow to NaN.  A client's MOON "last model" is such a fresh backbone
run in eval mode in round 0, so the port draws the convs from
N(0, 1 / fan_out) instead (fan_out = out channels x kernel area), which
grows that forward by ~1.5x per block and keeps its features finite at
every depth (``tests/test_torch_iresnet.py`` checks iresnet100 and 200).
Every conv feeds a BatchNorm, so a train-mode forward does not depend on
that scale.  Weights carried from the JAX package through ``interop`` are
not affected.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import PReLU, batch_norm, conv3x3, lecun_normal, remat_call

IRES_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 14, 3),
               100: (3, 13, 30, 3), 200: (6, 26, 60, 6)}
IRES_FILTERS = (64, 128, 256, 512)


def _stage_out(size: int) -> int:
    """Spatial size after one stride-2, pad-1, 3x3 conv."""
    return (size - 1) // 2 + 1


def draw_dropout_keep(shape, p: float, generator: torch.Generator,
                      device) -> torch.Tensor:
    """The train-mode dropout's keep mask over the flattened pre-embedding
    features (``shape`` = (B, fc.in_features)): one uniform draw a feature
    from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) >= p


class IBasicBlock(nn.Module):
    """BN-first residual block (reference iresnet.py:28-57)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.bn1 = batch_norm(inplanes)
        self.conv1 = conv3x3(inplanes, planes)
        self.bn2 = batch_norm(planes)
        self.prelu = PReLU(planes)
        self.conv2 = conv3x3(planes, planes, stride=stride)
        self.bn3 = batch_norm(planes)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                batch_norm(planes))
        self.remat = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat:
            return remat_call(self, self._residual, x)
        return self._residual(x)

    def _residual(self, x: torch.Tensor) -> torch.Tensor:
        # x is the fp32 residual stream; the convs autocast to bf16
        y = self.conv1(self.bn1(x))
        y = self.prelu(self.bn2(y.float()))
        y = self.bn3(self.conv2(y).float())
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](self.downsample[0](x).float())
        return y + identity


class FeatureNorm(nn.BatchNorm1d):
    """The embedding's BatchNorm1d with its scale fixed at 1 (reference
    iresnet.py:99-100: ``features.weight`` is 1 and takes no gradient).  The
    forward reads ``weight`` detached, so it never gets a gradient and
    keeps its initial 1."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight.detach(), self.bias, self.training,
                            self.momentum, self.eps)


class IResNet(nn.Module):
    """iresnet{18..200} embedding backbone: (B, 3, H, W) float -> (B, E) float32."""

    def __init__(self, depth: int = 18, embedding_size: int = 512,
                 dropout: float = 0.0, bf16: bool = True,
                 freeze_bn: bool = False, image_size: int = 112,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        if depth not in IRES_LAYERS:
            raise ValueError(f"iresnet{depth} unsupported "
                             f"({'/'.join(map(str, IRES_LAYERS))})")
        self.depth = depth
        self.dropout = dropout
        self.bf16 = bf16
        self.freeze_bn = freeze_bn
        self.conv1 = conv3x3(3, 64)
        self.bn1 = batch_norm(64)
        self.prelu = PReLU(64)
        inplanes, hw = 64, image_size
        for stage, (blocks, planes) in enumerate(
                zip(IRES_LAYERS[depth], IRES_FILTERS), start=1):
            mods = [IBasicBlock(inplanes, planes, stride=2, downsample=True)]
            mods += [IBasicBlock(planes, planes) for _ in range(blocks - 1)]
            setattr(self, f"layer{stage}", nn.Sequential(*mods))
            inplanes, hw = planes, _stage_out(hw)
        self.bn2 = batch_norm(512)
        self.fc = nn.Linear(512 * hw * hw, embedding_size)
        self.features = FeatureNorm(embedding_size, eps=1e-5, momentum=0.1)
        for blk in self.modules():
            if isinstance(blk, IBasicBlock):
                blk.remat = remat
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, 1 / fan_out) convs (see the module docstring); as the JAX
        package otherwise: BN scale 1 and bias 0, PReLU 0.25, a LeCun-normal
        fc (flax's default) with zero bias."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                with torch.no_grad():
                    m.weight.normal_(0.0, math.sqrt(1.0 / fan_out),
                                     generator=generator)
        lecun_normal(self.fc.weight, generator)
        nn.init.zeros_(self.fc.bias)

    def train(self, mode: bool = True) -> "IResNet":
        super().train(mode)
        if self.freeze_bn:
            for m in self.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor,
                dropout_gen: Optional[torch.Generator] = None,
                dropout_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.bf16):
            x = self.prelu(self.bn1(self.conv1(x).float()))
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.bn2(x.float()).flatten(1)
        if self.training and self.dropout > 0:
            if dropout_keep is None:
                if dropout_gen is None:
                    raise ValueError("iresnet dropout in train mode needs an "
                                     "explicit dropout_gen")
                dropout_keep = draw_dropout_keep(x.shape, self.dropout,
                                                 dropout_gen, x.device)
            x = torch.where(dropout_keep, x / (1.0 - self.dropout), 0.0)
        return self.features(self.fc(x))
