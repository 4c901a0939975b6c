"""Backbone factory (counterpart of ``fedfr_tpu/models/factory.py``)."""

from __future__ import annotations

import torch
from torch import nn

from .iresnet import IResNet
from .layers import batch_norm, conv3x3, lecun_normal
from .sphnet import SphNet


class ToyNet(nn.Module):
    """Tiny conv embedder (global-avg-pool, any input size) for tests/smoke.

    The JAX ``ToyNet`` has no reference counterpart, so its state_dict keys
    are the port's own: ``conv1.weight``, ``bn1.*``, ``conv2.weight``,
    ``fc.{weight,bias}``.  Its init is flax's default, the JAX net's: every
    conv and the fc kernel lecun-normal, the fc bias 0, BN scale 1 and bias
    0, drawn from the global RNG.
    """

    def __init__(self, embedding_size: int = 32):
        super().__init__()
        self.conv1 = conv3x3(3, 16, stride=2)
        self.bn1 = batch_norm(16)
        self.conv2 = conv3x3(16, 32, stride=2)
        self.fc = nn.Linear(32, embedding_size)
        for w in (self.conv1.weight, self.conv2.weight, self.fc.weight):
            lecun_normal(w)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.conv2(x))
        return self.fc(x.mean(dim=(2, 3)))


def build_backbone(name: str, embedding_size: int = 512, bf16: bool = True,
                   image_size: int = 112, generator: torch.Generator = None,
                   dropout: float = 0.0, freeze_bn: bool = False,
                   remat: bool = False) -> nn.Module:
    """``toy``, ``sphnet`` (sphere64), ``sphnet20`` or ``iresnet<depth>``
    (18/34/50/100/200) on the CPU; the caller moves it to its device.
    ``dropout`` and ``freeze_bn`` are iresnet's (the pre-embedding dropout
    and BN kept in inference mode while training); the JAX package ignores
    them for the other nets, and so does the port.  ``remat`` (the JAX
    ``remat_blocks``, factory.py:35-53) checkpoints every residual block of
    sphnet and iresnet; the toy net has none, and ignores it as the JAX one
    does."""
    if name == "toy":
        return ToyNet(embedding_size=embedding_size)
    if name in ("sphnet", "sphnet20"):
        return SphNet(depth=20 if name == "sphnet20" else 64,
                      embedding_size=embedding_size, bf16=bf16,
                      image_size=image_size, generator=generator, remat=remat)
    if name.startswith("iresnet") and name[len("iresnet"):].isdigit():
        return IResNet(depth=int(name[len("iresnet"):]),
                       embedding_size=embedding_size, dropout=dropout,
                       bf16=bf16, freeze_bn=freeze_bn, image_size=image_size,
                       generator=generator, remat=remat)
    raise ValueError(f"unknown backbone '{name}'")
