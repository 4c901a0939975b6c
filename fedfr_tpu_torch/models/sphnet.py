"""SphereFace-style plain CNN backbone (PyTorch, NCHW).

Counterpart of ``fedfr_tpu/models/sphnet.py`` with the reference module
layout (backbones/sphnet.py), so its state_dict keys are the ones
``fedfr_tpu.utils.torch_interop.sphnet_to_torch`` emits:

    layer{s}.0          strided 3x3 stage conv (with bias)
    layer{s}.1          PReLU
    layer{s}.{2+b}      SphereBlock: conv1, prelu1, conv2, prelu2
    fc                  Linear(512 * h * w -> embedding), NCHW flatten

sphere20 uses blocks (1, 2, 4, 1), sphere64 (the FedFR default) (3, 7, 16, 3)
over filters (64, 128, 256, 512).  With ``bf16`` the conv trunk runs under
``torch.autocast(bfloat16)`` and the embedding ``fc`` in fp32, as the JAX
package's bf16 trunk with its fp32 head.  ``remat`` checkpoints every
SphereBlock (``layers.remat_call``; JAX ``remat_blocks``, sphnet.py:60-104):
the same numbers, with the blocks' activations recomputed in the backward.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import PReLU, conv3x3, normal_init, remat_call, xavier_uniform

SPH_LAYERS = {20: (1, 2, 4, 1), 64: (3, 7, 16, 3)}
SPH_FILTERS = (64, 128, 256, 512)


def _stage_out(size: int) -> int:
    """Spatial size after one stride-2, pad-1, 3x3 conv."""
    return (size - 1) // 2 + 1


class SphereBlock(nn.Module):
    """Residual unit: x + prelu(conv(prelu(conv(x)))) (reference sphnet.py:4-13)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = conv3x3(features, features)
        self.prelu1 = PReLU(features)
        self.conv2 = conv3x3(features, features)
        self.prelu2 = PReLU(features)
        self.remat = False

    def _residual(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.prelu2(self.conv2(self.prelu1(self.conv1(x))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat:
            return remat_call(self, self._residual, x)
        return self._residual(x)


class SphNet(nn.Module):
    """sphere20/64 embedding backbone: (B, 3, H, W) float -> (B, E) float32."""

    def __init__(self, depth: int = 64, embedding_size: int = 512,
                 bf16: bool = True, image_size: int = 112,
                 generator: torch.Generator = None, remat: bool = False):
        super().__init__()
        if depth not in SPH_LAYERS:
            raise ValueError(f"sphere{depth} unsupported (20 or 64)")
        self.depth = depth
        self.bf16 = bf16
        cin, hw = 3, image_size
        for stage, (blocks, feats) in enumerate(
                zip(SPH_LAYERS[depth], SPH_FILTERS), start=1):
            mods = [conv3x3(cin, feats, stride=2, bias=True), PReLU(feats)]
            mods += [SphereBlock(feats) for _ in range(blocks)]
            setattr(self, f"layer{stage}", nn.Sequential(*mods))
            cin, hw = feats, _stage_out(hw)
        self.fc = nn.Linear(cin * hw * hw, embedding_size)
        for blk in self.modules():
            if isinstance(blk, SphereBlock):
                blk.remat = remat
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """The JAX package's init: xavier stage convs and fc with zero bias,
        N(0, 0.01) block convs, PReLU 0.25."""
        for stage in range(1, 5):
            layer = getattr(self, f"layer{stage}")
            xavier_uniform(layer[0].weight, generator)
            nn.init.zeros_(layer[0].bias)
            for blk in layer[2:]:
                normal_init(blk.conv1.weight, 0.01, generator)
                normal_init(blk.conv2.weight, 0.01, generator)
        xavier_uniform(self.fc.weight, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.bf16):
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        # (B, 512, h, w) -> NCHW flatten; embedding projection in fp32
        return self.fc(x.flatten(1).float())
