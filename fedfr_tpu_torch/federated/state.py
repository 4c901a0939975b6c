"""Client train state and device-side preprocessing.

Counterpart of ``fedfr_tpu/federated/state.py``.  The JAX package keeps a
client's state in pytrees that its jitted step returns anew; here the state
is a set of modules and an optimizer that the step updates in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn


class ClientTrainState(NamedTuple):
    """Everything a client updates during a local run.

    backbone: the trainable backbone module (its BN buffers included)
    fc:       (C, E) cosine-classifier rows, [local ; global] during joint
              public training (reference client.py:313)
    bce:      the BCE module or None
    opt:      one SGD over backbone + fc + bce (reference client.py:335)
    """

    backbone: nn.Module
    fc: nn.Parameter
    bce: Optional[nn.Module]
    opt: torch.optim.SGD


def normalize_images(u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC RGB -> float32 NCHW in [-1, 1] (Normalize(0.5, 0.5),
    dataset.py:85); the same arithmetic as the JAX package, then channels
    first."""
    return (u8.float() * (1.0 / 127.5) - 1.0).permute(0, 3, 1, 2)


def apply_hflip(flip: torch.Tensor, imgs: torch.Tensor) -> torch.Tensor:
    """Mirror the rows of NHWC ``imgs`` where ``flip`` (B,) is True."""
    return torch.where(flip[:, None, None, None], imgs.flip(2), imgs)


def train_preprocess(flip: torch.Tensor, u8: torch.Tensor) -> torch.Tensor:
    return normalize_images(apply_hflip(flip, u8))
