"""Margin-softmax transforms as pure functions (``fedfr_tpu/ops/margins.py``).

Rows with label == -1 (PartialFC convention for "positive lives on another
shard") receive no margin.
"""

from __future__ import annotations

import torch


def _onehot(label: torch.Tensor, num_classes: int) -> torch.Tensor:
    cols = torch.arange(num_classes, device=label.device)[None, :]
    return (label[:, None] == cols) & (label[:, None] >= 0)


def cosface(cosine: torch.Tensor, label: torch.Tensor, s: float = 30.0,
            m: float = 0.4) -> torch.Tensor:
    """Additive cosine margin: subtract m at the target logit, scale by s
    (reference losses.py:17-29)."""
    onehot = _onehot(label, cosine.shape[-1])
    return (cosine - torch.where(onehot, m, 0.0)) * s


def arcface(cosine: torch.Tensor, label: torch.Tensor, s: float = 30.0,
            m: float = 0.5) -> torch.Tensor:
    """Additive angular margin: cos(theta + m) at the target, scale by s
    (reference losses.py:32-45)."""
    onehot = _onehot(label, cosine.shape[-1])
    theta = torch.arccos(torch.clamp(cosine, -1.0, 1.0))
    return torch.cos(theta + torch.where(onehot, m, 0.0)) * s


def reweight_negatives(logits: torch.Tensor, label: torch.Tensor,
                       num_local: int, num_clients: int) -> torch.Tensor:
    """Replicate each row's non-target local logits (num_clients-1)x
    (reference client.py:269-285): take the first ``num_local`` columns
    after deleting the target column, detach, repeat, and append."""
    ks = torch.arange(num_local, device=logits.device)[None, :]
    # column k of (logits minus target col l) is column k + (k >= l) of logits
    idx = ks + (ks >= label[:, None]).long()
    tmp = torch.gather(logits, 1, idx).detach()
    return torch.cat([logits, tmp.repeat(1, num_clients - 1)], dim=1)


MARGINS = {"CosFace": cosface, "ArcFace": arcface}
