"""Loss functions of the FedFR objective (``fedfr_tpu/ops/losses.py``).

loss = softmax-CE(margin logits) + 10 * BCE + mu * contrastive
(reference client.py:383).  All reductions take an optional per-row
``valid`` mask so padded batches contribute zero.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _masked_mean(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return x.mean()
    v = valid.to(x.dtype)
    return (x * v).sum() / v.sum().clamp_min(1.0)


def softmax_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                          valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard CE over the class axis, mean over (valid) rows."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, 1, label[:, None].long())[:, 0]
    return _masked_mean(logz - tgt, valid)


def bce_loss(logits: torch.Tensor, gt: torch.Tensor, r: float = 30.0,
             lambda_: float = 0.7, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary margin loss of the transformation layer (reference losses.py:4-15).

    positive terms:  (lambda/r)   * log(1 + exp(-z) + 1e-8)
    negative terms:  ((1-lambda)/r) * log(1 + exp(+z) + 1e-8)
    summed over classes, averaged over the batch.  The exp argument is
    clamped at 60 for fp32 safety; beyond it the log is z itself.
    """
    z = logits.float()
    pos = (lambda_ / r) * torch.log1p(torch.exp(torch.clamp(-z, max=60.0)) + 1e-8)
    pos = torch.where(z < -60.0, (lambda_ / r) * (-z), pos)
    neg = ((1.0 - lambda_) / r) * torch.log1p(torch.exp(torch.clamp(z, max=60.0)) + 1e-8)
    neg = torch.where(z > 60.0, ((1.0 - lambda_) / r) * z, neg)
    per_row = torch.where(gt, pos, neg).sum(dim=1)
    return _masked_mean(per_row, valid)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity, each norm clamped at eps separately (the
    JAX package's formula)."""
    na = torch.linalg.vector_norm(a, dim=1).clamp_min(eps)
    nb = torch.linalg.vector_norm(b, dim=1).clamp_min(eps)
    return (a * b).sum(dim=1) / (na * nb)


def moon_contrastive(feats: torch.Tensor, global_feats: torch.Tensor,
                     last_feats: torch.Tensor, temperature: float = 0.5,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MOON-style model-contrastive regularizer (reference client.py:372-375).

    CE over [sim(z, z_global)/T, sim(z, z_last)/T] with the global model as
    the positive: softplus(neg - pos) per row.
    """
    pos = cosine_similarity(feats, global_feats.detach()) / temperature
    neg = cosine_similarity(feats, last_feats.detach()) / temperature
    return _masked_mean(F.softplus(neg - pos), valid)
