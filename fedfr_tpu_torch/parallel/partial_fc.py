"""Margin-softmax FC over every class ("Partial FC") on one device.

The counterpart of ``fedfr_tpu/parallel/partial_fc.py`` with one class
shard: plain functions on tensors, whose feature and weight gradients come
from autograd.  The JAX package runs the same blocked log-sum-exp inside
``shard_map`` over the mesh's ``model`` axis (every device a batch shard and
a class shard, the reference's NCCL layout); with one shard its collectives
are identities and the function is the one below.  Sharding over more than
one GPU (``torch.distributed``) is not ported: ROADMAP B.2 item 4.

* ``partial_fc_loss``: the full softmax over the ``(C, E)`` weight; fp32
  cosine (the JAX package passes ``Precision.HIGHEST``: TF32 must stay off,
  PyTorch's default), the margin of ``ops/margins.py``, columns at or past
  ``num_valid`` masked to ``-inf``, a stable log-sum-exp, rows labelled
  ``-1`` left out of the mean.
* ``sample_negatives`` / ``sampled_partial_fc_loss``: ``num_sample`` class
  rows per step, positives forced and the rest uniform by the reference's
  top-k of perturbed scores (partial_fc.py:94-104), from the JAX package's
  key (``ops/threefry.py``).  Ties among the forced positives (score 2.0)
  go to the lower index first, as ``lax.top_k`` breaks them: a stable
  descending sort, not ``torch.topk``, whose order among ties is not
  specified.  A positive that loses the budget (more distinct positives
  than ``num_sample``) is masked out of the loss, not mis-targeted.

Deviation from the reference kept from the JAX package: rows labelled -1 are
excluded from the mean (the reference adds a spurious -log(1e-30) for them,
partial_fc.py:159-162).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.heads import l2_normalize
from ..ops import threefry
from ..ops.margins import MARGINS


def pad_classes(weight: torch.Tensor, num_shards: int) -> Tuple[torch.Tensor, int]:
    """Pad FC rows with zeros so that the class count divides the shard
    count; returns (weight, the real class count)."""
    c = weight.shape[0]
    pad = (-c) % num_shards
    if pad:
        weight = torch.cat([weight, weight.new_zeros(pad, weight.shape[1])])
    return weight, c


def _softmax_ce(logits: torch.Tensor, local_label: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Mean over ``valid`` rows of ``logsumexp(logits) - logits[label]``
    (label -1: no target logit), the stabilising max detached."""
    row_max = logits.max(dim=1).values.detach()
    logz = torch.log(torch.exp(logits - row_max[:, None]).sum(dim=1)) + row_max
    safe = local_label.clamp(0, logits.shape[1] - 1)
    tgt = torch.where(local_label >= 0,
                      logits.gather(1, safe[:, None])[:, 0], 0.0)
    per_row = torch.where(valid, logz - tgt, 0.0)
    return per_row.sum() / valid.sum().clamp_min(1)


def partial_fc_loss(features: torch.Tensor, labels: torch.Tensor,
                    weight: torch.Tensor, margin: str = "CosFace",
                    s: float = 30.0, m: float = 0.4,
                    num_valid: Optional[int] = None) -> torch.Tensor:
    """The full-softmax margin CE of ``features`` (B, E) with ``labels``
    (B,) in [0, C) or -1 against every row of ``weight`` (C, E)."""
    c = weight.shape[0]
    nv = c if num_valid is None else num_valid
    labels = labels.long()
    cosine = l2_normalize(features.float(), dim=1) @ l2_normalize(weight, dim=1).T
    local_label = torch.where((labels >= 0) & (labels < c), labels, -1)
    logits = MARGINS[margin](cosine, local_label, s, m)
    col = torch.arange(c, device=logits.device)[None, :]
    logits = torch.where(col < nv, logits, float("-inf"))
    return _softmax_ce(logits, local_label, labels >= 0)


def sample_negatives(key: threefry.Key, labels: torch.Tensor, num_local: int,
                     num_sample: int, class_start: int = 0,
                     valid_count: Optional[int] = None) -> torch.Tensor:
    """The sorted indices of ``num_sample`` class rows: the batch's
    positives forced (score 2.0), the rest by ``jax.random.uniform(key,
    (num_local,))``; rows at or past ``valid_count`` (padding) score -1, so
    real classes always win the budget."""
    dev = labels.device
    rel = labels.long() - class_start
    pos = (rel >= 0) & (rel < num_local)
    perm = threefry.uniform_at(key, torch.arange(num_local, device=dev))
    # one slot past the end takes the non-positives (no host sync)
    marks = torch.zeros(num_local + 1, dtype=torch.bool, device=dev)
    marks[torch.where(pos, rel, num_local)] = True
    perm = torch.where(marks[:num_local], 2.0, perm)
    if valid_count is not None:
        perm = torch.where(torch.arange(num_local, device=dev) < valid_count,
                           perm, -1.0)
    order = torch.sort(perm, descending=True, stable=True).indices
    return order[:num_sample].sort().values


def sampled_partial_fc_loss(key: threefry.Key, features: torch.Tensor,
                            labels: torch.Tensor, weight: torch.Tensor,
                            num_sample: int, margin: str = "CosFace",
                            s: float = 30.0, m: float = 0.4,
                            num_valid: Optional[int] = None) -> torch.Tensor:
    """Partial FC with negative-class sampling (a static ``num_sample``):
    the margin CE over the sampled rows of ``weight``, which alone get a
    gradient.  ``key`` is the step's sampling key; the shard's key is
    ``fold_in(key, 0)``, as the JAX package's shard 0 draws it."""
    c = weight.shape[0]
    labels = labels.long()
    index = sample_negatives(threefry.fold_in(key, 0), labels, c, num_sample,
                             valid_count=None if num_valid is None
                             else min(max(num_valid, 0), c))
    w_sub = weight[index]
    # remap labels into the sampled set; a positive that lost the budget
    # maps nowhere and its row leaves the loss
    pos = (labels >= 0) & (labels < c)
    safe_rel = torch.where(pos, labels, 0)
    remapped = torch.searchsorted(index, safe_rel).clamp(0, num_sample - 1)
    hit = index[remapped] == safe_rel
    local_label = torch.where(pos & hit, remapped, -1)
    col_ok = None
    if num_valid is not None:
        # a padded all-zero row that sampling had to fall back to becomes a
        # constant BEFORE the normalisation: the norm's gradient at 0 is NaN
        col_ok = index < num_valid
        w_sub = torch.where(col_ok[:, None], w_sub, 1.0)
    cosine = l2_normalize(features.float(), dim=1) @ l2_normalize(w_sub, dim=1).T
    logits = MARGINS[margin](cosine, local_label, s, m)
    if col_ok is not None:
        logits = torch.where(col_ok[None, :], logits, float("-inf"))
    return _softmax_ce(logits, local_label, (labels >= 0) & (local_label >= 0))


def num_sampled(sample_rate: float, num_classes_padded: int,
                num_shards: int = 1) -> int:
    """``pretrain.py:85``'s sample count per shard: the float floor
    division ``int(sample_rate * C_pad // n_shards)``, at least 1."""
    return max(1, int(sample_rate * num_classes_padded // num_shards))
