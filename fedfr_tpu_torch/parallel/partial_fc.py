"""Margin-softmax FC over every class ("Partial FC"), class-sharded over
the mesh's ``model`` axis.

The counterpart of ``fedfr_tpu/parallel/partial_fc.py``: plain functions on
tensors, whose feature and weight gradients come from autograd.  Shard d of
W holds the weight rows of classes ``[d * C_local, (d + 1) * C_local)``
(``pad_classes`` pads the class count to a multiple of W) on its device, and
a batch shard of the features and labels.  One controller runs the JAX
package's ``shard_map`` body shard by shard: each shard gathers every
feature and label in shard order (``mesh.gathered``), takes the logits of
its own classes, and the log-sum-exp's max, sum and target logit are
reduced on the first shard's device in shard order (``mesh.reduced``).  The
loss is one scalar there; the backward of the gather sums each feature
shard's gradient over the shards (JAX's reduce-scatter), and each weight
shard's gradient stays on its device.  With one shard the reductions are
identities.

* ``sharded_partial_fc_loss`` (``partial_fc_loss``: one shard): the full
  softmax; fp32 cosine (the JAX package passes ``Precision.HIGHEST``: TF32
  must stay off, PyTorch's default), the margin of ``ops/margins.py``,
  columns at or past ``num_valid`` masked to ``-inf``, a stable
  log-sum-exp, rows labelled ``-1`` left out of the mean.
* ``sample_negatives`` / ``sharded_sampled_partial_fc_loss``
  (``sampled_partial_fc_loss``: one shard): ``num_sample`` class rows per
  shard and step, positives forced and the rest uniform by the reference's
  top-k of perturbed scores (partial_fc.py:94-104), shard d from
  ``fold_in(key, d)`` of the JAX package's key (``ops/threefry.py``).  Ties
  among the forced positives (score 2.0) go to the lower index first, as
  ``lax.top_k`` breaks them: a stable descending sort, not ``torch.topk``,
  whose order among ties is not specified.  A positive that loses its
  shard's budget (more distinct positives than ``num_sample``) is masked
  out of the loss, not mis-targeted.

Deviation from the reference kept from the JAX package: rows labelled -1 are
excluded from the mean (the reference adds a spurious -log(1e-30) for them,
partial_fc.py:159-162).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..models.heads import l2_normalize
from ..ops import threefry
from ..ops.margins import MARGINS
from .mesh import gathered, reduced


def pad_classes(weight: torch.Tensor, num_shards: int) -> Tuple[torch.Tensor, int]:
    """Pad FC rows with zeros so that the class count divides the shard
    count; returns (weight, the real class count)."""
    c = weight.shape[0]
    pad = (-c) % num_shards
    if pad:
        weight = torch.cat([weight, weight.new_zeros(pad, weight.shape[1])])
    return weight, c


def _sharded_ce(logits: Sequence[torch.Tensor], local_labels: Sequence[torch.Tensor],
                valid: torch.Tensor) -> torch.Tensor:
    """Mean over ``valid`` rows of ``logsumexp(logits) - logits[label]``
    over the shards' columns (label -1: no target logit on that shard), on
    ``valid``'s device.  The stabilising max is the max of the shards'
    maxima, detached."""
    home = valid.device
    row_max = [lg.max(dim=1).values.detach() for lg in logits]
    gmax = row_max[0].to(home)
    for mx in row_max[1:]:
        gmax = torch.maximum(gmax, mx.to(home))
    z = [torch.exp(lg - gmax.to(lg.device)[:, None]).sum(dim=1) for lg in logits]
    logz = torch.log(reduced(z, home)) + gmax
    tgt = [torch.where(ll >= 0, lg.gather(1, ll.clamp(0, lg.shape[1] - 1)[:, None])[:, 0], 0.0)
           for lg, ll in zip(logits, local_labels)]
    per_row = torch.where(valid, logz - reduced(tgt, home), 0.0)
    return per_row.sum() / valid.sum().clamp_min(1)


def _shard_inputs(features, labels, weight: torch.Tensor):
    """A shard's gathered (B, E) fp32 features and (B,) int64 labels, on its
    weight's device."""
    dev = weight.device
    return gathered(features, dev).float(), gathered(labels, dev).long()


def sharded_partial_fc_loss(features: Sequence[torch.Tensor],
                            labels: Sequence[torch.Tensor],
                            weights: Sequence[torch.Tensor], margin: str = "CosFace",
                            s: float = 30.0, m: float = 0.4,
                            num_valid: Optional[int] = None) -> torch.Tensor:
    """The full-softmax margin CE over W shards: ``features[d]`` (B_d, E)
    and ``labels[d]`` (B_d,) in [0, C) or -1, the batch shards in order;
    ``weights[d]`` (C_local, E) the class shards, each on its device.
    Returns the scalar on ``weights[0]``'s device."""
    c_local = weights[0].shape[0]
    nv = c_local * len(weights) if num_valid is None else num_valid
    logits, local_labels = [], []
    for d, w in enumerate(weights):
        feats, all_labels = _shard_inputs(features, labels, w)
        rel = all_labels - d * c_local
        local_label = torch.where((rel >= 0) & (rel < c_local), rel, -1)
        cosine = l2_normalize(feats, dim=1) @ l2_normalize(w, dim=1).T
        lg = MARGINS[margin](cosine, local_label, s, m)
        col = d * c_local + torch.arange(c_local, device=w.device)[None, :]
        logits.append(torch.where(col < nv, lg, float("-inf")))
        local_labels.append(local_label)
    all_labels = gathered(labels, weights[0].device)
    return _sharded_ce(logits, local_labels, all_labels >= 0)


def partial_fc_loss(features: torch.Tensor, labels: torch.Tensor,
                    weight: torch.Tensor, margin: str = "CosFace",
                    s: float = 30.0, m: float = 0.4,
                    num_valid: Optional[int] = None) -> torch.Tensor:
    """The full-softmax margin CE of ``features`` (B, E) with ``labels``
    (B,) in [0, C) or -1 against every row of ``weight`` (C, E): the
    one-shard ``sharded_partial_fc_loss``."""
    return sharded_partial_fc_loss([features], [labels], [weight], margin, s, m,
                                   num_valid)


def sample_negatives(key: threefry.Key, labels: torch.Tensor, num_local: int,
                     num_sample: int, class_start: int = 0,
                     valid_count: Optional[int] = None) -> torch.Tensor:
    """The sorted indices of ``num_sample`` of a shard's ``num_local``
    class rows (its first class ``class_start``): the batch's positives
    forced (score 2.0), the rest by ``jax.random.uniform(key,
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


def shard_sample(key: threefry.Key, labels: torch.Tensor, shard: int,
                 num_local: int, num_sample: int,
                 num_valid: Optional[int] = None) -> torch.Tensor:
    """Shard ``shard``'s sampled row indices for the whole batch's
    ``labels`` (``partial_fc.py:176-180``): ``sample_negatives`` from
    ``fold_in(key, shard)`` over its ``num_local`` rows, those at or past
    ``num_valid`` being padding."""
    start = shard * num_local
    valid = None if num_valid is None else min(max(num_valid - start, 0), num_local)
    return sample_negatives(threefry.fold_in(key, shard), labels, num_local,
                            num_sample, start, valid_count=valid)


def sharded_sampled_partial_fc_loss(key: threefry.Key, features: Sequence[torch.Tensor],
                                    labels: Sequence[torch.Tensor],
                                    weights: Sequence[torch.Tensor], num_sample: int,
                                    margin: str = "CosFace", s: float = 30.0,
                                    m: float = 0.4,
                                    num_valid: Optional[int] = None) -> torch.Tensor:
    """The Partial FC with negative-class sampling over W shards (the
    layout of ``sharded_partial_fc_loss``): each shard's margin CE columns
    are its ``num_sample`` sampled rows, which alone get a gradient.
    ``key`` is the step's sampling key.  A row counts only where some shard
    holds its target among its sampled rows."""
    c_local = weights[0].shape[0]
    logits, local_labels = [], []
    for d, w in enumerate(weights):
        feats, all_labels = _shard_inputs(features, labels, w)
        start = d * c_local
        rel = all_labels - start
        index = shard_sample(key, all_labels, d, c_local, num_sample, num_valid)
        w_sub = w[index]
        # remap labels into the sampled set; a positive that lost the budget
        # maps nowhere and its row leaves the loss
        pos = (rel >= 0) & (rel < c_local)
        safe_rel = torch.where(pos, rel, 0)
        remapped = torch.searchsorted(index, safe_rel).clamp(0, num_sample - 1)
        hit = index[remapped] == safe_rel
        local_label = torch.where(pos & hit, remapped, -1)
        col_ok = None
        if num_valid is not None:
            # a padded all-zero row that sampling had to fall back to becomes
            # a constant BEFORE the normalisation: the norm's gradient at 0 is
            # NaN
            col_ok = (start + index) < num_valid
            w_sub = torch.where(col_ok[:, None], w_sub, 1.0)
        cosine = l2_normalize(feats, dim=1) @ l2_normalize(w_sub, dim=1).T
        lg = MARGINS[margin](cosine, local_label, s, m)
        if col_ok is not None:
            lg = torch.where(col_ok[None, :], lg, float("-inf"))
        logits.append(lg)
        local_labels.append(local_label)
    home = weights[0].device
    has_tgt = reduced([(ll >= 0).float() for ll in local_labels], home)
    all_labels = gathered(labels, home)
    return _sharded_ce(logits, local_labels, (all_labels >= 0) & (has_tgt > 0))


def sampled_partial_fc_loss(key: threefry.Key, features: torch.Tensor,
                            labels: torch.Tensor, weight: torch.Tensor,
                            num_sample: int, margin: str = "CosFace",
                            s: float = 30.0, m: float = 0.4,
                            num_valid: Optional[int] = None) -> torch.Tensor:
    """The one-shard ``sharded_sampled_partial_fc_loss``: the margin CE over
    ``num_sample`` sampled rows of ``weight``, drawn from ``fold_in(key,
    0)`` as the JAX package's shard 0 draws them."""
    return sharded_sampled_partial_fc_loss(key, [features], [labels], [weight],
                                           num_sample, margin, s, m, num_valid)


def num_sampled(sample_rate: float, num_classes_padded: int,
                num_shards: int = 1) -> int:
    """``pretrain.py:85``'s sample count per shard: the float floor
    division ``int(sample_rate * C_pad // n_shards)``, at least 1."""
    return max(1, int(sample_rate * num_classes_padded // num_shards))
