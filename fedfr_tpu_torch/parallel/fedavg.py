"""Server-side aggregation: weighted FedAvg and FC averaging.

Counterpart of ``fedfr_tpu/parallel/fedavg.py`` (reference server.py:25-46):

* ``stack_trees`` / ``unstack_tree`` — client state_dicts stacked on a
  leading client axis and taken apart again (the lockstep round's group
  states, ``parallel/client_parallel.py``).
* ``streaming_weighted_average`` — dataset-size-weighted mean of *every*
  floating state_dict entry, BatchNorm running statistics included, as
  ``FedPavg`` averages every entry (server.py:29-33).  Integer buffers
  (BatchNorm's ``num_batches_tracked``, which the JAX package does not
  have) are taken from the first client.
* ``fedavg_on_fc`` — weighted mean of the clients' copies of the shared
  global FC with server interpolation factor p (server.py:36-46).
* ``spreadout`` — momentum SGD on the SpreadOut regularizer over the
  sampled clients' local FC rows (server.py:340-371).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..models.heads import l2_normalize

StateDict = Dict[str, torch.Tensor]


def stack_trees(trees: Sequence[StateDict]) -> StateDict:
    """State_dicts with the same keys and shapes -> one state_dict of
    (len(trees), ...) tensors."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def unstack_tree(tree: StateDict, n: int) -> List[StateDict]:
    """The first ``n`` slots of a stacked state_dict, each entry a copy of
    its own."""
    return [{k: v[i].clone() for k, v in tree.items()} for i in range(n)]


def _normalized(weights) -> np.ndarray:
    w = np.asarray(weights, np.float32)
    return w / w.sum()  # f32 normalization, as the JAX package


def streaming_weighted_average(trees: Sequence[StateDict], weights) -> StateDict:
    """Weighted mean over client state_dicts, one client at a time: the same
    left-to-right f32 accumulation as the JAX package, with one state plus
    the accumulator live."""
    w = _normalized(weights)
    out: StateDict = {}
    for key, first in trees[0].items():
        if not first.is_floating_point():
            out[key] = first.clone()
            continue
        acc = first * float(w[0])
        for tree, wi in zip(trees[1:], w[1:]):
            acc = acc + tree[key] * float(wi)
        out[key] = acc
    return out


def fedavg_on_fc(pretrain_fc: torch.Tensor, fc_stack: torch.Tensor,
                 weights, p: float = 1.0) -> torch.Tensor:
    """(K, C, E) client copies of the global FC -> aggregated (C, E)."""
    w = torch.as_tensor(_normalized(weights), device=fc_stack.device)
    aggr = (fc_stack * w.view(-1, 1, 1)).sum(dim=0)
    if p == 1.0:
        return aggr
    return (1.0 - p) * pretrain_fc + p * aggr


def spreadout_loss(fc: torch.Tensor, margin: float = 0.4,
                   mode: str = "mean") -> torch.Tensor:
    """The SpreadOut objective: ``relu(cos - margin)^2`` over the
    off-diagonal pairs of the l2-normalized rows, summed (``mode='sum'``)
    or averaged over the N(N-1) pairs (``'mean'``, masked_select
    semantics).  The gram matrix is one fp32 product (TF32 must be off, as
    it is by default), outside any kernel of the TPU package."""
    fcn = l2_normalize(fc, dim=1)
    sim = torch.matmul(fcn, fcn.t())
    n = fc.shape[0]
    offdiag = ~torch.eye(n, dtype=torch.bool, device=fc.device)
    sq = torch.where(offdiag, torch.relu(sim - margin), 0.0) ** 2
    if mode == "sum":
        return sq.sum()
    return sq.sum() / (n * (n - 1))


def spreadout(fc_all: torch.Tensor, *, margin: float = 0.4, iters: int = 20,
              lr: float = 0.01, momentum: float = 0.9, weight_decay: float = 5e-4,
              mode: str = "mean") -> torch.Tensor:
    """Run ``iters`` momentum-SGD steps of ``spreadout_loss`` on
    ``fc_all``, the (sum_K C_k, E) concatenation of the sampled clients'
    local FC rows, and return the new rows.  The weight decay is added to
    the gradient and the momentum buffer starts at zero (JAX
    ``fedfr_tpu/parallel/fedavg.py::spreadout``).  Server call sites use
    margin 0.4, lr = 10x the base lr, 20 iterations, mode 'mean'
    (server.py:348-349, train.py:81)."""
    fc = fc_all.detach().float()
    buf = torch.zeros_like(fc)
    for _ in range(iters):
        x = fc.clone().requires_grad_(True)
        with torch.enable_grad():
            (grad,) = torch.autograd.grad(spreadout_loss(x, margin, mode), x)
        buf = momentum * buf + (grad + weight_decay * fc)
        fc = fc - lr * buf
    return fc
