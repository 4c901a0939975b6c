"""Server-side aggregation: weighted FedAvg and FC averaging.

Counterpart of ``fedfr_tpu/parallel/fedavg.py`` (reference server.py:25-46):

* ``streaming_weighted_average`` — dataset-size-weighted mean of *every*
  floating state_dict entry, BatchNorm running statistics included, as
  ``FedPavg`` averages every entry (server.py:29-33).  Integer buffers
  (BatchNorm's ``num_batches_tracked``, which the JAX package does not
  have) are taken from the first client.
* ``fedavg_on_fc`` — weighted mean of the clients' copies of the shared
  global FC with server interpolation factor p (server.py:36-46).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


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
