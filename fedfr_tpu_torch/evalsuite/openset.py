"""Shared open-set identification threshold math.

The port's numpy-only copy of ``fedfr_tpu/evalsuite/openset.py``.

Both open-set protocols — IJB-C 1:n (reference ijbc_all.py:404-427) and the
personalized local 1:n (reference local_all.py:142-177) — derive their
accept thresholds the same way: mask each probe's positive gallery score
out of the similarity matrix, pool every remaining (negative) score, and
take the k-th largest with k = ceil(num_probes * FPIR) per operating point.
One implementation here so the subtle parts (partial top-k, tie handling,
fewer negatives than k) cannot drift between the two callers.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def openset_thresholds(sim: np.ndarray, mask: np.ndarray,
                       fars: Sequence[float], inplace: bool = False
                       ) -> Tuple[np.ndarray, List[float]]:
    """(positive scores, per-FAR thresholds) from a probe-gallery sim matrix.

    ``mask[i]`` is probe i's gallery column, or -1 for an out-of-gallery
    probe (no positive score).  Positive entries are masked to -2 so the
    negative pool can be gathered with one compare; by default this happens
    on an internal copy — ``inplace=True`` skips the copy (callers whose
    ``sim`` is a throwaway can spare the q*g duplicate, but the matrix is
    corrupted afterwards).  Thresholds use a partial top-k (never a full
    sort of the ~q*g negative pool) and clamp k to the pool size —
    ceil(q * far) can exceed it on tiny galleries.
    """
    q = sim.shape[0]
    mask = np.asarray(mask)
    rows = np.nonzero(mask != -1)[0]
    pos_sims = sim[rows, mask[rows]].copy()
    if not inplace:
        sim = sim.copy()
    sim[rows, mask[rows]] = -2.0

    neg_sims = sim[sim > -2.0]
    if len(neg_sims) == 0:
        # degenerate single-row gallery with every probe positive: no
        # negative pool to estimate FPIR from — accept nothing
        return pos_sims, [float("inf")] * len(fars)
    required = [math.ceil(q * far) for far in fars]
    k = min(max(required), len(neg_sims))
    if k < len(neg_sims):
        top = np.partition(neg_sims, len(neg_sims) - k)[len(neg_sims) - k:]
    else:
        top = neg_sims
    top = np.sort(top)[::-1]
    ths = [float(top[min(p, len(top)) - 1]) for p in required]
    return pos_sims, ths
