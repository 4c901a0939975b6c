"""The personalised 1:1 ROC in plain PyTorch and NumPy.

FedFR's ``roc_cuda.py``: the target client's images first, every pair
(i, j) with i a target image and i < j binned by its cosine into 2,001
buckets ``clamp(int((cos + 1) * 1000), 0, 2000)``, split by whether the
labels match; TPR at FPR = 1e-1 .. 1e-6 by linear interpolation on the
cumulative counts, x100, two decimals.  ``tf32`` computes the cosines in
TF32 (the control, one step below the fp32 the configuration states).
Imports nothing of the measured program.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

BINS = 2001


def target_first(labels: np.ndarray, start: int, end: int) -> np.ndarray:
    target = (labels >= start) & (labels < end)
    return np.concatenate([np.flatnonzero(target), np.flatnonzero(~target)])


def histogram(feats: torch.Tensor, labels: np.ndarray, start: int, end: int,
              tf32: bool = False, tile: int = 1024) -> np.ndarray:
    """(BINS, 2) int64 [same, different] pair counts; ``feats`` (N, E)
    unit rows in dataset order on the device that computes."""
    order = target_first(labels, start, end)
    t = int(((labels >= start) & (labels < end)).sum())
    f = feats[torch.as_tensor(order, device=feats.device)].float()
    lab = torch.as_tensor(labels[order].astype(np.int64), device=feats.device)
    n = f.shape[0]
    hist = torch.zeros(2 * BINS, dtype=torch.int64, device=f.device)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for i0 in range(0, t, tile):
            i1 = min(i0 + tile, t)
            for j0 in range(i0 + 1, n, 8 * tile):
                j1 = min(j0 + 8 * tile, n)
                sim = f[i0:i1] @ f[j0:j1].t()
                bins = ((sim + 1.0) * 1000.0).to(torch.int64).clamp_(0, BINS - 1)
                cls = bins * 2 + (lab[i0:i1, None] != lab[None, j0:j1])
                ii = torch.arange(i0, i1, device=f.device)[:, None]
                jj = torch.arange(j0, j1, device=f.device)[None, :]
                hist += torch.bincount(cls[ii < jj], minlength=2 * BINS)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return hist.cpu().numpy().reshape(BINS, 2)


def tpr_table(hist: np.ndarray) -> List[float]:
    cum = np.cumsum(hist, axis=0)
    pos, neg = max(cum[-1, 0], 1), max(cum[-1, 1], 1)
    tpr = np.concatenate([[1.0], (cum[-1, 0] - cum[:, 0]) / pos])
    fpr = np.concatenate([[1.0], (cum[-1, 1] - cum[:, 1]) / neg])
    order = np.argsort(fpr)
    return [float("%.2f" % (100.0 * np.interp(10.0 ** e, fpr[order], tpr[order])))
            for e in (-1, -2, -3, -4, -5, -6)]
