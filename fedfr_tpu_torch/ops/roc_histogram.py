"""Per-client 1:1 ROC from the all-pairs cosine histogram.

The port's counterpart of ``fedfr_tpu/ops/roc_histogram.py`` on one device
(the reference's roc_cuda.py): the target client's images are reordered
first, every pair (i < j, i a target image) of the local verification set
is binned into 2001 cosine buckets by label match (``ops/roc_hist.py``: the
kernel on the card, its plain version on the CPU), and the TPR@FPR table
falls out of the cumulative histogram.  Features stay on the device until
the (2001, 2) histogram comes back to the host.

With a mesh (by default every visible GPU of a run on the card, as the JAX
package takes ``data_mesh()`` when more than one device is visible) the
j-rows are split over its ``data`` axis (``pairwise_roc_histogram_sharded``):
every device counts the replicated target rows against its own contiguous
slice of rows, and the partial histograms are summed on the caller's
device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import Mesh, auto_data_mesh, replicated, shard_over
from .roc_hist import NUM_BINS, roc_histogram, roc_histogram_range


def pairwise_roc_histogram_sharded(mesh: Mesh, feats: torch.Tensor,
                                   labels: torch.Tensor, target_size: int,
                                   axis: str = "data") -> torch.Tensor:
    """(2 * NUM_BINS,) int64 histogram of the target-first (N, E) feats with
    the j-rows split over ``mesh``'s ``axis`` (JAX
    ``pairwise_roc_histogram_sharded``): the target rows replicated on
    every device, device d counting them against rows [d*S, (d+1)*S)
    (S = ceil(N / D); a device may hold no rows), in global row indices;
    the partial histograms summed on ``feats``' device in device order."""
    feats = feats.float().contiguous()
    labels = labels.to(device=feats.device, dtype=torch.int32).contiguous()
    t = max(0, min(int(target_size), feats.shape[0]))
    devs = mesh.axis_devices(axis)
    step = -(-feats.shape[0] // len(devs))
    parts = zip(replicated(mesh, feats[:t], axis), replicated(mesh, labels[:t], axis),
                shard_over(mesh, feats, axis), shard_over(mesh, labels, axis))
    hists = [roc_histogram_range(ft, lt, rows, lr, d * step)
             for d, (ft, lt, rows, lr) in enumerate(parts)]
    out = torch.zeros(2 * NUM_BINS, dtype=torch.int64, device=feats.device)
    for h in hists:
        out += h.to(feats.device)
    return out


def pairwise_roc_histogram(feats: torch.Tensor, labels: torch.Tensor,
                           target_size: int, mesh: Optional[Mesh] = None
                           ) -> np.ndarray:
    """(N, E) l2-normalised feats, target rows first -> (2001, 2) int64
    [pos, neg] pair-count histogram on the host.  The rows are split over
    ``mesh``'s ``data`` axis when it has more than one device (default: the
    auto layout, every visible GPU of a run on the card)."""
    if mesh is None:
        mesh = auto_data_mesh(feats.device)
    if mesh is not None and mesh.shape["data"] > 1:
        hist = pairwise_roc_histogram_sharded(mesh, feats, labels, target_size)
    else:
        hist = roc_histogram(feats.float().contiguous(),
                             labels.to(torch.int32).contiguous(), target_size)
    return hist.cpu().numpy().reshape(NUM_BINS, 2)


def roc_from_histogram(hist: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cumulative histogram -> (TPR, FPR) curves (roc_cuda.py:56-69)."""
    data = np.cumsum(hist, axis=0)
    tpr = [1.0]
    fpr = [1.0]
    denom_pos = max(data[-1, 0], 1)
    denom_neg = max(data[-1, 1], 1)
    for i in range(data.shape[0]):
        tpr.append((data[-1, 0] - data[i, 0]) / denom_pos)
        fpr.append((data[-1, 1] - data[i, 1]) / denom_neg)
    return np.array(tpr), np.array(fpr)


def tpr_at_fpr_table(hist: np.ndarray,
                     exponents=(-1, -2, -3, -4, -5, -6)) -> list:
    """TPR (x100, 2dp) at FPR=10^e via linear interpolation on the sorted
    FPR curve (roc_cuda.py:65-71)."""
    tpr, fpr = roc_from_histogram(hist)
    order = np.argsort(fpr)
    fpr_s, tpr_s = fpr[order], tpr[order]
    out = []
    for e in exponents:
        target = 10.0 ** e
        v = np.interp(target, fpr_s, tpr_s)
        out.append(float("%.2f" % (100.0 * v)))
    return out


def reorder_target_first(feats: torch.Tensor, labels: np.ndarray,
                         start_id: int, end_id: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Move the target client's rows first (roc_cuda.py:127-134).

    The target flag comes from the host labels; a stable argsort on the
    device permutes the features, so they never leave the device.  Returns
    (features, int32 labels, both on the features' device, target count).
    """
    labels_np = np.asarray(labels)
    target = (labels_np >= start_id) & (labels_np < end_id)
    not_target = torch.from_numpy((~target).astype(np.uint8)).to(feats.device)
    order = torch.argsort(not_target, stable=True)
    labels_t = torch.from_numpy(labels_np.astype(np.int32)).to(feats.device)
    return feats[order], labels_t[order], int(target.sum())


def client_roc(feats: torch.Tensor, labels: np.ndarray, start_id: int,
               end_id: int, mesh: Optional[Mesh] = None) -> list:
    """Full per-client 1:1 ROC: reorder, histogram (over ``mesh``, default
    the auto layout), TPR table (-1..-6)."""
    f, l, tsize = reorder_target_first(feats, labels, start_id, end_id)
    return tpr_at_fpr_table(pairwise_roc_histogram(f, l, tsize, mesh))
