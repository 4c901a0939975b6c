"""All-pairs cosine ROC histogram: the per-client 1:1 verification kernel.

``roc_histogram(feats, labels, target_size)`` -> (2 * NUM_BINS,) int64, the
interleaved [pos, neg] pair counts over every pair ``i < target_size``,
``i < j < N`` of the (N, E) fp32 features, each binned at
``clamp(int((sim + 1) * 1000), 0, 2000)``.  ``roc_histogram_range(targets,
target_labels, rows, row_labels, j0)`` counts the pairs whose j lies in one
contiguous range of rows, ``j0 <= j < j0 + len(rows)`` in global row
indices (the targets are global rows ``0..T-1``): one device's share under
a mesh (``ops/roc_histogram.py::pairwise_roc_histogram_sharded``).  The
ranges' histograms add up to the whole, on the card bit for bit.  Both
replace the TPU kernel ``fedfr_tpu/ops/pallas_kernels.py::_roc_hist_kernel``
(``roc_histogram`` and, over a mesh, ``roc_histogram_pair`` there).

* On a CUDA tensor it makes the kernel's operand (``kernel_operand``: a
  K-major, zero-padded copy of the target rows and the range's rows) and
  launches the hand-written kernel in ``csrc/roc_hist.cu`` (built at first
  use) on the tensors' own device and that device's current stream,
  without synchronising, on a grid that ``fit_splits`` sizes to one wave by
  the kernel's own occupancy.  It raises if the launch fails.
* On a CPU tensor it runs ``roc_histogram_range_plain``, the same function
  in plain PyTorch (tiled ``mm``, the same binning, ``torch.bincount``, as
  the JAX package's ``roc_histogram._tiled_histogram_scan``).  The CPU
  tests and the kernel's on-card check use it.

``roc_hist_launches`` counts kernel launches, so that a run can show that
the local eval went through the kernel; ``roc_hist_launches_by_device``
counts them by CUDA device index.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Tuple

import torch

from ._build import load_kernel

NUM_BINS = 2001  # int((cos + 1) * 1000) for cos in [-1, 1]

roc_hist_launches = 0
roc_hist_launches_by_device: Counter = Counter()


def roc_histogram_range_plain(targets: torch.Tensor, target_labels: torch.Tensor,
                              rows: torch.Tensor, row_labels: torch.Tensor,
                              j0: int, tile_i: int = 1024,
                              tile_j: int = 8192) -> torch.Tensor:
    """(2 * NUM_BINS,) int64 [pos, neg] counts of the pairs i < T,
    j0 <= j < j0 + M, i < j, tile by tile: one ``mm`` per (i, j) tile, the
    kernel's binning, one ``bincount`` of the valid pairs.  A target tile's
    j-tiles start at its first row + 1, so tiles holding no pair with i < j
    are never computed."""
    t, m = targets.shape[0], rows.shape[0]
    dev = rows.device
    hist = torch.zeros(2 * NUM_BINS, dtype=torch.int64, device=dev)
    target_labels, row_labels = target_labels.to(torch.int32), row_labels.to(torch.int32)
    for i0 in range(0, t, tile_i):
        i1 = min(i0 + tile_i, t)
        fi, li = targets[i0:i1].float(), target_labels[i0:i1]
        gi = torch.arange(i0, i1, device=dev)
        for r0 in range(max(0, i0 + 1 - j0), m, tile_j):
            r1 = min(r0 + tile_j, m)
            sim = fi @ rows[r0:r1].float().t()
            bins = ((sim + 1.0) * 1000.0).to(torch.int32).clamp_(0, NUM_BINS - 1)
            combined = bins * 2 + (li[:, None] != row_labels[None, r0:r1])
            valid = gi[:, None] < torch.arange(j0 + r0, j0 + r1, device=dev)[None, :]
            hist += torch.bincount(combined[valid], minlength=2 * NUM_BINS)
    return hist


def roc_histogram_plain(feats: torch.Tensor, labels: torch.Tensor,
                        target_size: int, tile_i: int = 1024,
                        tile_j: int = 8192) -> torch.Tensor:
    """The whole histogram in plain PyTorch: the range of every row."""
    t = max(0, min(target_size, feats.shape[0]))
    return roc_histogram_range_plain(feats[:t], labels[:t], feats, labels, 0,
                                     tile_i, tile_j)


def _check(feats: torch.Tensor, labels: torch.Tensor) -> None:
    if feats.dtype != torch.float32:
        raise TypeError(f"feats must be float32, got {feats.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    if feats.dim() != 2:
        raise ValueError(f"feats must be 2-D, got shape {tuple(feats.shape)}")
    if labels.dim() != 1 or labels.shape[0] != feats.shape[0]:
        raise ValueError(f"labels must be ({feats.shape[0]},), got "
                         f"{tuple(labels.shape)}")
    for name, t in (("feats", feats), ("labels", labels)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if feats.device != labels.device:
        raise ValueError(f"feats on {feats.device} but labels on {labels.device}")
    if feats.numel() >= 2 ** 31:
        raise ValueError("more than 2^31 feature elements is not supported")


def kernel_operand(targets: torch.Tensor, rows: torch.Tensor, row_multiple: int,
                   k_multiple: int) -> Tuple[torch.Tensor, int]:
    """The kernel's operand and the column of the range's first row:
    (E_pad, b_col + M_pad) fp32, contiguous, the T targets K-major in
    columns 0.. (``out[k, i] = targets[i, k]``) and the M rows from column
    ``b_col`` on, zeros elsewhere.  ``b_col`` and M_pad are T and M rounded
    up to a multiple of ``row_multiple``, E_pad E to a positive multiple of
    ``k_multiple``.  Zero columns add exact zeros at the end of every dot,
    and the kernel masks rows past T and M, so the padding changes no
    count."""
    (t, e), m = targets.shape, rows.shape[0]
    b_col = -(-t // row_multiple) * row_multiple
    m_pad = -(-m // row_multiple) * row_multiple
    e_pad = max(1, -(-e // k_multiple)) * k_multiple
    out = rows.new_zeros((e_pad, b_col + m_pad), dtype=torch.float32)
    out[:e, :t].copy_(targets.t())
    out[:e, b_col:b_col + m].copy_(rows.t())
    return out, b_col


def fit_splits(i_tiles: int, j_tiles: int, sms: int, blocks_per_sm: int) -> int:
    """j-range splits per target tile, so that the (i_tiles, splits) grid
    holds at most the ``sms * blocks_per_sm`` blocks that run at once: a
    block more starts a second wave and nearly doubles the time.  At least
    1 (a grid wider than a wave cannot be helped), at most ``j_tiles`` and
    CUDA's 65,535 grid rows."""
    return max(1, min(j_tiles, 65535, sms * blocks_per_sm // i_tiles))


_configs = {}


def kernel_config(device: int) -> dict:
    """The kernel's tile sizes and occupancy as built, from the library
    itself, with the card's SM count: keys bm, bn, bk, blocks_per_sm,
    threads, smem_bytes, sms."""
    cfg = _configs.get(device)
    if cfg is None:
        fn = load_kernel("roc_hist").fedfr_roc_hist_config
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        vals = (ctypes.c_int * 6)()
        err = fn(device, vals)
        if err != 0 or vals[3] < 1:
            raise RuntimeError(f"roc_hist kernel does not fit on an SM: CUDA "
                               f"error {err}, {vals[3]} blocks per SM")
        cfg = dict(zip(("bm", "bn", "bk", "blocks_per_sm", "threads",
                        "smem_bytes"), vals))
        cfg["sms"] = torch.cuda.get_device_properties(device).multi_processor_count
        _configs[device] = cfg
    return cfg


def useful_targets(t: int, m: int, j0: int) -> int:
    """The targets that hold a pair in rows j0..j0+M-1: i < j needs
    i < j0 + M - 1."""
    return max(0, min(t, j0 + m - 1)) if m > 0 else 0


def launch_grid(m: int, t: int, device: int, j0: int = 0) -> dict:
    """The grid the wrapper launches for a range of M rows from global row
    ``j0`` and T targets: blocks (i_tiles x splits, the targets that hold
    a pair, the range's own j-tiles), blocks_per_sm and waves (blocks over
    the blocks that run at once)."""
    cfg = kernel_config(device)
    i_tiles = -(-useful_targets(t, m, j0) // cfg["bm"])
    j_tiles = -(-m // cfg["bn"])
    splits = fit_splits(i_tiles, j_tiles, cfg["sms"], cfg["blocks_per_sm"])
    return {"i_tiles": i_tiles, "splits": splits, "blocks": i_tiles * splits,
            "blocks_per_sm": cfg["blocks_per_sm"],
            "waves": i_tiles * splits / (cfg["sms"] * cfg["blocks_per_sm"])}


def roc_histogram(feats: torch.Tensor, labels: torch.Tensor,
                  target_size: int) -> torch.Tensor:
    """(2 * NUM_BINS,) int64 interleaved [pos, neg] pair counts.

    Inputs: float32 (N, E) features with the target rows first and int32
    (N,) labels, contiguous, on one device.  CPU tensors take the plain
    version; CUDA tensors take the kernel.  No target rows (or no rows)
    gives zeros without a launch.
    """
    _check(feats, labels)
    t = max(0, min(int(target_size), feats.shape[0]))
    return roc_histogram_range(feats[:t], labels[:t], feats, labels, 0)


def roc_histogram_range(targets: torch.Tensor, target_labels: torch.Tensor,
                        rows: torch.Tensor, row_labels: torch.Tensor,
                        j0: int) -> torch.Tensor:
    """(2 * NUM_BINS,) int64 [pos, neg] counts of the pairs i < T,
    j0 <= j < j0 + M, i < j (global row indices; the targets are rows
    0..T-1).

    Inputs: float32 (T, E) targets and (M, E) rows, int32 (T,) and (M,)
    labels, contiguous, all on one device.  CPU tensors take the plain
    version; CUDA tensors take the kernel.  No pair gives zeros without a
    launch.
    """
    global roc_hist_launches
    _check(targets, target_labels)
    _check(rows, row_labels)
    if targets.device != rows.device or targets.shape[1] != rows.shape[1]:
        raise ValueError(f"targets {tuple(targets.shape)} on {targets.device} and "
                         f"rows {tuple(rows.shape)} on {rows.device} do not match")
    if j0 < 0:
        raise ValueError(f"j0 must be >= 0, got {j0}")
    if rows.device.type == "cpu":
        return roc_histogram_range_plain(targets, target_labels, rows, row_labels, j0)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    m = rows.shape[0]
    t = useful_targets(targets.shape[0], m, j0)
    out = torch.zeros(2 * NUM_BINS, dtype=torch.int64, device=rows.device)
    if t == 0:
        return out
    device = rows.device.index
    cfg = kernel_config(device)
    if cfg["bm"] * -(-m // cfg["bn"]) * cfg["bn"] >= 2 ** 31:
        raise ValueError(f"{m} rows: a block's int32 counters could overflow")
    feats_k, b_col = kernel_operand(targets[:t], rows, cfg["bn"], cfg["bk"])
    if feats_k.numel() >= 2 ** 31:
        raise ValueError("more than 2^31 operand elements is not supported")
    grid = launch_grid(m, t, device, j0)
    fn = load_kernel("roc_hist").fedfr_roc_hist
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = fn(feats_k.data_ptr(), target_labels.data_ptr(), row_labels.data_ptr(),
             out.data_ptr(), t, m, j0, b_col, feats_k.shape[1], feats_k.shape[0],
             grid["splits"], device, stream)
    if err != 0:
        raise RuntimeError(f"roc_hist kernel launch failed: CUDA error {err}")
    roc_hist_launches += 1
    roc_hist_launches_by_device[device] += 1
    return out
