"""All-pairs cosine ROC histogram: the per-client 1:1 verification kernel.

``roc_histogram(feats, labels, target_size)`` -> (2 * NUM_BINS,) int64, the
interleaved [pos, neg] pair counts over every pair ``i < target_size``,
``i < j < N`` of the (N, E) fp32 features, each binned at
``clamp(int((sim + 1) * 1000), 0, 2000)``.  It replaces the TPU kernel
``fedfr_tpu/ops/pallas_kernels.py::_roc_hist_kernel`` (wrapped there by
``roc_histogram``).

* On a CUDA tensor it makes the kernel's operand (``kernel_operand``: a
  K-major, zero-padded copy of the features) and launches the hand-written
  kernel in ``csrc/roc_hist.cu`` (built at first use) on the current stream,
  without synchronising, on a grid that ``fit_splits`` sizes to one wave by
  the kernel's own occupancy.  It raises if the launch fails.
* On a CPU tensor it runs ``roc_histogram_plain``, the same function in
  plain PyTorch (tiled ``mm``, the same binning, ``torch.bincount``, as the
  JAX package's ``roc_histogram._tiled_histogram_scan``).  The CPU tests and
  the kernel's on-card check use it.

``roc_hist_launches`` counts kernel launches, so that a run can show that
the local eval went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_kernel

NUM_BINS = 2001  # int((cos + 1) * 1000) for cos in [-1, 1]

roc_hist_launches = 0


def roc_histogram_plain(feats: torch.Tensor, labels: torch.Tensor,
                        target_size: int, tile_i: int = 1024,
                        tile_j: int = 8192) -> torch.Tensor:
    """(2 * NUM_BINS,) int64 [pos, neg] counts, tile by tile: one ``mm`` per
    (i, j) tile, the kernel's binning, one ``bincount`` of the valid pairs.
    j-tiles start at i0 + 1, so tiles holding no pair with i < j are never
    computed."""
    n = feats.shape[0]
    t = min(target_size, n)
    hist = torch.zeros(2 * NUM_BINS, dtype=torch.int64, device=feats.device)
    labels = labels.to(torch.int32)
    for i0 in range(0, max(t, 0), tile_i):
        i1 = min(i0 + tile_i, t)
        fi, li = feats[i0:i1].float(), labels[i0:i1]
        gi = torch.arange(i0, i1, device=feats.device)
        for j0 in range(i0 + 1, n, tile_j):
            j1 = min(j0 + tile_j, n)
            sim = fi @ feats[j0:j1].float().t()
            bins = ((sim + 1.0) * 1000.0).to(torch.int32).clamp_(0, NUM_BINS - 1)
            combined = bins * 2 + (li[:, None] != labels[None, j0:j1])
            valid = gi[:, None] < torch.arange(j0, j1, device=feats.device)[None, :]
            hist += torch.bincount(combined[valid], minlength=2 * NUM_BINS)
    return hist


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


def kernel_operand(feats: torch.Tensor, row_multiple: int,
                   k_multiple: int) -> torch.Tensor:
    """The kernel's operand: (E_pad, N_pad) fp32, contiguous, with
    ``out[k, r] = feats[r, k]`` and zeros past N and E.  N_pad is the next
    multiple of ``row_multiple``, E_pad the next positive multiple of
    ``k_multiple``.  Zero columns add exact zeros at the end of every dot,
    and the kernel masks rows past N, so the padding changes no count."""
    n, e = feats.shape
    n_pad = -(-n // row_multiple) * row_multiple
    e_pad = max(1, -(-e // k_multiple)) * k_multiple
    out = feats.new_empty((e_pad, n_pad), dtype=torch.float32)
    out[:e, :n].copy_(feats.t())
    out[:e, n:].zero_()
    out[e:].zero_()
    return out


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


def launch_grid(n: int, t: int, device: int) -> dict:
    """The grid the wrapper launches for N rows and T targets: blocks
    (i_tiles x splits), blocks_per_sm and waves (blocks over the blocks
    that run at once)."""
    cfg = kernel_config(device)
    i_tiles, j_tiles = -(-t // cfg["bm"]), -(-n // cfg["bn"])
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
    global roc_hist_launches
    _check(feats, labels)
    if feats.device.type == "cpu":
        return roc_histogram_plain(feats, labels, target_size)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    n = feats.shape[0]
    t = min(int(target_size), n)
    out = torch.zeros(2 * NUM_BINS, dtype=torch.int64, device=feats.device)
    if t <= 0:
        return out
    device = (feats.device.index if feats.device.index is not None
              else torch.cuda.current_device())
    cfg = kernel_config(device)
    if cfg["bm"] * -(-n // cfg["bn"]) * cfg["bn"] >= 2 ** 31:
        raise ValueError(f"{n} rows: a block's int32 counters could overflow")
    feats_k = kernel_operand(feats, cfg["bn"], cfg["bk"])
    grid = launch_grid(n, t, device)
    fn = load_kernel("roc_hist").fedfr_roc_hist
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = fn(feats_k.data_ptr(), labels.data_ptr(), out.data_ptr(), n, t,
             feats_k.shape[1], feats_k.shape[0], grid["splits"], device, stream)
    if err != 0:
        raise RuntimeError(f"roc_hist kernel launch failed: CUDA error {err}")
    roc_hist_launches += 1
    return out
