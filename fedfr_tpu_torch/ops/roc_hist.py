"""All-pairs cosine ROC histogram: the per-client 1:1 verification kernel.

``roc_histogram(feats, labels, target_size)`` -> (2 * NUM_BINS,) int64, the
interleaved [pos, neg] pair counts over every pair ``i < target_size``,
``i < j < N`` of the (N, E) fp32 features, each binned at
``clamp(int((sim + 1) * 1000), 0, 2000)``.  It replaces the TPU kernel
``fedfr_tpu/ops/pallas_kernels.py::_roc_hist_kernel`` (wrapped there by
``roc_histogram``).

* On a CUDA tensor it launches the hand-written kernel in
  ``csrc/roc_hist.cu`` (built at first use) on the current stream, without
  synchronising, and raises if the launch fails.
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
    n, e = feats.shape
    t = min(int(target_size), n)
    out = torch.zeros(2 * NUM_BINS, dtype=torch.int64, device=feats.device)
    if t <= 0:
        return out
    lib = load_kernel("roc_hist")
    fn = lib.fedfr_roc_hist
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    device = (feats.device.index if feats.device.index is not None
              else torch.cuda.current_device())
    # split each target tile's j-range so that the grid fills at most the
    # two blocks per SM that run at once (the kernel's tiles are 128 rows):
    # one block more would start a second wave and nearly double the time
    i_tiles, j_tiles = -(-t // 128), -(-n // 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(j_tiles, 65535, 2 * sms // i_tiles))
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = fn(feats.data_ptr(), labels.data_ptr(), out.data_ptr(), n, t, e,
             splits, device, stream)
    if err != 0:
        raise RuntimeError(f"roc_hist kernel launch failed: CUDA error {err}")
    roc_hist_launches += 1
    return out
