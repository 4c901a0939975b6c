"""Max-over-local cosine similarity: the hard-negative mining kernel.

``max_cosine_similarity(public, local)`` -> (N_pub,) fp32, where
``out[p] = max_l <public[p], local[l]>`` over l2-normalised rows.  It
replaces the TPU kernel ``fedfr_tpu/ops/pallas_kernels.py::_max_sim_kernel``.

* On a CUDA tensor it launches the hand-written kernel in
  ``csrc/max_sim.cu`` (built at first use) on the current stream, without
  synchronising, and raises if the launch fails.
* On a CPU tensor it runs ``max_cosine_similarity_plain``, the same function
  in plain PyTorch (chunked ``public @ local.T`` then ``amax``, as the JAX
  package's ``embed._chunk_max_sim``).  The CPU tests and the kernel's
  on-card check use it.

``max_sim_launches`` counts kernel launches, so that a run can show that
mining went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_kernel

max_sim_launches = 0


def max_cosine_similarity_plain(public: torch.Tensor, local: torch.Tensor,
                                chunk: int = 65536) -> torch.Tensor:
    """(N_pub,) max over local rows of <public, local>, fp32, chunked over
    public rows so the similarity block stays at ``chunk`` x N_loc."""
    out = torch.empty(public.shape[0], dtype=torch.float32, device=public.device)
    lt = local.float().t()
    for start in range(0, public.shape[0], chunk):
        out[start:start + chunk] = (public[start:start + chunk].float() @ lt).amax(1)
    return out


def _check(public: torch.Tensor, local: torch.Tensor) -> None:
    for name, t in (("public", public), ("local", local)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if public.device != local.device:
        raise ValueError(f"public on {public.device} but local on {local.device}")
    if public.shape[1] != local.shape[1]:
        raise ValueError(f"embedding widths differ: {public.shape[1]} vs "
                         f"{local.shape[1]}")
    if local.shape[0] == 0:
        raise ValueError("local is empty: the max over no rows is undefined")
    if max(public.numel(), local.numel()) >= 2 ** 31:
        raise ValueError("more than 2^31 elements per operand is not supported")


def max_cosine_similarity(public: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """(N_pub,) max cosine similarity of each public row to any local row.

    Inputs: float32, 2-D, contiguous, same device and width, rows
    l2-normalised by the caller.  CPU tensors take the plain version; CUDA
    tensors take the kernel.
    """
    global max_sim_launches
    _check(public, local)
    if public.device.type == "cpu":
        return max_cosine_similarity_plain(public, local)
    if public.device.type != "cuda":
        raise ValueError(f"unsupported device {public.device}")
    lib = load_kernel("max_sim")
    fn = lib.fedfr_max_sim
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    out = torch.empty(public.shape[0], dtype=torch.float32, device=public.device)
    stream = torch.cuda.current_stream(public.device).cuda_stream
    err = fn(public.data_ptr(), local.data_ptr(), out.data_ptr(),
             public.shape[0], local.shape[0], public.shape[1],
             public.device.index if public.device.index is not None
             else torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError(f"max_sim kernel launch failed: CUDA error {err}")
    max_sim_launches += 1
    return out
