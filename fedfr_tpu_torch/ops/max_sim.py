"""Max-over-local cosine similarity: the hard-negative mining kernel.

``max_cosine_similarity(public, local)`` -> (N_pub,) fp32, where
``out[p] = max_l <public[p], local[l]>`` over l2-normalised rows.  It
replaces the TPU kernel ``fedfr_tpu/ops/pallas_kernels.py::_max_sim_kernel``.

Its precision follows the device, as the JAX package's does
(``fedfr_tpu/federated/embed.py::max_similarity``: the Pallas kernel on a
TPU, the ``Precision.HIGHEST`` XLA path elsewhere):

* On a CUDA tensor it launches the hand-written kernel in
  ``csrc/max_sim.cu`` (built at first use) on the current stream, without
  synchronising, and raises if the launch fails.  It computes what the TPU
  kernel computes: ``max_l sum_k bf16(P[p,k]) * bf16(L[l,k])`` summed in
  fp32 (bf16 rounds to nearest even, as ``Tensor.to(torch.bfloat16)`` and
  ``jnp.astype(jnp.bfloat16)`` do).  fp32 operands are cast once per call
  by ``kernel_operand``; a bf16 operand already in the kernel's layout is
  read as it is.
* On a CPU tensor it runs ``max_cosine_similarity_plain``, the same function
  in plain PyTorch (chunked ``public @ local.T`` then ``amax``, as the JAX
  package's ``embed._chunk_max_sim``), in fp32 on the operands as given.
  The CPU tests use it.

``max_cosine_similarity_plain`` upcasts its operands, so on bf16 operands it
computes exactly the card's function: ``max_cosine_similarity_plain(
P.bfloat16(), L.bfloat16())`` is the kernel's oracle on the card, where only
the order of the fp32 sums differs.

``max_sim_launches`` counts kernel launches, so that a run can show that
mining went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_kernel

KERNEL_K = 64      # the kernel reads K in chunks of 64 bf16 (128 bytes)
MAX_WIDTH = 512    # its resident public tile: 128 rows x 512 bf16 = 128 KB

# the C function's own error codes (csrc/max_sim.cu)
_ERRORS = {-1: "cuTensorMapEncodeTiled not found in the driver",
           -2: "cuTensorMapEncodeTiled refused a tensor map",
           -3: f"width not a multiple of {KERNEL_K} in [{KERNEL_K}, {MAX_WIDTH}]"}

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


def _kernel_width(e: int) -> int:
    return -(-e // KERNEL_K) * KERNEL_K


def kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` (N, E) in the layout the card kernel reads: bf16, contiguous,
    16-byte aligned, E zero-padded to a multiple of 64 (zero columns add
    nothing to a dot).  A tensor already in that layout is returned as it
    is; otherwise this makes one copy, rounding fp32 to the nearest bf16."""
    n, e = t.shape
    width = _kernel_width(e)
    if (t.dtype == torch.bfloat16 and e == width and t.is_contiguous()
            and t.data_ptr() % 16 == 0):
        return t
    if e == width:
        return t.to(torch.bfloat16, memory_format=torch.contiguous_format, copy=True)
    out = torch.zeros(n, width, dtype=torch.bfloat16, device=t.device)
    out[:, :e] = t
    return out


def _check(public: torch.Tensor, local: torch.Tensor) -> None:
    for name, t in (("public", public), ("local", local)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
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

    Inputs: float32 or bfloat16, 2-D, contiguous, of one width, on one
    device, rows l2-normalised by the caller.  CPU tensors take the plain
    version on the operands as given; CUDA tensors take the bf16
    tensor-core kernel (widths up to 512).
    """
    global max_sim_launches
    _check(public, local)
    if public.device.type == "cpu":
        return max_cosine_similarity_plain(public, local)
    if public.device.type != "cuda":
        raise ValueError(f"unsupported device {public.device}")
    width = _kernel_width(public.shape[1])
    if width > MAX_WIDTH:
        raise ValueError(f"the card kernel takes widths up to {MAX_WIDTH}, got "
                         f"{public.shape[1]}")
    out = torch.empty(public.shape[0], dtype=torch.float32, device=public.device)
    if public.shape[0] == 0:
        return out
    pub_k, loc_k = kernel_operand(public), kernel_operand(local)
    lib = load_kernel("max_sim")
    fn = lib.fedfr_max_sim
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    stream = torch.cuda.current_stream(public.device).cuda_stream
    err = fn(pub_k.data_ptr(), loc_k.data_ptr(), out.data_ptr(),
             pub_k.shape[0], loc_k.shape[0], width,
             public.device.index if public.device.index is not None
             else torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError(f"max_sim kernel launch failed: "
                           f"{_ERRORS.get(err, f'CUDA error {err}')}")
    max_sim_launches += 1
    return out
