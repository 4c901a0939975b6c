"""Shared layers for the face backbones (PyTorch, NCHW).

Counterpart of ``fedfr_tpu/models/layers.py``.  The JAX package's
``TorchBatchNorm`` reproduces torch's BatchNorm train semantics (momentum
0.1, biased variance to normalize, unbiased variance into the running
estimate), so the port uses ``nn.BatchNorm2d`` as it is.

``remat_call`` is the counterpart of ``nn.remat`` around a residual block
(the JAX ``remat_blocks`` option): ``torch.utils.checkpoint`` keeps only
the block's input and recomputes its activations in the backward.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class PReLU(nn.PReLU):
    """Per-channel parametric ReLU, init 0.25 (``nn.PReLU`` and its
    state_dict key ``weight``).

    The fp32 slope is cast to the input's dtype, as the JAX layer does, so
    the layer runs in the bf16 trunk under autocast as one fused kernel.
    """

    def __init__(self, num_parameters: int):
        super().__init__(num_parameters, init=0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


def conv3x3(cin: int, cout: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    """3x3 conv, padding 1 (the JAX package's SAME-1 ``conv3x3``)."""
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


def batch_norm(features: int) -> nn.BatchNorm2d:
    """BatchNorm with the reference hyperparameters (momentum 0.1, eps 1e-5,
    iresnet.py:37-42)."""
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


def normal_init(tensor: torch.Tensor, stddev: float,
                generator: torch.Generator = None) -> torch.Tensor:
    with torch.no_grad():
        return tensor.normal_(0.0, stddev, generator=generator)


def lecun_normal(tensor: torch.Tensor,
                 generator: torch.Generator = None) -> torch.Tensor:
    """flax's default Dense and Conv kernel init for a torch ``(out, in)`` or
    ``(out, in, kh, kw)`` weight: a normal truncated at 2 sigma, rescaled to
    variance 1 / fan_in (``in * kh * kw``)."""
    std = math.sqrt(1.0 / tensor[0].numel()) / 0.87962566103423978
    return nn.init.trunc_normal_(tensor, std=std, a=-2.0 * std, b=2.0 * std,
                                 generator=generator)


def xavier_uniform(tensor: torch.Tensor,
                   generator: torch.Generator = None) -> torch.Tensor:
    return nn.init.xavier_uniform_(tensor, generator=generator)


@contextlib.contextmanager
def _buffers_kept(module: nn.Module):
    """Restore every buffer of ``module`` on exit: a recomputed train-mode
    BatchNorm would otherwise update its running statistics (and
    ``num_batches_tracked``) a second time."""
    saved = [(b, b.clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, value in saved:
                b.copy_(value)


def remat_call(block: nn.Module, fn: Callable[[torch.Tensor], torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """``fn(x)``, the forward of ``block``, checkpointed where autograd
    records it: the backward recomputes the block's activations from ``x``
    (``use_reentrant=False``; the recompute runs under the forward's
    autocast state).  The recompute keeps ``block``'s buffers as the
    forward left them, so the forward's output, the BatchNorm statistics and
    the gradients are those of the plain call.  The blocks draw no random
    numbers, so no RNG state is stashed."""
    if not torch.is_grad_enabled():
        return fn(x)
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _buffers_kept(block)))
