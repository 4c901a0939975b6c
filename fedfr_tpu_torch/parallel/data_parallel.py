"""A backbone replicated over the devices of one mesh axis, trained on batch
shards as one function of the whole batch.

The pretraining's backbone is data-parallel over the ``model`` axis
(``pretrain.py:153-154``: the batch sharded over the mesh, the forward under
``jax.jit``, not inside ``shard_map``).  So the JAX forward is the whole
batch's: XLA reduces every BatchNorm's mean and variance over the devices,
and the running statistics it writes are the whole batch's.  The port keeps
that function with one controller:

* ``DataParallel`` holds one replica a shard: shard 0 is the caller's
  module, the others copies on their devices (a separate copy also where a
  device repeats, so that each shard has its own gradients and buffers).
* ``forward`` runs each replica on its batch shard.  With more than one
  shard and a BatchNorm in the net, each replica runs in a thread of its
  own, and every train-mode ``F.batch_norm`` call meets the other shards'
  at a barrier (``_ShardBatchNorm``, a ``TorchFunctionMode``, so every
  BatchNorm layer is caught, ``IResNet``'s ``FeatureNorm`` too): the mean
  is the sum of the shards' per-channel sums, the variance the sum of their
  squared deviations from it, each reduced on the first device in shard
  order and sent back, so that autograd carries the backward over the
  shards.  Normalisation, the biased variance and the running statistics'
  update (momentum, unbiased variance) are ``TorchBatchNorm``'s
  (``fedfr_tpu/models/layers.py``), that is torch's.
* ``reduce_grads`` sums the replicas' gradients onto shard 0 in shard
  order; the caller steps its optimizer there; ``broadcast`` copies shard
  0's parameters and buffers into the other replicas, which are then equal
  to it bit for bit.

One shard is the module alone: no thread, no copy, the numbers of a plain
call.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from .mesh import as_device, reduced

# seconds a shard waits at a BatchNorm barrier for the others before the
# forward fails (a shard that raised aborts the barrier at once)
BARRIER_TIMEOUT_S = 600.0


def _bn_args(input, running_mean, running_var, weight=None, bias=None,
             training=False, momentum=0.1, eps=1e-5):
    return input, running_mean, running_var, weight, bias, training, momentum, eps


class _BatchStats:
    """The shards' meeting point for one forward of a ``rows``-row batch:
    ``total`` sums one tensor over the shards, in shard order on the first
    device, and hands each shard the sum on its own device."""

    def __init__(self, devices: Sequence[torch.device], rows: int):
        self.devices = list(devices)
        self.rows = rows  # the whole batch's
        self.barrier = threading.Barrier(len(self.devices), timeout=BARRIER_TIMEOUT_S)
        self.posted: Dict[Tuple[int, int], torch.Tensor] = {}

    def total(self, shard: int, call: int, value: torch.Tensor) -> torch.Tensor:
        self.posted[(call, shard)] = value
        self.barrier.wait()
        parts = [self.posted[(call, d)] for d in range(len(self.devices))]
        return reduced(parts, self.devices[0]).to(self.devices[shard], non_blocking=True)


class _ShardBatchNorm(TorchFunctionMode):
    """Shard ``shard``'s train-mode ``F.batch_norm`` over the whole batch
    (see the module docstring); every other function runs as called."""

    def __init__(self, stats: _BatchStats, shard: int):
        super().__init__()
        self.stats = stats
        self.shard = shard
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not F.batch_norm:
            return func(*args, **kwargs)
        x, r_mean, r_var, weight, bias, training, momentum, eps = _bn_args(*args, **kwargs)
        if not training:
            return func(*args, **kwargs)
        shape = [1, -1] + [1] * (x.dim() - 2)
        dims = [0] + list(range(2, x.dim()))
        xf = x.float()
        n = (xf.numel() // (xf.shape[0] * xf.shape[1])) * self.stats.rows
        mean = self.stats.total(self.shard, self.calls, xf.sum(dims)) / n
        centred = xf - mean.view(shape)
        var = self.stats.total(self.shard, self.calls + 1,
                               centred.square().sum(dims)) / n
        self.calls += 2
        y = centred * torch.rsqrt(var + eps).view(shape)
        if weight is not None:
            y = y * weight.view(shape)
        if bias is not None:
            y = y + bias.view(shape)
        if r_mean is not None:
            with torch.no_grad():
                r_mean.mul_(1.0 - momentum).add_(mean.detach(), alpha=momentum)
                r_var.mul_(1.0 - momentum).add_(var.detach() * (n / max(n - 1, 1)),
                                                alpha=momentum)
        return y.to(x.dtype)


class DataParallel:
    """``module`` and one replica of it on each further device of
    ``devices`` (see the module docstring)."""

    def __init__(self, module: nn.Module, devices: Sequence[torch.device]):
        self.devices = [as_device(d) for d in devices]
        self.replicas: List[nn.Module] = [module] + [
            copy.deepcopy(module).to(dev) for dev in self.devices[1:]]
        self.sync_bn = any(isinstance(m, nn.modules.batchnorm._BatchNorm)
                           for m in module.modules())

    @property
    def module(self) -> nn.Module:
        return self.replicas[0]

    def train(self, mode: bool = True) -> None:
        for r in self.replicas:
            r.train(mode)

    def zero_grad(self) -> None:
        for r in self.replicas:
            r.zero_grad(set_to_none=True)

    def forward(self, xs: Sequence[torch.Tensor],
                kwargs: Optional[Sequence[dict]] = None) -> List[torch.Tensor]:
        """Each replica on its shard ``xs[d]`` (with ``kwargs[d]``), BN over
        the whole batch; the outputs in shard order, each on its device."""
        kwargs = list(kwargs) if kwargs is not None else [{}] * len(xs)
        if len(self.replicas) == 1 or not self.sync_bn:
            return [r(x, **kw) for r, x, kw in zip(self.replicas, xs, kwargs)]
        stats = _BatchStats(self.devices, sum(x.shape[0] for x in xs))
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        errors: List[BaseException] = []
        grad = torch.is_grad_enabled()

        def run(d: int) -> None:
            try:
                with torch.set_grad_enabled(grad), _ShardBatchNorm(stats, d):
                    out[d] = self.replicas[d](xs[d], **kwargs[d])
            except BaseException as e:  # re-raised by the caller below
                errors.append(e)
                stats.barrier.abort()

        threads = [threading.Thread(target=run, args=(d,), name=f"shard-{d}")
                   for d in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            # a shard's own error, not the broken barrier it left the others
            errors.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
            raise errors[0]
        return out

    __call__ = forward

    def reduce_grads(self) -> None:
        """Every parameter's gradient summed over the replicas onto shard
        0's, in shard order."""
        if len(self.replicas) == 1:
            return
        params = [list(r.parameters()) for r in self.replicas]
        home = self.devices[0]
        for d, p0 in enumerate(params[0]):
            grads = [ps[d].grad for ps in params]
            if any(g is None for g in grads):
                continue
            p0.grad = reduced(grads, home)

    @torch.no_grad()
    def broadcast(self) -> None:
        """Shard 0's parameters and buffers copied into every replica."""
        src = list(self.module.parameters()) + list(self.module.buffers())
        for r in self.replicas[1:]:
            for t, s in zip(list(r.parameters()) + list(r.buffers()), src):
                t.copy_(s, non_blocking=True)

    def replicas_equal(self) -> bool:
        """Whether every replica's state equals shard 0's bit for bit."""
        ref = self.module.state_dict()
        return all(torch.equal(v.cpu(), ref[k].cpu())
                   for r in self.replicas[1:] for k, v in r.state_dict().items())
