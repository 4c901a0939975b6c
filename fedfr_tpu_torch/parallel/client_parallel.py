"""Client-parallel (lockstep) training of K clients on one device.

Counterpart of ``fedfr_tpu/parallel/client_parallel.py``.  The JAX package
stacks K clients' states on a leading axis and advances them with one
``jax.vmap`` of its train step.  Here the K clients' weights, BN buffers,
FC rows, BCE weights and momentum are stacked on a leading client axis
too, and one step advances all of them:

* ``stack_module(module, k)`` is the group's network: a copy of
  ``module`` whose every leaf module (a conv, BN, PReLU, linear) holds its
  parameters and buffers stacked as (K, ...) and runs once per client
  through ``torch.func.vmap`` over ``torch.func.functional_call``.  The
  containers' own code (the residual adds, the autocast trunk, the flatten,
  a remat'd block's checkpoint) runs as written on the group's activations
  with the clients flattened into the batch, (K*B, ...).  A train-mode BN
  normalizes each client by its own batch statistics and updates its own
  slot of the stacked running statistics.  The vmap sits at the leaves
  because ``torch.utils.checkpoint`` (``--remat``) can run neither inside a
  ``torch.func.vmap`` (its recompute runs after the vmap has exited) nor
  inside ``torch.func.grad`` (which refuses saved-tensor hooks).
* The loss bodies are the sequential steps' own
  (``federated/trainer.py::make_branch_objective``,
  ``make_plain_objective``), run once per client under ``torch.func.vmap``
  (the BCE branch through ``functional_call`` over its stacked weights).
  The gradient is autograd's over the sum of the K totals, which is each
  client's own gradient in its slot.
* The update is ``torch.optim.SGD`` over the stacked tensors (weight decay
  added to the gradient, the first momentum buffer equal to the gradient,
  dampening 0), the sequential ``_sgd_step``: every operation of it is
  elementwise, so slot k takes exactly client k's update.

Randomness stays outside the step, as in the sequential step: the caller
draws each member's flip mask (and iresnet's dropout keep mask) from that
member's own generator and passes them stacked.

``vmap`` axes as the JAX ``make_parallel_branch_step`` (``:61``, ``:63``):
the global model is shared and the last-round model per client; the
cached form's g/l caches and ``idx`` are per client; lr is shared.

Over a mesh (``parallel/mesh.py``) the group spreads over the ``client``
axis: with K = ``lockstep`` x the axis size, device d holds members
[d*L, (d+1)*L) (L = ``lockstep``) in a stacked state of its own, and one
step a device advances them.  ``client_sharding``, ``shard_stacked_tree``
and ``replicate_tree`` are the JAX module's placements of stacked and
shared trees on that axis, each as one tree per device; ``parallel_fedavg``
is the round-end weighted average over the members of every device.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, vmap

from ..federated.state import train_preprocess
from ..federated.trainer import (StepMetrics, _sgd_step, check_cached_contrastive,
                                 make_branch_objective, make_plain_objective,
                                 proximal_sq)
from .fedavg import stack_trees, streaming_weighted_average, unstack_tree
from .mesh import Mesh

StateDict = Dict[str, torch.Tensor]


def client_sharding(mesh: Mesh) -> List[torch.device]:
    """The device of each slot of ``mesh``'s ``client`` axis, in order (JAX
    ``client_sharding``: a stacked tree's leading axis split over it)."""
    return mesh.axis_devices("client")


def shard_stacked_tree(mesh: Mesh, tree: StateDict) -> List[StateDict]:
    """A stacked tree split on its leading (member) axis into one
    contiguous block per client-axis slot, each block on its device (JAX
    ``shard_stacked_tree``); the axis must divide the member count."""
    devs = client_sharding(mesh)
    k = len(next(iter(tree.values())))
    if k % len(devs):
        raise ValueError(f"{k} stacked members do not split over a {len(devs)}-wide "
                         f"client axis")
    step = k // len(devs)
    return [{name: v[d * step:(d + 1) * step].to(dev, non_blocking=True)
             for name, v in tree.items()} for d, dev in enumerate(devs)]


def replicate_tree(mesh: Mesh, tree: StateDict) -> List[StateDict]:
    """``tree`` on every client-axis slot's device (JAX ``replicate_tree``)."""
    return [{name: v.to(dev, non_blocking=True) for name, v in tree.items()}
            for dev in client_sharding(mesh)]


def parallel_fedavg(shards: List[StateDict], weights, device) -> StateDict:
    """Round-end aggregation over the member axis of every slot's stacked
    tree (JAX ``parallel_fedavg``): each member's state copied to
    ``device`` and ``streaming_weighted_average`` in member order (slot by
    slot), so the result is the one-device round's, bit for bit, given
    equal members.  ``weights`` has one entry a member."""
    members = [{k: v.to(device) for k, v in m.items()}
               for shard in shards
               for m in unstack_tree(shard, len(next(iter(shard.values()))))]
    if len(members) != len(weights):
        raise ValueError(f"{len(members)} members but {len(weights)} weights")
    return streaming_weighted_average(members, weights)


# leaves whose op autocast runs in its lower-precision dtype (conv2d,
# linear and prelu are on autocast's lower-precision lists for CUDA and CPU)
_AUTOCAST_LEAVES = (nn.Conv2d, nn.Linear, nn.PReLU)


class _StackedLeaf(nn.Module):
    """One leaf module of a K-client group: the leaf's parameters and
    buffers under their own names, stacked (K, ...); its code runs once per
    client on a (K*B, ...) input through ``torch.func.vmap``.  A buffer
    that the leaf updates in place (BN's running statistics) is updated in
    its client's slot."""

    def __init__(self, leaf: nn.Module, k: int):
        super().__init__()
        self.k = k
        self.autocasts = isinstance(leaf, _AUTOCAST_LEAVES)
        self.mixed_bn = isinstance(leaf, nn.modules.batchnorm._BatchNorm)
        # the leaf's code without its storage, kept out of the module tree
        self._code = [copy.deepcopy(leaf).to("meta")]
        for name, p in leaf.named_parameters(recurse=False):
            self.register_parameter(name, nn.Parameter(
                p.new_empty((k,) + p.shape), requires_grad=p.requires_grad))
        for name, b in leaf.named_buffers(recurse=False):
            self.register_buffer(name, b.new_empty((k,) + b.shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        code = self._code[0]
        code.training = self.training
        tensors = dict(self.named_parameters(recurse=False))
        tensors.update(self.named_buffers(recurse=False))
        device, out_dtype = x.device.type, x.dtype
        if self.autocasts and torch.is_autocast_enabled(device):
            dtype = torch.get_autocast_dtype(device)
            x = x.to(dtype)
            tensors = {k: v.to(dtype) if v.is_floating_point() else v
                       for k, v in tensors.items()}
        elif self.mixed_bn:
            x = x.to(tensors["running_mean"].dtype)
        out = vmap(lambda t, xi: functional_call(code, t, (xi,)))(
            tensors, x.unflatten(0, (self.k, -1)))
        return out.flatten(0, 1).to(out_dtype) if self.mixed_bn else out.flatten(0, 1)


def stack_module(module: nn.Module, k: int) -> nn.Module:
    """The K-client copy of ``module`` (see the module docstring): the same
    classes, names and state_dict keys, each entry stacked (K, ...), so
    ``load_state_dict(stack_trees(states))`` loads K clients' states and
    ``unstack_tree(state_dict(), k)`` takes them out.  Its values are
    uninitialized until loaded.  Every module with parameters or buffers of
    its own must be a leaf; train/eval flags follow ``module``'s through
    ``follow_modes``."""
    twin = copy.deepcopy(module)
    for name, m in list(twin.named_modules()):
        own = list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False))
        if not own:
            continue
        if next(m.children(), None) is not None:
            raise ValueError(f"{name or type(m).__name__}: a module with both "
                             f"state of its own and submodules cannot be stacked")
        if m is twin:
            return _StackedLeaf(m, k)
        parent, _, attr = name.rpartition(".")
        setattr(twin.get_submodule(parent), attr, _StackedLeaf(m, k))
    return twin


def follow_modes(twin: nn.Module, module: nn.Module) -> None:
    """Copy every train/eval flag of ``module`` onto its stacked copy, by
    module name (``IResNet.train`` keeps its BN layers in eval mode under
    ``freeze_bn``, which a BN wrapped in a ``_StackedLeaf`` would miss)."""
    modes = {name: m.training for name, m in module.named_modules()}
    for name, m in twin.named_modules():
        m.training = modes[name]


class GroupTrainState(NamedTuple):
    """The sequential ``ClientTrainState`` of K clients, stacked.

    backbone: ``stack_module`` of the work backbone
    fc:       (K, C, E) rows
    bce:      {name: (K, ...)} BCE weights, or None
    opt:      one SGD over backbone + fc + bce, the sequential order
    """

    backbone: nn.Module
    fc: nn.Parameter
    bce: Optional[Dict[str, nn.Parameter]]
    opt: torch.optim.SGD


def init_group_state(backbone: nn.Module, fc: torch.Tensor,
                     bce: Optional[StateDict], lr: float, momentum: float = 0.9,
                     weight_decay: float = 5e-4) -> GroupTrainState:
    """Fresh optimizer buffers around a stacked backbone already loaded
    with the group's starting weights, the stacked (K, C, E) ``fc`` and the
    stacked BCE state (``init_client_state`` of K clients)."""
    fc = nn.Parameter(fc.detach().clone())
    params = list(backbone.parameters()) + [fc]
    if bce is not None:
        bce = {k: nn.Parameter(v.detach().clone()) for k, v in bce.items()}
        params += list(bce.values())
    opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                          weight_decay=weight_decay)
    return GroupTrainState(backbone=backbone, fc=fc, bce=bce, opt=opt)


def group_client_states(state: GroupTrainState, n: int) -> List[tuple]:
    """The first ``n`` slots' (backbone state_dict, fc, bce state_dict or
    None), each a copy of its own (the stacked storage is reused by the next
    group); the momentum is dropped, as the sequential run drops it."""
    backbones = unstack_tree(state.backbone.state_dict(), n)
    bces = (unstack_tree({k: v.detach() for k, v in state.bce.items()}, n)
            if state.bce is not None else [None] * n)
    return [(backbones[i], state.fc.detach()[i].clone(), bces[i]) for i in range(n)]


def _group_forward(template: nn.Module, net: nn.Module, x: torch.Tensor,
                   dropout_keep: Optional[torch.Tensor]) -> torch.Tensor:
    """The trainable stacked forward in ``template``'s train mode (the
    sequential ``_forward``), flattened (K*B, E)."""
    template.train()
    follow_modes(net, template)
    return net(x) if dropout_keep is None else net(x, dropout_keep=dropout_keep)


def make_parallel_branch_step(backbone: nn.Module, bce_module: Optional[nn.Module],
                              cached_contrastive: bool = False,
                              **objective_kwargs) -> Callable:
    """K-client branch train step (JAX ``make_parallel_branch_step``).

    ``backbone`` and ``bce_module`` are the sequential work modules the
    group's state was stacked from (``backbone``'s train mode is the one the
    stacked forward follows; ``bce_module``'s code runs the BCE branch).
    Returns ``step(state, global_net, last_net, images (K,B,H,W,C) u8,
    labels (K,B), valid (K,B), lr, flips (K,B), dropout_keep=None) ->
    (state, StepMetrics of (K,) tensors)``: ``state`` a ``GroupTrainState``
    updated in place, ``global_net`` the shared frozen global model,
    ``last_net`` the ``stack_module`` of the members' last-round models
    (eval mode), ``dropout_keep`` the (K*B, D) iresnet dropout keep masks.

    With ``cached_contrastive``: ``cached_step(state, g_caches (K,N,2,E),
    l_caches (K,N,2,E), images, labels, valid, idx (K,B), lr, flips,
    dropout_keep=None)``, each client's frozen features gathered from its
    own caches."""
    check_cached_contrastive(cached_contrastive, objective_kwargs)
    objective = make_branch_objective(**objective_kwargs)
    fedprox = objective_kwargs.get("fedprox_mu", 0.0) > 0.0
    bce_code = None if bce_module is None else copy.deepcopy(bce_module).to("meta")

    def per_client(feats, fc, bce_params, labels, valid, gfeats, lfeats,
                   params, global_params):
        bce = None
        if bce_params is not None:
            bce = lambda f, y: functional_call(bce_code, bce_params, (f, y))  # noqa: E731
        return objective(feats, fc, bce, labels, valid, lambda: (gfeats, lfeats),
                         lambda: proximal_sq(params, global_params))

    def run(state: GroupTrainState, x, con_feats: Callable, global_net, labels,
            valid, lr, dropout_keep):
        k = labels.shape[0]
        labels = labels.long()
        feats = _group_forward(backbone, state.backbone, x, dropout_keep)
        feats = feats.unflatten(0, (k, -1))
        gfeats = lfeats = None
        if objective_kwargs.get("contrastive", True):
            with torch.no_grad():
                gfeats, lfeats = con_feats(k)
        params = global_params = None
        if fedprox:
            params = list(state.backbone.parameters())
            global_params = list(global_net.parameters())
        args = (feats, state.fc, state.bce, labels, valid, gfeats, lfeats, params,
                global_params)
        # every argument per client but the shared global model (and the Nones)
        in_dims = tuple(None if a is None else 0 for a in args[:-1]) + (None,)
        total, cos_l, bce_l, con_l = vmap(per_client, in_dims=in_dims)(*args)
        _sgd_step(state, total.sum(), lr)
        return state, StepMetrics(total.detach(), cos_l.detach(), bce_l.detach(),
                                  con_l.detach())

    def step(state: GroupTrainState, global_net: nn.Module, last_net: nn.Module,
             images_u8: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
             lr: float, flips: torch.Tensor,
             dropout_keep: Optional[torch.Tensor] = None):
        x = train_preprocess(flips.flatten(0, 1), images_u8.flatten(0, 1))
        return run(state, x,
                   lambda k: (global_net(x).unflatten(0, (k, -1)),
                              last_net(x).unflatten(0, (k, -1))),
                   global_net, labels, valid, lr, dropout_keep)

    def cached_step(state: GroupTrainState, g_caches: torch.Tensor,
                    l_caches: torch.Tensor, images_u8: torch.Tensor,
                    labels: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor,
                    lr: float, flips: torch.Tensor,
                    dropout_keep: Optional[torch.Tensor] = None):
        x = train_preprocess(flips.flatten(0, 1), images_u8.flatten(0, 1))
        rows = torch.arange(labels.shape[0], device=idx.device)[:, None]
        idx, fi = idx.long(), flips.long()
        return run(state, x,
                   lambda k: (g_caches[rows, idx, fi], l_caches[rows, idx, fi]),
                   None, labels, valid, lr, dropout_keep)

    return cached_step if cached_contrastive else step


def make_parallel_plain_step(backbone: nn.Module, *, margin: str = "CosFace",
                             s: float = 30.0, m: float = 0.4) -> Callable:
    """K-client plain (CosFace-only) train step (JAX
    ``make_parallel_plain_step``): ``step(state, images (K,B,H,W,C) u8,
    labels (K,B), valid (K,B), lr, flips (K,B), dropout_keep=None) ->
    (state, (K,) losses)``."""
    objective = make_plain_objective(margin=margin, s=s, m=m)

    def step(state: GroupTrainState, images_u8: torch.Tensor,
             labels: torch.Tensor, valid: torch.Tensor, lr: float,
             flips: torch.Tensor, dropout_keep: Optional[torch.Tensor] = None):
        k = labels.shape[0]
        labels = labels.long()
        x = train_preprocess(flips.flatten(0, 1), images_u8.flatten(0, 1))
        feats = _group_forward(backbone, state.backbone, x, dropout_keep)
        loss = vmap(objective)(feats.unflatten(0, (k, -1)), state.fc, labels, valid)
        _sgd_step(state, loss.sum(), lr)
        return state, loss.detach()

    return step


def stack_client_batches(batches) -> tuple:
    """List of per-client (imgs, labels, valid[, idx]) -> stacked parts.

    Device-resident parts (a ``synth:`` batch, generated on the device)
    stack on the device; host numpy parts stack on the host, to go to the
    device in one copy."""
    return tuple(
        torch.stack(parts) if isinstance(parts[0], torch.Tensor) else np.stack(parts)
        for parts in zip(*batches))
