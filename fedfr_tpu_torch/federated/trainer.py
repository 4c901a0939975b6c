"""Local-training steps of the FedFR objectives (PyTorch).

Counterpart of ``fedfr_tpu/federated/trainer.py``: the branch step in its
per-step-recompute form (the frozen global and last-round models run every
step) and its cached-contrastive form (their features gathered from
per-run caches), and the plain step.  The branch step reproduces the
reference hot loop (client.py:355-404):

    loss = CE(margin(cos_logits), labels)
         + 10 * BCE(transformation-layer logits)
         + mu * MOON-contrastive(feats; global model, last-round model)

with one SGD(momentum 0.9, wd 5e-4) over backbone + FC + BCE, and the
backbone's BatchNorm statistics updated by its train-mode forward.  The
loss bodies (``make_branch_objective``, ``make_plain_objective``) are
shared with the lockstep step of ``parallel/client_parallel.py``.

Randomness is explicit: the step takes the augmentation flip mask as an
argument, where the JAX step draws it inside from its key, and iresnet's
dropout draws from a ``torch.Generator`` the caller passes, where the JAX
step folds a separate dropout key (``fold_in(base, 1)``).  ``freeze_bn``
lives on the module (``IResNet.train`` keeps its BN layers in eval mode),
as it does in the JAX package, so the step needs no flag for it.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..models.heads import cosine_logits
from ..ops.losses import bce_loss, moon_contrastive, softmax_cross_entropy
from ..ops.margins import MARGINS, reweight_negatives
from .state import ClientTrainState, train_preprocess


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    cos_loss: torch.Tensor
    bce_loss: torch.Tensor
    con_loss: torch.Tensor


_warned_cache_fallback = False


def use_cached_contrastive(cfg) -> bool:
    """One predicate for every build and call site of the cached-contrastive
    step (the client and the server's round), so they never disagree on the
    step's signature: ``fed.cache_contrastive`` with ``fed.contrastive`` on
    and no FedProx term.  A request that cannot be met logs a warning once
    and runs the recompute step, as the JAX package does."""
    active = bool(cfg.fed.cache_contrastive and cfg.fed.contrastive
                  and cfg.fed.fedprox_mu == 0.0)
    global _warned_cache_fallback
    if cfg.fed.cache_contrastive and not active and not _warned_cache_fallback:
        _warned_cache_fallback = True
        logging.getLogger("fedfr_tpu_torch.trainer").warning(
            "cache_contrastive requested but falling back to per-step "
            "recompute: %s", "contrastive is disabled"
            if not cfg.fed.contrastive
            else "fedprox_mu > 0 needs the global model inside the step")
    return active


def _forward(state: ClientTrainState, x: torch.Tensor,
             dropout_gen: Optional[torch.Generator]) -> torch.Tensor:
    state.backbone.train()
    return (state.backbone(x) if dropout_gen is None
            else state.backbone(x, dropout_gen=dropout_gen))


def _sgd_step(state: ClientTrainState, total: torch.Tensor, lr: float) -> None:
    for group in state.opt.param_groups:
        group["lr"] = lr
    state.opt.zero_grad(set_to_none=True)
    total.backward()
    state.opt.step()


def proximal_sq(params, global_params) -> torch.Tensor:
    """FedProx's ||w - w_global||^2 over the backbone's parameters, summed
    parameter by parameter in module order."""
    return sum(((p - g.detach()) ** 2).sum() for p, g in zip(params, global_params))


def make_branch_objective(*, margin: str = "CosFace", s: float = 30.0,
                          m: float = 0.4, bce_weight: float = 10.0,
                          bce_r: float = 30.0, bce_lambda: float = 0.7,
                          mu: float = 5.0, temperature: float = 0.5,
                          bce_detach: bool = False, contrastive: bool = True,
                          reweight: bool = False, num_local: int = 100,
                          num_clients: int = 40,
                          fedprox_mu: float = 0.0) -> Callable:
    """The joint objective's loss body, shared by the sequential step below
    and the client-parallel step (``parallel/client_parallel.py``), which
    runs it once per client under ``torch.func.vmap``.

    Returns ``objective(feats, fc, bce, labels, valid, con_feats, prox_sq)
    -> (total, cos_loss, bce_loss, con_loss)``: ``feats`` the trainable
    forward's (B, E) output, ``fc`` the (C, E) rows, ``bce(feats, labels)``
    the BCE branch or None, ``labels`` int64, ``con_feats()`` the frozen
    models' (global, last) features (called under ``no_grad``) and
    ``prox_sq()`` FedProx's squared distance (called only when
    ``fedprox_mu`` > 0)."""
    margin_fn = MARGINS[margin]

    def objective(feats: torch.Tensor, fc: torch.Tensor, bce: Optional[Callable],
                  labels: torch.Tensor, valid: torch.Tensor, con_feats: Callable,
                  prox_sq: Optional[Callable]):
        cos = cosine_logits(feats, fc)
        logits = margin_fn(cos, labels, s, m)
        if reweight:
            logits = reweight_negatives(logits, labels, num_local, num_clients)
        cos_l = softmax_cross_entropy(logits, labels, valid)

        if bce is not None:
            bce_logits, gts = bce(feats.detach() if bce_detach else feats, labels)
            bce_l = bce_loss(bce_logits, gts, bce_r, bce_lambda, valid)
        else:  # reference client.py:320,383 guards the term on BCE_local
            bce_l = torch.zeros((), device=feats.device)

        if contrastive:
            with torch.no_grad():
                gfeats, lfeats = con_feats()
            con_l = moon_contrastive(feats, gfeats, lfeats, temperature, valid)
        else:
            con_l = torch.zeros((), device=feats.device)

        total = cos_l + bce_weight * bce_l + mu * con_l
        if fedprox_mu > 0.0:
            total = total + 0.5 * fedprox_mu * prox_sq()
        return total, cos_l, bce_l, con_l

    return objective


def make_branch_train_step(*, cached_contrastive: bool = False,
                           **objective_kwargs) -> Callable:
    """Train step for the joint local+public objective with the BCE branch
    (``objective_kwargs``: those of ``make_branch_objective``).

    Returns ``step(state, global_net, last_net, images_u8, labels, valid, lr,
    flip, dropout_gen=None) -> (state, StepMetrics)``.  ``state`` is updated
    in place; ``global_net`` and ``last_net`` are frozen modules in eval
    mode; ``images_u8`` is the NHWC uint8 batch on the device and ``flip``
    its (B,) bool flip mask; ``dropout_gen`` feeds the trainable forward's
    dropout (iresnet with ``dropout > 0``; other nets take none).  The
    metrics are detached device scalars.

    ``fedprox_mu`` > 0 adds mu/2 * ||w - w_global||^2 over the backbone
    parameters, as the JAX step does.

    ``cached_contrastive`` returns ``cached_step(state, g_cache, l_cache,
    images_u8, labels, valid, idx, lr, flip, dropout_gen=None)`` instead:
    the two frozen forwards become gathers ``g_cache[idx, flip]`` and
    ``l_cache[idx, flip]`` from the (N, 2, E) caches of
    ``embed.embed_flip_caches`` (axis 1 = [original, h-flipped]), ``idx``
    the batch's dataset positions.  The caller passes the same ``flip`` to
    the trainable forward and the gather, so the features belong to the
    images the step trains on.  The loss body is the recompute step's.
    """
    check_cached_contrastive(cached_contrastive, objective_kwargs)
    objective = make_branch_objective(**objective_kwargs)

    def run(state: ClientTrainState, x: torch.Tensor, con_feats: Callable,
            prox_net: Optional[nn.Module], labels: torch.Tensor,
            valid: torch.Tensor, lr: float,
            dropout_gen: Optional[torch.Generator]):
        labels = labels.long()
        feats = _forward(state, x, dropout_gen)
        total, cos_l, bce_l, con_l = objective(
            feats, state.fc, state.bce, labels, valid, con_feats,
            lambda: proximal_sq(state.backbone.parameters(), prox_net.parameters()))
        _sgd_step(state, total, lr)
        metrics = StepMetrics(total.detach(), cos_l.detach(), bce_l.detach(),
                              con_l.detach())
        return state, metrics

    def step(state: ClientTrainState, global_net: Optional[nn.Module],
             last_net: Optional[nn.Module], images_u8: torch.Tensor,
             labels: torch.Tensor, valid: torch.Tensor, lr: float,
             flip: torch.Tensor,
             dropout_gen: Optional[torch.Generator] = None):
        x = train_preprocess(flip, images_u8)
        return run(state, x, lambda: (global_net(x), last_net(x)), global_net,
                   labels, valid, lr, dropout_gen)

    def cached_step(state: ClientTrainState, g_cache: torch.Tensor,
                    l_cache: torch.Tensor, images_u8: torch.Tensor,
                    labels: torch.Tensor, valid: torch.Tensor,
                    idx: torch.Tensor, lr: float, flip: torch.Tensor,
                    dropout_gen: Optional[torch.Generator] = None):
        x = train_preprocess(flip, images_u8)
        idx, fi = idx.long(), flip.long()
        return run(state, x, lambda: (g_cache[idx, fi], l_cache[idx, fi]), None,
                   labels, valid, lr, dropout_gen)

    return cached_step if cached_contrastive else step


def check_cached_contrastive(cached_contrastive: bool, objective_kwargs) -> None:
    """The cached step's preconditions: the MOON term on, FedProx off."""
    if cached_contrastive and not objective_kwargs.get("contrastive", True):
        raise ValueError("cached_contrastive requires contrastive=True")
    if cached_contrastive and objective_kwargs.get("fedprox_mu", 0.0) > 0.0:
        raise ValueError(
            "cached_contrastive drops the global model from the step; the "
            "FedProx proximal term needs it — disable one")


def branch_objective_kwargs(cfg, num_local: int) -> dict:
    """``make_branch_objective``'s loss and federated settings from ``cfg``
    (``num_local``: the clients' local class count)."""
    return dict(
        margin=cfg.loss.loss, s=cfg.loss.margin_s, m=cfg.loss.margin_m,
        bce_weight=cfg.loss.bce_weight, bce_r=cfg.loss.bce_r,
        bce_lambda=cfg.loss.bce_lambda, mu=cfg.loss.mu,
        temperature=cfg.loss.temperature, bce_detach=cfg.fed.bce_detach,
        contrastive=cfg.fed.contrastive, reweight=cfg.fed.reweight_cosface,
        num_local=num_local, num_clients=cfg.data.num_clients,
        fedprox_mu=cfg.fed.fedprox_mu)


def branch_step_for(cfg, num_local: int, cached_contrastive: bool = False) -> Callable:
    """``make_branch_train_step`` with the loss and federated settings of
    ``cfg`` (``num_local``: the clients' local class count)."""
    return make_branch_train_step(cached_contrastive=cached_contrastive,
                                  **branch_objective_kwargs(cfg, num_local))


def make_plain_objective(*, margin: str = "CosFace", s: float = 30.0,
                         m: float = 0.4) -> Callable:
    """The plain objective's loss body, ``objective(feats, fc, labels,
    valid)``: the margin softmax CE over the client's own FC rows, shared by
    the sequential and the client-parallel plain steps."""
    margin_fn = MARGINS[margin]

    def objective(feats: torch.Tensor, fc: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
        return softmax_cross_entropy(
            margin_fn(cosine_logits(feats, fc), labels, s, m), labels, valid)

    return objective


def make_plain_train_step(*, margin: str = "CosFace", s: float = 30.0,
                          m: float = 0.4) -> Callable:
    """CosFace/ArcFace-only local training over the client's own FC
    (reference ``Client.train``, client.py:511-571; JAX
    ``make_plain_train_step``).  Returns ``step(state, images_u8, labels,
    valid, lr, flip, dropout_gen=None) -> (state, loss)``, with the branch
    step's explicit flip mask and dropout generator.  No reweighting: the
    plain logits have only the local columns, and the JAX server never
    asks for it here."""
    objective = make_plain_objective(margin=margin, s=s, m=m)

    def step(state: ClientTrainState, images_u8: torch.Tensor,
             labels: torch.Tensor, valid: torch.Tensor, lr: float,
             flip: torch.Tensor, dropout_gen: Optional[torch.Generator] = None):
        labels = labels.long()
        feats = _forward(state, train_preprocess(flip, images_u8), dropout_gen)
        loss = objective(feats, state.fc, labels, valid)
        _sgd_step(state, loss, lr)
        return state, loss.detach()

    return step


def init_client_state(backbone: nn.Module, fc: torch.Tensor,
                      bce: Optional[nn.Module], lr: float,
                      momentum: float = 0.9,
                      weight_decay: float = 5e-4) -> ClientTrainState:
    """Fresh optimizer buffers around modules that already hold the run's
    starting weights (the reference builds a new SGD per local run,
    client.py:335)."""
    fc = nn.Parameter(fc.detach().clone())
    params = list(backbone.parameters()) + [fc]
    if bce is not None:
        params += list(bce.parameters())
    opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                          weight_decay=weight_decay)
    return ClientTrainState(backbone=backbone, fc=fc, bce=bce, opt=opt)
