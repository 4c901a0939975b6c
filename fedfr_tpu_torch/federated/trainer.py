"""Local-training step of the FedFR joint objective (PyTorch).

Counterpart of ``fedfr_tpu/federated/trainer.py``'s ``make_branch_train_step``
in its per-step-recompute form (the frozen global and last-round models run
every step).  The step reproduces the reference hot loop (client.py:355-404):

    loss = CE(margin(cos_logits), labels)
         + 10 * BCE(transformation-layer logits)
         + mu * MOON-contrastive(feats; global model, last-round model)

with one SGD(momentum 0.9, wd 5e-4) over backbone + FC + BCE, and the
backbone's BatchNorm statistics updated by its train-mode forward.

Randomness is explicit: the step takes the augmentation flip mask as an
argument, where the JAX step draws it inside from its key, and iresnet's
dropout draws from a ``torch.Generator`` the caller passes, where the JAX
step folds a separate dropout key (``fold_in(base, 1)``).  ``freeze_bn``
lives on the module (``IResNet.train`` keeps its BN layers in eval mode),
as it does in the JAX package, so the step needs no flag for it.
"""

from __future__ import annotations

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


def make_branch_train_step(*, margin: str = "CosFace", s: float = 30.0,
                           m: float = 0.4, bce_weight: float = 10.0,
                           bce_r: float = 30.0, bce_lambda: float = 0.7,
                           mu: float = 5.0, temperature: float = 0.5,
                           bce_detach: bool = False, contrastive: bool = True,
                           reweight: bool = False, num_local: int = 100,
                           num_clients: int = 40,
                           fedprox_mu: float = 0.0) -> Callable:
    """Train step for the joint local+public objective with the BCE branch.

    Returns ``step(state, global_net, last_net, images_u8, labels, valid, lr,
    flip, dropout_gen=None) -> (state, StepMetrics)``.  ``state`` is updated
    in place; ``global_net`` and ``last_net`` are frozen modules in eval
    mode; ``images_u8`` is the NHWC uint8 batch on the device and ``flip``
    its (B,) bool flip mask; ``dropout_gen`` feeds the trainable forward's
    dropout (iresnet with ``dropout > 0``; other nets take none).  The
    metrics are detached device scalars.

    ``fedprox_mu`` > 0 adds mu/2 * ||w - w_global||^2 over the backbone
    parameters, as the JAX step does.
    """
    margin_fn = MARGINS[margin]

    def step(state: ClientTrainState, global_net: Optional[nn.Module],
             last_net: Optional[nn.Module], images_u8: torch.Tensor,
             labels: torch.Tensor, valid: torch.Tensor, lr: float,
             flip: torch.Tensor,
             dropout_gen: Optional[torch.Generator] = None):
        x = train_preprocess(flip, images_u8)
        labels = labels.long()
        state.backbone.train()
        feats = (state.backbone(x) if dropout_gen is None
                 else state.backbone(x, dropout_gen=dropout_gen))

        cos = cosine_logits(feats, state.fc)
        logits = margin_fn(cos, labels, s, m)
        if reweight:
            logits = reweight_negatives(logits, labels, num_local, num_clients)
        cos_l = softmax_cross_entropy(logits, labels, valid)

        if state.bce is not None:
            bce_logits, gts = state.bce(feats.detach() if bce_detach else feats,
                                        labels)
            bce_l = bce_loss(bce_logits, gts, bce_r, bce_lambda, valid)
        else:  # reference client.py:320,383 guards the term on BCE_local
            bce_l = torch.zeros((), device=feats.device)

        if contrastive:
            with torch.no_grad():
                gfeats = global_net(x)
                lfeats = last_net(x)
            con_l = moon_contrastive(feats, gfeats, lfeats, temperature, valid)
        else:
            con_l = torch.zeros((), device=feats.device)

        total = cos_l + bce_weight * bce_l + mu * con_l
        if fedprox_mu > 0.0:
            sq = sum(((p - g.detach()) ** 2).sum() for p, g in zip(
                state.backbone.parameters(), global_net.parameters()))
            total = total + 0.5 * fedprox_mu * sq

        for group in state.opt.param_groups:
            group["lr"] = lr
        state.opt.zero_grad(set_to_none=True)
        total.backward()
        state.opt.step()
        metrics = StepMetrics(total.detach(), cos_l.detach(), bce_l.detach(),
                              con_l.detach())
        return state, metrics

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
