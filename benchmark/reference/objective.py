"""FedFR's local objective and its SGD step in plain fp32 PyTorch.

FedFR's client loop (``client.py`` of the FedFR reference code):

    loss = CE(CosFace(s, m) over [local ; global] FC rows)
         + bce_weight * BCE(the personalised transformation layer)
         + mu * MOON(trained features; global model +, last model -)

with one SGD (momentum 0.9, weight decay 5e-4) over backbone, FC rows and
the BCE module.  Images arrive as uint8 NHWC with a flip mask; they are
mirrored where the mask is set and mapped to [-1, 1] NCHW.  Imports nothing
of the measured program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn


def preprocess(u8: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    u8 = torch.where(flip[:, None, None, None], u8.flip(2), u8)
    return (u8.float() * (1.0 / 127.5) - 1.0).permute(0, 3, 1, 2)


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


class BCEHead(nn.Module):
    """The transformation layer: an identity-initialised linear converter,
    cosine logits against its own rows, g(x) = 2((x + 1) / 2)^t - 1, the
    margin m added to negatives and taken from positives, scale r.  State
    dict keys: ``converter.0.{weight,bias}``, ``weight``, ``bias``."""

    def __init__(self, e: int, n_class: int):
        super().__init__()
        self.converter = nn.Sequential(nn.Linear(e, e))
        self.weight = nn.Parameter(torch.zeros(n_class, e))
        self.bias = nn.Parameter(torch.zeros(n_class))

    def forward(self, x, labels, m: float, r: float, t: float):
        cos = unit(self.converter(x)) @ unit(self.weight).t()
        gt = labels[:, None] == torch.arange(self.weight.shape[0], device=x.device)[None, :]
        g = 2.0 * ((cos + 1.0) / 2.0) ** t - 1.0
        return torch.where(gt, r * (g - m), r * (g + m)) + self.bias, gt


def bce_loss(z, gt, r: float, lam: float, valid):
    pos = (lam / r) * torch.log1p(torch.exp(torch.clamp(-z, max=60.0)) + 1e-8)
    pos = torch.where(z < -60.0, (lam / r) * (-z), pos)
    neg = ((1.0 - lam) / r) * torch.log1p(torch.exp(torch.clamp(z, max=60.0)) + 1e-8)
    neg = torch.where(z > 60.0, ((1.0 - lam) / r) * z, neg)
    return masked_mean(torch.where(gt, pos, neg).sum(1), valid)


def masked_mean(x, valid):
    v = valid.float()
    return (x * v).sum() / v.sum().clamp_min(1.0)


def objective(feats, fc, bce: BCEHead, labels, valid, gfeats, lfeats, p: Dict):
    """(total, cos, bce, con) of one batch; ``p`` holds the loss settings."""
    cos = unit(feats) @ unit(fc).t()
    onehot = labels[:, None] == torch.arange(fc.shape[0], device=feats.device)[None, :]
    logits = (cos - p["margin_m"] * onehot.float()) * p["margin_s"]
    ce = masked_mean(torch.logsumexp(logits, 1) - logits.gather(1, labels[:, None])[:, 0],
                     valid)
    z, gt = bce(feats, labels, p["bce_margin"], p["bce_scale"], p["bce_t"])
    bl = bce_loss(z, gt, p["bce_r"], p["bce_lambda"], valid)

    def cs(a, b):
        return (a * b).sum(1) / (a.norm(dim=1).clamp_min(1e-8) * b.norm(dim=1).clamp_min(1e-8))

    con = masked_mean(F.softplus((cs(feats, lfeats) - cs(feats, gfeats)) / p["temperature"]),
                      valid)
    total = ce + p["bce_weight"] * bl + p["mu"] * con
    return total, ce, bl, con


def follow_steps(net_cls, cfg: Dict, weights: Dict, batches, lr: float, p: Dict,
                 device, cast=None, drop_half: bool = False) -> Dict:
    """Run the objective's first steps from the benchmark's weights on the
    batches the measured program trained on.

    ``weights``: ``global`` and ``last`` backbone state dicts, ``fc`` the
    [local ; global] rows, ``bce`` the BCE state dict.  ``batches``: (u8,
    labels, valid, flip) a step.  Returns the losses of every step, the
    first step's gradient a leaf, each leaf's start and its value after the
    last step, keyed ``backbone.<name>``, ``fc``, ``bce.<name>``, and the
    trained backbone's floating buffers (BatchNorm's running statistics)
    before the first step and after the last (``stats_start``,
    ``stats_end``).
    ``cast`` replaces the backbone's operand cast (the control);
    ``drop_half`` leaves out the second half of every batch (a planted
    fault)."""
    nets = {}
    for role in ("train", "global", "last"):
        net = net_cls(cfg).to(device)
        net.load_state_dict(weights["global" if role == "train" else role])
        if cast is not None:
            net.cast = cast
        net.train(role == "train").requires_grad_(role == "train")
        nets[role] = net
    fc = nn.Parameter(weights["fc"].detach().clone().float())
    bce = BCEHead(fc.shape[1], weights["bce"]["weight"].shape[0]).to(device)
    bce.load_state_dict(weights["bce"])
    leaves = {f"backbone.{k}": v for k, v in nets["train"].named_parameters()}
    leaves["fc"] = fc
    leaves.update({f"bce.{k}": v for k, v in bce.named_parameters()})
    opt = torch.optim.SGD(list(leaves.values()), lr=lr, momentum=p["momentum"],
                          weight_decay=p["weight_decay"])
    start = {k: v.detach().clone() for k, v in leaves.items()}
    stats_start = running_stats(nets["train"])
    losses, grads = [], {}
    for i, (u8, labels, valid, flip) in enumerate(batches):
        labels, valid = labels.long(), valid.clone()
        if drop_half:
            valid[valid.shape[0] // 2:] = False
        x = preprocess(u8, flip)
        feats = nets["train"](x)
        with torch.no_grad():
            gfeats, lfeats = nets["global"](x), nets["last"](x)
        total, ce, bl, con = objective(feats, fc, bce, labels, valid, gfeats, lfeats, p)
        opt.zero_grad(set_to_none=True)
        total.backward()
        if i == 0:
            grads = {k: (v.grad.detach().clone() if v.grad is not None else None)
                     for k, v in leaves.items()}
        opt.step()
        losses.append([float(v.detach()) for v in (total, ce, bl, con)])
    end = {k: v.detach().clone() for k, v in leaves.items()}
    return {"losses": losses, "grads": grads, "start": start, "end": end,
            "stats_start": stats_start, "stats_end": running_stats(nets["train"])}


def running_stats(net: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of ``net``'s floating buffers (BatchNorm's running means and
    variances), keyed ``backbone.<name>``."""
    return {f"backbone.{k}": v.detach().clone() for k, v in net.named_buffers()
            if v.is_floating_point()}
