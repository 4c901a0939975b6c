"""Classification heads: cosine FC and the personalized BCE transformation layer.

Counterpart of ``fedfr_tpu/models/heads.py`` (reference client.py:25-113):

* ``cosine_logits`` — the normalized cosine classifier behind FC_module
  (client.py:63-83).  The FC weight is a plain ``(C, E)`` tensor held in the
  client's train state, because the server concatenates, splits and averages
  it across clients every round.
* ``BCEModule`` — the personalized "transformation layer" branch
  (client.py:25-61): an identity-initialized Linear converter (or, with
  ``converter_layers != 1``, a ``BottleBlock``), per-class
  cosine logits against its own weight matrix, a polynomial hardness
  transform g(x) = 2*((x+1)/2)^t - 1, and +/- margins scaled by r.  Labels
  >= n_class collapse to a dropped virtual "other" column, i.e. those rows
  have no positive.  State_dict keys are the reference's (``weight``,
  ``bias``, ``converter.0.{weight,bias}`` or the BottleBlock's
  ``converter.br{i}.{0,2}.*`` and ``converter.concat_fc.*``).

Everything here runs in fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .bottle import BottleBlock
from .layers import normal_init


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics: x / max(||x||, eps)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def cosine_logits(feats: torch.Tensor, weight: torch.Tensor,
                  normalize_feat: bool = True) -> torch.Tensor:
    """(B,E) x (C,E) -> (B,C) cosine similarities (client.py:69-74)."""
    w = l2_normalize(weight, dim=1)
    if normalize_feat:
        feats = l2_normalize(feats, dim=1)
    return feats @ w.t()


class LinearConverter(nn.Sequential):
    """Identity-initialized Linear(hidden, hidden) converter (client.py:29-33)."""

    def __init__(self, hidden: int):
        super().__init__(nn.Linear(hidden, hidden))
        with torch.no_grad():
            self[0].weight.copy_(torch.eye(hidden))
            self[0].bias.zero_()


class BCEModule(nn.Module):
    """Personalized BCE branch with margin/hardness logits (client.py:25-58)."""

    def __init__(self, hidden: int = 512, n_class: int = 100,
                 converter_layers: int = 1, m: float = 0.4, r: float = 30.0,
                 t: float = 3.0, generator: torch.Generator = None):
        super().__init__()
        self.n_class = n_class
        self.m, self.r, self.t = m, r, t
        self.converter = (LinearConverter(hidden) if converter_layers == 1
                          else BottleBlock(hidden, 4, generator=generator))
        self.weight = nn.Parameter(torch.empty(n_class, hidden))
        self.bias = nn.Parameter(torch.zeros(n_class))
        normal_init(self.weight, 0.01, generator)

    def forward(self, x: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = self.converter(x)
        cosine = l2_normalize(feat) @ l2_normalize(self.weight).t()
        # one-hot gt; labels >= n_class (public-data rows) have no positive
        gt = labels[:, None] == torch.arange(self.n_class, device=labels.device)[None, :]
        g = 2.0 * torch.pow((cosine + 1.0) / 2.0, self.t) - 1.0
        logits = torch.where(gt, self.r * (g - self.m), self.r * (g + self.m))
        return logits + self.bias[None, :], gt
