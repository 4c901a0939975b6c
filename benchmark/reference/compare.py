"""The numbers that decide ``correct``: each a gap between what the measured
program produced and what the reference works out, compared with the limit
of ``benchmark/limits/<cell>.json``."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def rel_gap(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-12)


def loss_gap(program, reference) -> float:
    """The largest relative gap of a step's total loss over the steps."""
    return max((rel_gap(p[0], r[0]) for p, r in zip(program, reference)),
               default=math.inf) if len(program) == len(reference) else math.inf


def counted_leaves(ref_grads: Dict[str, Optional[torch.Tensor]]) -> Tuple[list, float]:
    """The leaves a norm gap is taken over, and the median leaf's gradient
    norm: leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone (a bias under softmax), and are
    left out by that rule, never by name.  Running statistics are counted
    by the same rule on the reference's change."""
    norms = {k: float(v.float().norm()) for k, v in ref_grads.items() if v is not None}
    med = float(np.median(list(norms.values()))) if norms else 0.0
    return sorted(k for k, n in norms.items() if n >= 1e-3 * med), med


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              leaves) -> Dict[str, float]:
    """Each of ``leaves``' |‖program‖ - ‖reference‖| / max(‖reference‖, the
    median leaf's ‖reference‖)."""
    ref = {k: float(reference[k].float().norm()) for k in leaves}
    med = float(np.median(list(ref.values()))) if ref else 0.0
    out = {}
    for k in leaves:
        p = program.get(k)
        pn = float(p.float().norm()) if p is not None else 0.0
        out[k] = abs(pn - ref[k]) / max(ref[k], med, 1e-30) if math.isfinite(pn) else math.inf
    return out


def worst_leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
                   leaves) -> Tuple[float, str]:
    """The largest of ``leaf_gaps``, and the leaf that gives it."""
    gaps = leaf_gaps(program, reference, leaves)
    if not gaps:
        return math.inf, ""
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def median_leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
                    leaves) -> float:
    """The median of ``leaf_gaps``: steady from seed to seed where the worst
    leaf is a sum that cancels (a BatchNorm shift's gradient summed over
    every position of a bf16 convolution's input gradient)."""
    gaps = list(leaf_gaps(program, reference, leaves).values())
    return float(np.median(gaps)) if gaps else math.inf


def head_leaves(leaves) -> list:
    """Those of ``leaves`` that are the heads' (the FC rows and the BCE
    module's), not the backbone's: a fault confined to these few leaves
    moves the median leaf not at all."""
    return [k for k in leaves if not k.startswith("backbone.")]


def row_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The largest distance between matching unit rows."""
    if program.shape != reference.shape:
        return math.inf
    d = (program.float() - reference.float()).norm(dim=1).max()
    return float(d) if torch.isfinite(d) else math.inf


def mined_set_gap(program_keys: np.ndarray, ref_scores: np.ndarray, cap: int,
                  threshold: float) -> float:
    """How far below the reference's cut the program's mined set reaches:
    max over the program's images of (the reference's k-th highest score -
    the image's reference score), 0 when every image is among the
    reference's hardest; inf when the set's size is not
    min(cap, images above the threshold).  Keys are 1-based positions."""
    above = int((ref_scores > threshold).sum())
    k = min(cap, above) if cap else above
    if len(program_keys) != k or len(np.unique(program_keys)) != k:
        return math.inf
    if k == 0:
        return 0.0
    cut = np.partition(ref_scores, len(ref_scores) - k)[len(ref_scores) - k]
    return float(max(0.0, (cut - ref_scores[np.asarray(program_keys) - 1]).max()))


def hist_moved(program: np.ndarray, reference: np.ndarray) -> float:
    """Share of the pairs the program binned elsewhere than the reference;
    inf when the two count different totals."""
    program, reference = np.asarray(program, np.int64), np.asarray(reference, np.int64)
    total = int(reference.sum())
    if program.shape != reference.shape or int(program.sum()) != total or total == 0:
        return math.inf
    return float(np.abs(program - reference).sum() / 2 / total)


def table_gap(program, reference) -> float:
    p, r = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    if p.shape != r.shape or not np.isfinite(p).all():
        return math.inf
    return float(np.abs(p - r).max())
