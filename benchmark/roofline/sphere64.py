"""Model FLOPs of FedFR's sphere64 (2 a multiply-accumulate; convs and the fc,
elementwise work left out), from the configuration's published shapes."""

from __future__ import annotations


def _out(size: int) -> int:
    return (size - 1) // 2 + 1


def forward_flops(cfg) -> float:
    """One image's forward: per stage a stride-2 3x3 conv and ``layers``
    units of two 3x3 convs at the stage's resolution, then the fc."""
    cin, hw, total = 3, int(cfg["image_size"]), 0.0
    for units, c in zip(cfg["layers"], cfg["filters"]):
        hw = _out(hw)
        total += 2.0 * cin * c * 9 * hw * hw + units * 2 * (2.0 * c * c * 9 * hw * hw)
        cin = c
    return total + 2.0 * cin * hw * hw * cfg["embedding_size"]


def stem_dgrad_flops(cfg) -> float:
    """The first conv's input gradient, which no backward computes."""
    return 2.0 * 3 * cfg["filters"][0] * 9 * _out(int(cfg["image_size"])) ** 2
