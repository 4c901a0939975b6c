"""Model FLOPs of iresnet100 (2 a multiply-accumulate; convs and the fc,
BN and elementwise work left out), from the configuration's published
shapes."""

from __future__ import annotations


def _out(size: int) -> int:
    return (size - 1) // 2 + 1


def forward_flops(cfg) -> float:
    """One image's forward: the 3x3 stem at full resolution; per stage a
    first block (3x3 conv at the input resolution, stride-2 3x3 conv, 1x1
    stride-2 downsample) and ``layers - 1`` blocks of two 3x3 convs at the
    stage's resolution; then the fc."""
    hw = int(cfg["image_size"])
    total = 2.0 * 3 * 64 * 9 * hw * hw
    cin = 64
    for blocks, c in zip(cfg["layers"], cfg["filters"]):
        out = _out(hw)
        total += 2.0 * cin * c * 9 * hw * hw + 2.0 * c * c * 9 * out * out
        total += 2.0 * cin * c * out * out
        total += (blocks - 1) * 2 * (2.0 * c * c * 9 * out * out)
        cin, hw = c, out
    return total + 2.0 * cin * hw * hw * cfg["embedding_size"]


def stem_dgrad_flops(cfg) -> float:
    """The stem conv's input gradient, which no backward computes."""
    return 2.0 * 3 * 64 * 9 * int(cfg["image_size"]) ** 2
