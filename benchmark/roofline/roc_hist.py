"""Least time of one ROC histogram call: every pair (i, j), i < T, i < j < N.

Operations: 2 E a pair (one fp32 fused multiply-add an element) at the
fp32 peak outside the tensor cores (the configurations state fp32 cosines).
Bytes: the (N, E) fp32 features and (N,) labels read once and the
(2,001 x 2) int64 counts written once, at the HBM peak.  The least time is
the larger of the two."""

from __future__ import annotations


def pairs(t: int, n: int) -> int:
    return t * n - t * (t + 1) // 2


def least_seconds(shape, peaks) -> float:
    t, n, e = shape
    flops = 2.0 * e * pairs(t, n)
    nbytes = 4.0 * n * e + 4.0 * n + 2001 * 2 * 8
    return max(flops / peaks["fp32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
