"""Least time of one mining call, ``out[p] = max_l <pub[p], loc[l]>``.

Operations: 2 P L E at the bf16 tensor-core peak (the configurations state
bf16 operands with fp32 sums).  Bytes: the (P, E) bf16 public features and
the (L, E) fp32 local features read once, the (P,) fp32 maxima written
once, at the HBM peak.  The least time is the larger of the two."""

from __future__ import annotations


def least_seconds(shape, peaks) -> float:
    p, l, e = shape
    flops = 2.0 * p * l * e
    nbytes = 2.0 * p * e + 4.0 * l * e + 4.0 * p
    return max(flops / peaks["bf16_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
