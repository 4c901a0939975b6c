"""Minimal ASCII table (PrettyTable-style output for the IJB-C logs); the
port's copy of ``fedfr_tpu/utils/table.py``."""

from __future__ import annotations

from typing import List, Sequence


def ascii_table(header: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    cols = [str(h) for h in header]
    data = [[str(c) for c in row] for row in rows]
    widths = [len(c) for c in cols]
    for row in data:
        for i, c in enumerate(row):
            widths[i] = max(widths[i], len(c))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out: List[str] = [sep]
    out.append("|" + "|".join(f" {c:^{w}} " for c, w in zip(cols, widths)) + "|")
    out.append(sep)
    for row in data:
        out.append("|" + "|".join(f" {c:^{w}} " for c, w in zip(row, widths)) + "|")
    out.append(sep)
    return "\n".join(out)
