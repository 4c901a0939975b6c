"""Everything a run draws comes from ``--seed`` through ``derive``.

``--seed`` may be any whole number, larger than 64 bits hold; ``derive``
hashes it with a tag into the range each consumer takes."""

from __future__ import annotations

import hashlib

import torch


def derive(seed: int, tag: str, bits: int = 62) -> int:
    h = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") % (1 << bits)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))
