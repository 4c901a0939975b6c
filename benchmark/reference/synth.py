"""The ``synth:`` face universe, worked out again in plain PyTorch.

A frozen copy of the measured program's generator (JAX's threefry PRNG,
bit for bit, and the image formula of ``data/synthetic.py``), so that the
reference makes the images it compares on from the universe's spec alone
and takes no image from the program.  Only what the benchmark's
configurations use is kept: ``expr`` 0 (no distractor blend).

Per image ``i`` with ``ki = fold_in(fold_in(master, 2^30 + dseed), key)``:
a ``block x block x 3`` template a identity (``randint(fold_in(master,
gid), ., 30, 226)``, blended ``(1 - bw) T[gid] + bw T[bgid]``), repeated to
the image, plus ``randint(fold_in(ki, 0), ., -noise, noise + 1)``, times
``0.75 + 0.5 u(fold_in(ki, 1))``, plus ``randint(fold_in(ki, 2), -20, 21)``,
rolled by ``randint(fold_in(ki, 3 | 4), -amp, amp + 1)``, clipped, uint8.
Every uint32 word is held in int64 and masked.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

U32 = 0xFFFFFFFF
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
CHUNK = 64


def _rotl(v, r):
    return ((v << r) & U32) | (v >> (32 - r))


def _mul32(a, b):
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & U32


def threefry(key, x0, x1):
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & U32, (x1 + ks[1]) & U32
    for i in range(5):
        for r in ROT[i % 2]:
            x0 = (x0 + x1) & U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & U32
    return x0, x1


def fold_in(key, d):
    return threefry(key, 0, d & U32)


def _bits(key, idx):
    b0, b1 = threefry(key, idx >> 32, idx & U32)
    return b0 ^ b1


def randint_at(key, lo: int, hi: int, idx):
    k1, k2 = threefry(key, 0, 0), threefry(key, 0, 1)
    span = (hi - lo) & U32 if hi > lo else 1
    mult = _mul32((1 << 16) % span, (1 << 16) % span) % span
    off = ((_mul32(_bits(k1, idx) % span, mult) + _bits(k2, idx) % span) & U32) % span
    return (((lo + off) & U32) + 0x80000000 & U32) - 0x80000000


def uniform_at(key, idx):
    b = torch.as_tensor(_bits(key, idx), dtype=torch.int64)
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _templates(master, gid, block):
    kb = fold_in(master, gid.to(torch.int64)[:, None])
    idx = torch.arange(block * block * 3, dtype=torch.int64, device=gid.device)
    return randint_at(kb, 30, 226, idx).to(torch.float32)


def _chunk(keys, gids, bgids, bw, dseeds, master, size, noise, block, shift_div):
    dev = keys.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    ki = fold_in(fold_in(master, dseeds.to(torch.int64) + (1 << 30)), keys.to(torch.int64))
    bw = bw.to(torch.float32)[:, None]
    base = (f32(1.0) - bw) * _templates(master, gids, block) + bw * _templates(master, bgids, block)
    scale = f32(0.75) + f32(0.5) * uniform_at(fold_in(ki, 1), 0).to(dev)
    offset = randint_at(fold_in(ki, 2), -20, 21, 0)
    amp = size // shift_div
    dy = randint_at(fold_in(ki, 3), -amp, amp + 1, 0)
    dx = randint_at(fold_in(ki, 4), -amp, amp + 1, 0)
    ar = torch.arange(size, dtype=torch.int64, device=dev)
    ys = (ar[None, :] - dy[:, None]) % size
    xs = (ar[None, :] - dx[:, None]) % size
    c = torch.arange(3, dtype=torch.int64, device=dev)
    flat = ((ys[:, :, None, None] * size + xs[:, None, :, None]) * 3 + c).reshape(len(keys), -1)
    rep = size // block
    tidx = (((ys // rep)[:, :, None, None] * block + (xs // rep)[:, None, :, None]) * 3
            + c).reshape(len(keys), -1)
    kn = fold_in(ki, 0)
    n = randint_at((kn[0][:, None], kn[1][:, None]), -noise, noise + 1, flat)
    img = torch.gather(base, 1, tidx) + n.to(torch.float32)
    img = img * scale[:, None] + offset.to(torch.float32)[:, None]
    return img.clamp(0, 255).to(torch.uint8).reshape(len(keys), size, size, 3)


def generate(vecs: Tuple[np.ndarray, ...], spec: Dict, device) -> torch.Tensor:
    """(keys, gids, bgids, bw, dseeds) host vectors -> (B, S, S, 3) uint8."""
    if float(spec.get("expr", 0.0)) != 0.0:
        raise ValueError("the reference generator keeps only expr = 0")
    seed = int(spec["seed"])
    master = ((seed >> 32) & U32, seed & U32)
    keys, gids, bgids, bw, dseeds = (torch.as_tensor(np.asarray(v)).to(device) for v in vecs)
    size, noise = int(spec["image_size"]), int(spec["noise"])
    block, shift_div = int(spec["block"]), int(spec["shift_div"])
    return torch.cat([_chunk(keys[s:s + CHUNK], gids[s:s + CHUNK], bgids[s:s + CHUNK],
                             bw[s:s + CHUNK], dseeds[s:s + CHUNK], master, size, noise,
                             block, shift_div)
                      for s in range(0, len(keys), CHUNK)])


def client_vectors(spec: Dict, cid: int, positions: np.ndarray):
    """The generator's inputs and the labels of client ``cid``'s images at
    ``positions``: 100-odd identities, each with ``imgs_min..imgs_max``
    images drawn from the stream ``[seed, 1]``, record keys from 1."""
    rng = np.random.default_rng([int(spec["seed"]), 1])
    ipc = int(spec["ids_per_client"])
    for _ in range(cid + 1):
        counts = rng.integers(int(spec["imgs_min"]), int(spec["imgs_max"]) + 1, ipc)
    labels = np.repeat(np.arange(ipc), counts)[positions]
    n = len(positions)
    return ((np.asarray(positions) + 1).astype(np.int32),
            (cid * ipc + labels).astype(np.int32), (cid * ipc + labels).astype(np.int32),
            np.zeros(n, np.float32), np.full(n, cid + 1, np.int32)), labels


def veri_vectors(spec: Dict, positions: np.ndarray):
    """The same for the local-verification split: ``veri_ids`` identities
    of the FL pool, ``veri_imgs`` images each, stream 900,001."""
    labels = (np.asarray(positions) // int(spec["veri_imgs"])).astype(np.int32)
    n = len(positions)
    return ((np.asarray(positions) + 1).astype(np.int32), labels, labels,
            np.zeros(n, np.float32), np.full(n, 900_001, np.int32)), labels
