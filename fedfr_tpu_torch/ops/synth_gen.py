"""The ``synth:`` image generator: JAX's jitted ``gen``, bit for bit.

``synth_generate(keys, gids, bgids, bw, dseeds, master, ...)`` -> ``(B, size,
size, 3)`` uint8 NHWC images, the function of the JAX package's generator
(``fedfr_tpu/data/synthetic.py::_make_generator``, which XLA fuses into one
program; not a Pallas kernel).  Per image ``i``, with ``ki =
fold_in(fold_in(master, 2^30 + dseeds[i]), keys[i])``:

* a template of ``block x block x 3`` values per identity ``g``:
  ``randint(fold_in(master, g), (block, block, 3), 30, 226)``, blended
  ``(1 - bw) * T[gids[i]] + bw * T[bgids[i]]``; under ``expr > 0`` then
  ``(1 - u) * base + u * T[dgid]`` with ``u = expr * uniform(fold_in(ki,
  5))`` and ``dgid = randint(fold_in(ki, 6), (), 2^26, 2^30)``;
* the template repeated to ``size x size``, plus
  ``randint(fold_in(ki, 0), (size, size, 3), -noise, noise + 1)``;
* times ``0.75 + 0.5 * uniform(fold_in(ki, 1))``, rounded, plus
  ``randint(fold_in(ki, 2), (), -20, 21)``;
* rolled by ``(dy, dx)``, each ``randint(fold_in(ki, 3 | 4), (), -amp, amp +
  1)`` with ``amp = size // shift_div``, so output pixel ``(y, x)`` holds the
  pre-roll value at ``((y - dy) mod size, (x - dx) mod size)``, noise draw
  included;
* clipped to [0, 255] and truncated to uint8 (XLA's f32 -> u8 convert).

Every float op is one rounded fp32 op in JAX's order (no fused
multiply-add), so the images are equal byte for byte.

* On a CUDA tensor it launches the hand-written kernel ``csrc/synth_gen.cu``
  (built at first use) on the current stream, without synchronising, and
  raises if the launch fails.  The kernel's remainders by the noise's span
  are a 64-bit multiply-add and a shift by ``fastmod_magic``'s constants,
  and its grid is one wave of equal chunks of the batch (``launch_grid``).
* On a CPU tensor it runs ``synth_generate_plain``, the same function in
  plain PyTorch on int64 words (``ops/threefry.py``), chunked over images.
  It is the kernel's oracle on the card.

``synth_gen_launches`` counts kernel launches, so that a run can show that
its ``synth:`` batches came from the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import threefry as tf
from ._build import load_kernel

TEMPLATE_LO, TEMPLATE_HI = 30, 226     # template values: randint [30, 226)
DISTRACTOR_LO, DISTRACTOR_HI = 1 << 26, 1 << 30
DSEED_BASE = 1 << 30                   # fold_in(master, 2^30 + dataset seed)
OFFSET_LO, OFFSET_HI = -20, 21
PLAIN_CHUNK = 64  # images per step of the plain version (~2 KB of int64
                  # temporaries per output byte)

synth_gen_launches = 0
_configs: dict = {}


def fastmod_magic(d: int) -> Tuple[int, int, int]:
    """``(m, a, l)``, each below 2^32, such that ``n // d == (n * m + a) >>
    (32 + l)`` for every uint32 ``n``: the kernel's remainder by ``d``
    without a division.  ``l = floor(log2 d)``; ``m`` is ``2^(32+l) / d``
    rounded up with ``a = 0`` where that is exact (Granlund and Montgomery
    1994, theorem 4.2: ``m d - 2^(32+l) <= 2^l``), else rounded down with
    ``a = m`` (Robison 2005: then ``2^(32+l) - m d <= 2^l``, as the two
    errors sum to ``d < 2^(l+1)``); a power of two takes ``m = a = 2^32 -
    1``.  ``1 <= d < 2^32``."""
    if not 1 <= d < 1 << 32:
        raise ValueError(f"divisor {d} is not in [1, 2^32)")
    low = d.bit_length() - 1
    if d & (d - 1) == 0:
        return (1 << 32) - 1, (1 << 32) - 1, low
    up = -(-(1 << (32 + low)) // d)
    if up * d - (1 << (32 + low)) <= 1 << low:
        return up, 0, low
    down = (1 << (32 + low)) // d
    return down, down, low


def fastmod(n: torch.Tensor, d: int) -> torch.Tensor:
    """``n % d`` for uint32 values ``n`` (int64) by the kernel's arithmetic
    on ``fastmod_magic(d)``: the high word of the 64-bit ``n * m + a``
    (``n`` split at 16 bits, so that every product stays below 2^48),
    shifted by ``l``."""
    m, a, low = fastmod_magic(d)
    lo = m * (n & 0xFFFF) + a                     # < 2^49
    hi = (m * (n >> 16) + (lo >> 16)) >> 16       # (n * m + a) >> 32
    return n - (hi >> low) * d


def noise_span(noise: int) -> int:
    """The span of the noise's ``randint(-noise, noise + 1)``."""
    return 2 * noise + 1 if noise >= 0 else 1


def check_geometry(size: int, block: int, shift_div: int) -> None:
    """Raise where the JAX generator fails: its ``jnp.repeat`` of the
    template by ``size // block`` must give the noise's ``size x size``."""
    if block < 1 or size < 1 or size % block != 0:
        raise ValueError(f"synth: image_size {size} is not a multiple of block "
                         f"{block}; the template cannot tile the image")
    if shift_div < 1:
        raise ValueError(f"synth: shift_div must be >= 1, got {shift_div}")


def _templates(master: tf.Key, gid: torch.Tensor, block: int) -> torch.Tensor:
    """(B, block*block*3) float32 templates of the identities ``gid``."""
    kb = tf.fold_in(master, gid.to(torch.int64)[:, None])
    idx = torch.arange(block * block * 3, dtype=torch.int64, device=gid.device)
    return tf.RandInt(kb, TEMPLATE_LO, TEMPLATE_HI).at(idx).to(torch.float32)


def _scalar_int(key: tf.Key, lo: int, hi: int) -> torch.Tensor:
    return tf.RandInt(key, lo, hi).at(0)


def _plain_chunk(keys, gids, bgids, bw, dseeds, master, size, noise, block,
                 expr, shift_div) -> torch.Tensor:
    dev = keys.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    ki = tf.fold_in(tf.fold_in(master, dseeds.to(torch.int64) + DSEED_BASE),
                    keys.to(torch.int64))
    bw = bw.to(torch.float32)[:, None]
    base = (f32(1.0) - bw) * _templates(master, gids, block) \
        + bw * _templates(master, bgids, block)
    if expr > 0.0:
        u = (f32(expr) * tf.uniform_at(tf.fold_in(ki, 5), 0).to(dev))[:, None]
        dgid = _scalar_int(tf.fold_in(ki, 6), DISTRACTOR_LO, DISTRACTOR_HI)
        base = (f32(1.0) - u) * base + u * _templates(master, dgid, block)
    scale = f32(0.75) + f32(0.5) * tf.uniform_at(tf.fold_in(ki, 1), 0).to(dev)
    offset = _scalar_int(tf.fold_in(ki, 2), OFFSET_LO, OFFSET_HI)
    amp = size // shift_div
    dy = _scalar_int(tf.fold_in(ki, 3), -amp, amp + 1)
    dx = _scalar_int(tf.fold_in(ki, 4), -amp, amp + 1)

    # output pixel (y, x) holds the pre-roll value at ((y-dy), (x-dx)) mod S
    ar = torch.arange(size, dtype=torch.int64, device=dev)
    ys = (ar[None, :] - dy[:, None]) % size                    # (B, S)
    xs = (ar[None, :] - dx[:, None]) % size
    c = torch.arange(3, dtype=torch.int64, device=dev)
    flat = ((ys[:, :, None, None] * size + xs[:, None, :, None]) * 3
            + c).reshape(len(keys), -1)                        # (B, S*S*3)
    rep = size // block
    tidx = (((ys // rep)[:, :, None, None] * block + (xs // rep)[:, None, :, None]) * 3
            + c).reshape(len(keys), -1)
    kn = tf.fold_in(ki, 0)
    n = tf.RandInt((kn[0][:, None], kn[1][:, None]), -noise, noise + 1).at(flat)
    img = torch.gather(base, 1, tidx) + n.to(torch.float32)
    img = img * scale[:, None] + offset.to(torch.float32)[:, None]
    return img.clamp(0, 255).to(torch.uint8).reshape(len(keys), size, size, 3)


def synth_generate_plain(keys: torch.Tensor, gids: torch.Tensor,
                         bgids: torch.Tensor, bw: torch.Tensor,
                         dseeds: torch.Tensor, master: tf.Key, size: int,
                         noise: int, block: int, expr: float,
                         shift_div: int) -> torch.Tensor:
    """The generator in plain PyTorch, ``PLAIN_CHUNK`` images at a time."""
    check_geometry(size, block, shift_div)
    c = PLAIN_CHUNK
    parts = [_plain_chunk(keys[s:s + c], gids[s:s + c], bgids[s:s + c],
                          bw[s:s + c], dseeds[s:s + c], master, size, noise,
                          block, expr, shift_div)
             for s in range(0, len(keys), c)]
    if not parts:
        return torch.empty((0, size, size, 3), dtype=torch.uint8, device=keys.device)
    return torch.cat(parts)


def _check(vecs: Tuple[torch.Tensor, ...]) -> None:
    dev, n = vecs[0].device, vecs[0].shape
    for name, t, dtype in zip(("keys", "gids", "bgids", "bw", "dseeds"), vecs,
                              (torch.int32, torch.int32, torch.int32,
                               torch.float32, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or t.shape != n:
            raise ValueError(f"{name} must be 1-D of the keys' length {tuple(n)}, "
                             f"got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, keys on {dev}")


def kernel_config(device: int, size: int, block: int) -> dict:
    """The built ``csrc/synth_gen.cu`` for images of ``size`` with ``block``
    x ``block`` templates, cached: threads, run (bytes a thread stores at
    once), blocks_per_sm (the occupancy query), registers (per thread), sms,
    smem_bytes, images_per_chunk (the most images a block's chunk may
    span)."""
    key = (device, size, block)
    if key not in _configs:
        fn = load_kernel("synth_gen").fedfr_synth_gen_config
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        vals = (ctypes.c_int * 7)()
        err = fn(device, size, block, vals)
        if err != 0 or vals[2] < 1:
            raise RuntimeError(f"synth_gen kernel does not fit on an SM at size {size}, "
                               f"block {block}: CUDA error {err}, {vals[2]} blocks per SM")
        _configs[key] = dict(zip(("threads", "run", "blocks_per_sm", "registers", "sms",
                                  "smem_bytes", "images_per_chunk"), vals))
    return _configs[key]


def launch_grid(batch: int, size: int, block: int, device: int) -> dict:
    """The grid for ``batch`` images: the batch's runs (flat over images)
    cut into equal chunks of whole warps, one a block, as many as the card
    runs at once (one wave) unless a chunk would span more than
    ``images_per_chunk`` images; ``fill`` is the share of the waves' thread
    steps that hold a run."""
    cfg = kernel_config(device, size, block)
    per_image = size * (3 * size // cfg["run"])
    runs = batch * per_image
    slots = cfg["sms"] * cfg["blocks_per_sm"]
    chunk = min(-(-runs // (slots * 32)) * 32, (cfg["images_per_chunk"] - 1) * per_image)
    blocks = -(-runs // chunk)
    return {**cfg, "runs": runs, "chunk": chunk, "blocks": blocks,
            "fill": runs / (-(-blocks // slots) * slots * chunk)}


def synth_generate(keys: torch.Tensor, gids: torch.Tensor, bgids: torch.Tensor,
                   bw: torch.Tensor, dseeds: torch.Tensor, master: tf.Key,
                   size: int, noise: int, block: int, expr: float,
                   shift_div: int) -> torch.Tensor:
    """(B, size, size, 3) uint8 images on the inputs' device.

    Inputs: ``keys``, ``gids``, ``bgids``, ``dseeds`` int32 and ``bw``
    float32, each (B,), on one device; ``master`` the universe key
    ``prng_key(seed)``.  CPU tensors take the plain version; CUDA tensors
    the kernel.
    """
    global synth_gen_launches
    vecs = (keys, gids, bgids, bw, dseeds)
    _check(vecs)
    check_geometry(size, block, shift_div)
    if keys.device.type == "cpu":
        return synth_generate_plain(*vecs, master, size, noise, block, expr,
                                    shift_div)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    out = torch.empty((keys.shape[0], size, size, 3), dtype=torch.uint8,
                      device=keys.device)
    if keys.shape[0] == 0:
        return out
    vecs = tuple(t.contiguous() for t in vecs)
    grid = launch_grid(keys.shape[0], size, block, out.device.index)
    fn = load_kernel("synth_gen").fedfr_synth_gen
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_uint, ctypes.c_uint] + \
        [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_uint,
                              ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p]
    m, a, low = fastmod_magic(noise_span(noise))
    err = fn(*(t.data_ptr() for t in vecs), master[0], master[1], keys.shape[0],
             size, noise, block, expr, shift_div, m, a, low, grid["run"],
             grid["chunk"], out.device.index, out.data_ptr(),
             torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"synth_gen kernel launch failed: CUDA error {err}")
    synth_gen_launches += 1
    return out
