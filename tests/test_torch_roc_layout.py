"""The ROC kernel's host side on the CPU: its K-major operand and the grid
fit.

The kernel itself (``csrc/roc_hist.cu``) runs only on the card
(``tests/test_torch_kernels.py``); what surrounds it is Python that these
tests reach: the zero-padded K-major copy it reads and the split of the grid
to one wave.  The file imports torch only.
"""

import numpy as np
import pytest
import torch

from fedfr_tpu_torch.ops import roc_hist

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)


def _dyadic(n, e, seed):
    """Entries in {0, +-1/8, +-1/4}: every dot is exact in fp32, so any sum
    order (and any number of zero terms) gives the same histogram."""
    rng = np.random.default_rng(seed)
    vals = np.array([0.0, 0.125, -0.125, 0.25, -0.25], np.float32)
    feats = torch.from_numpy(vals[rng.integers(0, 5, size=(n, e))])
    labels = torch.from_numpy(rng.integers(0, 7, size=n).astype(np.int32))
    return feats, labels


@pytest.mark.parametrize("n,e,rows,k", [
    (5, 3, 4, 16),
    (4099, 100, 128, 32),   # both padded
    (256, 512, 128, 32),    # neither padded
    (130, 7, 256, 16),
    (9, 0, 128, 32),        # E = 0 still gets one K-slice of zeros
])
def test_kernel_operand_is_k_major_and_zero_padded(n, e, rows, k):
    """The targets (the first third of the rows) K-major in columns 0..,
    every row from column ``b_col`` on (T rounded up to ``rows``), zeros
    in every other column and past E."""
    feats = torch.from_numpy(
        np.random.default_rng(n + e).standard_normal((n, e)).astype(np.float32))
    t = n // 3
    out, b_col = roc_hist.kernel_operand(feats[:t], feats, rows, k)
    e_pad, n_cols = out.shape
    assert out.dtype == torch.float32 and out.is_contiguous()
    assert b_col % rows == 0 and t <= b_col < t + rows
    n_pad = n_cols - b_col
    assert n_pad % rows == 0 and n <= n_pad < n + rows
    assert e_pad % k == 0 and max(e, 1) <= e_pad < max(e, 1) + k
    assert torch.equal(out[:e, :t], feats[:t].t())
    assert torch.equal(out[:e, b_col:b_col + n], feats.t())
    assert int((out[e:] != 0).sum()) == 0
    assert int((out[:, t:b_col] != 0).sum()) == 0
    assert int((out[:, b_col + n:] != 0).sum()) == 0


@pytest.mark.parametrize("n,t,e", [
    (1000, 333, 100),   # E = 100: zero-padded K columns
    (4099, 129, 100),   # T = 129: one target past the first diagonal tile
    (300, 300, 16),
])
def test_plain_histogram_on_the_padded_copy_is_unchanged(n, t, e):
    """Zero K columns add exact zeros to every dot: the plain histogram of
    the kernel's operand, read back row-major, equals the original's."""
    feats, labels = _dyadic(n, e, seed=n + t + e)
    padded, b_col = roc_hist.kernel_operand(feats[:t], feats, 128, 32)
    back = padded.t()[b_col:b_col + n].contiguous()
    targets = padded.t()[:t].contiguous()
    assert back.shape == (n, -(-e // 32) * 32)
    want = roc_hist.roc_histogram_plain(feats, labels, t)
    assert int(want.sum()) == t * n - t * (t + 1) // 2
    assert torch.equal(roc_hist.roc_histogram_plain(back, labels, t), want)
    assert torch.equal(roc_hist.roc_histogram_range_plain(
        targets, labels[:t], back, labels, 0), want)


@pytest.mark.parametrize("i_tiles,j_tiles,sms,per_sm,want", [
    (32, 1250, 132, 2, 8),   # the reference shape: 256 of 264 slots
    (32, 1250, 132, 1, 4),   # one block per SM: 128 of 132
    (1, 3, 132, 2, 3),       # never more splits than j-tiles
    (300, 1250, 132, 2, 1),  # a grid wider than a wave: one split
    (32, 10 ** 6, 10 ** 5, 32, 65535),  # CUDA's grid-row limit
])
def test_fit_splits_cases(i_tiles, j_tiles, sms, per_sm, want):
    assert roc_hist.fit_splits(i_tiles, j_tiles, sms, per_sm) == want


def test_fit_splits_fills_at_most_one_wave():
    """At least 1 and at most j_tiles splits; never more blocks than one
    wave unless the i-tiles alone exceed it.  At the reference shape 9
    splits of 32 i-tiles (288 blocks against 264 resident) would run in two
    waves; the fit gives 8, one wave."""
    for sms in (1, 7, 132):
        for per_sm in (1, 2, 3):
            wave = sms * per_sm
            for i_tiles in (1, 2, 31, 32, 33, 263, 264, 265, 1000):
                for j_tiles in (1, 2, 9, 1250):
                    s = roc_hist.fit_splits(i_tiles, j_tiles, sms, per_sm)
                    assert 1 <= s <= j_tiles
                    assert i_tiles * s <= max(wave, i_tiles)
    s = roc_hist.fit_splits(32, 1250, 132, 2)
    assert 32 * s <= 264 < 288


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """A CPU call never builds or launches the kernel: it is
    roc_histogram_plain, and counts no launch."""
    def no_kernel(*_):
        raise AssertionError("the CPU path reached the kernel")
    monkeypatch.setattr(roc_hist, "load_kernel", no_kernel)
    feats, labels = _dyadic(300, 16, seed=3)
    before = roc_hist.roc_hist_launches
    got = roc_hist.roc_histogram(feats, labels, 100)
    assert torch.equal(got, roc_hist.roc_histogram_plain(feats, labels, 100))
    assert roc_hist.roc_hist_launches == before


def test_launch_grid_fits_the_reference_shape_to_one_wave(monkeypatch):
    """The grid from the kernel's reported config: at 4,000 targets of
    160,000 rows with 128 x 128 tiles and 2 blocks on each of 132 SMs,
    32 i-tiles x 8 splits = 256 blocks, 0.97 of a wave."""
    cfg = {"bm": 128, "bn": 128, "bk": 32, "blocks_per_sm": 2,
           "threads": 256, "smem_bytes": 114824, "sms": 132}
    monkeypatch.setattr(roc_hist, "kernel_config", lambda device: cfg)
    grid = roc_hist.launch_grid(160_000, 4_000, 0)
    assert grid == {"i_tiles": 32, "splits": 8, "blocks": 256,
                    "blocks_per_sm": 2, "waves": 256 / 264}
    cfg["blocks_per_sm"] = 1   # a build that fits one block per SM
    assert roc_hist.launch_grid(160_000, 4_000, 0)["blocks"] == 128
