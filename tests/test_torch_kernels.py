"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (a CUDA kernel has no CPU mode)
and skip without one.  The file imports torch only, so on a machine with a
card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import pytest
import torch

from fedfr_tpu_torch.ops import max_sim, roc_hist


def _unit_rows(n, e, gen):
    x = torch.randn(n, e, device="cuda", generator=gen)
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pub,n_loc,e", [
    (130, 65, 512),     # ragged: neither count a multiple of the 128 tile
    (1, 1, 512),
    (1000, 300, 100),   # width not a multiple of the 8-wide K slice
])
def test_max_sim_kernel_matches_plain(n_pub, n_loc, e):
    """max abs error <= 1e-5 (fp32 FFMA against cuBLAS fp32 sums), and one
    counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(n_pub + n_loc + e)
    pub, loc = _unit_rows(n_pub, e, gen), _unit_rows(n_loc, e, gen)
    before = max_sim.max_sim_launches
    got = max_sim.max_cosine_similarity(pub, loc)
    assert max_sim.max_sim_launches == before + 1
    want = max_sim.max_cosine_similarity_plain(pub, loc)
    torch.cuda.synchronize()
    assert got.shape == (n_pub,)
    assert float((got - want).abs().max()) <= 1e-5


def _near_edge_pairs(feats, target_size):
    """Pairs (i < target_size, i < j) whose fp64 similarity lies within 1e-6
    of a bin edge: the only pairs that a different fp32 sum order may move
    by one bin."""
    f = feats.double()
    sim = f[:target_size] @ f.t()
    x = (sim + 1.0) * 1000.0
    near = (x - x.round()).abs() < 1e-3
    i = torch.arange(target_size, device=feats.device)[:, None]
    j = torch.arange(feats.shape[0], device=feats.device)[None, :]
    return int((near & (i < j)).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,e,dyadic", [
    (100, 37, 16, True),     # tests/test_pallas.py:36-45, exact on both sides
    (64, 64, 16, True),
    (50, 3, 16, False),
    (4097, 1000, 512, False),  # ragged 128-tiles at the reference width
    (300, 300, 100, False),    # width not a multiple of the 8-wide K slice
])
def test_roc_hist_kernel_matches_plain(n, t, e, dyadic):
    """Dyadic entries make every dot exact in fp32, so the histograms are
    identical.  Otherwise the pos and neg totals are equal and the L1 bin
    difference is at most 2 x the pairs within 1e-6 of a bin edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(n + t + e)
    if dyadic:
        vals = torch.tensor([0.0, 0.125, -0.125, 0.25, -0.25], device="cuda")
        feats = vals[torch.randint(0, 5, (n, e), device="cuda", generator=gen)]
    else:
        feats = _unit_rows(n, e, gen)
    labels = torch.randint(0, 7, (n,), device="cuda", generator=gen,
                           dtype=torch.int32)
    before = roc_hist.roc_hist_launches
    got = roc_hist.roc_histogram(feats, labels, t)
    assert roc_hist.roc_hist_launches == before + 1
    want = roc_hist.roc_histogram_plain(feats, labels, t)
    torch.cuda.synchronize()
    assert got.shape == (2 * roc_hist.NUM_BINS,) and got.dtype == torch.int64
    assert int(got.sum()) == t * n - t * (t + 1) // 2
    if dyadic:
        assert torch.equal(got, want)
    else:
        assert int(got[0::2].sum()) == int(want[0::2].sum())
        assert int(got[1::2].sum()) == int(want[1::2].sum())
        assert int((got - want).abs().sum()) <= 2 * _near_edge_pairs(feats, t)


@pytest.mark.cuda
def test_roc_hist_kernel_empty_target_does_not_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    feats = torch.randn(1000, 16, device="cuda")
    labels = torch.zeros(1000, dtype=torch.int32, device="cuda")
    before = roc_hist.roc_hist_launches
    out = roc_hist.roc_histogram(feats, labels, 0)
    assert roc_hist.roc_hist_launches == before
    assert out.shape == (2 * roc_hist.NUM_BINS,) and int(out.abs().sum()) == 0


@pytest.mark.cuda
def test_roc_hist_wrapper_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    feats = torch.randn(10, 16, device="cuda")
    labels = torch.zeros(10, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        roc_hist.roc_histogram(feats.double(), labels, 5)
    with pytest.raises(TypeError):
        roc_hist.roc_histogram(feats, labels.long(), 5)
    with pytest.raises(ValueError):
        roc_hist.roc_histogram(torch.randn(10, 32, device="cuda")[:, ::2], labels, 5)
    with pytest.raises(ValueError):
        roc_hist.roc_histogram(feats, labels.cpu(), 5)
