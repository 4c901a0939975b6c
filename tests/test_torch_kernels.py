"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (a CUDA kernel has no CPU mode)
and skip without one.  The file imports torch only, so on a machine with a
card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import pytest
import torch

from fedfr_tpu_torch.ops import max_sim


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
