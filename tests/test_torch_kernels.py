"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (a CUDA kernel has no CPU mode)
and skip without one.  The file imports torch only, so on a machine with a
card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from fedfr_tpu_torch.data import CombinedDataset, synthetic
from fedfr_tpu_torch.ops import max_sim, roc_hist, synth_gen

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)


def _unit_rows(n, e, gen):
    x = torch.randn(n, e, device="cuda", generator=gen)
    return x / x.norm(dim=1, keepdim=True)


# The mining kernel computes on bf16 operands with fp32 sums.  Against its
# oracle (the plain version on the same bf16 operands) only the order of the
# fp32 sums differs: 1e-5.  Against the fp32 plain version each operand is
# rounded by at most 2^-8 relative, so for unit rows the score moves by at
# most 2^-7 (Cauchy-Schwarz).
MINING_BF16_TOL = 1e-5
MINING_FP32_TOL = 2.0 ** -7


def _check_max_sim(pub, loc):
    """The kernel on (pub, loc) against the bf16 oracle and the fp32 plain
    version; returns the kernel's result."""
    torch.backends.cuda.matmul.allow_tf32 = False
    got = max_sim.max_cosine_similarity(pub, loc)
    oracle = max_sim.max_cosine_similarity_plain(pub.bfloat16(), loc.bfloat16())
    fp32 = max_sim.max_cosine_similarity_plain(pub.float(), loc.float())
    torch.cuda.synchronize()
    assert got.shape == (pub.shape[0],) and got.dtype == torch.float32
    assert float((got - oracle).abs().max()) <= MINING_BF16_TOL
    assert float((got - fp32).abs().max()) <= MINING_FP32_TOL
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n_pub,n_loc,e", [
    (130, 65, 512),     # ragged: neither count a multiple of the 128 tile
    (1, 1, 512),
    (1000, 300, 100),   # width padded to the kernel's 64-wide K-chunk
])
def test_max_sim_kernel_matches_plain(n_pub, n_loc, e):
    """Within 1e-5 of the bf16 oracle and 2^-7 of the fp32 plain version,
    and one counted launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(n_pub + n_loc + e)
    pub, loc = _unit_rows(n_pub, e, gen), _unit_rows(n_loc, e, gen)
    before = max_sim.max_sim_launches
    _check_max_sim(pub, loc)
    assert max_sim.max_sim_launches == before + 1


@pytest.mark.cuda
def test_max_sim_kernel_all_negative_ragged():
    """Every true score is negative and n_loc % 128 != 0: the zero rows that
    TMA fills past the local edge must not enter the max."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(7)
    u = _unit_rows(1, 512, gen)
    loc = u + 0.3 * _unit_rows(300, 512, gen)
    pub = -u + 0.3 * _unit_rows(1000, 512, gen)
    loc, pub = loc / loc.norm(dim=1, keepdim=True), pub / pub.norm(dim=1, keepdim=True)
    got = _check_max_sim(pub, loc)
    assert float(got.max()) < -0.5


@pytest.mark.cuda
def test_max_sim_kernel_takes_bf16_operands_as_they_are():
    """A bf16 operand in the kernel's layout is read without a copy and
    gives what its fp32 source gives (the same bf16 values), padded or not;
    a bf16 public set pairs with an fp32 local set, as mining passes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(8)
    for e in (512, 100):
        pub, loc = _unit_rows(700, e, gen), _unit_rows(200, e, gen)
        pub_k, loc_k = max_sim.kernel_operand(pub), max_sim.kernel_operand(loc)
        assert max_sim.kernel_operand(pub_k) is pub_k
        got = max_sim.max_cosine_similarity(pub_k, loc_k)
        want = max_sim.max_cosine_similarity(pub, loc)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        _check_max_sim(pub.bfloat16(), loc)


@pytest.mark.cuda
def test_max_sim_one_launch_per_call():
    """Each CUDA call counts exactly one launch; a CPU call and an empty
    public set count none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(9)
    pub, loc = _unit_rows(300, 512, gen), _unit_rows(129, 512, gen)
    before = max_sim.max_sim_launches
    for _ in range(3):
        max_sim.max_cosine_similarity(pub, loc)
    assert max_sim.max_sim_launches == before + 3
    max_sim.max_cosine_similarity(pub.cpu(), loc.cpu())
    out = max_sim.max_cosine_similarity(pub[:0], loc)
    torch.cuda.synchronize()
    assert out.shape == (0,)
    assert max_sim.max_sim_launches == before + 3


@pytest.mark.cuda
def test_max_sim_wrapper_rejects_wide_rows():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    with pytest.raises(ValueError, match="512"):
        max_sim.max_cosine_similarity(torch.randn(4, 520, device="cuda"),
                                      torch.randn(3, 520, device="cuda"))


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
    (300, 300, 100, False),    # width not a multiple of the 32-wide K slice
    (1000, 333, 100, True),    # E = 100: zero-padded K columns
    (4099, 1000, 16, True),    # N = 4,099: a ragged last j-tile
    (4099, 129, 100, True),    # T = 129: one target past the first diagonal tile
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
@pytest.mark.parametrize("n,t,cuts", [
    (4099, 1000, (0, 2050, 4099)),                  # two shards
    (4099, 1000, (0, 1367, 2734, 4099)),            # three
    (4099, 1000, (0, 513, 1026, 4099, 4099)),       # an empty shard
    (4099, 129, (0, 100, 4099)),                    # the targets span shards
])
def test_roc_hist_ranges_add_up_bitwise(n, t, cuts):
    """The kernel's j-range form keeps each pair's fp32 FFMA chain, so the
    ranges' histograms add up bit for bit to the whole on unit rows at the
    reference width (no tolerance: not dyadic), one launch a non-empty
    range; and the mesh's sharded histogram over two shards of this card
    equals the whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import importlib

    from fedfr_tpu_torch.parallel.mesh import data_mesh
    rh = importlib.import_module("fedfr_tpu_torch.ops.roc_histogram")
    gen = torch.Generator(device="cuda").manual_seed(n + t)
    feats = _unit_rows(n, 512, gen)
    labels = (torch.arange(n, device="cuda", dtype=torch.int32) // 40).contiguous()
    whole = roc_hist.roc_histogram(feats, labels, t)
    before = roc_hist.roc_hist_launches
    parts = [roc_hist.roc_histogram_range(feats[:t], labels[:t], feats[a:b].contiguous(),
                                          labels[a:b].contiguous(), a)
             for a, b in zip(cuts, cuts[1:])]
    torch.cuda.synchronize()
    assert roc_hist.roc_hist_launches - before == sum(b > a for a, b in zip(cuts, cuts[1:]))
    assert torch.equal(sum(parts), whole)
    sharded = rh.pairwise_roc_histogram_sharded(data_mesh(devices=["cuda:0"] * 2),
                                                feats, labels, t)
    assert torch.equal(sharded, whole)


@pytest.mark.cuda
def test_launchers_leave_the_current_device():
    """Each launcher and config call runs on its tensors' device (the last
    card) and gives the caller its current device back."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    gen = torch.Generator(device=dev).manual_seed(3)
    pub, loc = _unit_rows(300, 512, gen).to(dev), _unit_rows(70, 512, gen).to(dev)
    max_sim.max_cosine_similarity(pub, loc)
    assert torch.cuda.current_device() == 0
    labels = torch.zeros(300, dtype=torch.int32, device=dev)
    roc_hist.kernel_config(dev.index)
    roc_hist.roc_histogram(pub, labels, 50)
    assert torch.cuda.current_device() == 0
    universe = synthetic.build_fl_synthetic(synthetic.parse_synth_spec(
        "synth:image_size=16,imgs_min=4,imgs_max=4,public_ids=4,public_imgs=8,"
        "veri_ids=2,veri_imgs=2,clients=1,ids_per_client=2"), device=dev)
    universe["public"].device_batch(np.arange(4))
    assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev)


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


# The synth: generator: its images are integers, so the kernel must equal
# its plain version byte for byte (every float op rounded alone, in JAX's
# order, on both).  The batch sizes cover one image, the combined training
# batch (256) and the embeds' (512), and the ragged sizes beside them: the
# kernel cuts a batch's runs into one wave of equal chunks, so a chunk may
# end inside an image.  Templates of block 32 and 64 take more than 48 KB of
# shared memory in all (four of them a block).
@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 255, 256, 257, 512])
@pytest.mark.parametrize("spec", [
    "synth:", "synth:expr=0.5,shift_div=4", "synth:image_size=64,block=8,noise=40",
    "synth:image_size=64,block=32", "synth:image_size=64,block=64,expr=0.5"])
def test_synth_gen_kernel_bitwise_equal_to_plain(spec, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    universe = synthetic.build_fl_synthetic(synthetic.parse_synth_spec(spec),
                                            device="cuda")
    rng = np.random.default_rng(batch)
    sources = (universe["clients"][5], universe["public"], universe["veri"])
    counts = (batch // 4, batch // 2, batch - batch // 4 - batch // 2)
    parts = [ds.synth_vectors(rng.integers(0, len(ds), k))[:5]
             for ds, k in zip(sources, counts)]
    vecs = [torch.from_numpy(np.concatenate(v)).cuda() for v in zip(*parts)]
    ds = universe["public"]
    args = (synth_gen.tf.prng_key(ds.seed), ds.image_size, ds.noise, ds.block,
            ds.expr, ds.shift_div)
    before = synth_gen.synth_gen_launches
    got = synth_gen.synth_generate(*vecs, *args)
    want = synth_gen.synth_generate_plain(*vecs, *args)
    torch.cuda.synchronize()
    assert synth_gen.synth_gen_launches == before + 1
    assert got.shape == (batch, ds.image_size, ds.image_size, 3)
    assert int((got != want).sum()) == 0


@pytest.mark.cuda
def test_synth_gen_kernel_combined_batch_bitwise_equal_to_plain():
    """A mixed local + public training batch of 256, drawn as the training
    step draws it (``CombinedDataset.device_batch``, one launch), equals the
    same batch of the same universe built on the CPU (the plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    spec = synthetic.parse_synth_spec("synth:expr=0.5")
    combined = []
    for device in ("cuda", "cpu"):
        universe = synthetic.build_fl_synthetic(spec, device=device)
        public = universe["public"].subset(np.arange(0, 420_000, 64))  # ~6,500 mined
        combined.append(CombinedDataset(universe["clients"][3], public))
    pos = np.random.default_rng(4).permutation(len(combined[0]))[:256]
    assert 64 < int((pos < combined[0].local_len).sum()) < 192
    before = synth_gen.synth_gen_launches
    got, labels = combined[0].device_batch(pos)
    want, want_labels = combined[1].device_batch(pos)
    torch.cuda.synchronize()
    assert synth_gen.synth_gen_launches == before + 1
    assert got.shape == (256, 112, 112, 3)
    assert int((got.cpu() != want).sum()) == 0
    np.testing.assert_array_equal(labels, want_labels)


@pytest.mark.cuda
def test_lockstep_step_matches_sequential_on_card():
    """The K=2 lockstep step (sphnet20, bf16 trunk, batch 32 at 112x112) on
    the card against two sequential steps from the same state: every loss
    term, the updated weights and the BN statistics within the smoke's
    bound (``chip_smoke.LOCKSTEP_TOL_FACTOR`` x the sequential step's
    distance from the same step in fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the lockstep step is checked on the card")
    import chip_smoke
    from fedfr_tpu_torch import train as train_cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = train_cli.build_parser().parse_args(chip_smoke.round_args(
        "unused", 2, 100, network="sphnet20"))
    cfg = train_cli.build_config(args)
    m = chip_smoke.step_members(cfg, "sphnet20", 2, 112, 32, 200, torch.device("cuda"),
                                seed=3)
    out = chip_smoke.compare_lockstep_step(cfg, m, False, "sphnet20 card test")
    assert all(out["max_abs_diff"][q] <= out["tol"][q] for q in out["tol"])
