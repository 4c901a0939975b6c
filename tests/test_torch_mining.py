"""Hard-negative mining in the port against the JAX package.

* the plain version of the mining kernel against the Pallas kernel run in
  interpret mode, on the cases of ``tests/test_pallas.py`` plus an E=512
  case: atol=1e-5;
* ``hard_negative_mask`` and the ``hn_cap`` selection against the JAX
  package's.

The CUDA kernel against its plain version is in ``test_torch_kernels.py``,
which imports no JAX so that it runs on the card.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fedfr_tpu.config import FedFRConfig as JConfig
from fedfr_tpu.data.datasets import FaceRecordDataset as JDataset
from fedfr_tpu.federated.client import Client as JClient
from fedfr_tpu.federated.embed import embed_dataset as j_embed
from fedfr_tpu.federated.embed import hard_negative_mask as j_hard_negative_mask
from fedfr_tpu.federated.embed import make_embed_fn
from fedfr_tpu.models import BCEModule as JBCE
from fedfr_tpu.models.factory import ToyNet as JToy
from fedfr_tpu.ops.pallas_kernels import max_cosine_similarity as j_max_sim

from fedfr_tpu_torch import interop
from fedfr_tpu_torch.config import FedFRConfig
from fedfr_tpu_torch.data import FaceRecordDataset, codec, write_split
from fedfr_tpu_torch.federated import Client, hard_negative_mask
from fedfr_tpu_torch.models import BCEModule, ToyNet
from fedfr_tpu_torch.ops import max_cosine_similarity, max_cosine_similarity_plain

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)


def _unit(rng, n, e):
    x = rng.standard_normal((n, e)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n_pub,n_loc,e,tile_p,tile_l", [
    (300, 70, 128, 128, 64),    # tests/test_pallas.py:8
    (130, 65, 128, 128, 64),    # tests/test_pallas.py:20 (ragged, padding)
    (200, 33, 512, 128, 128),   # the reference embedding width
])
def test_plain_matches_pallas_interpret(n_pub, n_loc, e, tile_p, tile_l):
    rng = np.random.default_rng(n_pub + n_loc)
    pub, loc = _unit(rng, n_pub, e), _unit(rng, n_loc, e)
    want = np.asarray(j_max_sim(pub, loc, tile_p=tile_p, tile_l=tile_l,
                                interpret=True))
    got = max_cosine_similarity(torch.from_numpy(pub), torch.from_numpy(loc))
    assert got.shape == (n_pub,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the wrapper takes the plain version on the CPU
    np.testing.assert_array_equal(
        got.numpy(), max_cosine_similarity_plain(torch.from_numpy(pub),
                                                 torch.from_numpy(loc)).numpy())


@pytest.mark.parametrize("n_pub,n_loc,e,tile_p,tile_l", [
    (300, 70, 128, 128, 64),
    (130, 65, 128, 128, 64),
    (200, 33, 512, 128, 128),
])
def test_bf16_plain_matches_pallas_interpret(n_pub, n_loc, e, tile_p, tile_l):
    """The card's function (the plain version on bf16 operands) against the
    Pallas kernel fed the same inputs rounded to bf16 by jnp: atol 1e-5."""
    rng = np.random.default_rng(n_pub * n_loc + e)
    pub, loc = _unit(rng, n_pub, e), _unit(rng, n_loc, e)

    def jnp_bf16(x):
        return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    want = np.asarray(j_max_sim(jnp_bf16(pub), jnp_bf16(loc), tile_p=tile_p,
                                tile_l=tile_l, interpret=True))
    got = max_cosine_similarity(torch.from_numpy(pub).bfloat16(),
                                torch.from_numpy(loc).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # bf16 rounding moves a score by at most 2^-7 for unit rows
    exact = (pub @ loc.T).max(1)
    assert np.abs(got.numpy() - exact).max() <= 2.0 ** -7


def _bf16_bits_torch(x):
    return torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()


def _bf16_bits_jnp(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)


def test_bf16_rounding_matches_jnp():
    """torch's fp32 -> bf16 rounding is bit-equal to jnp's: on random values
    and on constructed halfway ties (low 16 bits 0x8000, upper half even and
    odd) and their neighbours, which round to nearest even."""
    rng = np.random.default_rng(3)
    rand = (rng.standard_normal(100_000)
            * 10.0 ** rng.integers(-6, 6, 100_000)).astype(np.float32)
    np.testing.assert_array_equal(_bf16_bits_torch(rand), _bf16_bits_jnp(rand))
    sign = rng.integers(0, 2, 4096, dtype=np.uint32) << 31
    exponent = rng.integers(100, 150, 4096, dtype=np.uint32) << 23
    upper = (sign | exponent | (rng.integers(0, 1 << 7, 4096, dtype=np.uint32) << 16))
    ties = np.concatenate([upper | low for low in (0x7FFF, 0x8000, 0x8001)])
    ties = ties.view(np.float32)
    got = _bf16_bits_torch(ties)
    np.testing.assert_array_equal(got, _bf16_bits_jnp(ties))
    # halfway ties round to the even upper half
    half = (upper | 0x8000).view(np.float32)
    even = _bf16_bits_torch(half).view(np.uint16).astype(np.uint32)
    assert (even & 1 == 0).all()


@pytest.mark.parametrize("e", [100, 512, 16])
def test_kernel_operand_pads_and_casts(e):
    """The wrapper's pad-and-cast helper, on the CPU: bf16, width rounded up
    to 64 with zero columns, the values rounded as ``Tensor.to`` rounds;
    an operand already in the layout comes back as it is; the results of
    the plain version and of the wrapper do not change."""
    from fedfr_tpu_torch.ops.max_sim import kernel_operand

    rng = np.random.default_rng(e)
    pub = torch.from_numpy(_unit(rng, 90, e))
    loc = torch.from_numpy(_unit(rng, 40, e))
    pk, lk = kernel_operand(pub), kernel_operand(loc)
    width = -(-e // 64) * 64
    assert pk.dtype == torch.bfloat16 and pk.shape == (90, width)
    assert pk.is_contiguous() and kernel_operand(pk) is pk
    assert torch.equal(pk[:, :e], pub.to(torch.bfloat16))
    assert not pk[:, e:].any() and not lk[:, e:].any()
    want = max_cosine_similarity_plain(pub.bfloat16(), loc.bfloat16())
    np.testing.assert_allclose(max_cosine_similarity_plain(pk, lk).numpy(),
                               want.numpy(), atol=1e-6)
    np.testing.assert_allclose(max_cosine_similarity(pk, lk).numpy(),
                               want.numpy(), atol=1e-6)


def test_wrapper_takes_float32_and_bfloat16_only():
    """bf16 and fp32 operands mix (the plain version upcasts both); a padded
    operand pairs only with another of its width; other float types raise."""
    from fedfr_tpu_torch.ops.max_sim import kernel_operand

    rng = np.random.default_rng(4)
    pub, loc = torch.from_numpy(_unit(rng, 30, 100)), torch.from_numpy(_unit(rng, 7, 100))
    mixed = max_cosine_similarity(pub.bfloat16(), loc)
    np.testing.assert_array_equal(
        mixed.numpy(), max_cosine_similarity_plain(pub.bfloat16().float(), loc).numpy())
    with pytest.raises(ValueError, match="widths"):
        max_cosine_similarity(kernel_operand(pub), loc)
    with pytest.raises(TypeError, match="bfloat16"):
        max_cosine_similarity(pub.half(), loc.half())


def test_wrapper_rejects_bad_inputs():
    pub = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="empty"):
        max_cosine_similarity(pub, torch.zeros(0, 8))
    with pytest.raises(ValueError, match="widths"):
        max_cosine_similarity(pub, torch.zeros(3, 6))
    with pytest.raises(TypeError, match="float32"):
        max_cosine_similarity(pub.double(), torch.zeros(3, 8).double())
    with pytest.raises(ValueError, match="contiguous"):
        max_cosine_similarity(torch.zeros(8, 4).t(), torch.zeros(3, 8))


def test_hard_negative_mask_matches_jax():
    """Same mask as the JAX package's exact (xla) path, away from scores
    within 1e-5 of the threshold."""
    rng = np.random.default_rng(5)
    loc = _unit(rng, 40, 64)
    lean = rng.random((500, 1)).astype(np.float32)
    pub = lean * loc[rng.integers(0, 40, 500)] + (1 - lean) * _unit(rng, 500, 64)
    pub /= np.linalg.norm(pub, axis=1, keepdims=True)
    want = np.asarray(j_hard_negative_mask(loc, pub, 0.4, backend="xla"))
    got = hard_negative_mask(torch.from_numpy(loc), torch.from_numpy(pub), 0.4).numpy()
    near = np.abs((pub @ loc.T).max(1) - 0.4) < 1e-5
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got[~near], want[~near])


IMG = 16


@pytest.fixture(scope="module")
def mining_split(tmp_path_factory):
    """A 3-ID local split and a 6-ID public split of 16x16 images."""
    root = tmp_path_factory.mktemp("mining")
    rng = np.random.default_rng(11)
    for name, ids, per in (("local", 3, 4), ("public", 6, 5)):
        d = root / name
        os.makedirs(d)
        imgs = [rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8)
                for _ in range(ids * per)]
        write_split(str(d / "train.idx"), str(d / "train.rec"),
                    [codec.encode_raw(im) for im in imgs],
                    [i // per for i in range(ids * per)], num_classes=ids,
                    id_base=0)
    return str(root)


@pytest.mark.parametrize("cap", [0, 7], ids=["threshold", "hn_cap"])
def test_select_hard_negatives_matches_jax(mining_split, cap):
    """Client.select_hard_negatives picks the same public images as the JAX
    client: every image above the threshold, or with ``hn_cap`` the cap
    hardest of those (DESIGN.md deviation 8)."""
    jcfg, cfg = JConfig(), FedFRConfig()
    for c in (jcfg, cfg):
        c.model.network, c.model.embedding_size = "toy", 8
        c.data.image_size, c.data.eval_batch_size = IMG, 8
        c.fed.hn_cap = cap
        c.fed.contrastive = c.fed.bce_local = False
    cfg.runtime.device = "cpu"
    jnet = JToy(embedding_size=8)
    jvars = jax.tree_util.tree_map(np.array, jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))))

    jlocal = JDataset(os.path.join(mining_split, "local"))
    jpub = JDataset(os.path.join(mining_split, "public"))
    jclient = JClient(0, jcfg, jlocal, jnet, JBCE(8, 3), np.random.default_rng(0))
    embed = make_embed_fn(jnet)
    jpub_feats, _ = j_embed(embed, jvars, jpub, 8, l2norm=True)
    jloc_feats, _ = j_embed(embed, jvars, jlocal, 8, l2norm=True)
    # a threshold halfway between two middle scores: about half the public
    # set is mined, and no score lies near the cut
    scores = np.sort((jpub_feats @ jloc_feats.T).max(1))
    mid = len(scores) // 2 - (4 if cap else 0)
    threshold = float(scores[mid - 1] + scores[mid]) / 2
    jcfg.fed.hn_threshold = cfg.fed.hn_threshold = threshold
    want = jclient.select_hard_negatives(jvars, jpub, jpub_feats,
                                         jpub.all_labels()).imgidx

    net = ToyNet(embedding_size=8)
    net.load_state_dict(interop.toy_state_dict(jvars))
    net.eval()
    local = FaceRecordDataset(os.path.join(mining_split, "local"))
    pub = FaceRecordDataset(os.path.join(mining_split, "public"))
    client = Client(0, cfg, local, net, BCEModule(8, 3))
    pub_feats = torch.from_numpy(np.array(jpub_feats))
    got = client.select_hard_negatives(net, pub, pub_feats, pub.all_labels()).imgidx
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < len(pub)
    if cap:
        assert len(got) == cap

