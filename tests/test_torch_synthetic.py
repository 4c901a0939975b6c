"""The port's ``synth:`` universe against the JAX package's, on the CPU.

* PRNG: ``ops/threefry.py`` bit for bit equal to ``jax.random`` (keys,
  ``fold_in``, ``split``, 32-bit bits, ``randint`` including the span
  2^30 - 2^26 whose uint32 multiplier wraps to 0, ``uniform``).
* Universe: ``build_fl_synthetic`` gives the same labels, identities,
  blends, bases, seeds and lengths in both packages.
* Images: 0 differing bytes against JAX ``synth_device_batch`` (the
  generator's plain version; the card's kernel is held against it in
  tests/test_torch_kernels.py and chip_smoke.py), on client, public and veri
  splits, at 16 and 112 pixels, ``expr`` 0 and 0.5, ``shift_div`` 8 and 4.
* Loaders: ``CombinedDataset.device_batch`` equals its parts,
  ``BatchLoader`` pads synthetic sets, the errors JAX raises are raised.
* Two toy rounds of ``Server.train_round`` on a ``synth:`` root against the
  JAX ``Server``, within tests/test_torch_round.py's tolerances (losses
  rtol=1e-4, global weights and FC atol=1e-4, mined sizes exact).
* ``local_all`` on a ``synth:`` data dir against the JAX CLI, 1:1 and 1:n,
  within tests/test_torch_local_all.py's tolerances.
"""

import argparse
import os
import re
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import local_all as jax_local_all
from fedfr_tpu.config import FedFRConfig as JConfig
from fedfr_tpu.data import synthetic as jsyn
from fedfr_tpu.data.datasets import AllClientData as JData
from fedfr_tpu.federated import Server as JServer
from fedfr_tpu.federated.client import _run_key
from fedfr_tpu.federated.state import flip_mask
from fedfr_tpu.models import BCEModule as JBCE
from fedfr_tpu.models.factory import ToyNet as JToy
from fedfr_tpu.utils import torch_interop as ti
from fedfr_tpu.utils.checkpoint import save_native

from fedfr_tpu_torch import interop, local_all
from fedfr_tpu_torch.config import FedFRConfig
from fedfr_tpu_torch.data import AllClientData, BatchLoader, CombinedDataset
from fedfr_tpu_torch.data import synthetic as tsyn
from fedfr_tpu_torch.federated import Server
from fedfr_tpu_torch.ops import threefry as tf

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

SPANS = [(30, 226), (-18, 19), (-20, 21), (1 << 26, 1 << 30), (0, 1), (5, 5),
         (-3, 4), (-2 ** 31, 2 ** 31 - 1)]
SEEDS = [0, 100, 2 ** 31 - 1]


def _key(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def test_jax_prng_is_the_ported_one():
    assert jax.config.jax_threefry_partitionable is True, (
        "the port copies JAX's partitionable threefry bit layout; JAX now "
        "draws other bits, so the synth: universes of the two packages differ")
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_bits_uniform_match_jax(seed):
    k = jax.random.PRNGKey(seed)
    key = tf.prng_key(seed)
    assert key == _key(k)
    for d in (0, 1, 6, 1 << 30, (1 << 30) + 900_001, 2 ** 32 - 1):
        assert tf.fold_in(key, d) == _key(jax.random.fold_in(k, np.uint32(d)))
    assert list(tf.split(key)) == [_key(s) for s in jax.random.split(k)]
    assert list(tf.split(key, 3)) == [_key(s) for s in jax.random.split(k, 3)]
    bits = np.asarray(jax.random.bits(k, (5, 7), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(tf.random_bits(key, (5, 7)).numpy(), bits)
    u = np.asarray(jax.random.uniform(k, (3, 11)))
    np.testing.assert_array_equal(tf.uniform(key, (3, 11)).numpy().view(np.int32),
                                  u.view(np.int32))
    # keys as tensors, as the generator holds them: one fold per element
    data = torch.tensor([3, 77, 2 ** 31 + 5], dtype=torch.int64)
    k0, k1 = tf.fold_in(key, data)
    for i, d in enumerate(data.tolist()):
        assert (int(k0[i]), int(k1[i])) == _key(jax.random.fold_in(k, np.uint32(d)))


@pytest.mark.parametrize("lo,hi", SPANS)
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_randint_matches_jax(seed, lo, hi):
    k = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.randint(k, (6, 5), lo, hi)).astype(np.int64)
    np.testing.assert_array_equal(tf.randint(tf.prng_key(seed), (6, 5), lo, hi).numpy(),
                                  want)
    scalar = int(jax.random.randint(k, (), lo, hi))
    assert int(tf.randint(tf.prng_key(seed), (), lo, hi)) == scalar


def test_randint_wrapping_multiplier():
    """The distractor draw's span 2^30 - 2^26: (2^16)^2 wraps to 0 in
    uint32, so its multiplier is 0; exact integers would give 2^32 % span."""
    r = tf.RandInt(tf.prng_key(1), 1 << 26, 1 << 30)
    assert r.mult == 0 != (1 << 32) % r.span


SPEC = ("synth:clients=3,ids_per_client=4,imgs_min=5,imgs_max=7,public_ids=20,"
        "public_imgs=70,veri_ids=12,veri_imgs=3")


@pytest.mark.parametrize("spec", [
    SPEC + ",image_size=16",
    SPEC + ",public_imgs=30,public_imgs_min=2,public_imgs_max=3,blend=0.9,seed=7",
    "synth:clients=2,ids_per_client=3,public_ids=50,public_imgs=60,veri_ids=6",
], ids=["up", "down", "reference-counts"])
def test_universe_matches_jax(spec):
    assert tsyn.parse_synth_spec(spec) == jsyn.parse_synth_spec(spec)
    assert tsyn.explicit_synth_keys(spec) == jsyn.explicit_synth_keys(spec)
    got = tsyn.build_fl_synthetic(tsyn.parse_synth_spec(spec), device="cpu")
    want = jsyn.build_fl_synthetic(jsyn.parse_synth_spec(spec))
    pairs = list(zip(got["clients"], want["clients"])) + [
        (got["public"], want["public"]), (got["veri"], want["veri"])]
    assert len(got["clients"]) == len(want["clients"])
    for a, b in pairs:
        assert len(a) == len(b)
        for name in ("class_gids", "blend_gids", "blend_w"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        np.testing.assert_array_equal(a.all_labels(), b.all_labels())
        assert (a.id_base, a.dataset_seed, a.seed, a.num_classes) == (
            b.id_base, b.dataset_seed, b.seed, b.num_classes)
    assert tsyn.PUBLIC_GID_OFFSET == jsyn.PUBLIC_GID_OFFSET


@pytest.mark.parametrize("size,expr,shift_div", [
    (16, 0.0, 8), (16, 0.5, 4), (112, 0.5, 8), (112, 0.0, 4)])
def test_images_bitwise_equal_to_jax(size, expr, shift_div):
    spec = SPEC + f",image_size={size},expr={expr},shift_div={shift_div}"
    got = tsyn.build_fl_synthetic(tsyn.parse_synth_spec(spec), device="cpu")
    want = jsyn.build_fl_synthetic(jsyn.parse_synth_spec(spec))
    rng = np.random.default_rng(size + int(10 * expr) + shift_div)
    for split in ("clients", "public", "veri"):
        a, b = got[split], want[split]
        if split == "clients":
            a, b = a[2], b[2]
        pos = rng.integers(0, len(a), 12)  # one batch shape: one JAX compile
        imgs, tl = a.device_batch(pos)
        ji, jl = b.device_batch(pos)
        ji = np.asarray(ji)
        assert imgs.dtype == torch.uint8 and imgs.shape == ji.shape == (12, size, size, 3)
        assert int((imgs.numpy() != ji).sum()) == 0, split
        np.testing.assert_array_equal(tl, jl)


def test_combined_device_batch_equals_its_parts():
    u = tsyn.build_fl_synthetic(tsyn.parse_synth_spec(SPEC + ",image_size=16"),
                                device="cpu")
    local, public = u["clients"][1], u["public"].subset(np.array([3, 9, 10, 44]))
    comb = CombinedDataset(local, public)
    assert comb.is_device_synthetic and len(comb) == len(local) + 4
    pos = np.array([0, len(local) + 2, 5, len(local), len(local) + 3, 1])
    imgs, labels = comb.device_batch(pos)
    is_local = pos < len(local)
    li, ll = local.device_batch(pos[is_local])
    pi, pl = public.device_batch(pos[~is_local] - len(local))
    torch.testing.assert_close(imgs[torch.from_numpy(is_local)], li, rtol=0, atol=0)
    torch.testing.assert_close(imgs[torch.from_numpy(~is_local)], pi, rtol=0, atol=0)
    np.testing.assert_array_equal(labels[is_local], ll)
    np.testing.assert_array_equal(labels[~is_local], pl + local.num_classes)
    # splits of two universes do not combine
    other = tsyn.build_fl_synthetic(tsyn.parse_synth_spec(SPEC + ",image_size=16,seed=3"),
                                    device="cpu")
    with pytest.raises(AssertionError, match="one universe"):
        CombinedDataset(local, other["public"])


def test_batch_loader_pads_synthetic_batches():
    u = tsyn.build_fl_synthetic(tsyn.parse_synth_spec(SPEC + ",image_size=16"),
                                device="cpu")
    ds = u["veri"]  # 36 images
    with BatchLoader(ds, 16, shuffle=False, drop_last=False) as loader:
        batches = list(loader.epoch(with_positions=True))
    assert [b[0].shape[0] for b in batches] == [16, 16, 16]
    imgs, labels, valid, pos = batches[-1]
    assert isinstance(imgs, torch.Tensor) and valid.sum() == 4
    np.testing.assert_array_equal(pos, [32, 33, 34, 35] + [32] * 12)
    assert all(torch.equal(imgs[i], imgs[0]) for i in range(4, 16))
    np.testing.assert_array_equal(labels, ds.all_labels()[pos])
    want, _ = ds.device_batch(np.arange(32, 36))
    assert torch.equal(imgs[:4], want)


def test_errors_raised_where_jax_raises():
    bad = SPEC + ",public_imgs=10"
    for mod in (tsyn, jsyn):
        with pytest.raises(ValueError, match="public_imgs=10 < public_ids=20"):
            mod.build_fl_synthetic(mod.parse_synth_spec(bad))
    # a spec key that contradicts its CLI flag, in both packages
    for cfg, data in ((FedFRConfig(), AllClientData), (JConfig(), JData)):
        cfg.data.rec_root = SPEC
        cfg.data.num_clients = 2
        cfg.runtime.device = "cpu"
        with pytest.raises(ValueError, match="clients=3"):
            data(cfg)
    # a template that cannot tile the image (JAX fails in jnp.repeat)
    with pytest.raises(ValueError, match="not a multiple of block"):
        tsyn.build_fl_synthetic(tsyn.parse_synth_spec(SPEC + ",image_size=18"),
                                device="cpu")


# ----------------------------------------------------- two toy rounds

ROUND_SPEC = ("synth:imgs_min=7,imgs_max=9,public_ids=6,public_imgs=30,"
              "public_imgs_min=4,public_imgs_max=6,veri_ids=6,veri_imgs=4")
NUM_CLIENTS, IDS, IMG = 2, 3, 16


def _configure(cfg, root=ROUND_SPEC):
    cfg.data.rec_root = root
    cfg.data.num_clients = NUM_CLIENTS
    cfg.data.num_ids = NUM_CLIENTS * IDS
    cfg.data.image_size = IMG
    cfg.data.combined_batch_size = 8
    cfg.data.public_batch_size = 16
    cfg.data.eval_batch_size = 16
    cfg.data.num_workers = 2
    cfg.model.network = "toy"
    cfg.model.embedding_size = 16
    cfg.model.bf16 = False
    cfg.optim.lr = 0.01
    cfg.fed.local_epochs = 1   # round 1 then runs max(4, 1 - 2) = 4 epochs
    cfg.fed.client_parallel = False
    return cfg


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


def test_two_synth_rounds_match_jax_server():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jcfg = _configure(JConfig())
    jserver = JServer(jcfg, JData(jcfg))
    # mine about half the public set: a threshold between two middle scores
    from fedfr_tpu.federated.embed import embed_dataset, max_similarity
    pub, _ = embed_dataset(jserver._embed_fn, jserver.federated_vars,
                           jserver.data.public_dataset, 16)
    loc, _ = embed_dataset(jserver._embed_fn, jserver.federated_vars,
                           jserver.clients[0].dataset, 16)
    scores = np.sort(max_similarity(loc, pub, backend="xla"))
    threshold = float(scores[len(scores) // 2 - 1] + scores[len(scores) // 2]) / 2

    cfg = _configure(FedFRConfig())
    cfg.runtime.device = "cpu"
    jcfg.fed.hn_threshold = cfg.fed.hn_threshold = threshold
    server = Server(cfg, AllClientData(cfg))
    assert server.data.synthetic_universe is not None
    server.global_net.load_state_dict(
        interop.toy_state_dict(_np_tree(jserver.federated_vars)))
    server._init_pretrain_fc()
    np.testing.assert_allclose(server.pretrained_fc.numpy(),
                               np.asarray(jserver.pretrained_fc), atol=1e-5)
    for c, jc in zip(server.clients, jserver.clients):
        state = interop.client_state("toy", jc.fc_local, _np_tree(jc.bce_vars),
                                     _np_tree(jc.last_backbone))
        c.fc_local, c.bce_state, c.last_backbone = (
            state["fc_local"], state["bce_state"], state["last_backbone"])

        def flip_fn(step_no, imgs, cid=c.cid):
            key = jax.random.fold_in(_run_key(jcfg.runtime.seed,
                                              server.global_round, cid), step_no)
            return np.asarray(flip_mask(key, imgs.shape[0]))
        c.flip_fn = flip_fn

    mined = []
    for rnd in range(2):
        for s in (jserver, server):
            s.current_client_list = s.sample_clients()
        assert server.current_client_list == jserver.current_client_list
        jstats = jserver.train_round()
        stats = server.train_round()
        for c, jc in zip(server.clients, jserver.clients):
            assert c.dataset_size == jc.dataset_size, (rnd, c.cid)
            np.testing.assert_allclose(c.last_loss, jc.last_loss, rtol=1e-4,
                                       err_msg=f"round {rnd} client {c.cid}")
            mined.append(c.dataset_size - len(c.dataset))
        np.testing.assert_allclose(stats["avg_loss"], jstats["avg_loss"], rtol=1e-4)
        want = interop.toy_state_dict(_np_tree(jserver.federated_vars))
        for k, v in server.global_net.state_dict().items():
            if v.is_floating_point():
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-4,
                                           rtol=0, err_msg=k)
        np.testing.assert_allclose(server.pretrained_fc.numpy(),
                                   np.asarray(jserver.pretrained_fc), atol=1e-4)
        for s in (jserver, server):
            s.advance_round()
    assert any(0 < m < 30 for m in mined), mined
    # the round's phases were timed under the JAX package's span names
    assert set(server.timer.totals) == set(jserver.timer.totals)


# ---------------------------------------------------- local_all on synth:

EMB, VERI = 16, 4
N_POS = IDS * VERI * (VERI - 1) // 2
TPR_TOL = 100.0 / N_POS + 0.01
NUMBER = re.compile(r"-?\d+(\.\d+)?(e-?\d+)?")
LA_SPEC = (f"synth:clients={NUM_CLIENTS},ids_per_client={IDS},imgs_min=5,"
           f"imgs_max=7,public_ids=6,public_imgs=12,veri_ids={NUM_CLIENTS * IDS},"
           f"veri_imgs={VERI},image_size={IMG},expr=0.5")


@pytest.fixture(scope="module")
def jax_exports(tmp_path_factory):
    """clients/client_<c>/{backbone.npz, bce_module.pth} and backbone_0.npz,
    written by the JAX package's writers."""
    out = str(tmp_path_factory.mktemp("synth_exports"))
    jnet, jbce = JToy(embedding_size=EMB), JBCE(hidden=EMB, n_class=IDS)
    x0 = jnp.zeros((1, IMG, IMG, 3))
    rng = np.random.default_rng(3)
    for c in range(NUM_CLIENTS):
        cdir = os.path.join(out, "clients", f"client_{c}")
        os.makedirs(cdir)
        save_native(jax.device_get(jnet.init(jax.random.PRNGKey(10 + c), x0)),
                    os.path.join(cdir, "backbone.npz"))
        bvars = jax.tree_util.tree_map(np.array, jbce.init(
            jax.random.PRNGKey(20 + c), jnp.zeros((1, EMB)),
            jnp.zeros((1,), jnp.int32)))
        bvars["params"]["converter"]["dense"]["kernel"] += (
            0.3 * rng.standard_normal((EMB, EMB)).astype(np.float32))
        ti.save_pth(ti.bce_to_torch(bvars), os.path.join(cdir, "bce_module.pth"))
    save_native(jax.device_get(jnet.init(jax.random.PRNGKey(30), x0)),
                os.path.join(out, "backbone_0.npz"))
    return out


def _la_args(ckpt, backbone, task, epoch, data_dir=LA_SPEC, num_ids=NUM_CLIENTS * IDS):
    return argparse.Namespace(
        backbone=backbone, task=task, ckpt_path=ckpt, data_dir=data_dir,
        gallery_data_dir="", epoch=epoch, num_client=NUM_CLIENTS,
        num_ids=num_ids, embedding_size=EMB, network="toy", gpu=None,
        fp16=False, batch_size=16, fp32=True, converter_layer=1, device="cpu")


@pytest.mark.parametrize("backbone,task,epoch", [
    ("multi", "1:1", -1), ("multi", "1:n", -1), ("single", "1:n", 0)],
    ids=["multi-1:1", "multi-1:n", "single-1:n"])
def test_local_all_on_synth_matches_jax(jax_exports, tmp_path, backbone, task, epoch):
    logs = []
    for side in ("jax", "port"):
        ckpt = str(tmp_path / side)
        shutil.copytree(jax_exports, ckpt)
        args = _la_args(ckpt, backbone, task, epoch)
        (jax_local_all.main if side == "jax" else local_all.main)(args)
        with open(os.path.join(ckpt, "local_log.txt")) as f:
            logs.append(f.read().splitlines())
    jlines, lines = logs
    assert len(lines) == len(jlines) > 0
    for got, want in zip(lines, jlines):
        assert NUMBER.sub("#", got) == NUMBER.sub("#", want)
        a = [float(m.group(0)) for m in NUMBER.finditer(got)]
        b = [float(m.group(0)) for m in NUMBER.finditer(want)]
        if got.startswith(("Target label", "1:1 at", "1:n at", "Far")):
            assert a == b
        elif got.startswith("Pr"):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        else:  # per-client TPR tables and their mean, in percent
            np.testing.assert_allclose(a, b, atol=TPR_TOL, rtol=0)


def test_local_all_synth_checks_match_jax(tmp_path):
    """JAX's two ValueErrors: the spec and the flags disagree on the
    clients, and the veri split does not cover --num_ids."""
    for data_dir, num_ids, match in ((LA_SPEC.replace("clients=2", "clients=3"),
                                      NUM_CLIENTS * IDS, "clients=3"),
                                     (LA_SPEC.replace("veri_ids=6", "veri_ids=4"),
                                      NUM_CLIENTS * IDS, "veri_ids=4")):
        for main in (jax_local_all.main, local_all.main):
            with pytest.raises(ValueError, match=match):
                main(_la_args(str(tmp_path), "multi", "1:1", -1, data_dir, num_ids))
