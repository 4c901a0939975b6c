"""The port's convergence chain (``fedfr_tpu_torch/convergence.py`` and
``data/split.py``) against the JAX package, on the CPU.

* ``split_fl`` / ``split_pretrain`` write byte for byte the files of
  ``split_dataset/split_FL.py`` / ``split_pretrain.py`` (each script run as
  its own process seeds ``random`` with 100 at import), on the chain's
  source and on a source with ragged image counts; ``gen_source`` writes the
  bytes of ``experiments/convergence_tpu.py::gen_source``;
* the plain step learns class separation as ``tests/test_convergence.py``'s
  does, from the JAX initial weights (carried by ``interop``) on both
  packages, with JAX's flip masks, in fp32, the first ``FP32_EPOCHS``
  epochs' losses within ``FP32_LOSS_RTOL`` of the JAX run's; in float64
  the port's separation gain is within ``SEPARATION_TOL`` of the JAX run's;
* the port's whole chain at ``tests/test_convergence.py``'s sizes and
  arguments (toy, E=32, 24x24, 2 clients x 8 IDs, 4 public IDs, 3 rounds,
  lr 0.02, ``--spreadout --init_fc``, ``HN_threshold -1``) from that
  test's random initial weights meets its two criteria with its numbers;
* the toy net's init is the JAX net's (flax's lecun-normal kernels, where
  the port took PyTorch's default, a third of the variance);
* both pretraining CLIs (lr 0.05, the default; fp32; 8 epochs at one lr)
  from the same initial weights: every logged loss within ``LOSS_TOL``, the
  final median feature norm within ``LOG10_NORM_TOL`` decades of the JAX
  run's, and both norms grown over ``NORM_GROWTH`` x: the recipe's growth,
  shared by the JAX package.
"""

import argparse
import contextlib
import filecmp
import importlib.util
import os
import random
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pretrain as jax_pretrain
import split_dataset.split_FL as sfl
import split_dataset.split_pretrain as spre
from fedfr_tpu.data import codec as jcodec
from fedfr_tpu.data import write_split as jwrite_split
from fedfr_tpu.data.datasets import BatchLoader as JBatchLoader
from fedfr_tpu.data.datasets import FaceRecordDataset as JDataset
from fedfr_tpu.federated.embed import embed_dataset as jembed
from fedfr_tpu.federated.embed import make_embed_fn
from fedfr_tpu.federated.state import flip_mask
from fedfr_tpu.federated.trainer import init_client_state as jinit_state
from fedfr_tpu.federated.trainer import make_plain_train_step as jplain_step
from fedfr_tpu.models import build_backbone as jax_backbone
from fedfr_tpu.utils.checkpoint import load_native, save_native

from fedfr_tpu_torch import convergence as conv
from fedfr_tpu_torch import interop
from fedfr_tpu_torch import pretrain as port_pretrain
from fedfr_tpu_torch.data import BatchLoader, FaceRecordDataset
from fedfr_tpu_torch.data.split import split_fl, split_pretrain
from fedfr_tpu_torch.federated.embed import embed_dataset
from fedfr_tpu_torch.federated.trainer import init_client_state, make_plain_train_step
from fedfr_tpu_torch.models import build_backbone

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the separation gains of the two packages after 180 plain steps at lr
# 0.05 from the same weights and flips, float64 both: 0.7694406949822
# (JAX) against gaps of 8.4e-13, 1.5e-13, 5.5e-13 and 4.6e-13 at 1, 2, 4
# and 8 torch threads.  In fp32 the gaps were 0.0114, 0.0026, 0.0250 and
# 1e-5: the order of the CPU's fp32 sums, compounded over the steps.
SEPARATION_TOL = 1e-9
# the plain runs' per-epoch losses in fp32 over the first 10 epochs (30
# steps): at most 3.3e-7 apart, relative, at 1, 2, 3, 4, 6 and 8 torch
# threads; later the sum order's drift builds up (0.39 to 5.5 by epoch 60)
FP32_EPOCHS, FP32_LOSS_RTOL = 10, 2e-6
# pretraining: the logs print 4 decimals (measured: equal), 2 units
LOSS_TOL = 2e-4
# log10 of the final median feature norm (measured: 5670.96 against
# 5671.86, 7e-5 decades)
LOG10_NORM_TOL = 1e-3
# both packages' median feature norm after 8 epochs over the initial one
# (measured: 0.64 -> 5671, 8,850 x)
NORM_GROWTH = 100.0


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _harness():
    spec = importlib.util.spec_from_file_location(
        "convergence_tpu", os.path.join(REPO, "experiments", "convergence_tpu.py"))
    exp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exp)
    return exp


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_tree(a, b):
    assert _files(a) == _files(b)
    for rel in _files(a):
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel


def _ragged_source(src):
    """18 IDs of 6..12 images (the scripts' count filter drops some)."""
    rng = np.random.default_rng(7)
    payloads, labels = [], []
    for pid in range(18):
        for _ in range(int(rng.integers(6, 13))):
            payloads.append(jcodec.encode_raw(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)))
            labels.append(pid)
    os.makedirs(src)
    jwrite_split(os.path.join(src, "train.idx"), os.path.join(src, "train.rec"),
                 payloads, labels, num_classes=18)


def _script(module, name, argv):
    """One split script in process, as tests/helpers.py drives them, seeded
    as its own process seeds at import (split_FL.py:32-33,
    split_pretrain.py:26-27)."""
    random.seed(100)
    old = sys.argv
    try:
        sys.argv = [name] + [str(a) for a in argv]
        module.main()
    finally:
        sys.argv = old


# (split_FL flags, split_pretrain flags) on the chain's source (24 IDs x 10
# images of 24x24) and on 18 IDs of 6..12 images that the count filters thin
SPLITS = {
    "chain": (dict(num_client=2, num_id=8, min_imgs=10, max_imgs=10, test_imgs=4),
              dict(num_id=4, min_imgs=10, max_imgs=10)),
    "ragged": (dict(num_client=3, num_id=3, min_imgs=8, max_imgs=10, test_imgs=3),
               dict(num_id=2, min_imgs=7, max_imgs=11)),
}


@pytest.mark.parametrize("source", sorted(SPLITS))
def test_split_matches_split_dataset(tmp_path, source):
    src = str(tmp_path / "src")
    if source == "chain":
        conv.gen_source(src, total_ids=24, image_size=24, imgs_per_id=10)
    else:
        _ragged_source(src)
    fl, pub = SPLITS[source]
    jout, tout = str(tmp_path / "scripts"), str(tmp_path / "port")
    _script(sfl, "split_FL.py", ["--data_dir", src, "--output_dir", jout,
                                 "--num_client", fl["num_client"], "--num_ID", fl["num_id"],
                                 "--min_imgs", fl["min_imgs"], "--max_imgs", fl["max_imgs"],
                                 "--test_imgs", fl["test_imgs"]])
    _script(spre, "split_pretrain.py", ["--data_dir", src, "--output_dir", jout,
                                        "--num_ID", pub["num_id"], "--min_imgs",
                                        pub["min_imgs"], "--max_imgs", pub["max_imgs"]])
    state = random.getstate()
    got = split_fl(src, tout, **fl)
    root = split_pretrain(src, tout, **pub)
    assert random.getstate() == state  # the caller's stream is left alone
    assert root == os.path.join(tout, f"split_pretrain_{pub['num_id']}")
    assert got["veri_dir"] == os.path.join(tout, f"local_veri_{fl['num_id']}")
    assert got["veri_imgs"] == fl["num_id"] * fl["test_imgs"]
    _assert_same_tree(jout, tout)

    if source == "chain":
        exp = _harness()
        exp.IMG, exp.IMGS_PER_ID = 24, 10
        exp.gen_source(str(tmp_path / "harness_src"), total_ids=24)
        _assert_same_tree(str(tmp_path / "harness_src"), src)



@pytest.mark.parametrize("which", ["fl", "pretrain"])
def test_split_refuses_too_few_ids(tmp_path, which):
    """More IDs asked for than pass the count filter raise, as the scripts
    stop (split_FL.py:103-104, split_pretrain.py:52)."""
    src = str(tmp_path / "src")
    _ragged_source(src)
    with pytest.raises(ValueError, match="IDs"):
        if which == "fl":
            split_fl(src, str(tmp_path / "out"), num_client=1, num_id=18, min_imgs=8,
                     max_imgs=10)
        else:
            split_pretrain(src, str(tmp_path / "out"), num_id=18, min_imgs=8, max_imgs=10)

def _class_separation(feats, labels):
    """tests/test_convergence.py's: mean intra-class cosine minus mean
    inter-class cosine."""
    f = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    sim = f @ f.T
    same = labels[:, None] == labels[None, :]
    np.fill_diagonal(same, False)
    off = ~np.eye(len(f), dtype=bool)
    return sim[same].mean() - sim[off & ~same].mean()


def _separation_setup(root):
    """tests/test_convergence.py:27's data (4 classes of 12 noisy copies of
    one random 24x24 image, written to ``root``) and initial weights, fp32
    -> (backbone, variables, FC rows, key)."""
    rng = np.random.default_rng(0)
    n_cls, per, hw = 4, 12, 24
    payloads, labels = [], []
    for c in range(n_cls):
        base = rng.integers(0, 255, size=(hw, hw, 3))
        for _ in range(per):
            img = np.clip(base + rng.integers(-25, 25, (hw, hw, 3)), 0, 255)
            payloads.append(jcodec.encode_raw(img.astype(np.uint8)))
            labels.append(c)
    root.mkdir()
    jwrite_split(str(root / "train.idx"), str(root / "train.rec"), payloads, labels,
                 num_classes=n_cls, id_base=0)
    backbone = jax_backbone("toy", 16)
    key = jax.random.PRNGKey(0)
    bvars = jax.device_get(backbone.init(key, jnp.zeros((1, hw, hw, 3)), train=False))
    fc = np.array(0.01 * jax.random.normal(key, (n_cls, 16)))
    return backbone, bvars, fc, key


def _jax_plain_run(root, backbone, bvars, fc, key):
    """180 plain steps at lr 0.05 (60 epochs of 3 batches) of the JAX
    package -> (per-epoch losses, separation before, after, labels)."""
    jds = JDataset(str(root))
    state = jinit_state(bvars, jnp.asarray(fc), None)
    jstep = jplain_step(backbone)
    embed_fn = make_embed_fn(backbone)
    feats0, labs = jembed(embed_fn, bvars, jds, 16)
    losses, n_steps = [], 0
    loader = JBatchLoader(jds, 16, shuffle=True, seed=1, drop_last=True)
    for _ in range(60):
        for imgs, lbl, valid in loader.epoch():
            state, loss = jstep(state, jnp.asarray(imgs), jnp.asarray(lbl),
                                jnp.asarray(valid), 0.05, key, n_steps)
            n_steps += 1
        losses.append(float(loss))
    feats1, _ = jembed(embed_fn, jax.device_get(state.backbone), jds, 16)
    return (losses, _class_separation(np.asarray(feats0), labs),
            _class_separation(np.asarray(feats1), labs), labs)


def _port_plain_run(root, net, fc, key):
    """The same steps on the port, with the JAX run's flip masks."""
    ds = FaceRecordDataset(str(root))
    f0, labs = embed_dataset(net, ds, 16, device="cpu")
    tstate = init_client_state(net, fc, None, lr=0.05)
    step = make_plain_train_step()
    losses, n_steps = [], 0
    with BatchLoader(ds, 16, shuffle=True, seed=1, drop_last=True) as loader:
        for _ in range(60):
            for imgs, lbl, valid in loader.epoch():
                flip = torch.from_numpy(np.array(flip_mask(
                    jax.random.fold_in(key, n_steps), imgs.shape[0])))
                tstate, loss = step(tstate, torch.from_numpy(imgs), torch.from_numpy(lbl),
                                    torch.from_numpy(valid), 0.05, flip)
                n_steps += 1
            losses.append(float(loss))
    f1, _ = embed_dataset(net, ds, 16, device="cpu")
    return (losses, _class_separation(f0.numpy(), labs),
            _class_separation(f1.numpy(), labs), labs)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX package
    pins its images, layers and losses to float32 by that name."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@contextlib.contextmanager
def _float64(monkeypatch):
    """Both packages' plain steps in float64 inside the block: JAX under
    ``jax.enable_x64`` with the modules on the toy step's path (images,
    layers, cosine logits, CE) reading ``jnp.float32`` as float64, and
    ``conv3x3``'s default dtype with them; the port with float64 as torch's
    default dtype (the margin's scalars) and ``Tensor.float`` made
    ``Tensor.double``, as tests/test_torch_lockstep.py's float64 step test
    does."""
    from fedfr_tpu.federated import state as jstate
    from fedfr_tpu.models import heads as jheads
    from fedfr_tpu.models import layers as jlayers
    from fedfr_tpu.ops import losses as jlosses

    default = torch.get_default_dtype()
    with monkeypatch.context() as mp, jax.enable_x64(True):
        for mod in (jstate, jheads, jlayers, jlosses):
            mp.setattr(mod, "jnp", _Float64Numpy())
        mp.setattr(jlayers.conv3x3, "__defaults__", tuple(
            jnp.float64 if d is jnp.float32 else d for d in jlayers.conv3x3.__defaults__))
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        torch.set_default_dtype(torch.float64)
        try:
            yield
        finally:
            torch.set_default_dtype(default)


def _plain_runs(root, init, dtype=torch.float32):
    """Both packages' plain runs from ``_separation_setup``'s weights cast
    to ``dtype``, with the same flips -> (JAX run, port run), each as
    ``_jax_plain_run`` returns."""
    backbone, bvars, fc, key = init
    net = build_backbone("toy", 16)
    net.load_state_dict(interop.backbone_state_dict("toy", bvars))
    fc = torch.from_numpy(fc).to(dtype)
    bvars = jax.tree_util.tree_map(lambda a: np.asarray(a, fc.numpy().dtype), bvars)
    return (_jax_plain_run(root, backbone, bvars, fc.numpy(), key),
            _port_plain_run(root, net.to(dtype), fc, key))


def test_plain_training_learns_separation(tmp_path, monkeypatch):
    """tests/test_convergence.py:27's data, weights, steps and criteria, on
    both packages from the same weights and flips: in fp32 each package
    meets the criteria and the first epochs' losses agree; the two
    packages' separation gains are compared in float64, where the order of
    the CPU's sums cannot build up over the 180 steps (in fp32 the port's
    gain moves by up to 0.025 with torch's thread count)."""
    init = _separation_setup(tmp_path / "ds")
    jrun, trun = _plain_runs(tmp_path / "ds", init)
    np.testing.assert_array_equal(trun[3], jrun[3])
    for losses, sep0, sep1, _ in (jrun, trun):
        assert losses[-1] < losses[0] - 3.0, (losses[0], losses[-1])
        assert sep1 > sep0 + 0.1, (sep0, sep1)
    assert abs(trun[1] - jrun[1]) < 1e-5, (trun[1:3], jrun[1:3])  # the same start
    np.testing.assert_allclose(trun[0][:FP32_EPOCHS], jrun[0][:FP32_EPOCHS],
                               rtol=FP32_LOSS_RTOL)

    with _float64(monkeypatch):
        jrun, trun = _plain_runs(tmp_path / "ds", init, torch.float64)
    assert abs(trun[1] - jrun[1]) < 1e-10, (trun[1:3], jrun[1:3])
    gap = abs((trun[2] - trun[1]) - (jrun[2] - jrun[1]))
    assert gap < SEPARATION_TOL, (trun[1:3], jrun[1:3])


def test_full_cli_chain_improves_metrics(tmp_path):
    """tests/test_convergence.py:76 on the port: the chain's data and
    splits, then the training CLI with that test's arguments from its
    initial weights (the JAX ``Server``'s init from ``PRNGKey(seed)``,
    written as a root's ``backbone.npz``), then local_all, all on the CPU;
    its two criteria with its numbers."""
    root = tmp_path / "init"
    root.mkdir()
    save_native(jax.device_get(jax_backbone("toy", 32).init(
        jax.random.PRNGKey(100), jnp.zeros((1, 24, 24, 3)), train=False)),
        str(root / "backbone.npz"))
    args = conv.build_parser().parse_args([
        "--work_dir", str(tmp_path / "chain"), "--network", "toy", "--embed", "32",
        "--image_size", "24", "--num_clients", "2", "--num_ids", "8", "--rounds", "3",
        "--local_epoch", "2", "--imgs_per_id", "10", "--pretrain_epochs", "0",
        "--lr", "0.02", "--device", "cpu"])
    torch.manual_seed(0)  # the clients' toy MOON models draw from the global RNG
    summary = conv.run_chain(args, pub_ids=4, n_pairs=48, pretrained_root=str(root),
                             train_extra=["--public_batch_size", "16",
                                          "--eval_batch_size", "16", "--HN_threshold", "-1"])

    accs = [a for _, a in summary["agedb_per_round"]]
    assert len(accs) == 3
    assert accs[-1] >= accs[0], accs
    base = summary["local_tpr_at_1e-1_baseline_mean"]
    trained = summary["local_tpr_at_1e-1_trained_mean"]
    assert accs[-1] > accs[0] + 0.02 or trained > base + 2.0, (accs, base, trained)
    crit = summary["criteria"]
    assert crit["not_worse"] and crit["learned"], crit
    assert len(summary["xnorm_per_round"]) == len(summary["avg_loss_per_round"]) == 3
    assert np.all(np.isfinite(summary["xnorm_per_round"] + summary["avg_loss_per_round"]))
    assert len(summary["local_tpr_per_round"]) == 3
    assert len(summary["local_all_mean_tpr"]) == 6
    assert summary["collapse_warnings"] == 0
    assert set(summary["stage_seconds"]) == {"data", "train", "local_all"}
    assert "loaded pretrained backbone from" in open(tmp_path / "chain" / "run" /
                                                     "training.log").read()
    # on the CPU the plain versions run: no kernel launch
    assert all(v == {"max_sim": 0, "roc_hist": 0} for v in summary["launches"].values())


def test_toy_init_is_the_jax_nets():
    """The port's toy kernels have the JAX net's spread (flax's
    lecun-normal, variance 1 / fan_in): each weight's standard deviation
    within 10% of the JAX init's over 64 seeds; the fc bias 0."""
    jstd, tstd = {}, {}
    for seed in range(64):
        v = jax_backbone("toy", 64).init(jax.random.PRNGKey(seed),
                                         jnp.zeros((1, 16, 16, 3)), train=False)
        sd = interop.backbone_state_dict("toy", jax.device_get(v))
        torch.manual_seed(seed)
        net = build_backbone("toy", 64)
        for k, w in net.state_dict().items():
            if k.endswith("weight") and w.dim() > 1:
                jstd.setdefault(k, []).append(float(sd[k].std()))
                tstd.setdefault(k, []).append(float(w.std()))
        assert torch.equal(net.fc.bias, torch.zeros(64))
    assert set(tstd) == {"conv1.weight", "conv2.weight", "fc.weight"}
    for k in tstd:
        ratio = np.mean(tstd[k]) / np.mean(jstd[k])
        assert abs(ratio - 1.0) < 0.1, (k, ratio)


LOSS_RE = re.compile(r"Loss (\S+)\s+Epoch: (\d+)\s+Global Step: (\d+)")


def _losses(out):
    with open(os.path.join(out, "pretrain.log")) as f:
        return [(int(m.group(3)), float(m.group(1))) for m in LOSS_RE.finditer(f.read())]


def test_pretrain_norms_track_jax(tmp_path, monkeypatch):
    """ROADMAP §C item 1: both pretraining CLIs at the default lr 0.05 for
    8 epochs at one lr (toy, E=16, 24x24, a 64-image public set, fp32),
    from the JAX CLI's initial weights."""
    root = tmp_path / "public"
    root.mkdir()
    rng = np.random.default_rng(0)
    payloads, labels = [], []
    for pid in range(8):
        base = rng.integers(0, 200, size=(24, 24, 3))
        for _ in range(8):
            img = np.clip(base + rng.integers(-20, 20, (24, 24, 3)), 0, 255)
            payloads.append(jcodec.encode_raw(img.astype(np.uint8)))
            labels.append(pid)
    jwrite_split(str(root / "train.idx"), str(root / "train.rec"), payloads, labels,
                 num_classes=8)
    common = dict(network="toy", loss="CosFace", embedding_size=16, image_size=24,
                  batch_size=16, num_epoch=8, lr=0.05, lr_steps="9", scale=64.0,
                  margin=0.4, momentum=0.9, weight_decay=5e-4, sample_rate=1.0,
                  num_workers=2, log_every=2, seed=100, fp32=True, scan_blocks=False)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jout.mkdir()
    jax_pretrain.main(argparse.Namespace(data_dir=str(root), output_dir=str(jout),
                                         resume=False, **common))

    backbone = jax_backbone("toy", 16, bf16=False)
    variables = jax.device_get(backbone.init(jax.random.PRNGKey(100),
                                             jnp.zeros((1, 24, 24, 3)), train=False))
    w0 = 0.01 * jax.random.normal(jax.random.PRNGKey(101), (8, 16))

    def initial_state(args, num_classes):
        net = build_backbone("toy", 16)
        net.load_state_dict(interop.backbone_state_dict("toy", variables))
        return net, torch.from_numpy(np.array(w0))

    monkeypatch.setattr(port_pretrain, "initial_state", initial_state)
    args = port_pretrain.build_parser().parse_args(
        ["--data_dir", str(root), "--output_dir", str(tout), "--device", "cpu"])
    vars(args).update(common)
    out = port_pretrain.main(args)
    assert out["epochs"] == list(range(8)) and set(out["lr"]) == {0.05}

    lj, lt = _losses(jout), _losses(tout)
    assert [s for s, _ in lt] == [s for s, _ in lj] == list(range(4, 33, 2))
    np.testing.assert_allclose([v for _, v in lt], [v for _, v in lj], rtol=0, atol=LOSS_TOL)

    jds, ds = JDataset(str(root)), FaceRecordDataset(str(root))
    embed_fn = make_embed_fn(backbone)

    def jnorm(v):
        return float(np.median(np.linalg.norm(
            np.asarray(jembed(embed_fn, v, jds, 16, l2norm=False)[0]), axis=1)))

    def tnorm(net):
        return float(embed_dataset(net, ds, 16, l2norm=False, device="cpu")[0]
                     .norm(dim=1).median())
    net0, _ = initial_state(None, 8)
    j0, t0 = jnorm(variables), tnorm(net0)
    j1 = jnorm(load_native(str(jout / "backbone.npz")))
    net1 = build_backbone("toy", 16)
    net1.load_state_dict(torch.load(tout / "backbone.pth"))
    t1 = tnorm(net1)
    assert abs(np.log10(t0) - np.log10(j0)) < LOG10_NORM_TOL, (t0, j0)
    assert abs(np.log10(t1) - np.log10(j1)) < LOG10_NORM_TOL, (t1, j1)
    # the recipe's norm growth, alike in both packages
    assert j1 > NORM_GROWTH * j0 and t1 > NORM_GROWTH * t0, (j0, j1, t0, t1)


def test_chip_smoke_convergence_phase_rehearsed_on_cpu(tmp_path):
    """The smoke's phase 15 (15a gated on the criteria, the lr-0 control
    15b on failing them, 15c printed) at the chain test's sizes on
    sphnet20 at 16x16 (BN-free like sphere64: at lr 0 nothing moves; the
    toy net's BN statistics would), with 2 pretraining epochs; on the CPU
    no kernel launches."""
    argv = ["--network", "sphnet20", "--embed", "32", "--image_size", "16", "--num_clients", "2",
            "--num_ids", "8", "--imgs_per_id", "10", "--pretrain_epochs", "2",
            "--pretrain_lr", "0.001", "--rounds", "2", "--local_epoch", "2", "--lr", "0.02"]
    launches = chip_smoke.phase_convergence(
        str(tmp_path), argv=argv, device="cpu", pub_ids=4, n_pairs=48,
        train_extra=("--public_batch_size", "16", "--eval_batch_size", "16",
                     "--HN_threshold", "-1"))
    assert launches == {"max_sim": 0, "roc_hist": 0, "synth_gen": 0}
    assert os.path.exists(tmp_path / "a" / "pre" / "backbone.pth")
    assert sorted(os.listdir(tmp_path / "a" / "run" / "clients")) == ["client_0", "client_1"]


def test_chain_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    """``python -m fedfr_tpu_torch.convergence`` runs on ``cuda`` unless
    ``--device cpu``, and raises with no GPU before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    work = tmp_path / "work"
    assert conv.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        conv.main(["--work_dir", str(work)])
    assert not work.exists()
