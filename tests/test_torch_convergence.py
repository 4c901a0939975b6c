"""The port's convergence chain (``fedfr_tpu_torch/convergence.py`` and
``data/split.py``) against the JAX package, on the CPU.

* ``split_fl`` / ``split_pretrain`` write byte for byte the files of
  ``split_dataset/split_FL.py`` / ``split_pretrain.py`` (each script run as
  its own process seeds ``random`` with 100 at import), on the chain's
  source and on a source with ragged image counts; ``gen_source`` writes the
  bytes of ``experiments/convergence_tpu.py::gen_source``;
* the plain step learns class separation as ``tests/test_convergence.py``'s
  does, from the JAX initial weights (carried by ``interop``) on both
  packages, with JAX's flip masks: the port's separation gain within
  ``SEPARATION_TOL`` of the JAX run's;
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the separation gains of the two packages after 180 plain steps at lr
# 0.05 from the same weights and flips, fp32 both: 1.11214 against
# 1.11215 (measured gap 1e-5)
SEPARATION_TOL = 1e-3
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


def test_plain_training_learns_separation(tmp_path):
    """tests/test_convergence.py:27's data, weights, steps and criteria, on
    both packages from the same weights and flips."""
    rng = np.random.default_rng(0)
    n_cls, per, hw = 4, 12, 24
    payloads, labels = [], []
    for c in range(n_cls):
        base = rng.integers(0, 255, size=(hw, hw, 3))
        for _ in range(per):
            img = np.clip(base + rng.integers(-25, 25, (hw, hw, 3)), 0, 255)
            payloads.append(jcodec.encode_raw(img.astype(np.uint8)))
            labels.append(c)
    root = tmp_path / "ds"
    root.mkdir()
    jwrite_split(str(root / "train.idx"), str(root / "train.rec"), payloads, labels,
                 num_classes=n_cls, id_base=0)

    backbone = jax_backbone("toy", 16)
    key = jax.random.PRNGKey(0)
    bvars = jax.device_get(backbone.init(key, jnp.zeros((1, hw, hw, 3)), train=False))
    fc = np.array(0.01 * jax.random.normal(key, (n_cls, 16)))

    # JAX
    jds = JDataset(str(root))
    state = jinit_state(bvars, jnp.asarray(fc), None)
    jstep = jplain_step(backbone)
    embed_fn = make_embed_fn(backbone)
    feats0, labs = jembed(embed_fn, bvars, jds, 16)
    jlosses, n_steps = [], 0
    jloader = JBatchLoader(jds, 16, shuffle=True, seed=1, drop_last=True)
    for _ in range(60):
        for imgs, lbl, valid in jloader.epoch():
            state, loss = jstep(state, jnp.asarray(imgs), jnp.asarray(lbl),
                                jnp.asarray(valid), 0.05, key, n_steps)
            n_steps += 1
        jlosses.append(float(loss))
    feats1, _ = jembed(embed_fn, jax.device_get(state.backbone), jds, 16)
    jsep = (_class_separation(np.asarray(feats0), labs),
            _class_separation(np.asarray(feats1), labs))

    # the port
    net = build_backbone("toy", 16)
    net.load_state_dict(interop.backbone_state_dict("toy", bvars))
    ds = FaceRecordDataset(str(root))
    f0, tlabs = embed_dataset(net, ds, 16, device="cpu")
    tstate = init_client_state(net, torch.from_numpy(fc), None, lr=0.05)
    step = make_plain_train_step()
    tlosses, n_steps = [], 0
    with BatchLoader(ds, 16, shuffle=True, seed=1, drop_last=True) as loader:
        for _ in range(60):
            for imgs, lbl, valid in loader.epoch():
                flip = torch.from_numpy(np.array(flip_mask(
                    jax.random.fold_in(key, n_steps), imgs.shape[0])))
                tstate, loss = step(tstate, torch.from_numpy(imgs), torch.from_numpy(lbl),
                                    torch.from_numpy(valid), 0.05, flip)
                n_steps += 1
            tlosses.append(float(loss))
    f1, _ = embed_dataset(net, ds, 16, device="cpu")
    np.testing.assert_array_equal(tlabs, labs)
    tsep = (_class_separation(f0.numpy(), tlabs), _class_separation(f1.numpy(), tlabs))

    for losses, (sep0, sep1) in ((jlosses, jsep), (tlosses, tsep)):
        assert losses[-1] < losses[0] - 3.0, (losses[0], losses[-1])
        assert sep1 > sep0 + 0.1, (sep0, sep1)
    assert abs(tsep[0] - jsep[0]) < 1e-5, (tsep, jsep)  # the same start
    assert abs((tsep[1] - tsep[0]) - (jsep[1] - jsep[0])) < SEPARATION_TOL, (tsep, jsep)


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


@pytest.fixture
def one_thread():
    """One intra-op thread: on a worker that shares the CPU with others,
    sphnet20's many small convs ran the phase over 10x slower on
    oversubscribed threads (594 s against 47 s on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_chip_smoke_convergence_phase_rehearsed_on_cpu(tmp_path, one_thread):
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
