"""Partial-FC pretraining: the port's ``parallel/partial_fc.py`` and
``python -m fedfr_tpu_torch.pretrain`` against the JAX package, on the CPU.

* the full-softmax and sampled losses with their feature and weight
  gradients against JAX ``partial_fc_loss`` / ``sampled_partial_fc_loss``
  on ``model_mesh(1)``, to 1e-5 (fp32 on both sides); the full softmax also
  against the 8-shard mesh of ``tests/conftest.py``, to 1e-5 (sharding does
  not change that function);
* ``sample_negatives`` gives JAX's index set from the same key, also with
  more distinct positives than ``num_sample`` and with padded rows; the
  flip mask is ``flip_mask``'s; the sample count is ``pretrain.py:85``'s;
* a 2-epoch toy run through both CLIs in process on ``tests/test_pretrain.py``'s
  data (JAX on its 8-device mesh, the port starting from the JAX initial
  weights carried by ``interop``): the FC, the backbone state and the
  logged losses agree within ``CLI_TOL`` (8 SGD steps at scale 30 in fp32;
  the 8-way sharded BN statistics and log-sum-exp sum in another order);
* 2 epochs straight equal 1 epoch + ``--resume`` 1 bitwise;
* ``--save_every 0`` is refused at parse time;
* the port's ``Server`` loads the root the port's pretraining wrote.
"""

import argparse
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import pretrain as jax_pretrain
from fedfr_tpu.data import codec, write_split
from fedfr_tpu.federated.state import flip_mask
from fedfr_tpu.models import build_backbone as jax_backbone
from fedfr_tpu.parallel import partial_fc as jpfc
from fedfr_tpu.parallel.mesh import model_mesh
from fedfr_tpu.utils.checkpoint import load_native

from fedfr_tpu_torch import interop
from fedfr_tpu_torch import pretrain as port_pretrain
from fedfr_tpu_torch import train as train_cli
from fedfr_tpu_torch.models import build_backbone
from fedfr_tpu_torch.ops import threefry
from fedfr_tpu_torch.parallel import partial_fc as tpfc

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

TOL = 1e-5
CLI_TOL = 1e-4
B, E, C = 16, 8, 24


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(seed: int, labels=None):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, E)).astype(np.float32)
    weight = rng.standard_normal((C, E)).astype(np.float32)
    if labels is None:
        labels = rng.integers(0, C, B).astype(np.int32)
    return feats, np.asarray(labels, np.int32), weight


def _port_grads(fn, feats, weight):
    f = torch.tensor(feats, requires_grad=True)
    w = torch.tensor(weight, requires_grad=True)
    loss = fn(f, w)
    loss.backward()
    return float(loss.detach()), f.grad.numpy(), w.grad.numpy()


def _jax_grads(fn, feats, weight):
    loss, (gf, gw) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(
        jnp.asarray(feats), jnp.asarray(weight))
    return float(loss), np.asarray(gf), np.asarray(gw)


def _assert_close(port, ref):
    assert abs(port[0] - ref[0]) <= TOL * max(1.0, abs(ref[0]))
    np.testing.assert_allclose(port[1], ref[1], atol=TOL)
    np.testing.assert_allclose(port[2], ref[2], atol=TOL)


@pytest.mark.parametrize("shards,num_valid,margin", [
    (1, None, "CosFace"), (8, None, "CosFace"), (1, C - 5, "CosFace"),
    (8, C - 5, "CosFace"), (1, None, "ArcFace")])
def test_full_softmax_matches_jax(shards, num_valid, margin):
    labels = np.random.default_rng(1).integers(0, num_valid or C, B)
    labels[3] = -1  # an ignored row
    feats, labels, weight = _case(0, labels)
    if num_valid is not None:
        weight[num_valid:] = 0.0  # pad_classes' zero rows
    jfn = jpfc.partial_fc_loss(model_mesh(shards), margin, 30.0, 0.4,
                               num_valid=num_valid)
    ref = _jax_grads(lambda f, w: jfn(f, jnp.asarray(labels), w), feats, weight)
    port = _port_grads(lambda f, w: tpfc.partial_fc_loss(
        f, torch.from_numpy(labels), w, margin, 30.0, 0.4, num_valid=num_valid),
        feats, weight)
    if num_valid is not None:
        # a zero row's norm has no derivative: JAX's gives NaN there, torch's
        # 0; the row is masked out of the softmax either way
        assert not np.asarray(port[2][num_valid:]).any()
        port, ref = ((x[0], x[1], x[2][:num_valid]) for x in (port, ref))
    _assert_close(port, ref)


# (labels, num_sample, num_valid): ordinary; more distinct positives than
# num_sample (some positives lose the budget); padded rows past num_valid
SAMPLED_CASES = {
    "ordinary": (None, 12, None),
    "overflow": (list(range(B)), 10, None),
    "padded": (None, 20, C - 3),
}


@pytest.mark.parametrize("case", sorted(SAMPLED_CASES))
def test_sampled_loss_matches_jax(case):
    labels, num_sample, num_valid = SAMPLED_CASES[case]
    feats, labels, weight = _case(2, labels)
    if num_valid is not None:
        labels = labels % num_valid
        weight[num_valid:] = 0.0
    jfn = jpfc.sampled_partial_fc_loss(model_mesh(1), num_sample, "CosFace",
                                       30.0, 0.4, num_valid=num_valid)
    key = jax.random.PRNGKey(7)
    ref = _jax_grads(lambda f, w: jfn(key, f, jnp.asarray(labels), w), feats, weight)
    port = _port_grads(lambda f, w: tpfc.sampled_partial_fc_loss(
        threefry.prng_key(7), f, torch.from_numpy(labels), w, num_sample,
        "CosFace", 30.0, 0.4, num_valid=num_valid), feats, weight)
    _assert_close(port, ref)
    assert np.isfinite(port[2]).all()


@pytest.mark.parametrize("case", sorted(SAMPLED_CASES))
@pytest.mark.parametrize("seed", [0, 5])
def test_sample_negatives_matches_jax(case, seed):
    labels, num_sample, num_valid = SAMPLED_CASES[case]
    _, labels, _ = _case(3 + seed, labels)
    if num_valid is not None:
        labels = labels % num_valid
    labels[0] = -1
    ref = np.asarray(jpfc.sample_negatives(
        jax.random.PRNGKey(seed), jnp.asarray(labels), C, num_sample, 0,
        valid_count=num_valid))
    got = tpfc.sample_negatives(threefry.prng_key(seed), torch.from_numpy(labels),
                                C, num_sample, 0, valid_count=num_valid)
    np.testing.assert_array_equal(got.numpy(), ref)
    if case == "overflow":  # the lower-index positives win the ties
        np.testing.assert_array_equal(got.numpy(), np.arange(1, num_sample + 1))


def test_flip_and_step_keys_match_jax():
    key = jax.random.PRNGKey(107)
    sub = jax.random.fold_in(jax.random.fold_in(key, 3), 11)
    prng, srng = jax.random.split(sub)
    port = port_pretrain.step_key(threefry.prng_key(107), 3, 11)
    pp, ps = threefry.split(port)
    assert tuple(np.asarray(srng).tolist()) == ps
    want = np.asarray(flip_mask(prng, 64))
    got = threefry.uniform_at(pp, torch.arange(64)) < 0.5
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rate,c_pad,shards", [(0.1, 6000, 1), (0.5, 8, 1),
                                               (0.3, 7, 1), (0.001, 10, 1),
                                               (0.2, 6000, 8)])
def test_sample_count_is_pretrain_py_expression(rate, c_pad, shards):
    assert tpfc.num_sampled(rate, c_pad, shards) == max(1, int(rate * c_pad // shards))
    w, nv = tpfc.pad_classes(torch.ones(c_pad, 2), shards)
    jw, jnv = jpfc.pad_classes(jnp.ones((c_pad, 2)), shards)
    assert (w.shape[0], nv) == (jw.shape[0], jnv)


# --------------------------------------------------------------- the CLIs

@pytest.fixture(scope="module")
def public_root(tmp_path_factory):
    """tests/test_pretrain.py's data: 8 IDs x 8 images of 24x24."""
    root = tmp_path_factory.mktemp("torch_pretrain_data")
    rng = np.random.default_rng(0)
    payloads, labels = [], []
    for pid in range(8):
        base = rng.integers(0, 200, size=(24, 24, 3))
        for _ in range(8):
            img = np.clip(base + rng.integers(-20, 20, (24, 24, 3)), 0, 255)
            payloads.append(codec.encode_raw(img.astype(np.uint8)))
            labels.append(pid)
    write_split(str(root / "train.idx"), str(root / "train.rec"),
                payloads, labels, num_classes=8)
    return str(root)


def _port_args(data_dir, out, *extra):
    return port_pretrain.build_parser().parse_args([
        "--data_dir", data_dir, "--output_dir", str(out), "--network", "toy",
        "--embedding_size", "16", "--image_size", "24", "--batch_size", "16",
        "--num_epoch", "2", "--lr", "0.05", "--lr_steps", "1", "--scale", "30",
        "--num_workers", "2", "--log_every", "2", "--fp32", "--device", "cpu",
        *extra])


LOSS_RE = re.compile(r"Loss (\S+)\s+Epoch: (\d+)\s+Global Step: (\d+)")


def _losses(out):
    with open(os.path.join(out, "pretrain.log")) as f:
        return [(int(m.group(3)), float(m.group(1))) for m in LOSS_RE.finditer(f.read())]


def test_cli_matches_jax_pretrain(public_root, tmp_path, monkeypatch):
    """Both CLIs, 2 epochs at sample_rate 1.0 from the same initial weights:
    the same log lines, and FC, backbone state and losses within CLI_TOL."""
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jout.mkdir()
    jargs = argparse.Namespace(
        data_dir=public_root, output_dir=str(jout), network="toy", loss="CosFace",
        embedding_size=16, image_size=24, batch_size=16, num_epoch=2, lr=0.05,
        lr_steps="1", scale=30.0, margin=0.4, momentum=0.9, weight_decay=5e-4,
        sample_rate=1.0, num_workers=2, log_every=2, seed=100, fp32=True,
        scan_blocks=False, resume=False)
    jax_pretrain.main(jargs)

    # the JAX CLI's initial weights (pretrain.py:77-81), carried by interop
    variables = jax.device_get(jax_backbone("toy", 16, bf16=False).init(
        jax.random.PRNGKey(100), jnp.zeros((1, 24, 24, 3)), train=False))
    w0 = 0.01 * jax.random.normal(jax.random.PRNGKey(101), (8, 16))

    def initial_state(args, num_classes):
        net = build_backbone("toy", 16)
        net.load_state_dict(interop.backbone_state_dict("toy", variables))
        return net, torch.from_numpy(np.array(w0))

    monkeypatch.setattr(port_pretrain, "initial_state", initial_state)
    out = port_pretrain.main(_port_args(public_root, tout))
    assert out["epochs"] == [0, 1] and out["num_sample"] is None

    fc_j = torch.load(jout / "fc.pth")
    fc_t = torch.load(tout / "fc.pth")
    assert fc_t.shape == fc_j.shape == (8, 16)
    np.testing.assert_allclose(fc_t.numpy(), fc_j.numpy(), atol=CLI_TOL)
    sd_j = interop.backbone_state_dict("toy", load_native(str(jout / "backbone.npz")))
    sd_t = torch.load(tout / "backbone.pth")
    assert set(sd_t) >= set(sd_j)
    for k, v in sd_j.items():  # num_batches_tracked: the port's alone
        if not v.is_floating_point():
            continue
        np.testing.assert_allclose(sd_t[k].numpy(), v.numpy(), atol=CLI_TOL, err_msg=k)
    np.testing.assert_array_equal(torch.load(tout / "preCos_pretrain_labels.pth"),
                                  torch.load(jout / "preCos_pretrain_labels.pth"))
    lj, lt = _losses(jout), _losses(tout)
    assert [s for s, _ in lt] == [s for s, _ in lj] == [4, 6, 8]
    np.testing.assert_allclose([v for _, v in lt], [v for _, v in lj], atol=CLI_TOL + 1e-4)
    for text in ("partial-FC over 1 model shards", "public set: 64 imgs / 8 ids",
                 "epoch 1 done, lr 0.00500", "pretraining done"):
        assert text in open(tout / "pretrain.log").read()


def _bitwise_files(a, b, names):
    for name in names:
        x, y = torch.load(os.path.join(a, name)), torch.load(os.path.join(b, name))
        flat_x = x if isinstance(x, dict) else {"": x}
        flat_y = y if isinstance(y, dict) else {"": y}
        for k in flat_x:
            if isinstance(flat_x[k], torch.Tensor):
                assert torch.equal(flat_x[k], flat_y[k]), (name, k)


def test_resume_is_bitwise(public_root, tmp_path):
    """2 epochs straight against 1 epoch then --resume to 2, sampled
    classes (the sampling key chain restarts at the resumed epoch)."""
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    port_pretrain.main(_port_args(public_root, straight, "--sample_rate", "0.5"))
    first = port_pretrain.main(_port_args(public_root, resumed, "--sample_rate", "0.5",
                                          "--num_epoch", "1"))
    assert first["epochs"] == [0]
    second = port_pretrain.main(_port_args(public_root, resumed, "--sample_rate", "0.5",
                                           "--resume"))
    assert second["start_epoch"] == 1 and second["epochs"] == [1]
    assert second["num_sample"] == 4
    assert "resumed pretraining at epoch 1" in open(resumed / "pretrain.log").read()
    _bitwise_files(str(straight), str(resumed),
                   ["backbone.pth", "fc.pth", "preCos_pretrain_labels.pth"])
    st_s = torch.load(straight / port_pretrain.STATE_FILE)
    st_r = torch.load(resumed / port_pretrain.STATE_FILE)
    assert st_s["epoch"] == st_r["epoch"] == 1
    assert torch.equal(st_s["weight"], st_r["weight"])
    for k in ("opt", "wopt"):
        for i, s in st_s[k]["state"].items():
            assert torch.equal(s["momentum_buffer"], st_r[k]["state"][i]["momentum_buffer"])


@pytest.mark.parametrize("value", ["0", "-1"])
def test_save_every_below_one_is_refused(value, capsys):
    with pytest.raises(SystemExit):
        port_pretrain.build_parser().parse_args(
            ["--data_dir", "x", "--save_every", value])
    assert "must be >= 1" in capsys.readouterr().err


def test_synth_spec_conflicts_raise(tmp_path):
    with pytest.raises(ValueError, match="image_size"):
        port_pretrain.main(_port_args("synth:image_size=32", tmp_path))


def test_server_loads_the_ports_pretrained_root(tmp_path):
    """Pretrain on chip_smoke.py's public split, then the training CLI's
    setup with --pretrained_root: the global model, FC and labels are the
    files the pretraining wrote, with the three "loaded ..." lines."""
    root = str(tmp_path / "data")
    chip_smoke.write_fl_split(root, 2, 3, imgs_per_id=4, pub_ids=6, pub_imgs=4,
                              size=16, seed=0, veri_imgs=2)
    pre = tmp_path / "pre"
    args = _port_args(os.path.join(root, "split_pretrain_6000", "client_0000"), pre,
                      "--image_size", "16", "--batch_size", "8", "--num_epoch", "1")
    port_pretrain.main(args)
    argv = chip_smoke.round_args(root, 2, 3, device="cpu", network="toy",
                                 embedding=16, image_size=16, batch=8,
                                 local_epochs=1, rounds=1, eval_batch=16)
    argv += ["--pretrained_root", str(pre), "--num_workers", "2"]
    t = train_cli.setup(train_cli.build_parser().parse_args(argv))
    sd = torch.load(pre / "backbone.pth")
    for k, v in t.server.global_net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert torch.equal(t.server.pretrained_fc, torch.load(pre / "fc.pth"))
    assert t.server.pretrained_fc.shape == (6, 16)
    np.testing.assert_array_equal(t.server.pretrained_labels, np.repeat(np.arange(6), 4))
    log = open(os.path.join(t.cfg.runtime.output_dir, "training.log")).read()
    for text in ("loaded pretrained backbone from " + str(pre / "backbone.pth"),
                 "loaded pretrain labels (24,)", "loaded pretrained perfect FC (6, 16)"):
        assert text in log
