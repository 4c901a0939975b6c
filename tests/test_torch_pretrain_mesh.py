"""The Partial FC over the mesh's ``model`` axis: the port's sharded losses,
its data-parallel backbone and ``python -m fedfr_tpu_torch.pretrain`` over
W shards against the JAX package on ``tests/conftest.py``'s 8-device mesh,
on the CPU (the port's shards on ``[cpu] x W``).

* the sharded full and sampled losses with their feature and weight
  gradients at W = 2 and 8 against JAX ``partial_fc_loss`` /
  ``sampled_partial_fc_loss`` on ``model_mesh(W)``, to 1e-5 (fp32 on both
  sides), with a class count that W does not divide and with more distinct
  positives than a shard's sample; one shard equals the one-shard functions
  bit for bit;
* every shard's sampled rows are JAX's: the rows that JAX's sampled loss
  gives a weight gradient, and ``sample_negatives`` from ``fold_in(key,
  d)``;
* both CLIs, 2 epochs: JAX on its 8 devices, the port on ``[cpu] x 8``
  from the JAX initial weights, on a 30-ID public root (padded to 32 rows
  over 8 shards) at ``--sample_rate`` 0.5 (2 rows a shard of 4) and on a
  32-ID root at 1.0; the padded full softmax at 1.0 against the port on
  one device (JAX's turns NaN, see ``CLI_CASES``); the FC, the backbone
  state with its BN running statistics and the losses agree within
  ``CLI_TOL``, and the replicas are bit for bit shard 0's;
* one W = 2 step of the toy net (BN) equals the W = 1 step: running
  statistics to 1e-6;
* 2 epochs straight equal 1 epoch + ``--resume`` 1 bit for bit on
  ``[cpu] x 2``;
* a batch that W does not divide, and a resume state padded for another W,
  raise.
"""

import argparse
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pretrain as jax_pretrain
from fedfr_tpu.data import codec, write_split
from fedfr_tpu.models import build_backbone as jax_backbone
from fedfr_tpu.parallel import partial_fc as jpfc
from fedfr_tpu.parallel.mesh import model_mesh
from fedfr_tpu.utils.checkpoint import load_native

from fedfr_tpu_torch import interop
from fedfr_tpu_torch import pretrain as port_pretrain
from fedfr_tpu_torch.models import build_backbone
from fedfr_tpu_torch.ops import threefry
from fedfr_tpu_torch.parallel import partial_fc as tpfc

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

TOL = 1e-5
CLI_TOL = 1e-4
BN_TOL = 1e-6
B, E = 16, 8
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(seed: int, c_pad: int, num_valid: int, labels=None):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, E)).astype(np.float32)
    weight = rng.standard_normal((c_pad, E)).astype(np.float32)
    weight[num_valid:] = 0.0  # pad_classes' zero rows
    if labels is None:
        labels = rng.integers(0, num_valid, B)
        labels[3] = -1  # an ignored row
    return feats, np.asarray(labels, np.int32), weight


def _port_grads(fn, feats, weight, shards):
    """``fn(feature shards, label-free weight shards)``'s loss and the
    gradients of the whole features and weight."""
    f = torch.tensor(feats, requires_grad=True)
    w = torch.tensor(weight, requires_grad=True)
    loss = fn(list(f.chunk(shards)), list(w.chunk(shards)))
    loss.backward()
    return float(loss.detach()), f.grad.numpy(), w.grad.numpy()


def _jax_grads(fn, feats, weight):
    loss, (gf, gw) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(
        jnp.asarray(feats), jnp.asarray(weight))
    return float(loss), np.asarray(gf), np.asarray(gw)


def _assert_close(port, ref, rows=None):
    assert abs(port[0] - ref[0]) <= TOL * max(1.0, abs(ref[0]))
    np.testing.assert_allclose(port[1], ref[1], atol=TOL)
    np.testing.assert_allclose(port[2][:rows], ref[2][:rows], atol=TOL)


# (C_pad, num_valid, distinct positives): every row real; 21 classes
# padded to 24 (W = 8: 3 a shard, the last shard one real row)
FULL_CASES = {"even": (24, 24), "padded": (24, 21)}


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_sharded_full_softmax_matches_jax(shards, case):
    c_pad, nv = FULL_CASES[case]
    feats, labels, weight = _case(0, c_pad, nv)
    num_valid = None if nv == c_pad else nv
    jfn = jpfc.partial_fc_loss(model_mesh(shards), "CosFace", 30.0, 0.4,
                               num_valid=num_valid)
    ref = _jax_grads(lambda f, w: jfn(f, jnp.asarray(labels), w), feats, weight)
    lab = list(torch.from_numpy(labels).chunk(shards))
    port = _port_grads(lambda fs, ws: tpfc.sharded_partial_fc_loss(
        fs, lab, ws, "CosFace", 30.0, 0.4, num_valid=num_valid), feats, weight, shards)
    # a zero row's norm has no derivative: JAX's gives NaN there, torch's 0;
    # the row is masked out of the softmax either way
    assert not port[2][nv:].any()
    _assert_close(port, ref, rows=nv)


# (labels, num_sample a shard, num_valid): ordinary; every row its own
# class (W = 2: 8 positives a shard against 3 sampled rows, some lose the
# budget); 21 classes padded to 24
SAMPLED_CASES = {
    "ordinary": (None, {2: 6, 8: 2}, None),
    "overflow": (list(range(B)), {2: 3, 8: 1}, None),
    "padded": (None, {2: 10, 8: 2}, 21),
}


def _sampled(case, shards):
    labels, num_sample, num_valid = SAMPLED_CASES[case]
    feats, labels, weight = _case(2, 24, num_valid or 24, labels)
    return feats, labels, weight, num_sample[shards], num_valid


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("case", sorted(SAMPLED_CASES))
def test_sharded_sampled_loss_matches_jax(shards, case):
    feats, labels, weight, num_sample, num_valid = _sampled(case, shards)
    jfn = jpfc.sampled_partial_fc_loss(model_mesh(shards), num_sample, "CosFace",
                                       30.0, 0.4, num_valid=num_valid)
    key = jax.random.PRNGKey(7)
    ref = _jax_grads(lambda f, w: jfn(key, f, jnp.asarray(labels), w), feats, weight)
    lab = list(torch.from_numpy(labels).chunk(shards))
    port = _port_grads(lambda fs, ws: tpfc.sharded_sampled_partial_fc_loss(
        threefry.prng_key(7), fs, lab, ws, num_sample, "CosFace", 30.0, 0.4,
        num_valid=num_valid), feats, weight, shards)
    _assert_close(port, ref)
    assert np.isfinite(port[2]).all()

    # every shard's sample is JAX's: the rows JAX's loss gives a gradient
    c_local = 24 // shards
    nv = num_valid or 24
    got = np.concatenate([
        d * c_local + tpfc.shard_sample(threefry.prng_key(7), torch.from_numpy(labels), d,
                                        c_local, num_sample, num_valid).numpy()
        for d in range(shards)])
    np.testing.assert_array_equal(np.flatnonzero(np.abs(ref[2]).sum(1)),
                                  got[got < nv])


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("case", sorted(SAMPLED_CASES))
def test_shard_samples_match_jax(shards, case):
    _, labels, _, num_sample, num_valid = _sampled(case, shards)
    c_local = 24 // shards
    key = jax.random.PRNGKey(11)
    for d in range(shards):
        valid = None if num_valid is None else int(np.clip(num_valid - d * c_local, 0, c_local))
        ref = np.asarray(jpfc.sample_negatives(
            jax.random.fold_in(key, d), jnp.asarray(labels), c_local, num_sample,
            d * c_local, valid_count=valid))
        got = tpfc.shard_sample(threefry.prng_key(11), torch.from_numpy(labels), d,
                                c_local, num_sample, num_valid)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"shard {d}")


@pytest.mark.parametrize("sampled", [False, True])
def test_one_shard_is_the_one_shard_function(sampled):
    """The sharded forms at W = 1 are the one-shard functions, bit for bit
    (loss and both gradients)."""
    feats, labels, weight, num_sample, num_valid = _sampled("padded", 2)
    lab = torch.from_numpy(labels)
    if sampled:
        one = lambda f, w: tpfc.sampled_partial_fc_loss(  # noqa: E731
            threefry.prng_key(3), f[0], lab, w[0], num_sample, num_valid=num_valid)
        many = lambda f, w: tpfc.sharded_sampled_partial_fc_loss(  # noqa: E731
            threefry.prng_key(3), f, [lab], w, num_sample, num_valid=num_valid)
    else:
        one = lambda f, w: tpfc.partial_fc_loss(f[0], lab, w[0],  # noqa: E731
                                                num_valid=num_valid)
        many = lambda f, w: tpfc.sharded_partial_fc_loss(f, [lab], w,  # noqa: E731
                                                         num_valid=num_valid)
    a, b = (_port_grads(fn, feats, weight, 1) for fn in (one, many))
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


# --------------------------------------------------------------- the CLIs

N_IDS = 30  # W = 8 pads the FC to 32 rows, 4 a shard


def _write_root(root, n_ids: int) -> str:
    """``n_ids`` IDs x 4 images of 24x24 (7 or 8 steps of 16 an epoch)."""
    rng = np.random.default_rng(4)
    payloads, labels = [], []
    for pid in range(n_ids):
        base = rng.integers(0, 200, size=(24, 24, 3))
        for _ in range(4):
            img = np.clip(base + rng.integers(-20, 20, (24, 24, 3)), 0, 255)
            payloads.append(codec.encode_raw(img.astype(np.uint8)))
            labels.append(pid)
    write_split(str(root / "train.idx"), str(root / "train.rec"),
                payloads, labels, num_classes=n_ids)
    return str(root)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{class count: public root}: 30 IDs (padded over 8 shards) and 32."""
    return {n: _write_root(tmp_path_factory.mktemp(f"torch_pretrain_mesh_{n}"), n)
            for n in (N_IDS, 32)}


@pytest.fixture
def public_root(roots):
    return roots[N_IDS]


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


def _jax_initial_weights(monkeypatch, n_ids: int) -> None:
    """The port's initial weights set to the JAX CLI's (pretrain.py:77-81),
    carried by interop."""
    variables = jax.device_get(jax_backbone("toy", 16, bf16=False).init(
        jax.random.PRNGKey(100), jnp.zeros((1, 24, 24, 3)), train=False))
    w0 = np.array(0.01 * jax.random.normal(jax.random.PRNGKey(101), (n_ids, 16)))

    def initial_state(args, num_classes):
        net = build_backbone("toy", 16)
        net.load_state_dict(interop.backbone_state_dict("toy", variables))
        return net, torch.from_numpy(w0.copy())

    monkeypatch.setattr(port_pretrain, "initial_state", initial_state)


def _jax_cli(root: str, out, rate: str):
    out.mkdir()
    jax_pretrain.main(argparse.Namespace(
        data_dir=root, output_dir=str(out), network="toy", loss="CosFace",
        embedding_size=16, image_size=24, batch_size=16, num_epoch=2, lr=0.05,
        lr_steps="1", scale=30.0, margin=0.4, momentum=0.9, weight_decay=5e-4,
        sample_rate=float(rate), num_workers=2, log_every=2, seed=100, fp32=True,
        scan_blocks=False, resume=False))
    sd = interop.backbone_state_dict("toy", load_native(str(out / "backbone.npz")))
    torch.save(sd, out / "backbone.pth")


# (rate, class count, reference).  The JAX CLI's full softmax over a padded
# FC turns NaN at its first step (the norm of a zero pad row has a NaN
# gradient in JAX, which the sampled form alone guards against), so the
# port's padded full softmax over 8 shards is held to its own one-device
# run, which the 8-ID case of tests/test_torch_pretrain.py holds to JAX
CLI_CASES = {"sampled_padded": ("0.5", N_IDS, "jax"), "full": ("1.0", 32, "jax"),
             "full_padded": ("1.0", N_IDS, "one_device")}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_matches_jax_pretrain_on_8_shards(case, roots, tmp_path, monkeypatch):
    """The port's CLI over 8 shards, 2 epochs, against the JAX CLI on its 8
    devices (or the port on one device): FC, backbone state (BN running
    statistics included) and losses within CLI_TOL; the replicas equal."""
    rate, n_ids, ref = CLI_CASES[case]
    root, rout, tout = roots[n_ids], tmp_path / "ref", tmp_path / "port"
    _jax_initial_weights(monkeypatch, n_ids)
    if ref == "jax":
        _jax_cli(root, rout, rate)
    else:
        port_pretrain.main(_port_args(root, rout, "--sample_rate", rate), devices=[CPU])
    out = port_pretrain.main(_port_args(root, tout, "--sample_rate", rate),
                             devices=[CPU] * 8)
    assert out["num_shards"] == 8 and out["epochs"] == [0, 1]
    assert out["num_sample"] == (2 if rate == "0.5" else None)
    assert [w.shape[0] for w in out["state"].weights] == [4] * 8
    assert out["state"].backbone.replicas_equal()

    fc_r, fc_t = torch.load(rout / "fc.pth"), torch.load(tout / "fc.pth")
    assert fc_t.shape == fc_r.shape == (n_ids, 16)
    np.testing.assert_allclose(fc_t.numpy(), fc_r.numpy(), atol=CLI_TOL)
    sd_r, sd_t = torch.load(rout / "backbone.pth"), torch.load(tout / "backbone.pth")
    assert {"bn1.running_mean", "bn1.running_var"} <= set(sd_r)
    for k, v in sd_r.items():  # num_batches_tracked: the port's alone
        if v.is_floating_point():
            np.testing.assert_allclose(sd_t[k].numpy(), v.numpy(), atol=CLI_TOL, err_msg=k)
    lr, lt = _losses(rout), _losses(tout)
    steps = [4, 6, 8, 10, 12, 14] + ([16] if n_ids == 32 else [])
    assert [s for s, _ in lt] == [s for s, _ in lr] == steps
    np.testing.assert_allclose([v for _, v in lt], [v for _, v in lr], atol=CLI_TOL)
    log = open(tout / "pretrain.log").read()
    for text in ("partial-FC over 8 model shards",
                 f"public set: {4 * n_ids} imgs / {n_ids} ids"):
        assert text in log


# BN layers with running statistics: the toy net 1; iresnet18 31
# (BatchNorm2d and its features' BatchNorm1d); sphnet20 none (the shards'
# forwards run one after the other, no thread)
BN_LAYERS = {"toy": 1, "iresnet18": 31, "sphnet20": 0}


@pytest.mark.parametrize("network", sorted(BN_LAYERS))
def test_two_shard_step_keeps_batch_wide_bn(network):
    """One step over [cpu] x 2 against the same step on one device:
    every BN's running statistics (the whole batch's) to 1e-6,
    the loss to 1e-5 and the weights to 1e-5 (absolute and relative: fp32
    sums in another order through 18 layers); the replicas bit for bit
    shard 0's."""
    args = _port_args("unused", "unused", "--network", network)
    rng = np.random.default_rng(5)
    u8 = torch.from_numpy(rng.integers(0, 256, (B, 24, 24, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, N_IDS, B).astype(np.int32))
    states, losses = [], []
    for devices in ([CPU], [CPU, CPU]):
        st = port_pretrain.training_state(args, N_IDS, devices)
        step = port_pretrain.make_train_step(args, st.num_valid, None)
        losses.append(float(step(st, u8, labels, 0.05, threefry.prng_key(9))))
        states.append(st)
    one, two = (s.backbone.module.state_dict() for s in states)
    stats = [k for k in one if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * BN_LAYERS[network]
    for k in stats:
        torch.testing.assert_close(two[k], one[k], atol=BN_TOL, rtol=0, msg=k)
    for k, v in one.items():
        if v.is_floating_point():
            torch.testing.assert_close(two[k], v, atol=TOL, rtol=TOL, msg=k)
    assert abs(losses[0] - losses[1]) <= TOL
    torch.testing.assert_close(states[1].full_weight(), states[0].full_weight(),
                               atol=TOL, rtol=TOL)
    assert states[1].backbone.replicas_equal()
    assert states[1].backbone.replicas[1] is not states[1].backbone.module


def _bitwise_files(a, b, names):
    for name in names:
        x, y = torch.load(os.path.join(a, name)), torch.load(os.path.join(b, name))
        flat_x = x if isinstance(x, dict) else {"": x}
        flat_y = y if isinstance(y, dict) else {"": y}
        for k in flat_x:
            if isinstance(flat_x[k], torch.Tensor):
                assert torch.equal(flat_x[k], flat_y[k]), (name, k)


def test_resume_on_two_shards_is_bitwise(public_root, tmp_path):
    """2 epochs straight against 1 epoch then --resume to 2 on [cpu] x 2,
    sampled classes: artefacts, FC and both optimizers' momentum equal."""
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    devices = [CPU, CPU]
    port_pretrain.main(_port_args(public_root, straight, "--sample_rate", "0.5"),
                       devices=devices)
    first = port_pretrain.main(_port_args(public_root, resumed, "--sample_rate", "0.5",
                                          "--num_epoch", "1"), devices=devices)
    assert first["epochs"] == [0]
    second = port_pretrain.main(_port_args(public_root, resumed, "--sample_rate", "0.5",
                                           "--resume"), devices=devices)
    assert second["start_epoch"] == 1 and second["epochs"] == [1]
    assert second["num_sample"] == 7  # int(0.5 * 30 // 2)
    assert "resumed pretraining at epoch 1" in open(resumed / "pretrain.log").read()
    _bitwise_files(str(straight), str(resumed),
                   ["backbone.pth", "fc.pth", "preCos_pretrain_labels.pth"])
    st_s = torch.load(straight / port_pretrain.STATE_FILE)
    st_r = torch.load(resumed / port_pretrain.STATE_FILE)
    assert st_s["epoch"] == st_r["epoch"] == 1
    assert st_s["weight"].shape == (N_IDS, 16)
    assert torch.equal(st_s["weight"], st_r["weight"])
    for k in ("opt", "wopt"):
        assert st_s[k]["state"]
        for i, s in st_s[k]["state"].items():
            assert torch.equal(s["momentum_buffer"], st_r[k]["state"][i]["momentum_buffer"])
    assert second["state"].backbone.replicas_equal()


def test_indivisible_batch_and_foreign_resume_state_raise(public_root, tmp_path):
    with pytest.raises(ValueError, match="--batch_size 16 does not split into 3"):
        port_pretrain.main(_port_args(public_root, tmp_path / "a"), devices=[CPU] * 3)
    out = tmp_path / "b"
    port_pretrain.main(_port_args(public_root, out, "--num_epoch", "1"), devices=[CPU] * 2)
    with pytest.raises(ValueError, match="30 padded rows.* pad to 32"):
        port_pretrain.main(_port_args(public_root, out, "--resume"), devices=[CPU] * 8)
