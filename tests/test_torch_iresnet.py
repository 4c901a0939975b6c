"""The port's iresnet, BottleBlock and freeze_bn/dropout against the JAX
package's, fp32 on the CPU.

Weights are made by the JAX package's ``init`` and carried into the port
with ``fedfr_tpu_torch.interop``; inputs are seeded numpy arrays.  A fresh
iresnet's BN running statistics (mean 0, var 1) do not describe its
activations, so before an eval-mode comparison they are set to one batch's
statistics (computed by the port, written into the JAX tree).
"""

import re


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fedfr_tpu.federated.state import flip_mask
from fedfr_tpu.federated.trainer import init_client_state as j_init_state
from fedfr_tpu.federated.trainer import make_branch_train_step as j_make_step
from fedfr_tpu.models import BCEModule as JBCE
from fedfr_tpu.models.bottle import BottleBlock as JBottle
from fedfr_tpu.models.iresnet import IResNet as JIResNet
from fedfr_tpu.utils import torch_interop as ti

from fedfr_tpu_torch import interop
from fedfr_tpu_torch.federated import init_client_state, make_branch_train_step
from fedfr_tpu_torch.models import BCEModule, BottleBlock, IResNet, build_backbone

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _batch_norms(net):
    return [m for m in net.modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]


def _calibrated(jvars, depth, emb, x):
    """JAX iresnet variables whose BN running statistics are the batch
    statistics of ``x`` (one train-mode forward of the port at momentum 1)."""
    net = IResNet(depth, emb, bf16=False, image_size=x.shape[1])
    net.load_state_dict(interop.iresnet_state_dict(jvars, depth))
    for m in _batch_norms(net):
        m.momentum = 1.0
    with torch.no_grad():
        net.train()(_nchw(x))
    sd = net.state_dict()
    stats = {}
    for name, sub in jvars["batch_stats"].items():
        block = re.fullmatch(r"layer(\d)_block(\d+)", name)
        for bn, leaves in (sub.items() if block else [(None, sub)]):
            key = name if not block else "layer%s.%s.%s" % (
                *block.groups(), "downsample.1" if bn == "ds_bn" else bn)
            new = {"mean": sd[f"{key}.running_mean"].numpy(),
                   "var": sd[f"{key}.running_var"].numpy()}
            if block:
                stats.setdefault(name, {})[bn] = new
            else:
                stats[name] = new
    return {"params": jvars["params"], "batch_stats": stats}


def _jax_iresnet18(emb, size, key, **kw):
    jnet = JIResNet(depth=18, embedding_size=emb, bf16=False, **kw)
    return jnet, _np_tree(jnet.init(jax.random.PRNGKey(key),
                                    jnp.zeros((1, size, size, 3))))


@pytest.mark.parametrize("train", [True, False], ids=["bn_train", "bn_eval"])
def test_iresnet18_forward_matches_jax(train):
    """iresnet18 @112, batch 2, fp32: the output and (train) every updated
    running statistic at atol=rtol=1e-4, the sphere20 parity tolerance."""
    rng = np.random.default_rng(0)
    cal = (rng.standard_normal((4, 112, 112, 3)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((2, 112, 112, 3)) * 0.5).astype(np.float32)
    jnet, jvars = _jax_iresnet18(64, 112, 2)
    jvars = _calibrated(jvars, 18, 64, cal)

    net = IResNet(18, 64, bf16=False)
    net.load_state_dict(interop.iresnet_state_dict(jvars, 18))
    net.train(train)
    out = net(_nchw(x)).detach().numpy()
    if train:
        jout, mutated = jnet.apply(jvars, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        want = interop.iresnet_state_dict(
            {"params": jvars["params"],
             "batch_stats": _np_tree(mutated["batch_stats"])}, 18)
        stats = [k for k in want if "running" in k]
        assert len(stats) == 2 * 31  # 30 BatchNorm2d + the BN1d
        for k in stats:
            np.testing.assert_allclose(net.state_dict()[k].numpy(),
                                       want[k].numpy(), atol=1e-4, rtol=1e-4,
                                       err_msg=k)
    else:
        jout = jnet.apply(jvars, jnp.asarray(x), train=False)
    np.testing.assert_allclose(out, np.asarray(jout), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["plain", "scan"])
def test_iresnet_state_dict_matches_reference_bridge(scan_blocks):
    """The port's iresnet state_dict equals, key by key and bit for bit,
    what the JAX package's reference bridge emits, and loads strictly."""
    _, jvars = _jax_iresnet18(32, 112, 4, scan_blocks=scan_blocks)
    ours = interop.iresnet_state_dict(jvars, 18)
    ref = ti.backbone_to_torch("iresnet18", jvars)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].numpy(), err_msg=k)
    net = IResNet(18, 32, bf16=False)
    assert list(net.state_dict()) == list(ref)
    net.load_state_dict(ours, strict=True)
    assert interop.backbone_state_dict("iresnet18", jvars).keys() == ref.keys()


def test_bottle_block_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    jblock = JBottle(32, 4)
    jvars = _np_tree(jblock.init(jax.random.PRNGKey(5), jnp.zeros((1, 32))))
    jout = np.asarray(jblock.apply(jvars, jnp.asarray(x)))
    block = BottleBlock(32, 4)
    sd = interop.bce_state_dict({"params": {"weight": np.zeros((1, 32)),
                                            "bias": np.zeros(1),
                                            "converter": jvars["params"]}})
    block.load_state_dict({k[len("converter."):]: v for k, v in sd.items()
                           if k.startswith("converter.")})
    np.testing.assert_allclose(block(torch.from_numpy(x)).detach().numpy(),
                               jout, atol=1e-5, rtol=1e-5)


def test_bce_module_bottle_matches_jax():
    """BCEModule(converter_layers=2) (BottleBlock converter): logits and gt
    at 1e-5, the converter alone (the personalized eval's path) too, and the
    state_dict in the reference's key layout."""
    rng = np.random.default_rng(4)
    E, C = 16, 5
    x = rng.standard_normal((6, E)).astype(np.float32)
    labels = np.array([0, 4, 2, 5, 9, 1])
    jbce = JBCE(hidden=E, n_class=C, converter_layers=2)
    jvars = _np_tree(jbce.init(jax.random.PRNGKey(6), jnp.zeros((1, E)),
                               jnp.zeros((1,), jnp.int32)))
    jvars["params"]["bias"] = rng.standard_normal(C).astype(np.float32)
    jlogits, jgt = jbce.apply(jvars, jnp.asarray(x), jnp.asarray(labels))
    jconv = jbce.apply(jvars, jnp.asarray(x), method=JBCE.convert)

    bce = BCEModule(hidden=E, n_class=C, converter_layers=2)
    sd = interop.bce_state_dict(jvars)
    assert set(sd) == set(bce.state_dict())
    assert "converter.br4.2.weight" in sd and "converter.concat_fc.bias" in sd
    bce.load_state_dict(sd, strict=True)
    logits, gt = bce(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jgt))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bce.converter(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jconv), atol=1e-5, rtol=1e-5)


def test_freeze_bn_step_matches_jax():
    """One branch step of iresnet18 (32x32, batch 4) with ``freeze_bn`` and
    the BottleBlock converter against the JAX step: the loss terms at
    atol=1e-5/rtol=1e-6 and the updated backbone, FC and BCE at atol=1e-5
    (test_torch_step.py's tolerances); every BN running statistic is left
    as it was, on both sides, while the BN affine parameters move."""
    emb, size, n_local, n_global, batch = 16, 32, 3, 4, 4
    rng = np.random.default_rng(7)
    cal = (rng.standard_normal((4, size, size, 3)) * 0.5).astype(np.float32)
    jnet, _ = _jax_iresnet18(emb, size, 0, freeze_bn=True)
    jvars, gvars, lvars = (
        _calibrated(_jax_iresnet18(emb, size, k)[1], 18, emb, cal)
        for k in (1, 2, 3))
    jbce = JBCE(hidden=emb, n_class=n_local, converter_layers=2)
    bce_vars = _np_tree(jbce.init(jax.random.PRNGKey(4), jnp.zeros((1, emb)),
                                  jnp.zeros((1,), jnp.int32)))
    fc0 = (0.1 * rng.standard_normal((n_local + n_global, emb))).astype(np.float32)
    u8 = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
    labels = np.array([0, 5, 2, 6], np.int32)
    valid = np.array([True, True, True, False])
    key, step_no, lr = jax.random.PRNGKey(9), 3, 0.001

    jstep = j_make_step(jnet, jbce, num_local=n_local, num_clients=5, donate=False)
    jstate, jm = jstep(j_init_state(jvars, jnp.asarray(fc0), bce_vars), gvars,
                       lvars, jnp.asarray(u8), jnp.asarray(labels),
                       jnp.asarray(valid), jnp.float32(lr), key, step_no)
    flip = np.asarray(flip_mask(jax.random.fold_in(key, step_no), batch))

    def net(variables, freeze_bn=False):
        m = build_backbone("iresnet18", emb, bf16=False, image_size=size,
                           freeze_bn=freeze_bn)
        m.load_state_dict(interop.iresnet_state_dict(variables, 18))
        return m

    bce = BCEModule(emb, n_local, converter_layers=2)
    bce.load_state_dict(interop.bce_state_dict(bce_vars))
    state = init_client_state(net(jvars, freeze_bn=True), torch.from_numpy(fc0),
                              bce, lr)
    step = make_branch_train_step(num_local=n_local, num_clients=5)
    state, m = step(state, net(gvars).eval(), net(lvars).eval(),
                    torch.from_numpy(u8), torch.from_numpy(labels),
                    torch.from_numpy(valid), lr, torch.from_numpy(flip))

    assert state.backbone.training and not any(
        bn.training for bn in _batch_norms(state.backbone))
    for name, got, want in zip(("loss", "cos", "bce", "con"), m, jm):
        np.testing.assert_allclose(float(got), float(want), atol=1e-5,
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(state.fc.detach().numpy(), np.asarray(jstate.fc),
                               atol=1e-5, rtol=0)
    want_bce = interop.bce_state_dict(_np_tree(jstate.bce))
    for k, v in state.bce.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_bce[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    start = interop.iresnet_state_dict(jvars, 18)
    want_bb = interop.iresnet_state_dict(_np_tree(jstate.backbone), 18)
    got_bb = state.backbone.state_dict()
    for k, v in got_bb.items():
        if "running" in k:
            np.testing.assert_array_equal(v.numpy(), start[k].numpy(), err_msg=k)
            np.testing.assert_array_equal(want_bb[k].numpy(), start[k].numpy(),
                                          err_msg=k)
        elif v.is_floating_point():
            np.testing.assert_allclose(v.detach().numpy(), want_bb[k].numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
    assert float((got_bb["layer1.0.bn2.weight"] - start["layer1.0.bn2.weight"]
                  ).abs().max()) > 0


def _pair(dropout, seed=0):
    """Two iresnet18s (16x16 inputs) with the same weights, the second with
    ``dropout``."""
    plain = IResNet(18, 8, bf16=False, image_size=16,
                    generator=torch.Generator().manual_seed(seed))
    drop = IResNet(18, 8, dropout=dropout, bf16=False, image_size=16)
    drop.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (4, 3, 16, 16)).astype(np.float32))
    return plain, drop, x


def test_dropout_zero_is_a_noop():
    plain, drop, x = _pair(0.0)
    gen = torch.Generator().manual_seed(1)
    torch.testing.assert_close(drop.train()(x, dropout_gen=gen),
                               plain.train()(x), rtol=0, atol=0)
    torch.testing.assert_close(drop.train()(x), plain.train()(x), rtol=0, atol=0)


def test_dropout_is_identity_in_eval():
    plain, drop, x = _pair(0.5)
    with torch.no_grad():
        torch.testing.assert_close(drop.eval()(x), plain.eval()(x), rtol=0, atol=0)


def test_dropout_in_train_is_deterministic_per_generator():
    _, drop, x = _pair(0.5)
    drop.train()
    with torch.no_grad():
        a = drop(x, dropout_gen=torch.Generator().manual_seed(3))
        b = drop(x, dropout_gen=torch.Generator().manual_seed(3))
        c = drop(x, dropout_gen=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - c).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="dropout_gen"):
        drop(x)


def test_iresnet_client_state_loads():
    """A JAX iresnet client's host state (local FC, BottleBlock BCE, MOON
    last model) carried into the port loads strictly into its modules."""
    _, jvars = _jax_iresnet18(16, 32, 5)
    jbce = JBCE(hidden=16, n_class=3, converter_layers=2)
    bce_vars = _np_tree(jbce.init(jax.random.PRNGKey(6), jnp.zeros((1, 16)),
                                  jnp.zeros((1,), jnp.int32)))
    fc = np.ones((3, 16), np.float32)
    state = interop.client_state("iresnet18", fc, bce_vars, jvars)
    assert state["fc_local"].shape == (3, 16)
    BCEModule(16, 3, converter_layers=2).load_state_dict(state["bce_state"])
    IResNet(18, 16, image_size=32).load_state_dict(state["last_backbone"])


@pytest.mark.parametrize("depth,init", [(100, "port"), (200, "port"),
                                         (100, "jax")])
def test_fresh_iresnet_eval_forward(depth, init):
    """A freshly initialized iresnet (a client's MOON last model in round 0)
    in eval mode at 112x112: with the port's init its features are finite
    and of unit norm after l2 normalization; with the JAX package's N(0, 0.1)
    conv kernels (the reason for the port's init) they are not finite."""
    from fedfr_tpu_torch.models import l2_normalize

    gen = torch.Generator().manual_seed(0)
    net = IResNet(depth, 512, bf16=False, generator=gen).eval()
    if init == "jax":
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                with torch.no_grad():
                    m.weight.normal_(0.0, 0.1, generator=gen)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 3, 112, 112)).astype(np.float32))
    with torch.no_grad():
        f = net(x)
    if init == "jax":
        assert not bool(torch.isfinite(f).all())
        return
    assert bool(torch.isfinite(f).all())
    torch.testing.assert_close(l2_normalize(f).norm(dim=1), torch.ones(2))
