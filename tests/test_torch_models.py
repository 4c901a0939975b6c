"""The port's models against the JAX package's, fp32 on the CPU.

Weights are made by the JAX package's ``init`` and carried into the port
with ``fedfr_tpu_torch.interop``; inputs are seeded numpy arrays.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fedfr_tpu.models import BCEModule as JBCE
from fedfr_tpu.models import SphNet as JSphNet
from fedfr_tpu.models.factory import ToyNet as JToy
from fedfr_tpu.utils import torch_interop as ti

from fedfr_tpu_torch import interop
from fedfr_tpu_torch.models import BCEModule, IResNet, SphNet, ToyNet, build_backbone

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("train", [True, False], ids=["bn_train", "bn_eval"])
def test_toy_forward_matches_jax(train):
    """ToyNet forward, BN in train mode (batch stats + running-stat update)
    and in eval mode (running stats), atol=rtol=1e-5."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    jnet = JToy(embedding_size=8)
    jvars = _np_tree(jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3))))
    # non-trivial running stats for the eval case
    jvars["batch_stats"]["bn1"]["mean"] = rng.standard_normal(16).astype(np.float32) * 0.1
    jvars["batch_stats"]["bn1"]["var"] = rng.uniform(0.5, 2, 16).astype(np.float32)

    net = ToyNet(embedding_size=8)
    net.load_state_dict(interop.toy_state_dict(jvars))
    net.train(train)
    out = net(_nchw(x)).detach().numpy()
    if train:
        jout, mutated = jnet.apply(jvars, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        bn = mutated["batch_stats"]["bn1"]
        np.testing.assert_allclose(net.bn1.running_mean.numpy(),
                                   np.asarray(bn["mean"]), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(net.bn1.running_var.numpy(),
                                   np.asarray(bn["var"]), atol=1e-5, rtol=1e-5)
    else:
        jout = jnet.apply(jvars, jnp.asarray(x), train=False)
    np.testing.assert_allclose(out, np.asarray(jout), atol=1e-5, rtol=1e-5)


def test_sphere20_forward_matches_jax():
    """sphere20 @112, batch 2, fp32 on both sides: atol=rtol=1e-4 (the two
    frameworks order the conv sums differently over 20 layers)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 112, 112, 3)) * 0.5).astype(np.float32)
    jnet = JSphNet(depth=20, embedding_size=64, bf16=False)
    jvars = _np_tree(jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, 112, 112, 3))))
    jout = np.asarray(jnet.apply(jvars, jnp.asarray(x)))

    net = SphNet(depth=20, embedding_size=64, bf16=False)
    net.load_state_dict(interop.sphnet_state_dict(jvars, depth=20))
    with torch.no_grad():
        out = net(_nchw(x)).numpy()
    np.testing.assert_allclose(out, jout, atol=1e-4, rtol=1e-4)


def test_bce_module_matches_jax():
    rng = np.random.default_rng(2)
    E, C = 16, 5
    x = rng.standard_normal((6, E)).astype(np.float32)
    labels = np.array([0, 4, 2, 5, 9, 1])  # >= C: public rows, no positive
    jbce = JBCE(hidden=E, n_class=C)
    jvars = _np_tree(jbce.init(jax.random.PRNGKey(3), jnp.zeros((1, E)),
                               jnp.zeros((1,), jnp.int32)))
    jvars["params"]["bias"] = rng.standard_normal(C).astype(np.float32)
    jvars["params"]["converter"]["dense"]["kernel"] += (
        0.1 * rng.standard_normal((E, E)).astype(np.float32))
    jlogits, jgt = jbce.apply(jvars, jnp.asarray(x), jnp.asarray(labels))

    bce = BCEModule(hidden=E, n_class=C)
    bce.load_state_dict(interop.bce_state_dict(jvars))
    logits, gt = bce(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jgt))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["plain", "scan"])
def test_sphnet_state_dict_matches_reference_bridge(scan_blocks):
    """The port's sphnet state_dict equals, key by key, what the JAX
    package's reference bridge emits, and loads strictly into SphNet."""
    jnet = JSphNet(depth=20, embedding_size=32, bf16=False, scan_blocks=scan_blocks)
    jvars = _np_tree(jnet.init(jax.random.PRNGKey(4), jnp.zeros((1, 112, 112, 3))))
    ours = interop.sphnet_state_dict(jvars, depth=20)
    ref = ti.backbone_to_torch("sphnet20", jvars)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].numpy(), err_msg=k)
    net = SphNet(depth=20, embedding_size=32, bf16=False)
    assert list(net.state_dict()) == list(ref)
    net.load_state_dict(ours, strict=True)


def test_build_backbone_names():
    assert isinstance(build_backbone("toy", 8), ToyNet)
    assert build_backbone("sphnet", 512).depth == 64
    assert build_backbone("sphnet20", 512).depth == 20
    net = build_backbone("iresnet50", 512, dropout=0.2, freeze_bn=True)
    assert isinstance(net, IResNet)
    assert (net.depth, net.dropout, net.freeze_bn) == (50, 0.2, True)
    for name in ("nope", "iresnet", "iresnet19"):
        with pytest.raises(ValueError):
            build_backbone(name)
