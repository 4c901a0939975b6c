"""The port's margins, losses and optimizer against the JAX package's.

The cases are those of ``tests/test_losses.py``.  Values agree to 1e-5 and
gradients to 1e-4 (fp32 on both sides; the frameworks reduce in other
orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fedfr_tpu.ops import (arcface as j_arcface, bce_loss as j_bce,
                           cosface as j_cosface, moon_contrastive as j_moon,
                           reweight_negatives as j_reweight,
                           softmax_cross_entropy as j_ce)
from fedfr_tpu.utils.optim import sgd_init, sgd_update, step_lr as j_step_lr

from fedfr_tpu_torch.ops import (arcface, bce_loss, cosface, moon_contrastive,
                                 reweight_negatives, softmax_cross_entropy)
from fedfr_tpu_torch.utils.optim import step_lr

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)


def _rand_cos(rng, b, c):
    return (rng.random((b, c), dtype=np.float32) * 2 - 1) * 0.99


def _both(jfn, tfn, *arrays, grad_arg=0):
    """Value and d(sum)/d(arrays[grad_arg]) of a JAX and a torch function."""
    jval, jgrad = jax.value_and_grad(lambda x: jnp.sum(jfn(
        *arrays[:grad_arg], x, *arrays[grad_arg + 1:])))(jnp.asarray(arrays[grad_arg]))
    targs = [torch.from_numpy(np.array(a)) for a in arrays]
    targs[grad_arg].requires_grad_(True)
    tout = tfn(*targs)
    tout.sum().backward()
    jout = jfn(*[jnp.asarray(a) for a in arrays])
    return (np.asarray(jout), tout.detach().numpy(), float(jval),
            np.asarray(jgrad), targs[grad_arg].grad.numpy())


def _check(res):
    jout, tout, _, jgrad, tgrad = res
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tgrad, jgrad, atol=1e-4, rtol=1e-4)


def test_cosface_matches_jax():
    rng = np.random.default_rng(0)
    cos = _rand_cos(rng, 6, 10)
    label = np.array([0, 3, -1, 9, 2, -1])
    _check(_both(lambda c, l: j_cosface(c, l, 30.0, 0.4),
                 lambda c, l: cosface(c, l, 30.0, 0.4), cos, label))


def test_arcface_matches_jax():
    rng = np.random.default_rng(1)
    cos = _rand_cos(rng, 5, 8)
    label = np.array([1, -1, 7, 0, 4])
    _check(_both(lambda c, l: j_arcface(c, l, 64.0, 0.5),
                 lambda c, l: arcface(c, l, 64.0, 0.5), cos, label))


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "valid_mask"])
def test_bce_loss_matches_jax(masked):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 7), dtype=np.float32) * 20
    logits[0, 0], logits[1, 1] = 75.0, -80.0  # both clamp branches
    gt = rng.random((4, 7)) > 0.8
    gt[1, 1] = True
    valid = np.array([True, True, False, True])
    if masked:
        res = _both(lambda z, g, v: j_bce(z, g, valid=v),
                    lambda z, g, v: bce_loss(z, g, valid=v), logits, gt, valid)
    else:
        res = _both(j_bce, bce_loss, logits, gt)
    _check(res)


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "valid_mask"])
def test_softmax_ce_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 11), dtype=np.float32)
    label = rng.integers(0, 11, 6)
    valid = np.array([True, True, True, False, True, False])
    if masked:
        res = _both(j_ce, softmax_cross_entropy, logits, label, valid)
    else:
        res = _both(j_ce, softmax_cross_entropy, logits, label)
    _check(res)


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "valid_mask"])
def test_moon_contrastive_matches_jax(masked):
    """Value and gradient w.r.t. the trained features (the global and last
    features are constants on both sides)."""
    rng = np.random.default_rng(4)
    z, zg, zl = (rng.standard_normal((5, 16), dtype=np.float32) for _ in range(3))
    valid = np.array([True, False, True, True, True]) if masked else None
    _check(_both(lambda a, b, c: j_moon(a, b, c, 0.5, valid),
                 lambda a, b, c: moon_contrastive(
                     a, b, c, 0.5, None if valid is None else torch.from_numpy(valid)),
                 z, zg, zl))


def test_reweight_negatives_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 9), dtype=np.float32)
    label = np.array([1, 0, 5, 2])
    _check(_both(lambda x, l: j_reweight(x, l, 3, 4),
                 lambda x, l: reweight_negatives(x, l, 3, 4), logits, label))


def test_sgd_matches_jax_update():
    """torch.optim.SGD, as the port's step uses it (config momentum and
    weight decay, lr set per epoch) == the JAX package's SGD transform, over
    three steps with a learning-rate change."""
    rng = np.random.default_rng(6)
    p0 = rng.standard_normal((5, 3), dtype=np.float32)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.SGD([tp], lr=0.1, momentum=0.9, weight_decay=5e-4)
    params = {"w": jnp.asarray(p0)}
    state = sgd_init(params)
    for i, lr in enumerate((0.1, 0.1, 0.01)):
        g = rng.standard_normal((5, 3), dtype=np.float32)
        opt.param_groups[0]["lr"] = lr
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
        params, state = sgd_update(params, {"w": jnp.asarray(g)}, state, lr)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(params["w"]),
                               atol=1e-6)


@pytest.mark.parametrize("epoch", [0, 7, 8, 16])
def test_step_lr_matches_jax(epoch):
    assert step_lr(1.0, epoch, 8) == j_step_lr(1.0, epoch, 8)
