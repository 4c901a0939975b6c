"""One branch train step of the port against the JAX package's, fp32.

The JAX step draws its flip mask from its key; the same mask is handed to
the port's step.  Weights come from the JAX package's ``init`` through
``fedfr_tpu_torch.interop``.  The loss terms and the updated backbone, FC,
BCE and BN statistics agree to atol=1e-5 at run.sh's learning rate; the
loss terms, which are ~20 at random init, also get rtol=1e-6 (a few fp32
ulps at that size).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fedfr_tpu.federated.state import flip_mask
from fedfr_tpu.federated.trainer import init_client_state as j_init_state
from fedfr_tpu.federated.trainer import make_branch_train_step as j_make_step
from fedfr_tpu.models import BCEModule as JBCE
from fedfr_tpu.models import SphNet as JSphNet
from fedfr_tpu.models.factory import ToyNet as JToy

from fedfr_tpu_torch import interop
from fedfr_tpu_torch.federated import init_client_state, make_branch_train_step
from fedfr_tpu_torch.models import BCEModule, build_backbone

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

N_LOCAL, N_GLOBAL = 3, 4
STEP_NO, LR = 3, 0.001  # run.sh --lr


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _tree(t):
    return jax.tree_util.tree_map(np.array, t)


@pytest.mark.parametrize("network,batch,size,emb", [
    ("toy", 4, 16, 16),
    ("sphnet20", 2, 112, 32),
], ids=["toy", "sphere20"])
def test_branch_step_matches_jax(network, batch, size, emb):
    rng = np.random.default_rng(7)
    jnet = (JToy(embedding_size=emb) if network == "toy"
            else JSphNet(depth=20, embedding_size=emb, bf16=False))
    x0 = jnp.zeros((1, size, size, 3))
    jvars, gvars, lvars = (_tree(jnet.init(jax.random.PRNGKey(k), x0))
                           for k in (1, 2, 3))
    jbce = JBCE(hidden=emb, n_class=N_LOCAL)
    bce_vars = _tree(jbce.init(jax.random.PRNGKey(4), jnp.zeros((1, emb)),
                               jnp.zeros((1,), jnp.int32)))
    fc0 = (0.1 * rng.standard_normal((N_LOCAL + N_GLOBAL, emb))).astype(np.float32)
    u8 = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
    labels = np.array([0, 5, 2, 6][:batch], np.int32)  # local and public rows
    valid = np.array([True, True, True, False][:batch])
    key = jax.random.PRNGKey(9)

    jstep = j_make_step(jnet, jbce, num_local=N_LOCAL, num_clients=5,
                        donate=False)
    jstate, jm = jstep(j_init_state(jvars, jnp.asarray(fc0), bce_vars), gvars,
                       lvars, jnp.asarray(u8), jnp.asarray(labels),
                       jnp.asarray(valid), jnp.float32(LR), key, STEP_NO)
    flip = np.asarray(flip_mask(jax.random.fold_in(key, STEP_NO), batch))

    def net(variables):
        m = build_backbone(network, emb, bf16=False, image_size=size)
        m.load_state_dict(interop.backbone_state_dict(network, variables))
        return m

    bce = BCEModule(emb, N_LOCAL)
    bce.load_state_dict(interop.bce_state_dict(bce_vars))
    state = init_client_state(net(jvars), torch.from_numpy(fc0), bce, LR)
    step = make_branch_train_step(num_local=N_LOCAL, num_clients=5)
    state, m = step(state, net(gvars).eval(), net(lvars).eval(),
                    torch.from_numpy(u8), torch.from_numpy(labels),
                    torch.from_numpy(valid), LR, torch.from_numpy(flip))

    for name, got, want in zip(("loss", "cos", "bce", "con"), m, jm):
        np.testing.assert_allclose(float(got), float(want), atol=1e-5,
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(state.fc.detach().numpy(), np.asarray(jstate.fc),
                               atol=1e-5, rtol=0)
    want_bce = interop.bce_state_dict(_tree(jstate.bce))
    for k, v in state.bce.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_bce[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    # backbone params and, for toy, the BN running statistics
    want_bb = interop.backbone_state_dict(network, _tree(jstate.backbone))
    for k, v in state.backbone.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(v.detach().numpy(), want_bb[k].numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
    # the step moved the weights (a no-op step would pass the checks above)
    moved = interop.backbone_state_dict(network, jvars)
    assert any(float((v - moved[k]).abs().max()) > 1e-4
               for k, v in state.backbone.state_dict().items()
               if v.is_floating_point())
