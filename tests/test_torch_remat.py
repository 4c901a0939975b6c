"""``--remat`` (the JAX ``remat_blocks``): every residual block of sphnet
and iresnet under ``torch.utils.checkpoint``, fp32 on the CPU.

* sphnet20 and iresnet18 at 112x112 against the same nets without it: the
  forward bitwise (train and eval mode), the BN running statistics after a
  train step equal (a recompute that updated them a second time would not
  be), the gradients within 1e-6 (JAX ``tests/test_models.py:305``);
* against the JAX ``remat_blocks=True`` model from the same weights: the
  train-mode forward and the updated BN statistics within the model
  tests' 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedfr_tpu.models import build_backbone as jax_backbone

from fedfr_tpu_torch import interop
from fedfr_tpu_torch.models import build_backbone

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)

def _train_pass(net, x):
    """One train-mode forward and backward of mean(f^2); returns the
    features and the gradients by parameter name."""
    net.train()
    net.zero_grad(set_to_none=True)
    feats = net(x)
    feats.square().mean().backward()
    return feats.detach(), {k: p.grad for k, p in net.named_parameters()
                            if p.grad is not None}


@pytest.mark.parametrize("name", ["sphnet20", "iresnet18"])
def test_remat_is_transparent(name):
    """``--remat`` changes no forward output and no BN running statistic,
    and the gradients agree within 1e-6 (JAX tests/test_models.py:305)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 112, 112, generator=gen)
    nets = [build_backbone(name, 64, bf16=False, remat=remat,
                           generator=torch.Generator().manual_seed(2))
            for remat in (False, True)]
    (fa, ga), (fb, gb) = (_train_pass(n, x) for n in nets)
    assert torch.equal(fa, fb)
    assert ga.keys() == gb.keys() and ga
    for k in ga:
        np.testing.assert_allclose(gb[k].numpy(), ga[k].numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)
    bufs = [dict(n.named_buffers()) for n in nets]
    assert bufs[0].keys() == bufs[1].keys()
    for k, v in bufs[0].items():
        assert torch.equal(bufs[1][k], v), k
    nets[0].eval(), nets[1].eval()
    with torch.no_grad():
        assert torch.equal(nets[0](x), nets[1](x))


@pytest.mark.parametrize("name,depth", [("sphnet20", 20), ("iresnet18", 18)])
def test_remat_matches_jax_remat_model(name, depth):
    """The port's remat model against the JAX ``remat_blocks=True`` model
    from the same weights: the train-mode forward and, for iresnet, the
    updated BN statistics within the model tests' 1e-4."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 112, 112, 3)).astype(np.float32)
    jnet = jax_backbone(name, 64, bf16=False, remat_blocks=True)
    jvars = _np_tree(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    convert = (interop.sphnet_state_dict if name.startswith("sphnet")
               else interop.iresnet_state_dict)
    net = build_backbone(name, 64, bf16=False, remat=True)
    net.load_state_dict(convert(jvars, depth))
    net.train()
    feats = net(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    if "batch_stats" in jvars:
        jfeats, mutated = jnet.apply(jvars, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
        want = convert(dict(jvars, batch_stats=_np_tree(mutated["batch_stats"])), depth)
        for k, v in net.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-4,
                                           rtol=1e-4, err_msg=k)
    else:
        jfeats = jnet.apply(jvars, jnp.asarray(x), train=True)
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(jfeats),
                               atol=1e-4, rtol=1e-4)
