"""Two training rounds of the port against the JAX package's ``Server``.

A tiny rec split (toy backbone, fp32); the JAX server's initial global
model and client states are carried into the port with
``fedfr_tpu_torch.interop`` and the JAX steps' flip masks are injected
through ``Client.flip_fn``, so both sides start alike and see the same
batches.  Per round: per-client losses (rtol=1e-4), mined subset sizes
(exact), aggregated global weights and the averaged global FC (atol=1e-4).
"""

import os

import numpy as np
import jax
import pytest
import torch

from fedfr_tpu.config import FedFRConfig as JConfig
from fedfr_tpu.data.datasets import AllClientData as JData
from fedfr_tpu.federated import Server as JServer
from fedfr_tpu.federated.client import _run_key
from fedfr_tpu.federated.state import flip_mask

from fedfr_tpu_torch import interop
from fedfr_tpu_torch.config import FedFRConfig
from fedfr_tpu_torch.data import AllClientData, codec, write_split
from fedfr_tpu_torch.federated import Server

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

NUM_CLIENTS, IDS, IMG, PUB_IDS = 2, 3, 16, 6


@pytest.fixture(scope="module")
def fl_root(tmp_path_factory):
    """2 clients x 3 IDs x 8 images and a 6-ID x 5-image public split, in the
    style of tests/test_federated.py."""
    root = tmp_path_factory.mktemp("torch_fl")
    rng = np.random.default_rng(7)

    def write(d, ids, per, id_base):
        os.makedirs(d, exist_ok=True)
        payloads, labels = [], []
        for i in range(ids):
            base = rng.integers(0, 200, size=(IMG, IMG, 3))
            for _ in range(per):
                img = np.clip(base + rng.integers(-40, 40, size=(IMG, IMG, 3)), 0, 255)
                payloads.append(codec.encode_raw(img.astype(np.uint8)))
                labels.append(i)
        write_split(os.path.join(d, "train.idx"), os.path.join(d, "train.rec"),
                    payloads, labels, num_classes=ids, id_base=id_base)

    split = root / ("split_train_i%04dc%04d" % (NUM_CLIENTS * IDS, NUM_CLIENTS))
    for c in range(NUM_CLIENTS):
        write(str(split / ("client_%04d" % c)), IDS, 8, c * IDS)
    write(str(root / "split_pretrain_6000" / "client_0000"), PUB_IDS, 5, None)
    return str(root)


def _configure(cfg, root):
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


def _assert_state_close(sd, jvars, atol):
    want = interop.toy_state_dict(_np_tree(jvars))
    for k, v in sd.items():
        if v.is_floating_point():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=atol,
                                       rtol=0, err_msg=k)


def test_two_rounds_match_jax_server(fl_root):
    jcfg = _configure(JConfig(), fl_root)
    jserver = JServer(jcfg, JData(jcfg))
    # mine about half the public set: a threshold between two middle scores
    # of the first round's mining (a random toy net puts every score high)
    from fedfr_tpu.federated.embed import embed_dataset, max_similarity
    pub_feats, _ = embed_dataset(jserver._embed_fn, jserver.federated_vars,
                                 jserver.data.public_dataset, 16)
    loc_feats, _ = embed_dataset(jserver._embed_fn, jserver.federated_vars,
                                 jserver.clients[0].dataset, 16)
    scores = np.sort(max_similarity(loc_feats, pub_feats, backend="xla"))
    threshold = float(scores[len(scores) // 2 - 1] + scores[len(scores) // 2]) / 2

    cfg = _configure(FedFRConfig(), fl_root)
    cfg.runtime.device = "cpu"
    jcfg.fed.hn_threshold = cfg.fed.hn_threshold = threshold
    server = Server(cfg, AllClientData(cfg))

    # carry the JAX server's initial state into the port
    server.global_net.load_state_dict(
        interop.toy_state_dict(_np_tree(jserver.federated_vars)))
    server._init_pretrain_fc()
    np.testing.assert_allclose(server.pretrained_fc.numpy(),
                               np.asarray(jserver.pretrained_fc), atol=1e-5)
    assert server.local_candidates == jserver.local_candidates
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
        _assert_state_close(server.global_net.state_dict(),
                            jserver.federated_vars, atol=1e-4)
        np.testing.assert_allclose(server.pretrained_fc.numpy(),
                                   np.asarray(jserver.pretrained_fc), atol=1e-4)
        for s in (jserver, server):
            s.advance_round()
    # mining kept a strict, non-empty subset at least once
    assert any(0 < m < PUB_IDS * 5 for m in mined), mined
    assert server.local_epoch == jserver.local_epoch == 4
