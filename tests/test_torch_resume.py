"""Round-level resume of the port (``utils/checkpoint.py::RoundCheckpointer``
and the training CLI's ``--resume``), on the CPU at toy size.

* a save and a restore give bitwise-equal state, meta and sampling RNG;
* ``main()`` for two rounds, then ``--resume --total_round 3``, ends with
  the global state and ``.bin`` best table of an uninterrupted three-round
  ``main()``, bitwise;
* ``keep=1`` prunes, and a data file without a meta is swept and never
  restored;
* an async writer's error surfaces on ``wait()``;
* under ``bg_fetch`` a snapshot taken before a round still holds the
  pre-round state after the round rewrote the server in place.
"""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from fedfr_tpu_torch import train as train_cli
from fedfr_tpu_torch.config import FedFRConfig
from fedfr_tpu_torch.data import AllClientData
from fedfr_tpu_torch.federated import Server
from fedfr_tpu_torch.models import ToyNet
from fedfr_tpu_torch.utils.checkpoint import RoundCheckpointer

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

CLIENTS, IDS, IMG = 2, 3, 16


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_resume"))
    chip_smoke.write_fl_split(root, CLIENTS, IDS, imgs_per_id=8, pub_ids=6,
                              pub_imgs=5, size=IMG, seed=0, veri_imgs=6)
    chip_smoke.write_bin(os.path.join(root, "val", "agedb_30.bin"), n_pairs=40,
                         size=IMG, seed=1)
    return root


def _server(root, **fed):
    cfg = FedFRConfig()
    cfg.runtime.device = "cpu"
    cfg.data.rec_root = root
    cfg.data.num_clients, cfg.data.num_ids = CLIENTS, CLIENTS * IDS
    cfg.data.image_size, cfg.data.num_workers = IMG, 2
    cfg.data.combined_batch_size, cfg.data.public_batch_size = 8, 16
    cfg.data.eval_batch_size = 16
    cfg.model.network, cfg.model.embedding_size, cfg.model.bf16 = "toy", 8, False
    cfg.optim.lr = 0.01
    cfg.fed.local_epochs = 1
    cfg.fed.client_sampled_ratio = 0.5
    for k, v in fed.items():
        setattr(cfg.fed, k, v)
    return Server(cfg, AllClientData(cfg))


def _flat(server) -> dict:
    """Every tensor of the resume state, cloned, by a flat key."""
    out = {f"global.{k}": v.clone() for k, v in server.global_net.state_dict().items()}
    out["pretrained_fc"] = server.pretrained_fc.clone()
    for c in server.clients:
        out[f"c{c.cid}.fc_local"] = c.fc_local.clone()
        for name in ("bce_state", "last_backbone"):
            for k, v in (getattr(c, name) or {}).items():
                out[f"c{c.cid}.{name}.{k}"] = v.clone()
    return out


def _assert_bitwise(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _round(server) -> None:
    server.current_client_list = server.sample_clients()
    server.train_round()
    server.advance_round()


def test_save_restore_round_trip(root, tmp_path):
    server = _server(root)
    _round(server)
    ckpt = RoundCheckpointer(str(tmp_path / "rounds"))
    path = ckpt.save(server, extra={"best": [[0, 0.5]]})
    assert path.endswith("round_1.pt") and ckpt.latest() == 1
    want = _flat(server)
    meta = (server.global_round, server.global_epoch, server.local_epoch,
            server.train_decay)
    next_sample = server.sample_clients()

    fresh = _server(root)
    assert fresh.global_round == 0
    assert RoundCheckpointer(str(tmp_path / "rounds")).restore(fresh) == 1
    _assert_bitwise(_flat(fresh), want)
    assert (fresh.global_round, fresh.global_epoch, fresh.local_epoch,
            fresh.train_decay) == meta
    assert fresh.sample_clients() == next_sample
    ckpt2 = RoundCheckpointer(str(tmp_path / "rounds"))
    ckpt2.restore(_server(root))
    assert ckpt2.last_extra == {"best": [[0, 0.5]]}


def _argv(root, out, rounds):
    argv = chip_smoke.round_args(root, CLIENTS, IDS, device="cpu", network="toy",
                                 embedding=16, image_size=IMG, batch=8,
                                 local_epochs=1, rounds=rounds, eval_batch=16)
    argv[argv.index("--output_dir") + 1] = out
    return argv + ["--num_workers", "2", "--lr", "0.01", "--client_sampled_ratio", "0.5"]


def test_resumed_run_equals_uninterrupted_run(root, tmp_path):
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")

    def main(argv):
        # each run as a fresh process: the toy net draws its initial weights
        # from torch's global generator, which a process starts at one seed
        with torch.random.fork_rng():
            torch.manual_seed(0)
            return train_cli.main(train_cli.build_parser().parse_args(argv))
    main(_argv(root, straight, 3))
    main(_argv(root, resumed, 2))
    history = main(_argv(root, resumed, 3) + ["--resume"])
    assert [h["round"] for h in history] == [2]
    log = open(os.path.join(resumed, "training.log")).read()
    assert "resumed at round 2" in log
    for name in ("backbone_2.pth", "backbone.pth"):
        a = torch.load(os.path.join(straight, name))
        b = torch.load(os.path.join(resumed, name))
        _assert_bitwise(b, a)
    metas = [json.load(open(os.path.join(d, "rounds", "round_3.meta.json")))
             for d in (straight, resumed)]
    assert metas[1] == metas[0] and metas[0]["extra"]["best"]
    states = [torch.load(os.path.join(d, "rounds", "round_3.pt")) for d in
              (straight, resumed)]
    _assert_bitwise(states[1]["global"], states[0]["global"])


def _fake_server(round_idx: int):
    """A stand-in with the attributes the checkpointer reads."""
    client = SimpleNamespace(cid=0, fc_local=torch.full((2, 4), float(round_idx)),
                             bce_state=None, last_backbone=None)
    return SimpleNamespace(global_net=ToyNet(4), pretrained_fc=None,
                           clients=[client], global_round=round_idx,
                           global_epoch=round_idx, local_epoch=1, train_decay=1,
                           rng=np.random.default_rng(0), device=torch.device("cpu"))


def test_keep_prunes_and_orphans_are_swept(tmp_path):
    d = str(tmp_path / "rounds")
    ckpt = RoundCheckpointer(d, keep=1)
    ckpt.save(_fake_server(1))
    shutil.copy(os.path.join(d, "round_1.pt"), os.path.join(d, "round_7.pt"))
    assert ckpt.latest() == 1  # a data file without meta is never a round
    server = _fake_server(0)
    assert ckpt.restore(server) == 1 and float(server.clients[0].fc_local[0, 0]) == 1.0
    ckpt.save(_fake_server(2))
    assert sorted(os.listdir(d)) == ["round_2.meta.json", "round_2.pt"]


def test_async_writer_error_surfaces_on_wait(tmp_path):
    d = str(tmp_path / "rounds")
    ckpt = RoundCheckpointer(d, async_write=True)
    shutil.rmtree(d)  # the writer's torch.save then fails
    ckpt.save(_fake_server(1))
    with pytest.raises(RuntimeError, match="does not exist"):
        ckpt.wait()
    ckpt.wait()  # raised once


def test_bg_fetch_snapshot_holds_the_pre_round_state(root, tmp_path):
    server = _server(root, client_sampled_ratio=1.0)
    _round(server)
    before = _flat(server)
    snap = RoundCheckpointer(str(tmp_path / "a"), bg_fetch=True).snapshot(server)
    ckpt = RoundCheckpointer(str(tmp_path / "b"), bg_fetch=True)
    ckpt.save(server)
    _round(server)  # rewrites the global weights in place, rebinds the rest
    ckpt.wait()
    after = _flat(server)
    assert not torch.equal(after["global.fc.weight"], before["global.fc.weight"])
    flat = {f"global.{k}": v for k, v in snap["global"].items()}
    flat["pretrained_fc"] = snap["pretrained_fc"]
    for cid, cs in snap["clients"].items():
        flat[f"{cid}.fc_local"] = cs["fc_local"]
        flat.update({f"{cid}.bce_state.{k}": v for k, v in cs.get("bce", {}).items()})
        flat.update({f"{cid}.last_backbone.{k}": v for k, v in cs.get("last", {}).items()})
    _assert_bitwise(flat, before)
    saved, meta = ckpt.load(1)
    _assert_bitwise({f"global.{k}": v for k, v in saved["global"].items()},
                    {k: v for k, v in before.items() if k.startswith("global.")})
    assert meta["global_round"] == 1
