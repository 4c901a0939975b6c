"""The port's training CLI (``python -m fedfr_tpu_torch.train``) on the CPU.

* its parser accepts every flag of the repository's train.py (read by AST);
* ``build_config`` gives the JAX CLI's config from the same arguments;
* the flags once refused as unported (``--lockstep``, ``--remat``) pass
  ``check_flags``, the resume-state flags run, and the CLI and the eval
  callbacks default to ``cuda`` and raise without it;
* two toy rounds through ``main`` on data written by chip_smoke.py's own
  writers: local_log.txt as parse_log.py reads it (the epoch -1 baseline,
  then one entry per round), the .bin accuracy, training.log and the .pth
  exports; a round whose argv carries run.sh's ``--pretrained_root`` and
  ``--fedface``, and the source snapshot in ``<output_dir>/code``; and
  chip_smoke.py's phases, rehearsed on the CPU (phase 4 with the CLI's
  ``--profile``, phase 8 on a tiny ``synth:`` universe, phase 11's
  lockstep rounds over 3 clients, phase 14's native reader and its round
  over a JPEG root).
"""

import ast
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import parse_log
import train as jax_train
from fedfr_tpu_torch import train as train_cli
from fedfr_tpu_torch.evalsuite import local_eval as tle
from fedfr_tpu_torch.evalsuite import verification as tver
from fedfr_tpu_torch.models import ToyNet

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

REPO = Path(__file__).resolve().parent.parent
CLIENTS, IDS, IMG = 2, 3, 16


def _root_train_flags():
    tree = ast.parse((REPO / "train.py").read_text())
    flags = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flags += [a.value for a in node.args
                      if isinstance(a, ast.Constant) and str(a.value).startswith("--")]
    return flags


def test_parser_accepts_every_flag_of_train_py():
    flags = _root_train_flags()
    assert len(flags) >= 50 and "--BCE_local" in flags and "--round_ckpt_bg_fetch" in flags
    accepted = train_cli.build_parser()._option_string_actions
    assert [f for f in flags if f not in accepted] == []


def test_build_config_matches_jax_cli():
    argv = ["--network", "toy", "--num_client", "4", "--lr", "0.01", "--BCE_local",
            "--contrastive_bb", "--HN_cap", "7", "--val_targets", "lfw,agedb_30",
            "--client_ckpt_every", "2", "--converter_layer", "1", "--seed", "5"]
    args = train_cli.build_parser().parse_args(argv)
    got = dataclasses.asdict(train_cli.build_config(args))
    want = dataclasses.asdict(jax_train.build_config(args))
    assert got["runtime"].pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("argv,item", [
    (["--lockstep", "2"], "item 13"),
    (["--remat"], "item 13"),
])
def test_unported_flags_raise(argv, item, tmp_path):
    """The flags of ROADMAP queue A ``item`` are ported now: ``check_flags``
    accepts them, their help no longer names the item, and the config
    carries them (``fed.lockstep``, ``model.remat_blocks``)."""
    parser = train_cli.build_parser()
    args = parser.parse_args(argv + ["--output_dir", str(tmp_path), "--device", "cpu"])
    train_cli.check_flags(args)
    assert item not in parser.format_help()
    cfg = train_cli.build_config(args)
    assert (cfg.fed.lockstep, cfg.model.remat_blocks) == (
        (2, False) if "--lockstep" in argv else (1, True))


@pytest.mark.parametrize("argv,rounds_left", [
    (["--resume"], [0]),
    (["--round_ckpt_async"], [0, 1]),
    (["--round_ckpt_bg_fetch"], [0, 1]),
    (["--round_ckpt_keep", "1"], [1]),
])
def test_resume_state_flags_run(argv, rounds_left, smoke_root, tmp_path):
    """The resume flags parse and run two toy rounds (one round for
    ``--resume`` on a fresh directory, which starts at round 0 and says so);
    the complete round states left behind follow ``--round_ckpt_keep``."""
    out = str(tmp_path / "run")
    total = 1 if "--resume" in argv else 2
    args = train_cli.build_parser().parse_args(
        _argv(smoke_root, out) + argv + ["--total_round", str(total)])
    history = train_cli.main(args)
    assert [h["round"] for h in history] == list(range(total))
    assert all(np.isfinite(h["avg_loss"]) for h in history)
    rounds = sorted(f for f in os.listdir(os.path.join(out, "rounds")))
    assert rounds == sorted(f"round_{r + 1}{x}" for r in rounds_left
                            for x in (".pt", ".meta.json"))
    log = open(os.path.join(out, "training.log")).read()
    assert ("no complete round state" in log) == ("--resume" in argv)


def test_cli_and_callbacks_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = train_cli.build_parser().parse_args(["--output_dir", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(args)
    data = np.zeros((4, IMG, IMG, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tver.test_bin(ToyNet(8), data, np.array([True, False]), batch_size=4)
    cb = tle.LocalVerificationCallback(ToyNet(8), None, veri_dataset=None,
                                       output_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cb.veri_test(ToyNet(8).state_dict(), 0, [0, 1], 0)


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    """chip_smoke.py's data at toy size: 2 clients x 3 IDs, a 6-ID public
    set, a local_veri split of 6 images per ID and a 40-pair .bin."""
    root = str(tmp_path_factory.mktemp("torch_cli"))
    chip_smoke.write_fl_split(root, CLIENTS, IDS, imgs_per_id=8, pub_ids=6,
                              pub_imgs=5, size=IMG, seed=0, veri_imgs=6)
    chip_smoke.write_bin(os.path.join(root, "val", "agedb_30.bin"), n_pairs=40,
                         size=IMG, seed=1)
    return root


def _argv(root, out):
    argv = chip_smoke.round_args(root, CLIENTS, IDS, device="cpu", network="toy",
                                 embedding=16, image_size=IMG, batch=8,
                                 local_epochs=1, eval_batch=16)
    argv[argv.index("--output_dir") + 1] = out
    return argv + ["--num_workers", "2", "--lr", "0.01"]


def test_main_runs_two_rounds_with_eval(smoke_root, tmp_path):
    out = str(tmp_path / "run")
    history = train_cli.main(train_cli.build_parser().parse_args(_argv(smoke_root, out)))
    assert [h["round"] for h in history] == [0, 1]
    for h in history:
        assert h["clients"] == [0, 1]
        assert np.isfinite(h["avg_loss"]) and len(h["acc"]) == 1
        assert 0.0 <= h["acc"][0] <= 1.0
        assert h["local_eval_s"] > 0 and h["bin_eval_s"] > 0
    for cid in (0, 1):
        acc = parse_log.parse(os.path.join(out, "clients", f"client_{cid}",
                                           "local_log.txt"))
        assert list(acc) == [cid * IDS]
        assert [e for e, _ in acc[cid * IDS]] == [-1, 0, 4]
        assert all(len(t) == 6 for _, t in acc[cid * IDS])
    log = open(os.path.join(out, "training.log")).read()
    assert "Training: " in log and "====== Round 1 ======" in log
    assert "resumed at" not in log and "--resume" not in log
    assert "[agedb_30][1]Accuracy-Flip" in log and "training done" in log
    for f in ["backbone_0.pth", "backbone_1.pth", "backbone.pth",
              "clients/client_0/backbone.pth", "clients/client_1/bce_module.pth"]:
        assert os.path.exists(os.path.join(out, f)), f
    sd = torch.load(os.path.join(out, "backbone_1.pth"))
    assert set(sd) == set(ToyNet(16).state_dict())
    for r in (1, 2):  # the resume state after each round
        assert os.path.exists(os.path.join(out, "rounds", f"round_{r}.meta.json"))
    bce = torch.load(os.path.join(out, "clients", "client_0", "bce_module.pth"))
    assert set(bce) == {"weight", "bias", "converter.0.weight", "converter.0.bias"}


def test_cli_writes_final_client_exports_off_cadence(smoke_root, tmp_path):
    """--client_ckpt_every 0 writes no per-round client exports, so the end
    of the run writes them once; --round_ckpt_every 0 still exports the
    final round."""
    out = str(tmp_path / "run")
    argv = _argv(smoke_root, out) + ["--total_round", "1", "--client_ckpt_every", "0",
                                     "--round_ckpt_every", "0"]
    train_cli.main(train_cli.build_parser().parse_args(argv))
    assert os.path.exists(os.path.join(out, "backbone_0.pth"))
    assert os.path.exists(os.path.join(out, "clients", "client_1", "backbone.pth"))
    assert "saving final per-client checkpoints" in open(
        os.path.join(out, "training.log")).read()


NO_LAUNCHES = {"max_sim": 0, "roc_hist": 0, "synth_gen": 0}


def test_chip_smoke_round_phase_rehearsed_on_cpu(smoke_root, tmp_path):
    """The smoke's round phase (the CLI's setup/run_round/finish under
    ``--profile``, the trace, span-report, memory-line, log and export
    checks) at toy size on the CPU, where the kernels' plain versions run
    and no launch is counted."""
    launches = chip_smoke.phase_round(_argv(smoke_root, str(tmp_path / "run"))
                                      + ["--profile"])
    assert launches == NO_LAUNCHES
    assert os.path.exists(os.path.join(str(tmp_path / "run"), "torch_trace",
                                       "trace.json"))


def test_main_runs_from_pretrained_root_and_snapshots_the_source(smoke_root, tmp_path):
    """run.sh's --pretrained_root and --fedface: the backbone, FC and labels
    come from the root (with the JAX package's log texts), and setup copies
    the source to <output_dir>/code without caches."""
    pre = str(tmp_path / "pretrain")
    chip_smoke.write_pretrained_root(pre, "toy", 16, IMG, pub_ids=6, pub_imgs=5,
                                     seed=3)
    out = str(tmp_path / "run")
    argv = _argv(smoke_root, out) + ["--total_round", "1", "--pretrained_root", pre,
                                     "--fedface"]
    t = train_cli.setup(train_cli.build_parser().parse_args(argv))
    sd = torch.load(os.path.join(pre, "backbone.pth"))
    for k, v in t.server.global_net.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    torch.testing.assert_close(t.server.pretrained_fc,
                               torch.load(os.path.join(pre, "fc.pth")), rtol=0, atol=0)
    while not t.done:
        assert np.isfinite(train_cli.run_round(t)["avg_loss"])
    train_cli.finish(t)
    log = open(os.path.join(out, "training.log")).read()
    for text in ("loaded pretrained backbone from " + os.path.join(pre, "backbone.pth"),
                 "loaded pretrain labels (30,)", "loaded pretrained perfect FC (6, 16)"):
        assert text in log
    assert "train from scratch" not in log
    code = os.path.join(out, "code")
    for f in ("train.py", "chip_smoke.py", "fedfr_tpu_torch/train.py",
              "fedfr_tpu_torch/csrc/roc_hist.cu", "split_dataset/split_FL.py"):
        assert os.path.exists(os.path.join(code, f)), f
    assert not os.path.exists(os.path.join(code, "fedfr_tpu"))
    for _, dirs, files in os.walk(code):
        assert "__pycache__" not in dirs and "build" not in dirs
        assert not [f for f in files if f.endswith((".pyc", ".so"))]


def test_chip_smoke_pretrained_and_local_all_phases_rehearsed_on_cpu(smoke_root,
                                                                     tmp_path):
    """The smoke's pretrained-root round and its three local_all calls, at
    toy size on the CPU (iresnet18 with the BottleBlock converter), where
    the kernels' plain versions run and no launch is counted."""
    pre = str(tmp_path / "pre")
    chip_smoke.write_pretrained_root(pre, "iresnet18", 16, IMG, pub_ids=6,
                                     pub_imgs=5, seed=3)
    argv = chip_smoke.pretrained_args(smoke_root, CLIENTS, IDS, pre, device="cpu",
                                      network="iresnet18", embedding=16,
                                      image_size=IMG, batch=8, local_epochs=1,
                                      eval_batch=16)
    argv[argv.index("--output_dir") + 1] = out = str(tmp_path / "run")
    argv += ["--num_workers", "2", "--lr", "0.01"]
    assert chip_smoke.phase_pretrained(argv) == NO_LAUNCHES
    assert chip_smoke.phase_local_all(out, smoke_root, CLIENTS, IDS, "iresnet18", 16,
                                      converter_layer=2, device="cpu",
                                      batch=16) == NO_LAUNCHES


def test_chip_smoke_paths_phase_rehearsed_on_cpu(smoke_root):
    """The smoke's phase 7 at toy size on the CPU: cached contrastive +
    SpreadOut (with the cached step held against the recompute step at
    1e-5), resume twice (bitwise restore, the replayed client sample, one
    state kept under --round_ckpt_keep 1), FC-row mining and the plain
    objective, with their checks; no launch is counted here."""
    by_part = chip_smoke.phase_paths(smoke_root, CLIENTS, IDS, device="cpu",
                                     network="toy", embedding=16, image_size=IMG,
                                     batch=8, local_epochs=1, eval_batch=16)
    assert list(by_part) == ["7a_cached_spreadout", "7b_resume", "7c_fc_mining",
                             "7d_plain"]
    assert all(v == NO_LAUNCHES for v in by_part.values())


def test_chip_smoke_lockstep_phase_rehearsed_on_cpu(tmp_path):
    """The smoke's phase 11 at toy size on the CPU: --lockstep 2 over 3
    clients (groups [0, 1] and [2 + a pad]) for 1 round with its checks
    (the lockstep and group lines, exports, local_log.txt, a changed global
    model), the cached step with --remat, the plain objective, then the
    step checks (sphnet20, and iresnet18 with --remat, against sequential
    steps) and the step timings at K = 1, 2, 4 and 4 with --remat; no
    launch is counted here."""
    root = str(tmp_path / "lockstep")
    chip_smoke.write_fl_split(root, 3, IDS, imgs_per_id=8, pub_ids=6, pub_imgs=5,
                              size=IMG, seed=0, veri_imgs=6)
    chip_smoke.write_bin(os.path.join(root, "val", "agedb_30.bin"), n_pairs=40,
                         size=IMG, seed=1)
    by_part = chip_smoke.phase_lockstep(
        root, 3, IDS, step_net="sphnet20", check_net="iresnet18", step_image=IMG,
        step_batch=8, device="cpu", network="toy", embedding=16, image_size=IMG,
        batch=8, local_epochs=1, eval_batch=16)
    assert list(by_part) == ["11a", "11b", "11c"]
    assert all(v == NO_LAUNCHES for v in by_part.values())


def test_chip_smoke_mesh_phase_rehearsed_on_cpu(tmp_path):
    """The smoke's phase 12 at toy size on two shards of the CPU: the
    sharded ROC bit for bit (12a), the data-axis embed of a tiny synth:
    public set (12b), the busy-share windows (12g, not measured on the
    CPU), run.sh's round over the mesh with 3 clients for 2
    rounds against the one-device round at --lockstep 2 in bf16 and fp32
    (12c, 12e), the cached and plain rounds over the mesh (12d), with its
    log-line, export and local_log.txt checks; no launch is counted here."""
    devices = chip_smoke.mesh_devices("cpu")
    assert devices == [torch.device("cpu")] * 2
    spec = ("synth:image_size=16,imgs_min=2,imgs_max=2,public_ids=20,public_imgs=40,"
            "veri_ids=40,veri_imgs=2")
    by_part = chip_smoke.phase_mesh(
        str(tmp_path / "mesh"), devices, ids=IDS, pub_ids=6, roc_shape=(301, 40, 16),
        embed_spec=spec, embed_sample=16, busy_images=16, device="cpu", network="toy",
        embedding=16,
        image_size=IMG, batch=8, local_epochs=1, eval_batch=16)
    assert list(by_part) == ["12c", "12d_cached", "12d_plain"]
    assert all(v == NO_LAUNCHES for v in by_part.values())


def test_chip_smoke_pretrain_mesh_phase_rehearsed_on_cpu(tmp_path):
    """The smoke's phase 13 at toy size on two shards of the CPU: the
    sharded losses against one device at 6,000 and 6,001 classes (13a), the pretraining CLI over the
    mesh (a full epoch, a sampled one, the replicas and artefact checks)
    and against one device in bf16 and fp32 (13b), the step figures (13c),
    BN over the whole batch with iresnet18 in place of iresnet100 (13d: the
    BN statistics and parameters after a step against one device in bf16
    and fp32, the losses and BN statistics of two steps in float64, and the
    controls with BN over each shard beyond both bounds); no launch is
    counted here."""
    devices = chip_smoke.mesh_devices("cpu")
    spec = ("synth:image_size=16,imgs_min=2,imgs_max=2,public_ids=21,public_imgs=48,"
            "veri_ids=4,veri_imgs=2")
    argv = chip_smoke.pretrain_argv(spec, str(tmp_path / "pre"), device="cpu",
                                    network="toy", embedding=16, image_size=IMG,
                                    batch=8)
    argv = chip_smoke.with_flag(argv, "--log_every", "2") + ["--num_workers", "2"]
    launches = chip_smoke.phase_pretrain_mesh(
        str(tmp_path), devices, argv, short_spec=spec.replace("public_imgs=48", "public_imgs=24"),
        iters=2, bn_network="iresnet18")
    assert launches == NO_LAUNCHES
    assert os.path.exists(tmp_path / "pre_sampled" / "fc.pth")
    assert torch.load(tmp_path / "pre" / "fc.pth").shape == (21, 16)


def test_chip_smoke_native_phase_rehearsed_on_cpu(smoke_root, tmp_path):
    """The smoke's phase 14 at toy size on the CPU: the JPEG rec and its
    variants read natively byte for byte as ``codec.decode`` reads them
    (14b), the reader's rates (14c), and run.sh's round over the JPEG root
    through the CLI with the native counters, then the public embed on both
    planes with equal features (14d); no launch is counted here."""
    launches = chip_smoke.phase_native(
        str(tmp_path / "native"), os.path.join(smoke_root, "val"), n_images=64,
        rate_images=32, variant_images=8, clients=CLIENTS, ids=IDS, device="cpu",
        network="toy", embedding=16, image_size=IMG, batch=8, eval_batch=16,
        embed_batch=16, workers=2)
    assert launches == NO_LAUNCHES
    assert os.path.exists(tmp_path / "native" / "run" / "backbone_0.pth")


def test_chip_smoke_reference_phase_rehearsed_on_cpu(smoke_root, tmp_path, monkeypatch):
    """The smoke's phase 8 (run.sh's round on the synth: universe through
    the CLI, one local-eval candidate, the launch-shape, batch-count, span
    and memory checks) on a tiny universe and toy widths on the CPU."""
    spec = ("synth:imgs_min=5,imgs_max=7,public_ids=40,public_imgs=90,"
            "veri_ids=120,veri_imgs=3")
    argv = chip_smoke.reference_args(os.path.join(smoke_root, "val"),
                                     str(tmp_path / "ref"))
    for flag, value in (("--network", "toy"), ("--embedding_size", "16"),
                        ("--image_size", str(IMG)), ("--com_batch_size", "8"),
                        ("--eval_batch_size", "16"), ("--public_batch_size", "16"),
                        ("--num_ids", "120"), ("--HN_cap", "20"),
                        ("--rec_root", spec), ("--local_rec", spec)):
        argv[argv.index(flag) + 1] = value
    argv += ["--device", "cpu", "--num_workers", "2"]
    # the universe's sizes: 90 public and 120 x 3 veri images, 3 x 3 targets
    monkeypatch.setattr(chip_smoke, "REF_PUBLIC", 90)
    monkeypatch.setattr(chip_smoke, "REF_VERI", 360)
    monkeypatch.setattr(chip_smoke, "REF_TARGETS", 9)
    assert chip_smoke.phase_reference(argv) == NO_LAUNCHES


def test_chip_smoke_pretrain_and_ijbc_phases_rehearsed_on_cpu(smoke_root, tmp_path):
    """The smoke's phases 9 and 10 at toy size on the CPU: the pretraining
    CLI's three runs (2 epochs, --resume to 3, a sampled epoch), the
    artefact checks and the training CLI's setup from the root; then the
    synthetic IJB-C root at miniature counts, ijbc_all twice on the device
    engine (bitwise), the host engine through --load_feature, and
    ijbc_conti over phase 4's two exports; no launch is counted here."""
    spec = ("synth:imgs_min=5,imgs_max=7,public_ids=12,public_imgs=48,"
            "veri_ids=6,veri_imgs=4")
    argv = chip_smoke.pretrain_argv(spec, str(tmp_path / "pre"), device="cpu",
                                    network="toy", embedding=16, image_size=IMG,
                                    batch=8)
    argv = chip_smoke.with_flag(argv, "--log_every", "2") + ["--num_workers", "2"]
    setup = chip_smoke.reference_args(os.path.join(smoke_root, "val"),
                                      str(tmp_path / "from_pre"))
    for flag, value in (("--network", "toy"), ("--embedding_size", "16"),
                        ("--image_size", str(IMG)), ("--com_batch_size", "8"),
                        ("--eval_batch_size", "16"), ("--public_batch_size", "16"),
                        ("--num_client", "2"), ("--num_ids", "6"),
                        ("--rec_root", spec), ("--local_rec", spec),
                        ("--num_workers", "2")):
        setup = chip_smoke.with_flag(setup, flag, value)
    assert chip_smoke.phase_pretrain(setup_argv=setup + ["--device", "cpu"],
                                     argv=argv) == NO_LAUNCHES
    assert os.path.exists(tmp_path / "pre_sampled" / "fc.pth")

    run = str(tmp_path / "run")
    train_cli.main(train_cli.build_parser().parse_args(_argv(smoke_root, run)))
    assert chip_smoke.phase_ijbc(str(tmp_path / "ijbc"), os.path.join(run, "backbone_1.pth"),
                                 run, [0, 1], network="toy", embedding=16, batch=32,
                                 device="cpu", spec=f"synth:image_size={IMG},noise=5",
                                 counts=(6, 18, 300, 600)) == NO_LAUNCHES
