"""The round's profiling side of the port against the JAX package, on the CPU.

* ``SpanTimer``: JAX's API and its ``report`` lines, character for
  character on the same totals.
* ``torch_trace``: a ``torch.profiler`` Chrome trace under the log dir.
* The training CLI with ``--profile`` on a tiny ``synth:`` root (no data
  files): round 0's trace is written, the per-round span report names only
  the JAX package's phases, and the memory line is logged.
* ``count_flops``: a sphnet20 forward at batch 2 counts exactly what JAX
  ``count_flops`` counts.  The branch train step counts exactly JAX's count
  minus 3x the forward FLOPs of the stride-2 convolutions whose input
  gradient the step computes: JAX's jaxpr walk counts that gradient as a
  convolution over the cotangent dilated with zeros (4x the forward's
  multiply-adds, three quarters of them by inserted zeros), PyTorch's flop
  counter at the forward's work.  No other difference (tolerance 0).
"""

import json
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from fedfr_tpu.federated.trainer import init_client_state as j_init_state
from fedfr_tpu.federated.trainer import make_branch_train_step as j_make_step
from fedfr_tpu.models import BCEModule as JBCE
from fedfr_tpu.models import SphNet as JSphNet
from fedfr_tpu.utils import flops as jflops
from fedfr_tpu.utils import profiling as jprof

from fedfr_tpu_torch import interop
from fedfr_tpu_torch import train as train_cli
from fedfr_tpu_torch.federated import init_client_state, make_branch_train_step
from fedfr_tpu_torch.models import BCEModule, build_backbone
from fedfr_tpu_torch.utils import flops, profiling

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAN_LINE = re.compile(r"span (\S+)\s+total\s+\S+s  calls\s+\d+  avg\s+\S+s$")
MEMORY_LINE = re.compile(r"memory: device .* \| host maxrss \d+ MB$")


class _Lines:
    def __init__(self):
        self.lines = []

    def info(self, fmt, *args):
        self.lines.append(fmt % args)


def test_span_report_lines_equal_jax():
    totals = {"phase/local_train": 12.5, "phase/public_embed": 3.25,
              "phase/mining": 0.125, "train_round": 20.0}
    counts = {"phase/local_train": 40, "phase/public_embed": 1,
              "phase/mining": 2, "train_round": 1}
    reports = []
    for timer in (profiling.SpanTimer(), jprof.SpanTimer()):
        timer.totals, timer.counts = dict(totals), dict(counts)
        log = _Lines()
        timer.report(log)
        reports.append(log.lines)
    assert reports[0] == reports[1]
    assert reports[0][0].startswith("span train_round")
    assert all(SPAN_LINE.match(line) for line in reports[0])


def test_span_timer_accumulates():
    timer = profiling.SpanTimer("cpu")
    for _ in range(3):
        with timer.span("a"):
            pass
    with pytest.raises(RuntimeError):
        with timer.span("b"):
            raise RuntimeError("inside")
    assert timer.counts == {"a": 3, "b": 1}
    assert all(v >= 0.0 for v in timer.totals.values())


def test_torch_trace_writes_chrome_trace(tmp_path):
    with profiling.torch_trace(None) as prof:
        assert prof is None
    log_dir = str(tmp_path / "trace")
    with profiling.torch_trace(log_dir, "cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def _jax_phase_names():
    """Every span name the JAX package's round and CLI use."""
    names = set()
    for rel in ("fedfr_tpu/federated/server.py", "fedfr_tpu/federated/client.py",
                "train.py"):
        with open(os.path.join(REPO, rel)) as f:
            names |= set(re.findall(r'span\("([^"]+)"\)', f.read()))
    return names


def test_cli_profile_spans_and_memory_line(tmp_path):
    spec = ("synth:ids_per_client=3,imgs_min=5,imgs_max=7,public_ids=12,"
            "public_imgs=36,veri_ids=6,veri_imgs=4")
    val = str(tmp_path / "val")
    chip_smoke.write_bin(os.path.join(val, "agedb_30.bin"), 20, 16, 1)
    out = str(tmp_path / "run")
    argv = ["--network", "toy", "--embedding_size", "16", "--image_size", "16",
            "--com_batch_size", "8", "--eval_batch_size", "16",
            "--public_batch_size", "16", "--lr", "0.01", "--num_client", "2",
            "--num_ids", "6", "--local_epoch", "1", "--total_round", "2",
            "--num_workers", "2", "--rec_root", spec, "--local_rec", spec,
            "--val_root", val, "--output_dir", out, "--device", "cpu",
            "--profile", "--add_pretrained_data", "--combine_dataset",
            "--contrastive_bb", "--return_all", "--BCE_local",
            "--adaptive_local_epoch"]
    history = train_cli.main(train_cli.build_parser().parse_args(argv))
    assert [h["round"] for h in history] == [0, 1]
    # round 0's trace only
    with open(os.path.join(out, "torch_trace", profiling.TRACE_FILE)) as f:
        assert json.load(f)["traceEvents"]
    with open(os.path.join(out, "training.log")) as f:
        # drop the "Training: <date> <time>,<ms>-" prefix
        lines = [re.sub(r"^Training: \S+ \S+?,\d+-", "", line.rstrip("\n"))
                 for line in f]
    spans = [m.group(1) for m in map(SPAN_LINE.match, lines) if m]
    want = {"phase/public_embed", "phase/mining", "phase/local_train",
            "phase/aggregate", "phase/local_eval", "phase/bin_eval",
            "phase/torch_export", "phase/round_ckpt", "train_round", "eval"}
    assert set(spans) == want
    assert want <= _jax_phase_names()
    assert sum(bool(MEMORY_LINE.match(line)) for line in lines) == 2
    assert "trace written to" in "".join(lines)
    # the numbers reach the round's record too
    assert set(history[-1]["spans"]) == want - {"train_round", "eval"}
    assert history[-1]["memory"]["host_maxrss_mb"] > 0


def test_check_flags_refuses_only_item_13():
    """Item 13 (``--lockstep``, ``--remat``) is ported: ``check_flags``
    refuses no flag of the repository's train.py any more."""
    parser = train_cli.build_parser()
    assert train_cli.UNPORTED == {}
    for argv in (["--profile"], ["--lockstep", "2"], ["--remat"],
                 ["--lockstep", "4", "--remat", "--cache_contrastive"]):
        train_cli.check_flags(parser.parse_args(argv))


# ------------------------------------------------------------------ FLOPs

EMB, SIZE, BATCH = 32, 112, 2


def _tree(t):
    return jax.tree_util.tree_map(np.array, t)


@pytest.fixture(scope="module")
def sphnet20():
    jnet = JSphNet(depth=20, embedding_size=EMB, bf16=False)
    jvars = _tree(jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 3))))

    def net(train=False):
        m = build_backbone("sphnet20", EMB, bf16=False, image_size=SIZE)
        m.load_state_dict(interop.backbone_state_dict("sphnet20", jvars))
        return m.train(train)
    return jnet, jvars, net


def test_forward_flops_equal_jax(sphnet20):
    jnet, jvars, net = sphnet20
    want = jflops.count_flops(lambda v, x: jnet.apply(v, x, train=False), jvars,
                              jnp.zeros((BATCH, SIZE, SIZE, 3)))
    with torch.no_grad():
        got = flops.count_flops(net(), torch.zeros(BATCH, 3, SIZE, SIZE))
    assert got == want > 4e9


def _strided_conv_flops(model) -> float:
    """Forward FLOPs of the stride-2 convolutions after the first conv
    (whose input, the image, needs no gradient) at the test's batch."""
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    shapes = {}
    hooks = [c.register_forward_hook(
        lambda mod, inp, out: shapes.__setitem__(mod, tuple(out.shape)))
        for c in convs]
    with torch.no_grad():
        model(torch.zeros(BATCH, 3, SIZE, SIZE))
    for h in hooks:
        h.remove()
    total = 0.0
    for c in convs[1:]:
        if c.stride != (1, 1):
            kh, kw = c.kernel_size
            total += 2.0 * np.prod(shapes[c]) * kh * kw * (c.in_channels // c.groups)
    return total


def test_train_step_flops_match_jax_up_to_strided_input_grads(sphnet20):
    jnet, jvars, net = sphnet20
    jbce = JBCE(hidden=EMB, n_class=3)
    bce_vars = _tree(jbce.init(jax.random.PRNGKey(4), jnp.zeros((1, EMB)),
                               jnp.zeros((1,), jnp.int32)))
    fc0 = np.random.default_rng(0).standard_normal((7, EMB)).astype(np.float32)
    u8 = np.zeros((BATCH, SIZE, SIZE, 3), np.uint8)
    labels, valid = np.array([0, 5], np.int32), np.array([True, True])
    jstep = j_make_step(jnet, jbce, num_local=3, num_clients=5, donate=False)
    want = jflops.count_flops(
        jstep, j_init_state(jvars, jnp.asarray(fc0), bce_vars), jvars, jvars,
        jnp.asarray(u8), jnp.asarray(labels), jnp.asarray(valid),
        jnp.float32(0.001), jax.random.PRNGKey(9), 3)

    bce = BCEModule(EMB, 3)
    bce.load_state_dict(interop.bce_state_dict(bce_vars))
    trainable = net(train=True)
    state = init_client_state(trainable, torch.from_numpy(fc0), bce, 0.001)
    step = make_branch_train_step(num_local=3, num_clients=5)
    got = flops.count_flops(step, state, net(), net(), torch.from_numpy(u8),
                            torch.from_numpy(labels), torch.from_numpy(valid),
                            0.001, torch.zeros(BATCH, dtype=torch.bool))
    correction = 3 * _strided_conv_flops(net())
    assert correction > 0
    assert got == want - correction
