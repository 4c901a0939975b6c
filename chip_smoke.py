"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

1. device  — requires CUDA; prints the card's name and power limit
   (nvidia-smi); switches TF32 off for the comparisons.
2. build   — builds every CUDA kernel of the port from csrc/ (one nvcc per
   source, started together) and prints the build seconds.
3. kernels — each kernel against its plain PyTorch version on the card, at
   ragged small shapes and at the reference shape, with the tolerance
   stated; times the kernel, the plain version and one library call
   (CUDA events), and computes the bound from the shapes.
4. round   — writes a seeded rec split to a temporary directory, builds
   ``Server`` at sphere64 / E=512 / bf16 trunk / batch 256 with the run.sh
   federated flags, and runs two training rounds as train.py does.  Kernel
   launch counts are set to 0 just before and read just after.  Checks
   finite losses, a changed global model, and one mining launch per client
   per round.  The last round runs under torch.profiler and prints its
   device time by kernel (so its seconds include the profiler's cost).

The line before the last is a JSON object with every ported kernel; the
last line is the device record.  Data counts, epochs and clients are cut
from the reference scale; the widths (sphere64, E=512, 112x112, batch 256)
are not.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

import fedfr_tpu_torch.ops.max_sim as max_sim_mod
from fedfr_tpu_torch.config import FedFRConfig
from fedfr_tpu_torch.data import AllClientData, codec, write_split
from fedfr_tpu_torch.federated import Server
from fedfr_tpu_torch.ops._build import build_kernels, build_seconds, ptxas_info

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and fp32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

MINING_TOL = 1e-5          # max |kernel - plain|: fp32 FFMA vs cuBLAS fp32 sums
THRESHOLD = 0.4            # run.sh's hn_threshold


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, iters: int, label: str) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` runs, CUDA events;
    logs the spread."""
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    log("kernels", timed=label, runs=iters, min_ms=min(times), max_ms=max(times))
    return float(np.median(times))


# ---------------------------------------------------------------- phase 1

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return smi


# ---------------------------------------------------------------- phase 2

def phase_build() -> None:
    t0 = time.perf_counter()
    build_kernels(["max_sim"])
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        per_kernel={k: round(v, 2) for k, v in build_seconds.items()})
    for name, info in ptxas_info.items():
        for line in info.splitlines():
            if "registers" in line or "spill" in line:
                log("build", kernel=name, ptxas=line.strip())


# ---------------------------------------------------------------- phase 3

def _unit_rows(n: int, e: int, gen: torch.Generator) -> torch.Tensor:
    x = torch.randn(n, e, device="cuda", generator=gen)
    return x / x.norm(dim=1, keepdim=True)


def _mining_case(n_pub: int, n_loc: int, e: int, seed: int):
    """Unit-norm fp32 features; each public row leans on a random local row
    with a random weight, so the scores spread over [0, 1] and the 0.4
    threshold splits them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    local = _unit_rows(n_loc, e, gen)
    lean = torch.rand(n_pub, 1, device="cuda", generator=gen)
    pick = torch.randint(0, n_loc, (n_pub,), device="cuda", generator=gen)
    public = lean * local[pick] + (1 - lean) * _unit_rows(n_pub, e, gen)
    public = public / public.norm(dim=1, keepdim=True)
    return public.contiguous(), local.contiguous()


def check_mining(n_pub: int, n_loc: int, e: int, seed: int) -> float:
    public, local = _mining_case(n_pub, n_loc, e, seed)
    got = max_sim_mod.max_cosine_similarity(public, local)
    want = max_sim_mod.max_cosine_similarity_plain(public, local)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= MINING_TOL:
        raise AssertionError(f"max_sim {n_pub}x{n_loc}x{e}: max abs err "
                             f"{err} > {MINING_TOL}")
    differ = (got > THRESHOLD) != (want > THRESHOLD)
    near = (want - THRESHOLD).abs() < MINING_TOL
    if bool((differ & ~near).any()):
        raise AssertionError(f"max_sim {n_pub}x{n_loc}x{e}: masks at "
                             f"{THRESHOLD} differ away from the threshold")
    log("kernels", case=f"{n_pub}x{n_loc}x{e}", max_abs_err=err,
        above_threshold=int((want > THRESHOLD).sum()))
    return err


def phase_kernels(n_pub: int, n_loc: int, e: int) -> dict:
    check_mining(130, 65, 512, seed=1)
    check_mining(1, 1, 512, seed=2)
    err = check_mining(n_pub, n_loc, e, seed=3)

    public, local = _mining_case(n_pub, n_loc, e, seed=3)
    launches = max_sim_mod.max_sim_launches
    ms = cuda_ms(lambda: max_sim_mod.max_cosine_similarity(public, local), 7,
                 "kernel")
    plain_ms = cuda_ms(lambda: max_sim_mod.max_cosine_similarity_plain(public, local),
                       5, "plain")
    library_ms = cuda_ms(lambda: torch.mm(public, local.t()).amax(1), 5,
                         "library torch.mm+amax")
    max_sim_mod.max_sim_launches = launches
    ops = 2.0 * n_pub * n_loc * e
    nbytes = 4.0 * (n_pub * e + n_loc * e + n_pub)
    ops_ms, bytes_ms = ops / FP32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    record = {
        "name": "max_sim", "route": "cuda",
        "source": "fedfr_tpu_torch/csrc/max_sim.cu",
        "replaces": "fedfr_tpu/ops/pallas_kernels.py:31",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }
    log("kernels", shape=f"{n_pub}x{n_loc}x{e}", ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, fp32_ops_bound_ms=ops_ms, hbm_bound_ms=bytes_ms,
        tflops=ops / ms / 1e9)
    del public, local
    torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------- phase 4

def _identity_images(rng: np.random.Generator, n_ids: int, per_id: int,
                     size: int, noise: int) -> np.ndarray:
    """(n_ids * per_id, size, size, 3) u8: a smooth random pattern per
    identity plus per-image noise."""
    coarse = rng.integers(0, 256, size=(n_ids, 7, 7, 3)).astype(np.float32)
    rep = -(-size // 7)
    base = np.repeat(np.repeat(coarse, rep, axis=1), rep, axis=2)[:, :size, :size]
    imgs = np.repeat(base, per_id, axis=0)
    imgs += rng.normal(0, noise, size=imgs.shape).astype(np.float32)
    return np.clip(imgs, 0, 255).astype(np.uint8)


def write_fl_split(root: str, n_clients: int, ids: int, imgs_per_id: int,
                   pub_ids: int, pub_imgs: int, size: int, seed: int) -> None:
    """split_train_i{N}c{K}/client_*/ + split_pretrain_6000/client_0000/,
    written with the port's own ``write_split``."""
    rng = np.random.default_rng(seed)
    split = os.path.join(root, "split_train_i%04dc%04d" % (n_clients * ids, n_clients))

    def write(d, imgs, labels, num_classes, id_base=None):
        os.makedirs(d, exist_ok=True)
        write_split(os.path.join(d, "train.idx"), os.path.join(d, "train.rec"),
                    [codec.encode_raw(im) for im in imgs], labels,
                    num_classes=num_classes, id_base=id_base)

    for c in range(n_clients):
        imgs = _identity_images(rng, ids, imgs_per_id, size, noise=24)
        write(os.path.join(split, "client_%04d" % c), imgs,
              np.repeat(np.arange(ids), imgs_per_id).tolist(), ids, c * ids)
    imgs = _identity_images(rng, pub_ids, pub_imgs, size, noise=24)
    write(os.path.join(root, "split_pretrain_6000", "client_0000"), imgs,
          np.repeat(np.arange(pub_ids), pub_imgs).tolist(), pub_ids)


def round_config(root: str, n_clients: int, ids: int, device: str = "cuda",
                 network: str = "sphnet", embedding: int = 512,
                 image_size: int = 112, batch: int = 256,
                 local_epochs: int = 2, rounds: int = 2) -> FedFRConfig:
    cfg = FedFRConfig()
    cfg.data.rec_root = root
    cfg.data.num_clients = n_clients
    cfg.data.num_ids = n_clients * ids
    cfg.data.image_size = image_size
    cfg.data.combined_batch_size = batch
    cfg.data.num_workers = 6
    cfg.model.network = network
    cfg.model.embedding_size = embedding
    cfg.model.bf16 = True
    cfg.optim.lr = 0.001
    cfg.fed.local_epochs = local_epochs
    cfg.fed.total_rounds = rounds
    cfg.fed.hn_threshold = THRESHOLD
    # run.sh: --add_pretrained_data --combine_dataset --contrastive_bb
    # --return_all --BCE_local --adaptive_local_epoch
    cfg.fed.add_pretrained_data = cfg.fed.combine_dataset = True
    cfg.fed.contrastive = cfg.fed.return_all = cfg.fed.bce_local = True
    cfg.fed.adaptive_local_epoch = True
    cfg.runtime.device = device
    return cfg


def device_breakdown(prof, wall_s: float, top: int = 8) -> None:
    """Device time of a profiled round by kernel name, and the share of the
    round's wall time the device was busy (one stream, so the sum of kernel
    and copy times)."""
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by_name:
        log("profile", device_time="not measured (the profiler saw no device events)")
        return
    busy_ms = sum(by_name.values())
    log("profile", wall_s=f"{wall_s:.3f}", device_busy_ms=f"{busy_ms:.1f}",
        device_busy_share=f"{busy_ms / 1e3 / wall_s:.3f}", kernels=len(by_name))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log("profile", ms=f"{ms:.1f}", share=f"{ms / busy_ms:.3f}", kernel=name[:90])
    # where the host spends the round (self CPU time of the top operators;
    # the profiler's own per-operator cost inflates these)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:top]:
        log("profile", host_ms=f"{e.self_cpu_time_total / 1e3:.1f}",
            calls=e.count, op=e.key[:60])


def phase_round(cfg: FedFRConfig) -> dict:
    """Server(cfg, data) and ``total_rounds`` rounds as train.py:200-207
    runs them; returns the mining launches counted over the rounds."""
    sync = torch.cuda.synchronize if cfg.runtime.device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    data = AllClientData(cfg)
    server = Server(cfg, data)
    sync()
    log("round", setup_s=f"{time.perf_counter() - t0:.2f}",
        public_images=len(data.public_dataset),
        local_images=[len(d) for d in data.client_datasets])
    before = {k: v.detach().clone() for k, v in server.global_net.state_dict().items()}

    max_sim_mod.max_sim_launches = 0
    while server.global_round < cfg.fed.total_rounds:
        server.current_client_list = server.sample_clients()
        last = server.global_round == cfg.fed.total_rounds - 1
        profiling = last and cfg.runtime.device == "cuda"
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            if profiling else contextlib.nullcontext())
        t = time.perf_counter()
        with prof:
            stats = server.train_round()
            sync()
        seconds = time.perf_counter() - t
        if profiling:
            device_breakdown(prof, seconds)
        clients = [server.clients[c] for c in server.current_client_list]
        log("round", round=server.global_round, seconds=f"{seconds:.2f}",
            local_epochs=server.local_epoch, avg_loss=stats["avg_loss"],
            losses=[c.last_loss for c in clients],
            mined=[c.mined for c in clients],
            dataset_sizes=[c.dataset_size for c in clients])
        if not all(math.isfinite(c.last_loss) for c in clients):
            raise AssertionError("non-finite client loss")
        server.advance_round()
    launches = max_sim_mod.max_sim_launches

    after = server.global_net.state_dict()
    changed = max(float((after[k].float() - v.float()).abs().max())
                  for k, v in before.items() if v.is_floating_point())
    finite = all(bool(torch.isfinite(v).all()) for v in after.values()
                 if v.is_floating_point())
    if not (finite and changed > 0):
        raise AssertionError(f"global model finite={finite} max change={changed}")
    expected = cfg.data.num_clients * cfg.fed.total_rounds
    log("round", max_sim_launches=launches, expected=expected,
        global_max_change=changed)
    if cfg.runtime.device == "cuda" and launches != expected:
        raise AssertionError(f"mining kernel launched {launches} times, "
                             f"expected clients x rounds = {expected}")
    return {"max_sim": launches}


def main() -> None:
    smi = phase_device()
    phase_build()
    record = phase_kernels(420_671, 6_500, 512)
    with tempfile.TemporaryDirectory(prefix="fedfr_smoke_") as root:
        t0 = time.perf_counter()
        write_fl_split(root, n_clients=2, ids=100, imgs_per_id=8,
                       pub_ids=2000, pub_imgs=2, size=112, seed=0)
        log("round", data_written_s=f"{time.perf_counter() - t0:.2f}")
        launches = phase_round(round_config(root, n_clients=2, ids=100))
    record["launches"] = launches["max_sim"]
    print(smi, flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
