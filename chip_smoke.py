"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # every phase, on one card
    python3 chip_smoke.py --phase 12   # phases 1, 2 and 12, on every card
    python3 chip_smoke.py --phase 12g  # phases 1, 2 and 12g alone
    python3 chip_smoke.py --phase 13   # phases 1, 2 and 13, on every card
    python3 chip_smoke.py --phase 14   # phases 1, 2 and 14 alone
    python3 chip_smoke.py --phase 15   # phases 1, 2 and 15 alone

Phases, in order (any failure raises and the script exits non-zero):

1. device  — requires CUDA; prints the card's name and power limit
   (nvidia-smi); switches TF32 off for the comparisons.
2. build   — builds every CUDA kernel of the port from csrc/ (one nvcc per
   source, started together) and, beside them, the native reader
   (native/recio.cpp, g++), and prints the build seconds and ptxas lines
   (registers, spills); for the ROC kernel also its threads, dynamic shared
   memory and blocks per SM (the occupancy query).
3. kernels — each kernel against its plain PyTorch version on the card, at
   ragged small shapes and at the reference shape, with the tolerance
   stated; times the kernel, the plain version and one library route
   (CUDA events), and computes the bound from the shapes.
   * max_sim (mining; bf16 wgmma/TMA, fp32 sums): within 1e-5 of the plain
     version on the same bf16 operands and within 2^-7 of the fp32 plain
     version, masks at 0.4 differing only within 2^-7 of it; at 130x65x512,
     1x1x512, 1000x300x100 (width padded), 4097x6500x512, an all-negative
     1000x300x512 case (no zero row may enter the max) and 420,671 public x
     6,500 local x 512, where it also times the cast to bf16, the bf16 and
     fp32 library routes, and one full against half a wave of blocks over
     four copies of the local set (an L2 probe).
   * roc_hist (the local 1:1 eval): identical on dyadic inputs (every dot
     exact in fp32; ragged cases at E = 100, N = 4,099 and T = 129);
     otherwise equal pos and neg totals, an L1 bin difference of at most 2 x
     the pairs whose fp64 similarity lies within 1e-6 of a bin edge, and
     TPR tables within 0.01; at 4,000 targets (one client, 100 IDs x 40)
     against 160,000 rows (local_veri_4000) x 512, timed on spread and on
     clustered scores, with the K-major copy also timed alone, the grid
     (blocks, blocks per SM, waves) logged, and the SM clock and power
     sampled (nvidia-smi) over 60 launches, to show whether the card
     throttles under the kernel.
   * synth_gen (the synth: image generator, JAX's threefry): 0 differing
     bytes against the plain version on 4,096 images of the reference
     universe (``synth:``; client, blended-public and veri positions) and on
     1,024 with expr=0.5, shift_div=4, 512 a launch, and on one launch of
     256 and of a ragged 257; the kernel timed per batch of 256 (the
     combined training batch) and 512 (the embeds), each beside its bound,
     with its grid (blocks, blocks per SM, chunk, fill), registers and
     bytes per thread; the plain version per 512; one whole 420,671-image public pass timed
     twice, the kernel alone over the pass's 822 batches (CUDA events) and
     through the dataset's own batches (wall clock); the bound from the
     instructions the function needs, by the rate of each pipe they share.
4. round   — writes a seeded rec split, a seeded local verification split
   and a seeded agedb_30.bin to a temporary directory and runs two rounds
   through the training CLI's own loop (``fedfr_tpu_torch.train``: setup,
   run_round, finish) at sphere64 / E=512 / bf16 trunk / batch 256 with the
   run.sh federated flags: each round trains, runs the per-client 1:1 eval
   of both candidate clients (plus their epoch -1 baseline in round 0) and
   the .bin verification, and exports.  Kernel launch counts are set to 0
   just before and read just after.  Checks finite losses, a changed global
   model, one mining launch per client per round, one ROC launch per
   candidate per round plus the baselines, local_log.txt lines that
   parse_log.py reads, finite accuracies, the .pth exports, and the
   phase-span report and memory line in training.log after each round.
   The CLI's --profile traces round 0: the trace file must exist and its
   device events name both kernels; its device time is printed by kernel
   (the round's seconds include the profiler's cost).
5. pretrained — writes a pretrained root with the smoke's own writer (a
   seeded iresnet100 / E=512 state_dict in the reference layout as
   backbone.pth, an fc.pth over the public IDs, the public labels) and runs
   one round of iresnet100 from it through the training CLI with run.sh's
   own flags (--pretrained_root, --fedface) and the BottleBlock converter
   (--converter_layer 2), on the round phase's data: 112x112, bf16 trunk,
   batch 256, 2 local epochs.  The round phase's checks (launches set to 0
   before and read after: one mining launch per client, one ROC launch per
   candidate plus the baselines; finite losses; logs; exports), the three
   "loaded pretrained ..." lines in training.log, and the round's train,
   local-eval and .bin seconds with its peak device memory
   (torch.cuda.max_memory_allocated).
6. local_all — the post-training eval CLI (fedfr_tpu_torch.local_all) on
   that round's exports, three times: per-client backbones and converters
   for 1:1 (one ROC launch per client, counted) and 1:n (against
   local_gallery_200, no ROC launch), and the round-0 global backbone for
   1:1 (one ROC launch per client); the launch counts set to 0 before the
   three calls and read after, every line of <run>/local_log.txt checked
   against the formats parse_log.py and local_all.py use, and each call's
   seconds.
7. paths — the sequential round's other paths through the training CLI at
   sphere64 / E=512 / bf16 trunk / batch 256 on the round phase's data,
   each part's launch counts set to 0 before its rounds and read after:
   7a  --cache_contrastive --spreadout, 1 round, the clients' FC rows from
       a pretrained root's FC cache (--pretrained_root, --init_fc) whose
       pairs lie above SpreadOut's margin: one mining launch
       per client per round, one ROC launch per candidate per round plus
       the baselines, finite losses, one cache build per local run, the
       SpreadOut objective lower after than before; then on
       one batch of client 0's next local run the cached step against the
       recompute step from the same state and flip (MOON_TOL), and both
       forms timed (CUDA events, in turns) with the cache build's seconds.
   7b  --resume --total_round 2 on 7a's output: the restored state bitwise
       equal to 7a's last save, "resumed at round 1", one round, its client
       sample equal to a replay of sample_clients from the saved RNG state;
       again on a copy of 7a's round states with --round_ckpt_async
       --round_ckpt_bg_fetch --round_ckpt_keep 1, leaving one complete
       round state.  Save and restore seconds.
   7c  --hn_strategy fc, 1 round, the threshold set between two middle
       per-identity scores of client 0: no mining launch, no public embed,
       client 0's mined set a strict subset of the public set.
   7d  the plain objective (no --add_pretrained_data, --batch_size 64), 1
       round: no mining launch, the candidates' ROC launches, each client's
       FedAvg weight its own set's size.
8. reference — run.sh's round at the reference's data scale on the synth:
   universe at its defaults (--rec_root synth: --local_rec synth:: 40
   clients x 100 IDs x 61-69 images, 420,671 public images over 6,000 IDs,
   4,000 x 40 veri images), sphere64 / E=512 / bf16 trunk / batch 256,
   run.sh's federated flags, random weights from seed 100, the .bin of
   phase 4; through the CLI's setup, run_round and finish, launch counts
   set to 0 before the round and read after.  Checks every mining launch at
   420,671 x n_loc x 512 and every ROC launch at 4,000 x 160,000 x 512,
   that every synth: batch of the round was a synth_gen launch, finite
   losses and accuracy, the span report and the memory line; prints the
   round, train, local-eval and .bin seconds, the phase spans and the peak
   memory.  Cuts: --client_sampled_ratio 0.05 (2 of 40 clients),
   --local_epoch 1, 1 round, --HN_cap 6500 (at random weights mining keeps
   nearly the whole public set), the local-eval candidates cut from 10 to 1
   by this script (the first sampled client), no resume state and no
   per-round client exports (--round_ckpt_every 0 --client_ckpt_every 0).

9. pretrain — the pretraining CLI (``fedfr_tpu_torch.pretrain``) in
   process on the card at full width: sphere64 / E=512 / bf16 trunk /
   batch 512, every one of the synth: defaults' 6,000 public IDs in the
   FC, on ``synth:public_imgs=61440`` (120 steps an epoch).  Three runs,
   launch counts set to 0 before and read after: 2 epochs at --sample_rate
   1.0 --save_every 1, then --resume --num_epoch 3 ("resumed pretraining
   at epoch 2", one epoch), then 1 epoch at --sample_rate 0.1 (600 sampled
   classes) into a second directory.  Checks finite losses, fc.pth of
   (6000, 512), labels of one per public image, the resume state, one
   synth_gen launch per batch; then the training CLI's setup on the same
   universe with --pretrained_root set to the output logs its three
   "loaded pretrained ..." lines (no round).  Prints both losses' step ms
   and samples/s (CUDA events over a steady window), the epoch and save
   seconds and the peak memory.
10. ijbc — writes a synthetic IJB-C root at the protocol's counts (23,124
   templates: 3,531 gallery subjects over G1/G2 and 19,593 probe
   templates; 15,658,489 1:1 pairs) with images from the synth: universe
   at a held-out identity range straight into the aligned-image cache,
   then the IJB-C CLIs in process, launch counts set to 0 before the write
   and read after: ``ijbc_all --job both --engine device`` on phase 8's
   final global export twice (bitwise-equal scores), the host engine on
   the same image features through --load_feature (within 1e-5 of the
   device's scores), and ``ijbc_conti --job 1:1`` over phase 4's
   ``backbone_1.pth`` (the cache reused).  Checks
   the pair and template counts, the 6-entry 1:1 tables, top1/top5/top10
   and finite values; prints each stage's seconds (root write, embed with
   its images/s, aggregation, the 15.66 M pairs' scoring, 1:n) and the
   peak memory.
11. lockstep — the lockstep round (``--lockstep 2``) through the training
   CLI at sphere64 / E=512 / bf16 trunk / batch 256 on 3 clients x 100
   IDs x 8 images written like phase 4's data (its own public set, veri
   set and .bin), each part's launch counts set to 0 before its rounds and
   read after:
   11a  1 round, groups [c0, c1] and [c2 + a pad slot]: one mining launch
        per real client (none for the pad), one ROC launch per candidate
        plus the baselines, the "client-parallel
        ... lockstep 2 (branch objective)" line, one "parallel group"
        line per group and epoch, a loss line per round, a changed and
        finite global model, local_log.txt and the exports as phase 4.
   11b  --cache_contrastive --remat, 1 round: one cache build per client,
        every residual block checkpointed.
   11c  the plain objective (no --add_pretrained_data, --batch_size 64), 1
        round: no mining launch, each client's FedAvg weight its own set.
   11d  on one seeded batch of 256 per member: the K=2 lockstep step
        against two sequential steps (sphere64, then iresnet100 with
        --remat, BN statistics included) within LOCKSTEP_TOL_FACTOR x the
        sequential step's distance from the same step in fp32; ms per
        client-step and peak memory of the sequential step (K = 1) and of
        the lockstep step at K = 2, 4 and 4 with --remat (CUDA events over
        a steady window); one conv layer of each trunk stage for 2 clients
        as separate convs, one grouped conv and the stacked conv leaf.
12. mesh — the round on every GPU of the machine, or on a one-GPU machine
   over two shards of ``cuda:0`` (a mesh may name a device twice);
   ``mesh_devices=`` names them:
   12f  each kernel launched on the mesh's last device leaves
        ``torch.cuda.current_device()`` as it was;
   12a  the ROC at 4,000 x 160,000 x 512 split over the data axis, bit for
        bit the one-shard kernel's histogram (spread unit rows); ms per
        shard, for the sharded whole and for one shard; launches per device;
   12b  the data-axis embed of ``synth:public_imgs=61440`` at batch 512:
        images/s beside one device's, the largest difference per row from
        the one-device features within MESH_TOL_FACTOR x the bf16 trunk's
        own distance from fp32 (the first 4,096 images);
   12g  each card's busy share (torch.profiler, the union of its kernel and
        copy intervals over the window) while this one process drives the
        mesh: one data-axis embed pass over 6,144 of 12b's images and 4
        dispatches of the mesh round's training (one stacked step of one
        seeded member at batch 256 on every slot's card in turn), each
        beside the same work on one device; ms per client-step of both
        (``--phase 12g`` alone: 12,288 images, 6 dispatches);
   12c  run.sh's round over the mesh through the CLI's setup, run_round and
        finish, devices + 1 clients x 100 IDs x 8 images (so pad
        slots), 1 local epoch then 4, 2 rounds, with ``--HN_threshold -1``
        (every public image mined, so that no near-threshold score can
        move a client's batches); then the same clients on one device at
        ``--lockstep`` = devices, in bf16 and with the trunk in fp32: the
        losses and the aggregate within MESH_TOL_FACTOR x the one-device
        round's own bf16-vs-fp32 distance; the "client-parallel training
        over N devices" line, the launches (ROC: one a shard, by device),
        local_log.txt, the exports, the span report and memory lines;
   12d  one round each of --cache_contrastive and the plain objective over
        the mesh;
   12e  ms per client-step (the local-train span over the client-steps
        run, pad slots included) of the mesh and the one-device round, and
        each device's peak memory.

13. pretrain_mesh — pretraining on every GPU of the machine, or over two
   shards of ``cuda:0`` (phase 12's ``mesh_devices``), at phase 9's widths
   on ``synth:public_imgs=61440`` (6,000 IDs):
   13a  the sharded full-softmax and sampled (rate 0.1) Partial FC at 512
        x 512 x 6,000 and x 6,001 classes (a padded FC), fp32 with TF32
        off: loss, feature and weight gradients within 1e-5 (relative) of
        the one-shard function (full) and of the same W-shard sample as one
        softmax on one device (sampled), the padded rows' gradient 0;
   13b  the CLI over the mesh, launch counts set to 0 before its runs and
        read after: 1 epoch of the full softmax, 1 epoch at --sample_rate
        0.1 on ``synth:public_imgs=6144`` (12 steps), "partial-FC over W
        model shards", fc.pth, the resume state's padded rows, the replicas
        bit for bit shard 0's, one synth_gen launch a batch; then 12 steps
        of the full softmax on that set over the mesh, on one device, and
        on one device with the trunk in fp32: every step's loss within
        MESH_TOL_FACTOR x the one-device run's own bf16-vs-fp32 distance;
   13c  both losses' step ms and samples/s over the mesh and on one device
        (host clock, every device synchronized), each card's peak memory,
        and each card's busy share over 4 full-softmax steps (12g's
        ``card_busy``);
   13d  BN over the whole batch: iresnet100 (154 BatchNorm layers, counted
        from the model and logged), BN_STEPS = 2 of the pretraining CLI's
        full-softmax step (its training state and step) on the first
        batches of ``synth:public_imgs=6144`` from its initial weights,
        launches counted from 0.  At batch 512 over the mesh, on one
        device, on one device with the trunk in fp32, and over the mesh
        with each shard's BN over its own rows (the control): after the
        first step every BN running statistic and every parameter of the
        mesh within MESH_TOL_FACTOR x that tensor's own bf16-vs-fp32
        distance (norms of the differences; the first losses logged
        beside), the control beyond.  At 64 images a step in float64 over
        the mesh, on one device and as the control: the mesh's losses and,
        after the steps, its BN running statistics within 1e-10 of one
        device's, the control beyond.  The replicas bit for bit shard 0's
        after every run.  Then the full-softmax step at 512 over the mesh
        and on one device (ms, samples/s, peak memory, each card's busy
        share over 2 steps).

14. native — the native reader (``fedfr_tpu_torch/native``: C++ threads,
   its own JPEG decoder) and run.sh's round over a JPEG rec root:
   14a  the reader's build seconds and command, the host's cores (count,
        affinity), CPU model and cgroup CPU quota where readable, the
        card's name and power limit;
   14b  a rec of 32,768 JPEG images (112x112, quality 95, 4:2:0, cv2 or
        else PIL; 4,096 IDs x 8), every image read natively against
        ``codec.decode`` through the Python path's ``BatchLoader`` (6
        threads), and 256 images of each variant (4:4:4, 4:2:2, restart
        intervals, progressive, grayscale, 40x40): 0 differing bytes;
   14c  images/s of the reader at 1, 2, 4, 8 threads and the affinity
        count (batches of 512 over 8,192 images, host clock), of the Python
        loader at 6 workers and of ``codec.decode`` on one thread, beside
        the embed's ~23,000, and the split of one thread's time between
        entropy decode and reconstruction;
   14d  one round of run.sh's flags through the CLI's setup, run_round and
        finish over the JPEG root (2 clients x 100 IDs x 8 images, 14b's
        public set, 2,000 veri images, sphere64, E=512, batch 256),
        launches set to 0 before and read after (mining, ROC), the native
        counters (> 0: the public embed, the mined subset's training, the
        local eval; no split switched to the Python path, since the reader
        decodes every JPEG of the root), the ``phase/public_embed`` span's
        images/s; then the
        round's global model over the public set natively (the card's busy
        share, ``card_busy``) and over its first 8,192 images on the Python
        path (``use_native=False``): images/s of both and the largest
        feature difference, which must be 0 (the bytes are the same).

15. convergence — the port's convergence chain
   (``fedfr_tpu_torch.convergence.run_chain``: a synthetic identity source,
   ``data/split.py``'s splits, pretraining, the training CLI with every
   FedFR flag, ``local_all --backbone multi --task 1:1``) at DESIGN.md's
   flagship scale: sphere64, E=512, 112x112, 8 clients x 4 IDs, 16 public
   IDs, 10 images an ID, 4 of them veri, pretraining 4 epochs at lr 0.001,
   6 rounds x 4 local epochs at lr 0.001; launch counts set to 0 before
   each run and read after, and checked by stage (mining once a client a
   round; the ROC once a candidate a round plus the epoch -1 baselines,
   once a client in local_all):
   15a  every loss and XNorm finite, no collapsed-feature warning, and the
        repository's convergence test's criteria: the last round's .bin
        accuracy at least round 0's, and a gain over 0.02 or a last-round
        mean local TPR@1e-1 over the baseline's by more than 2.0; the
        per-round table (loss, accuracy, XNorm, mean TPR@1e-1 and @1e-3)
        and local_all's mean TPR, beside DESIGN.md's TPU v5e table (not
        gated);
   15b  the planted control: the same chain from 15a's pretrained root
        (the chain's pretraining is seeded) at lr 0 for 2 rounds of 1
        local epoch, which must fail the learning criterion;
   15c  15a at pretrain lr 0.01 for 1 round: the pretrained median feature
        norm, round 0's XNorm and loss and whether the collapse warning
        fired, beside DESIGN.md's TPU record (not gated).

The line before the last is a JSON object with every hand-written kernel
(its ``launches`` summed over phases 4-15, and by phase, 7a-7d apart, 11a-11c,
12c-12d and 15a-15c together); the last line is the device record.
``--phase 12``, ``--phase 13``, ``--phase 14`` and ``--phase 15`` print no
kernel line.  Widths are the reference's (sphere64 and iresnet100, E=512,
112x112, batch 256); counts are cut:
  * (phases 4-7; phase 8 runs the reference's data, cut as listed there)
    2 clients x 100 IDs x 8 train images (reference: 40 clients x 100 IDs);
  * a 4,000-image public set, 2,000 IDs x 2 (reference: 420,671 images);
  * (phases 4-7) 2 local epochs (phase 4: 1, so that the traced round 0
    stays small), then 4; 2 rounds (reference: 10 epochs, 20 rounds);
    the iresnet100 round: 2 local epochs, 1 round; phase 7: 2 local epochs
    then 4, 1 round for each part (7b's resumed round the second);
  * local_veri: 2 clients x 100 IDs x 10 images (reference: 4,000 IDs x 40);
    local_gallery: the 8 train images of each ID;
  * agedb_30.bin: 1,200 pairs (AgeDB-30: 6,000);
  * random weights from seed 100 (reference: pretrained), for iresnet100
    written as the pretrained root;
  * (phase 9) the public set cut from 420,671 to 61,440 images (all 6,000
    IDs kept, ~10 images each); 2 + 1 epochs and 1 sampled epoch
    (reference: 16 epochs); the CLI's setup, no round;
  * (phase 10) the images cut from the protocol's 469,375 to 100,000
    (every template keeps at least one; ~3.8 GB of cache); the templates,
    pairs and 1:n lists at the protocol's counts;
  * (phase 11) 3 clients x 100 IDs x 8 images; 1 local epoch, 1 round
    for each of 11a-11c (12c runs two lockstep rounds);
  * (phase 12) devices + 1 clients x 50 IDs x 8 images (100 under
    ``--phase 12``), a 128-image
    public set (64 IDs x 2), 4 veri images an ID; 1 local epoch then 4, 2
    rounds for 12c, 1 round each for 12d; 12b 61,440 of 420,671 public
    images;
  * (phase 13) the public set cut as phase 9's for the full epoch and to
    6,144 images (all 6,000 IDs) for the sampled epoch, 13b's 12 steps
    and 13d's 2 (reference: 16 epochs of 420,671 images);
  * (phase 14) a JPEG public set of 32,768 images (reference: 420,671),
    the mined set capped at 6,500 images as in phase 8, 1 local epoch, 1
    round;
  * (phase 15) DESIGN.md's flagship chain: 8 clients x 4 IDs x 6 train
    images, 16 public IDs x 10, 128 veri images, a 64-pair .bin, 6 rounds
    (reference: 40 clients x 100 IDs, 20 rounds); no per-round exports
    (``--round_ckpt_every 0 --client_ckpt_every 0``: the final round's) and
    one pretraining save, the last epoch's.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import glob
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

import fedfr_tpu_torch.federated.embed as embed_mod
import fedfr_tpu_torch.native as native_mod
import fedfr_tpu_torch.ops.max_sim as max_sim_mod
import fedfr_tpu_torch.ops.roc_hist as roc_hist_mod
import fedfr_tpu_torch.ops.roc_histogram as roc_histogram_mod
import fedfr_tpu_torch.ops.synth_gen as synth_gen_mod
from fedfr_tpu_torch import convergence as conv
from fedfr_tpu_torch import ijbc_all, ijbc_conti
from fedfr_tpu_torch import local_all as local_all_cli
from fedfr_tpu_torch.config import FedFRConfig
from fedfr_tpu_torch import pretrain as pretrain_cli
from fedfr_tpu_torch import train as train_cli
from fedfr_tpu_torch.data import BatchLoader, FaceRecordDataset, codec, synthetic, write_split
from fedfr_tpu_torch.data.datasets import native_threads
from fedfr_tpu_torch.data.pipeline import DevicePrefetcher
from fedfr_tpu_torch.evalsuite import ijbc
from fedfr_tpu_torch.federated.state import normalize_images
from fedfr_tpu_torch.federated.trainer import (branch_objective_kwargs, branch_step_for,
                                               init_client_state)
from fedfr_tpu_torch.models import BCEModule, build_backbone
from fedfr_tpu_torch.models.heads import l2_normalize
from fedfr_tpu_torch.native import NativeReader
from fedfr_tpu_torch.ops._build import build_kernels, build_seconds, ptxas_info
from fedfr_tpu_torch.ops.margins import MARGINS
from fedfr_tpu_torch.ops.roc_histogram import tpr_at_fpr_table
from fedfr_tpu_torch.ops.threefry import prng_key
from fedfr_tpu_torch.parallel import client_parallel
from fedfr_tpu_torch.parallel import mesh as mesh_mod
from fedfr_tpu_torch.parallel import partial_fc
from fedfr_tpu_torch.parallel.fedavg import stack_trees
from fedfr_tpu_torch.utils.checkpoint import RoundCheckpointer
from fedfr_tpu_torch.utils.profiling import TRACE_FILE

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, fp32
# operations/s outside the tensor cores, bf16 operations/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# Hopper's instruction rates on 132 SMs at 1.98 GHz (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0): each SM
# issues 4 warp instructions (128 lanes) a clock whatever their pipe; 64
# lanes of those are the INT32 ALU pipe's (logic, shifts); 32-bit type
# conversions run at 16 lanes
ISSUE_OPS_PER_S = 132 * 128 * 1.98e9
ALU_OPS_PER_S = 132 * 64 * 1.98e9
CONVERT_OPS_PER_S = 132 * 16 * 1.98e9

# synth_gen's least work per output byte, counted from the function the
# kernel computes (its loop and index arithmetic left out: a kernel could
# walk the pre-roll positions, so that its counter is the noise's flat
# index).  Two threefry2x32 hashes at counter (0, idx), each of 20 rounds of
# an add, a rotation and a xor, 10 injection adds (their key sums are per
# image, computed once), 1 add of the key to the counter's low word (the
# high word's is a constant) and the xor of its two output words: 31 adds,
# 20 rotations and 21 xors; randint's three remainders by the span (2
# instructions each at least: a multiply-high by a reciprocal computed once
# and a multiply-add), its multiply-add and its add of minval: 8; the float
# add, multiply and add: 3 (the clamp can ride on a saturating conversion);
# the noise's conversion to float and the value's to u8: 2.  Only the xors
# must issue on the ALU pipe: a rotation issues as a funnel shift there or
# as a wide multiply by 2^r on the FMA pipe, its or merged into the xor's
# three-input LOP3; adds and multiplies issue on either.
SYNTH_OPS_PER_BYTE = 2 * (31 + 20 + 21) + 8 + 3 + 2
SYNTH_ALU_OPS_PER_BYTE = 2 * 21
SYNTH_CONVERSIONS_PER_BYTE = 2
KERNEL_COUNTERS = {"max_sim": (max_sim_mod, "max_sim_launches"),
                   "roc_hist": (roc_hist_mod, "roc_hist_launches"),
                   "synth_gen": (synth_gen_mod, "synth_gen_launches")}

# mining: bf16 operands, fp32 sums.  Against the plain version on the same
# bf16 operands only the order of the fp32 sums differs; against the fp32
# plain version each operand moves by at most 2^-8 relative, so a unit-row
# score by at most 2^-7 (Cauchy-Schwarz), and masks at THRESHOLD may differ
# only within 2^-7 of it.
MINING_BF16_TOL = 1e-5
MINING_FP32_TOL = 2.0 ** -7
# IJB-C pair scores: the device engine sums in fp32 in segment order, the
# host engine in f64 then rounds; at E=512 with unit-norm templates the
# fp32 sums differ by a few ulps of 1 (2^-24 each)
IJBC_HOST_TOL = 1e-5
THRESHOLD = 0.4            # run.sh's hn_threshold
TPR_TOL = 0.01             # TPR table entries (percent, 2 decimals)

# the two line formats of local_log.txt that parse_log.py:18-22 reads (a
# copy: the smoke does not import the repository's scripts)
LOCAL_LOG_PATTERNS = (re.compile(r"Target label from (\d+) to (\d+)"),
                      re.compile(r"Epoch (-?\d+), TPR \(-1 to -6\) = \[(.*)\]"))
# the summary lines local_all appends to <ckpt_path>/local_log.txt (the
# repository's local_all.py:112,188-203)
MEAN_PATTERNS = (re.compile(r"Mean \(-6 to -1\):$"),
                 re.compile(r"\[(\d+\.\d\d ){6}\]$"))
ONE_TO_N_PATTERNS = (re.compile(r"1:n at Epoch : (-?\d+)$"),
                     re.compile(r"Far: \['1\.0e-06', '1\.0e-05', '1\.0e-04', "
                                r"'1\.0e-03'\]$"),
                     re.compile(r"Pr : \[('\d\.\d{5}'(, )?){4}\]$"))
SINGLE_PATTERN = re.compile(r"1:1 at Epoch : (-?\d+)$")


def zero_launches() -> None:
    """Every kernel's launch count set to 0 (the ROC's by device too)."""
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)
    roc_hist_mod.roc_hist_launches_by_device.clear()


def read_launches() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNEL_COUNTERS.items()}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


@contextlib.contextmanager
def sm_clocks(label: str):
    """Samples the card's SM clock and power draw every 50 ms (nvidia-smi)
    while the block runs, and logs their medians."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "50"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    try:
        yield
    finally:
        proc.terminate()
        out, _ = proc.communicate()
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines()
            if line.count(",") == 1]
    log("clocks", during=label, samples=len(rows),
        sm_mhz=float(np.median([r[0] for r in rows])) if rows else "not measured",
        power_w=float(np.median([r[1] for r in rows])) if rows else "not measured")


def cuda_ms(fn, iters: int, label: str, batch: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` runs, CUDA events
    around ``batch`` calls back to back (the time is per call); logs the
    spread."""
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    log("kernels", timed=label, runs=iters, min_ms=min(times), max_ms=max(times))
    return float(np.median(times))


# ---------------------------------------------------------------- phase 1

def card_lines() -> list:
    """Each card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs an NVIDIA GPU")
    cards = card_lines()
    smi = cards[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, cards=json.dumps(cards))
    return smi


# ---------------------------------------------------------------- phase 2

def phase_build() -> None:
    t0 = time.perf_counter()
    # the native reader's g++ runs beside the kernels' nvcc
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        reader = pool.submit(native_mod.build_library)
        build_kernels(list(KERNEL_COUNTERS))
        reader.result()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        per_kernel={k: round(v, 2) for k, v in build_seconds.items()},
        native_reader_s=native_mod.build_seconds)
    for name, info in ptxas_info.items():
        for line in info.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log("build", kernel=name, ptxas=line.strip())
    cfg = roc_hist_mod.kernel_config(0)
    log("build", kernel="roc_hist", threads=cfg["threads"],
        smem_bytes=cfg["smem_bytes"], blocks_per_sm=cfg["blocks_per_sm"])
    cfg = synth_gen_mod.kernel_config(0, 112, 4)
    log("build", kernel="synth_gen", threads=cfg["threads"], run_bytes=cfg["run"],
        registers=cfg["registers"], smem_bytes=cfg["smem_bytes"],
        blocks_per_sm=cfg["blocks_per_sm"], sms=cfg["sms"])


# ---------------------------------------------------------------- phase 3

def _unit_rows(n: int, e: int, gen: torch.Generator) -> torch.Tensor:
    x = torch.randn(n, e, device="cuda", generator=gen)
    return x / x.norm(dim=1, keepdim=True)


def _mining_case(n_pub: int, n_loc: int, e: int, seed: int,
                 negative: bool = False):
    """Unit-norm fp32 features.  By default each public row leans on a
    random local row with a random weight, so the scores spread over [0, 1]
    and the 0.4 threshold splits them.  ``negative``: local rows cluster
    around a direction u and public rows around -u, so every score is below
    -0.5 and a zero row leaking into the max would show as 0."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if negative:
        u = _unit_rows(1, e, gen)
        local = u + 0.3 * _unit_rows(n_loc, e, gen)
        public = -u + 0.3 * _unit_rows(n_pub, e, gen)
        local = local / local.norm(dim=1, keepdim=True)
    else:
        local = _unit_rows(n_loc, e, gen)
        lean = torch.rand(n_pub, 1, device="cuda", generator=gen)
        pick = torch.randint(0, n_loc, (n_pub,), device="cuda", generator=gen)
        public = lean * local[pick] + (1 - lean) * _unit_rows(n_pub, e, gen)
    public = public / public.norm(dim=1, keepdim=True)
    return public.contiguous(), local.contiguous()


def check_mining(n_pub: int, n_loc: int, e: int, seed: int,
                 negative: bool = False) -> dict:
    """The kernel (on fp32 operands: the wrapper casts them) against the
    plain version on the same bf16 operands, and against the fp32 plain
    version with its masks at THRESHOLD."""
    public, local = _mining_case(n_pub, n_loc, e, seed, negative)
    got = max_sim_mod.max_cosine_similarity(public, local)
    oracle = max_sim_mod.max_cosine_similarity_plain(public.bfloat16(),
                                                     local.bfloat16())
    fp32 = max_sim_mod.max_cosine_similarity_plain(public, local)
    torch.cuda.synchronize()
    case = f"max_sim {n_pub}x{n_loc}x{e}" + (" negative" if negative else "")
    err = float((got - oracle).abs().max())
    err_fp32 = float((got - fp32).abs().max())
    if not err <= MINING_BF16_TOL:
        raise AssertionError(f"{case}: max abs err {err} against the bf16 "
                             f"oracle > {MINING_BF16_TOL}")
    if not err_fp32 <= MINING_FP32_TOL:
        raise AssertionError(f"{case}: max abs err {err_fp32} against fp32 "
                             f"> {MINING_FP32_TOL}")
    flipped = (got > THRESHOLD) != (fp32 > THRESHOLD)
    near = (fp32 - THRESHOLD).abs() < MINING_FP32_TOL
    if bool((flipped & ~near).any()):
        raise AssertionError(f"{case}: masks at {THRESHOLD} differ farther "
                             f"than {MINING_FP32_TOL} from it")
    if negative and not float(got.max()) < -0.5:
        raise AssertionError(f"{case}: max {float(got.max())}: a zero row "
                             f"entered the max")
    flips = int(flipped.sum())
    log("kernels", case=case, max_abs_err_bf16=err, max_abs_err_fp32=err_fp32,
        mask_flips=flips, above_threshold=int((fp32 > THRESHOLD).sum()),
        farthest_flip=float((fp32[flipped] - THRESHOLD).abs().max()) if flips else 0.0)
    return {"max_abs_err": err, "max_abs_err_fp32": err_fp32, "mask_flips": flips}


def mining_l2_probe(public: torch.Tensor, local: torch.Tensor) -> None:
    """The marginal microseconds per 128-row local tile of one block (the
    time difference between the whole local set and its first half, over
    the tiles between them, so that the launch and the public tile's load
    cancel), with one full wave of blocks (132 x 128 public rows, one per
    SM) and with half a wave.  Each block's tensor work per tile is the
    same; the L2 reads of the local set halve.  If the half wave runs
    markedly faster per tile, L2 holds the kernel back.  Each time is the
    median of 7 runs of 20 launches back to back."""
    half = local[:local.shape[0] // 2]
    tiles = -(-local.shape[0] // 128) - -(-half.shape[0] // 128)
    tensor_us = 2.0 * 128 * 128 * local.shape[1] / (BF16_TENSOR_OPS_PER_S / 132) * 1e6
    for blocks in (132, 66):
        sub = public[:blocks * 128]
        ms = {name: cuda_ms(lambda: max_sim_mod.max_cosine_similarity(sub, loc), 7,
                            f"kernel, {blocks} blocks, {loc.shape[0]} local rows",
                            batch=20)
              for name, loc in (("all", local), ("half", half))}
        log("kernels", l2_probe_blocks=blocks,
            us_per_tile=(ms["all"] - ms["half"]) * 1e3 / tiles,
            tensor_us_per_tile=tensor_us)


def phase_mining(n_pub: int, n_loc: int, e: int) -> dict:
    check_mining(130, 65, 512, seed=1)
    check_mining(1, 1, 512, seed=2)
    check_mining(1000, 300, 100, seed=4)
    check_mining(4097, 6500, 512, seed=5)
    check_mining(1000, 300, 512, seed=6, negative=True)
    errs = check_mining(n_pub, n_loc, e, seed=3)

    public, local = _mining_case(n_pub, n_loc, e, seed=3)
    launches = max_sim_mod.max_sim_launches
    cast_ms = cuda_ms(lambda: (max_sim_mod.kernel_operand(public),
                               max_sim_mod.kernel_operand(local)), 7,
                      "cast of both operands to bf16")
    pub16, loc16 = max_sim_mod.kernel_operand(public), max_sim_mod.kernel_operand(local)
    ms = cuda_ms(lambda: max_sim_mod.max_cosine_similarity(pub16, loc16), 9,
                 "kernel")
    ms_cast = cuda_ms(lambda: max_sim_mod.max_cosine_similarity(public, local), 7,
                      "kernel on fp32 operands, cast included")
    # four copies of the local set (26,000 rows, 26.6 MB), so that enough
    # tiles lie between the two sizes to time
    mining_l2_probe(pub16, torch.cat([loc16] * 4))
    plain_ms = cuda_ms(lambda: max_sim_mod.max_cosine_similarity_plain(pub16, loc16),
                       5, "plain on the bf16 operands")
    library_ms = cuda_ms(lambda: torch.mm(pub16, loc16.t()).amax(1), 5,
                         "library bf16 torch.mm+amax")
    library_fp32_ms = cuda_ms(lambda: torch.mm(public, local.t()).amax(1), 5,
                              "library fp32 torch.mm+amax")
    max_sim_mod.max_sim_launches = launches
    ops = 2.0 * n_pub * n_loc * e
    nbytes = 2.0 * (n_pub * e + n_loc * e) + 4.0 * n_pub
    ops_ms = ops / BF16_TENSOR_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    record = {
        "name": "max_sim", "route": "cuda",
        "source": "fedfr_tpu_torch/csrc/max_sim.cu",
        "replaces": "fedfr_tpu/ops/pallas_kernels.py:31",
        "launches": None, **errs, "ms": ms, "cast_ms": cast_ms,
        "ms_with_cast": ms_cast, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms, "library_fp32_ms": library_fp32_ms,
    }
    log("kernels", shape=f"{n_pub}x{n_loc}x{e}", ms=ms, cast_ms=cast_ms,
        ms_with_cast=ms_cast, plain_ms=plain_ms, library_ms=library_ms,
        library_fp32_ms=library_fp32_ms, bf16_ops_bound_ms=ops_ms,
        hbm_bound_ms=bytes_ms, tflops=ops / ms / 1e9)
    del public, local, pub16, loc16
    torch.cuda.empty_cache()
    return record


def _roc_case(n: int, t: int, e: int, seed: int, kind: str):
    """(N, E) fp32 features and int32 labels laid out as local_veri: 40
    images per identity, the target rows first.  ``spread``: random unit
    rows (similarities spread over ~400 bins); ``clustered``: every row near
    one direction (cos ~0.85, a handful of bins, as a sphere64 at random
    weights gives); ``dyadic``: entries in {0, +-1/8, +-1/4}, so that every
    dot is exact in fp32 (a multiple of 1/64 of magnitude at most E/16; at
    E <= 16 within [-1, 1], beyond it some pairs clamp to the end bins)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "dyadic":
        vals = torch.tensor([0.0, 0.125, -0.125, 0.25, -0.25], device="cuda")
        feats = vals[torch.randint(0, 5, (n, e), device="cuda", generator=gen)]
    elif kind == "clustered":
        center = _unit_rows(1, e, gen)
        feats = center + 0.42 * _unit_rows(n, e, gen)
        feats = feats / feats.norm(dim=1, keepdim=True)
    else:
        feats = _unit_rows(n, e, gen)
    labels = (torch.arange(n, device="cuda", dtype=torch.int32) // 40)
    return feats.contiguous(), labels.contiguous()


def _near_edge_pairs(feats: torch.Tensor, t: int, chunk: int = 256) -> int:
    """Pairs (i < t, i < j) whose fp64 similarity lies within 1e-6 of a bin
    edge, counted in chunks of target rows on the card."""
    f = feats.double()
    j = torch.arange(feats.shape[0], device="cuda")[None, :]
    count = 0
    for i0 in range(0, t, chunk):
        i1 = min(i0 + chunk, t)
        x = (f[i0:i1] @ f.t() + 1.0) * 1000.0
        near = (x - x.round()).abs() < 1e-3
        i = torch.arange(i0, i1, device="cuda")[:, None]
        count += int((near & (i < j)).sum())
    return count


def check_roc(n: int, t: int, e: int, seed: int, kind: str) -> int:
    """The kernel against its plain version; returns the L1 bin difference."""
    feats, labels = _roc_case(n, t, e, seed, kind)
    before = roc_hist_mod.roc_hist_launches
    got = roc_hist_mod.roc_histogram(feats, labels, t)
    want = roc_hist_mod.roc_histogram_plain(feats, labels, t)
    torch.cuda.synchronize()
    launched = roc_hist_mod.roc_hist_launches - before
    roc_hist_mod.roc_hist_launches = before
    pairs = t * n - t * (t + 1) // 2
    if launched != (1 if t > 0 else 0):
        raise AssertionError(f"roc_hist {n}x{t}x{e}: {launched} launches")
    if int(got.sum()) != pairs or int(want.sum()) != pairs:
        raise AssertionError(f"roc_hist {n}x{t}x{e}: {int(got.sum())} and "
                             f"{int(want.sum())} pairs counted, expected {pairs}")
    l1 = int((got - want).abs().sum())
    if kind == "dyadic":
        if l1 != 0:
            raise AssertionError(f"roc_hist {n}x{t}x{e} dyadic: L1 {l1} != 0")
        log("kernels", case=f"roc {n}x{t}x{e} {kind}", l1_bins=l1, pairs=pairs)
        return l1
    for side, name in ((0, "pos"), (1, "neg")):
        if int(got[side::2].sum()) != int(want[side::2].sum()):
            raise AssertionError(f"roc_hist {n}x{t}x{e}: {name} totals differ")
    near = _near_edge_pairs(feats, t)
    if l1 > 2 * near:
        raise AssertionError(f"roc_hist {n}x{t}x{e}: L1 {l1} > 2 x {near} "
                             f"pairs near a bin edge")
    tg = tpr_at_fpr_table(got.cpu().numpy().reshape(-1, 2))
    tw = tpr_at_fpr_table(want.cpu().numpy().reshape(-1, 2))
    if max(abs(a - b) for a, b in zip(tg, tw)) > TPR_TOL:
        raise AssertionError(f"roc_hist {n}x{t}x{e}: TPR tables {tg} vs {tw}")
    log("kernels", case=f"roc {n}x{t}x{e} {kind}", l1_bins=l1,
        near_edge_pairs=near, pairs=pairs, tpr=tg)
    return l1


def roc_library(feats: torch.Tensor, labels: torch.Tensor, t: int,
                chunk: int = 512) -> torch.Tensor:
    """The library route: chunked fp32 ``torch.mm`` of target rows against
    every row, the kernel's binning, one ``torch.bincount`` per chunk."""
    n = feats.shape[0]
    hist = torch.zeros(2 * roc_hist_mod.NUM_BINS, dtype=torch.int64, device="cuda")
    j = torch.arange(n, device="cuda")[None, :]
    for i0 in range(0, t, chunk):
        i1 = min(i0 + chunk, t)
        sim = torch.mm(feats[i0:i1], feats.t())
        b = ((sim + 1.0) * 1000.0).to(torch.int32).clamp_(0, roc_hist_mod.NUM_BINS - 1)
        comb = b * 2 + (labels[i0:i1, None] != labels[None, :])
        valid = torch.arange(i0, i1, device="cuda")[:, None] < j
        hist += torch.bincount(comb[valid], minlength=2 * roc_hist_mod.NUM_BINS)
    return hist


def phase_roc(n: int, t: int, e: int) -> dict:
    check_roc(100, 37, 16, seed=11, kind="spread")
    check_roc(50, 3, 16, seed=12, kind="spread")
    check_roc(1000, 0, 16, seed=13, kind="spread")
    check_roc(4097, 1000, 512, seed=14, kind="spread")
    check_roc(1000, 333, 16, seed=15, kind="dyadic")
    check_roc(1000, 333, 100, seed=18, kind="dyadic")   # zero-padded K
    check_roc(4099, 1000, 16, seed=19, kind="dyadic")   # ragged last j-tile
    check_roc(4099, 129, 100, seed=20, kind="dyadic")   # T across the diagonal
    err = check_roc(n, t, e, seed=16, kind="spread")
    check_roc(n, t, e, seed=17, kind="clustered")

    launches = roc_hist_mod.roc_hist_launches
    cfg = roc_hist_mod.kernel_config(0)
    grid = roc_hist_mod.launch_grid(n, t, 0)
    log("kernels", roc_grid=grid, tile=f"{cfg['bm']}x{cfg['bn']}x{cfg['bk']}",
        sms=cfg["sms"])
    timed = {}
    for kind, seed in (("clustered", 17), ("spread", 16)):
        feats, labels = _roc_case(n, t, e, seed, kind)
        timed[kind] = cuda_ms(lambda: roc_hist_mod.roc_histogram(feats, labels, t),
                              5, f"roc kernel {kind}, copy included")
    with sm_clocks("roc kernel spread, 20 launches back to back x 3"):
        cuda_ms(lambda: roc_hist_mod.roc_histogram(feats, labels, t), 3,
                "roc kernel spread, batched", batch=20)
    copy_ms = cuda_ms(lambda: roc_hist_mod.kernel_operand(feats[:t], feats, cfg["bn"],
                                                          cfg["bk"]),
                      7, "roc K-major copy alone")
    # the plain version and the library route on the spread case
    plain_ms = cuda_ms(lambda: roc_hist_mod.roc_histogram_plain(feats, labels, t),
                       3, "roc plain")
    library_ms = cuda_ms(lambda: roc_library(feats, labels, t), 3,
                         "roc library torch.mm+bincount")
    roc_hist_mod.roc_hist_launches = launches
    pairs = t * n - t * (t + 1) // 2
    ops = 2.0 * e * pairs
    nbytes = 4.0 * (n * e + n) + 8.0 * 2 * roc_hist_mod.NUM_BINS
    ops_ms, bytes_ms = ops / FP32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    record = {
        "name": "roc_hist", "route": "cuda",
        "source": "fedfr_tpu_torch/csrc/roc_hist.cu",
        "replaces": "fedfr_tpu/ops/pallas_kernels.py:93",
        "launches": None, "max_abs_err": err, "ms": timed["spread"],
        "ms_clustered": timed["clustered"], "copy_ms": copy_ms,
        "blocks": grid["blocks"], "blocks_per_sm": grid["blocks_per_sm"],
        "waves": grid["waves"], "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }
    log("kernels", shape=f"roc {t}x{n}x{e}", pairs=pairs, ms=timed["spread"],
        ms_clustered=timed["clustered"], copy_ms=copy_ms, plain_ms=plain_ms,
        library_ms=library_ms, fp32_ops_bound_ms=ops_ms, hbm_bound_ms=bytes_ms,
        tflops=ops / timed["spread"] / 1e9)
    del feats, labels
    torch.cuda.empty_cache()
    return record


def _synth_vectors(universe: dict, n: int, seed: int):
    """Generator inputs of ``n`` random positions spread over a client, the
    public set (blended identities among them) and the veri set, as card
    tensors."""
    rng = np.random.default_rng(seed)
    parts = [(universe["clients"][7], n // 4), (universe["public"], n // 2),
             (universe["veri"], n - n // 4 - n // 2)]
    vecs = [np.concatenate(v) for v in zip(*[
        ds.synth_vectors(rng.integers(0, len(ds), k))[:5] for ds, k in parts])]
    return [torch.from_numpy(v).cuda() for v in vecs]


def check_synth_gen(spec: str, n: int, seed: int, batch: int = 512) -> dict:
    """The kernel against its plain version on ``n`` images of the spec's
    universe, ``batch`` at a time: 0 differing bytes."""
    universe = synthetic.build_fl_synthetic(synthetic.parse_synth_spec(spec), "cuda")
    ds = universe["public"]
    args = (synth_gen_mod.tf.prng_key(ds.seed), ds.image_size, ds.noise, ds.block,
            ds.expr, ds.shift_div)
    vecs = _synth_vectors(universe, n, seed)
    diff, err = 0, 0
    for s0 in range(0, n, batch):
        part = [v[s0:s0 + batch] for v in vecs]
        got = synth_gen_mod.synth_generate(*part, *args)
        want = synth_gen_mod.synth_generate_plain(*part, *args)
        diff += int((got != want).sum())
        err = max(err, int((got.int() - want.int()).abs().max()))
    blended = int((vecs[3] > 0).sum())
    log("kernels", case=f"synth_gen {spec} {n} images, {batch} a launch", differing_bytes=diff,
        max_abs_err=err, bytes=n * ds.image_size ** 2 * 3, blended_images=blended)
    if diff:
        raise AssertionError(f"synth_gen {spec}: {diff} bytes differ from the plain version")
    return {"universe": universe, "vecs": vecs, "args": args, "differing_bytes": diff,
            "max_abs_err": err}


def synth_bound_ms(nbytes: int) -> dict:
    """The least time of the generator's work for ``nbytes`` output bytes:
    the larger of its bytes over HBM and its instructions over each rate
    they must share (every pipe's issue, the ALU pipe, conversions)."""
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "issue": nbytes * SYNTH_OPS_PER_BYTE / ISSUE_OPS_PER_S * 1e3,
             "alu": nbytes * SYNTH_ALU_OPS_PER_BYTE / ALU_OPS_PER_S * 1e3,
             "conversions": nbytes * SYNTH_CONVERSIONS_PER_BYTE / CONVERT_OPS_PER_S * 1e3}
    return {**parts, "bound_ms": max(parts.values()),
            "bound_by": "bytes" if max(parts, key=parts.get) == "bytes" else "operations"}


def phase_synth_gen(n_public: int) -> dict:
    """The generator's gates (bitwise: 4,096 images of the reference
    universe and 1,024 with expr=0.5, shift_div=4, 512 a launch; 256 and a
    ragged 257 in one launch each), its times per batch of 256 (the
    combined training batch) and 512 (the embeds), the plain version's
    time, and one whole public pass of ``n_public`` images, measured twice:
    the kernel alone over the pass's own batches (their vectors on the card
    first; CUDA events), and through the dataset's own batches (host
    vectors and their copy included; wall clock); each beside its bound,
    with the grid."""
    launches = synth_gen_mod.synth_gen_launches
    gates = [check_synth_gen("synth:", 4096, seed=21),
             check_synth_gen("synth:expr=0.5,shift_div=4", 1024, seed=22),
             check_synth_gen("synth:", 256, seed=23, batch=256),
             check_synth_gen("synth:", 257, seed=24, batch=257)]
    ref = gates[0]
    args = ref["args"]
    public = ref["universe"]["public"]
    size = public.image_size
    by_batch = {}
    for b in (256, 512):
        batch = [v[:b] for v in ref["vecs"]]
        ms = cuda_ms(lambda: synth_gen_mod.synth_generate(*batch, *args), 7,
                     f"synth_gen kernel, {b} images", batch=20)
        bound = synth_bound_ms(b * size * size * 3)
        grid = synth_gen_mod.launch_grid(b, size, public.block, 0)
        by_batch[b] = {"ms": ms, "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                       "bound_share": bound["bound_ms"] / ms, "blocks": grid["blocks"],
                       "chunk_runs": grid["chunk"], "fill": grid["fill"]}
        log("kernels", shape=f"synth_gen {b}x{size}x{size}x3", ms=ms,
            **{f"{k}_bound_ms": v for k, v in bound.items() if k not in ("bound_ms", "bound_by")},
            bound_ms=bound["bound_ms"], bound_share=bound["bound_ms"] / ms,
            grid_blocks=grid["blocks"], blocks_per_sm=grid["blocks_per_sm"],
            chunk_runs=grid["chunk"], fill=grid["fill"])
    batch = [v[:512] for v in ref["vecs"]]
    plain_ms = cuda_ms(lambda: synth_gen_mod.synth_generate_plain(*batch, *args), 3,
                       "synth_gen plain, 512 images")
    starts = range(0, n_public, 512)
    vecs = [torch.from_numpy(v).cuda()
            for v in public.synth_vectors(np.arange(n_public))[:5]]

    def kernel_pass():
        for s0 in starts:
            synth_gen_mod.synth_generate(*[v[s0:s0 + 512] for v in vecs], *args)

    pass_ms = cuda_ms(kernel_pass, 1, f"synth_gen kernel, the {n_public}-image public pass")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s0 in starts:
        public.device_batch(np.arange(s0, min(s0 + 512, n_public)))
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    synth_gen_mod.synth_gen_launches = launches
    cfg = synth_gen_mod.kernel_config(0, size, public.block)
    pass_bound = synth_bound_ms(n_public * size * size * 3)
    record = {
        "name": "synth_gen", "route": "cuda",
        "source": "fedfr_tpu_torch/csrc/synth_gen.cu",
        "replaces": "fedfr_tpu/data/synthetic.py:83 (XLA-fused jitted gen; no Pallas kernel)",
        "launches": None,
        "max_abs_err": max(g["max_abs_err"] for g in gates),
        "differing_bytes": sum(g["differing_bytes"] for g in gates),
        "ms": by_batch[512]["ms"], "plain_ms": plain_ms,
        "bound_ms": by_batch[512]["bound_ms"], "bound_by": by_batch[512]["bound_by"],
        "library_ms": None, "batch_images": 512,
        "by_batch": by_batch, "threads": cfg["threads"], "bytes_per_thread": cfg["run"],
        "registers": cfg["registers"], "blocks_per_sm": cfg["blocks_per_sm"],
        "grid_blocks": by_batch[512]["blocks"],
        "public_pass_images": n_public, "public_pass_batches": len(starts),
        "public_pass_kernel_ms": pass_ms, "public_pass_s": pass_s,
        "public_pass_bound_ms": pass_bound["bound_ms"],
        "public_pass_bound_share": pass_bound["bound_ms"] / pass_ms,
    }
    log("kernels", synth_gen_ms_512=by_batch[512]["ms"], plain_ms=plain_ms,
        registers=cfg["registers"], bytes_per_thread=cfg["run"],
        blocks_per_sm=cfg["blocks_per_sm"], public_pass_kernel_ms=pass_ms,
        public_pass_s=pass_s, public_pass_batches=len(starts),
        public_pass_bound_ms=pass_bound["bound_ms"],
        public_pass_bound_share=pass_bound["bound_ms"] / pass_ms)
    del ref, gates, batch, vecs
    torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------- phase 4

def _patterns(rng: np.random.Generator, n_ids: int, size: int) -> np.ndarray:
    """(n_ids, size, size, 3) float: a smooth random pattern per identity."""
    coarse = rng.integers(0, 256, size=(n_ids, 7, 7, 3)).astype(np.float32)
    rep = -(-size // 7)
    return np.repeat(np.repeat(coarse, rep, axis=1), rep, axis=2)[:, :size, :size]


def _noisy(rng: np.random.Generator, base: np.ndarray, per_id: int,
           noise: int = 24) -> np.ndarray:
    """(len(base) * per_id, ...) u8: each identity's pattern plus per-image
    noise, identity by identity."""
    imgs = np.repeat(base, per_id, axis=0)
    imgs += rng.normal(0, noise, size=imgs.shape).astype(np.float32)
    return np.clip(imgs, 0, 255).astype(np.uint8)


def _write(d: str, prefix: str, imgs, labels, num_classes, id_base=None,
           encode=codec.encode_raw) -> None:
    os.makedirs(d, exist_ok=True)
    write_split(os.path.join(d, f"{prefix}.idx"), os.path.join(d, f"{prefix}.rec"),
                [encode(im) for im in imgs], list(labels),
                num_classes=num_classes, id_base=id_base)


def write_fl_split(root: str, n_clients: int, ids: int, imgs_per_id: int,
                   pub_ids: int, pub_imgs: int, size: int, seed: int,
                   veri_imgs: int, encode=codec.encode_raw) -> None:
    """split_train_i{N}c{K}/client_*/ + split_pretrain_6000/client_0000/
    (none where ``pub_ids`` is 0) + local_veri_{N}/ (the ``test`` prefix,
    ``veri_imgs`` images per identity drawn from the train split's identity
    patterns, global labels: client c owns c*ids .. c*ids+ids-1) +
    local_gallery_{N}/ (the ``test`` prefix: every client's train images
    under their global labels, as split_dataset/split_FL.py writes the
    gallery), written with the port's own ``write_split``, each image's
    payload ``encode(image)`` (FRAW by default)."""
    rng = np.random.default_rng(seed)
    split = os.path.join(root, "split_train_i%04dc%04d" % (n_clients * ids, n_clients))
    bases, train = [], []
    for c in range(n_clients):
        bases.append(_patterns(rng, ids, size))
        train.append(_noisy(rng, bases[-1], imgs_per_id))
        _write(os.path.join(split, "client_%04d" % c), "train", train[-1],
               np.repeat(np.arange(ids), imgs_per_id), ids, c * ids, encode)
    if pub_ids:
        _write(os.path.join(root, "split_pretrain_6000", "client_0000"), "train",
               _noisy(rng, _patterns(rng, pub_ids, size), pub_imgs),
               np.repeat(np.arange(pub_ids), pub_imgs), pub_ids, encode=encode)
    veri = np.concatenate([_noisy(rng, b, veri_imgs) for b in bases])
    _write(os.path.join(root, "local_veri_%d" % (n_clients * ids)), "test",
           veri, np.repeat(np.arange(n_clients * ids), veri_imgs),
           n_clients * ids, encode=encode)
    _write(os.path.join(root, "local_gallery_%d" % (n_clients * ids)), "test",
           np.concatenate(train), np.repeat(np.arange(n_clients * ids), imgs_per_id),
           n_clients * ids, encode=encode)


def write_bin(path: str, n_pairs: int, size: int, seed: int) -> None:
    """A .bin pair set in the reference's pickle layout (bins, issame) with
    FRAW payloads: even pairs show one identity twice, odd pairs two."""
    rng = np.random.default_rng(seed)
    bins, issame = [], []
    for i in range(n_pairs):
        base = _patterns(rng, 2, size)
        same = i % 2 == 0
        a = _noisy(rng, base[:1], 1)[0]
        b = _noisy(rng, base[:1] if same else base[1:], 1)[0]
        bins += [codec.encode_raw(a), codec.encode_raw(b)]
        issame.append(same)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f, pickle.HIGHEST_PROTOCOL)


def write_round_data(root: str, n_clients: int, ids: int, size: int) -> None:
    write_fl_split(root, n_clients=n_clients, ids=ids, imgs_per_id=8,
                   pub_ids=2000, pub_imgs=2, size=size, seed=0, veri_imgs=10)
    write_bin(os.path.join(root, "val", "agedb_30.bin"), n_pairs=1200,
              size=size, seed=1)


def round_args(root: str, n_clients: int, ids: int, device: str = "cuda",
               network: str = "sphnet", embedding: int = 512,
               image_size: int = 112, batch: int = 256, local_epochs: int = 2,
               rounds: int = 2, eval_batch: int = 512, out_name: str = "run") -> list:
    """The training CLI's argv for the smoke's rounds: run.sh's federated
    flags, at the reference widths unless asked otherwise, writing to
    ``<root>/<out_name>``."""
    return [
        "--network", network, "--embedding_size", str(embedding),
        "--image_size", str(image_size), "--com_batch_size", str(batch),
        "--eval_batch_size", str(eval_batch), "--lr", "0.001",
        "--num_client", str(n_clients), "--num_ids", str(n_clients * ids),
        "--local_epoch", str(local_epochs), "--total_round", str(rounds),
        "--HN_threshold", str(THRESHOLD), "--num_workers", "6",
        "--rec_root", root, "--val_root", os.path.join(root, "val"),
        "--local_rec", os.path.join(root, "local_veri_%d" % (n_clients * ids)),
        "--output_dir", os.path.join(root, out_name), "--device", device,
        "--add_pretrained_data", "--combine_dataset", "--contrastive_bb",
        "--return_all", "--BCE_local", "--adaptive_local_epoch",
    ]


def write_pretrained_root(pre: str, network: str, embedding: int,
                          image_size: int, pub_ids: int, pub_imgs: int,
                          seed: int) -> None:
    """The pretraining outputs a run starts from (``--pretrained_root``),
    written by the port: a seeded ``network`` state_dict in the reference
    key layout as ``backbone.pth``, an ``fc.pth`` of N(0, 1) rows over the
    public IDs and ``preCos_pretrain_labels.pth``, the public set's labels
    as ``write_fl_split`` writes them."""
    os.makedirs(pre, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    net = build_backbone(network, embedding, image_size=image_size, generator=gen)
    torch.save(net.state_dict(), os.path.join(pre, "backbone.pth"))
    torch.save(torch.randn(pub_ids, embedding, generator=gen),
               os.path.join(pre, "fc.pth"))
    torch.save(torch.from_numpy(np.repeat(np.arange(pub_ids), pub_imgs)),
               os.path.join(pre, "preCos_pretrain_labels.pth"))


def write_client_fc_cache(pre: str, rows: int, embedding: int, seed: int) -> None:
    """A pretrained root holding only the clients' FC cache
    (``preCos_init_AN.pth``, every client's rows stacked in client order,
    read under ``--init_fc``): rows u + 0.9 n_i around one shared random
    direction u, n_i random unit rows, so each pair's cosine is ~0.55 and
    lies above SpreadOut's 0.4 margin, as the rows of similar identities
    do.  The root's other files are absent, so the run falls back to the
    global model's own weights, the public labels and the mean-embedding
    global FC."""
    os.makedirs(pre, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn(1, embedding, generator=gen)
    n = torch.randn(rows, embedding, generator=gen)
    fc = u / u.norm() + 0.9 * n / n.norm(dim=1, keepdim=True)
    torch.save(fc, os.path.join(pre, "preCos_init_AN.pth"))


# the synthetic IJB-C subjects' template identities: a held-out range, apart
# from the FL identities (< clients x ids), the public ones (2^20 +), the expr
# distractors ([2^26, 2^30)) and the nuisance keys (2^30 +); the JAX
# package's experiments/posttrain_eval_tpu.py draws the same
IJBC_GID_OFFSET = 1 << 21
IJBC_DATASET_SEED = 700_001
# the IJB-C 1:1 and 1:n protocol's counts (the reference meta files')
IJBC_IMAGES, IJBC_SUBJECTS = 469_375, 3_531
IJBC_PROBE_TEMPLATES, IJBC_PAIRS = 19_593, 15_658_489


def int_lines(columns, chunk: int = 1 << 21) -> bytes:
    """Rows of non-negative integer columns as text, one row a line, the
    columns joined by a space (what pandas' ``to_csv(sep=" ")`` writes),
    built in chunks of rows from per-column digit tables: no Python loop
    over the rows."""
    n = len(columns[0])
    tables = []
    for c in columns:
        vmax = int(np.max(c)) if n else 0
        width = len(str(vmax))
        v = np.arange(vmax + 1, dtype=np.int64)
        p10 = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
        digits = ((v[:, None] // p10) % 10 + 48).astype(np.uint8)
        ndig = np.ones(vmax + 1, np.int64)
        for k in range(1, width):
            ndig += v >= 10 ** k
        tables.append((digits, np.arange(width)[None, :] >= (width - ndig)[:, None]))
    out = []
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        parts, keep = [], []
        for j, (c, (digits, lead)) in enumerate(zip(columns, tables)):
            v = np.asarray(c[s:e])
            parts += [digits[v], np.full((e - s, 1), 10 if j == len(columns) - 1
                                         else 32, np.uint8)]
            keep += [lead[v], np.ones((e - s, 1), bool)]
        out.append(np.concatenate(parts, 1)[np.concatenate(keep, 1)].tobytes())
    return b"".join(out)


def write_synth_ijbc_root(root: str, spec: str, *, n_subjects: int,
                          n_probe_templates: int, n_images: int, n_pairs: int,
                          seed: int = 100, batch: int = 512,
                          device: str = "cuda") -> dict:
    """An IJB-C-shaped protocol root that ``evalsuite/ijbc.py::run_ijbc``
    reads as it is: the port of the JAX package's ``build_synth_ijbc_root``
    (experiments/posttrain_eval_tpu.py:57-204), the same files from the
    same numpy streams (its rebuild marker left out).

    Each subject has one gallery template (G1 and G2 alternate, as the
    protocol splits its subjects over two galleries) and
    ~n_probe_templates / n_subjects probe templates; every template has at
    least one image, the rest spread nearly evenly; medias group up to 4
    images of a template.  Genuine pairs: every probe template against its
    subject's gallery template; impostors: a uniform probe against another
    subject's gallery.  The images are generated by ``SyntheticFaceDataset``
    (one ``synth_gen`` launch per ``batch`` on the card) from the universe
    of ``spec`` at a held-out identity range and written straight into the
    aligned-image cache ``IJBC_imgs.npy``.  Returns the seconds of the meta
    files and of the images."""
    meta = os.path.join(root, "meta", "IJBC_meta")
    os.makedirs(meta, exist_ok=True)
    rng = np.random.default_rng(seed + 11)
    t0 = time.perf_counter()
    n_templates = n_subjects + n_probe_templates
    t_subject = np.empty(n_templates, np.int64)
    t_subject[:n_subjects] = np.arange(n_subjects)  # the gallery templates
    t_subject[n_subjects:] = np.arange(n_probe_templates) % n_subjects
    per_t = np.full(n_templates, n_images // n_templates, np.int64)
    per_t[: n_images - int(per_t.sum())] += 1
    templates = np.repeat(np.arange(n_templates), per_t)
    subjects = t_subject[templates]
    pos_in_t = np.arange(n_images) - np.repeat(np.cumsum(per_t) - per_t, per_t)
    medias = templates * 1000 + pos_in_t // 4
    with open(os.path.join(meta, "ijbc_face_tid_mid.txt"), "w") as f:
        f.writelines(f"img_{i}.jpg {templates[i]} {medias[i]}\n" for i in range(n_images))
    # canonical landmarks and faceness ~ U(0.9, 1.0) (features are weighted
    # by it); the images are never aligned from loose crops here
    faceness = rng.uniform(0.9, 1.0, n_images)
    with open(os.path.join(meta, "ijbc_name_5pts_score.txt"), "w") as f:
        f.writelines(f"img_{i}.jpg 45 60 85 60 65 80 50 100 80 100 {faceness[i]:.4f}\n"
                     for i in range(n_images))
    gallery_t = np.arange(n_subjects)
    probe_t = np.arange(n_subjects, n_templates)
    imp_p = probe_t[rng.integers(0, n_probe_templates, n_pairs - n_probe_templates)]
    imp_g = rng.integers(0, n_subjects, n_pairs - n_probe_templates)
    # an impostor's gallery: shifted away from the probe's own subject
    imp_g = (t_subject[imp_p] + 1 + (imp_g % (n_subjects - 1))) % n_subjects
    label = np.zeros(n_pairs, np.int64)
    label[:n_probe_templates] = 1
    with open(os.path.join(meta, "ijbc_template_pair_label.txt"), "wb") as f:
        f.write(int_lines([np.concatenate([probe_t, imp_p]),
                           np.concatenate([t_subject[probe_t], imp_g]), label]))
    for name, rows in (("G1", gallery_t[0::2]), ("G2", gallery_t[1::2]),
                       ("probe_mixed", probe_t)):
        path = os.path.join(meta, "ijbc_1N_%s.csv" % (
            name if name == "probe_mixed" else "gallery_" + name))
        with open(path, "w") as f:
            f.write("TEMPLATE_ID,SUBJECT_ID\n")
            f.writelines(f"{t},{t_subject[t]}\n" for t in rows)
    meta_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    sp = synthetic.parse_synth_spec(spec)
    ds = synthetic.SyntheticFaceDataset(
        subjects.astype(np.int32),
        (IJBC_GID_OFFSET + np.arange(n_subjects)).astype(np.int32),
        seed=sp["seed"], dataset_seed=IJBC_DATASET_SEED,
        image_size=sp["image_size"], noise=sp["noise"], block=sp["block"],
        expr=sp["expr"], shift_div=sp["shift_div"], device=device)
    size = sp["image_size"]
    out = np.lib.format.open_memmap(os.path.join(root, "IJBC_imgs.npy"), mode="w+",
                                    dtype=np.uint8, shape=(n_images, size, size, 3))
    for s in range(0, n_images, batch):
        e = min(s + batch, n_images)
        out[s:e] = ds.device_batch(np.arange(s, e))[0].cpu().numpy()
    out.flush()
    del out
    return {"meta_s": meta_s, "images_s": time.perf_counter() - t0}


def pretrained_args(root: str, n_clients: int, ids: int, pre: str,
                    **round_kw) -> list:
    """One round from ``pre`` with the BottleBlock converter: run.sh's own
    flags (``--pretrained_root``, ``--fedface``) on ``round_args``."""
    return round_args(root, n_clients, ids, rounds=1, out_name="run_pretrained",
                      **round_kw) + ["--pretrained_root", pre,
                                     "--converter_layer", "2", "--fedface"]


def check_local_logs(out_dir: str, candidates: list, rounds: int) -> None:
    """Every local_log.txt line matches one of parse_log.py's two patterns,
    and each candidate has its baseline plus one table per round."""
    for cid in candidates:
        path = os.path.join(out_dir, "clients", f"client_{cid}", "local_log.txt")
        with open(path) as f:
            lines = f.read().splitlines()
        if len(lines) != 2 * (rounds + 1):
            raise AssertionError(f"{path}: {len(lines)} lines, expected "
                                 f"{2 * (rounds + 1)}")
        for k, line in enumerate(lines):
            if not LOCAL_LOG_PATTERNS[k % 2].match(line):
                raise AssertionError(f"{path}:{k + 1} does not parse: {line!r}")
        epochs = [int(LOCAL_LOG_PATTERNS[1].match(x).group(1)) for x in lines[1::2]]
        if epochs[0] != -1:
            raise AssertionError(f"{path}: first entry is epoch {epochs[0]}, not -1")
        log("round", local_log=path, epochs=epochs, last=lines[-1])


def check_exports(out_dir: str, rounds: int, candidates: list) -> None:
    want = [f"backbone_{r}.pth" for r in range(rounds)] + ["backbone.pth"]
    want += [os.path.join("clients", f"client_{c}", f)
             for c in candidates for f in ("backbone.pth", "bce_module.pth")]
    missing = [w for w in want if not os.path.exists(os.path.join(out_dir, w))]
    if missing:
        raise AssertionError(f"exports missing: {missing}")
    sd = torch.load(os.path.join(out_dir, f"backbone_{rounds - 1}.pth"))
    if not all(torch.isfinite(v).all() for v in sd.values() if v.is_floating_point()):
        raise AssertionError("non-finite exported weights")
    log("round", exports=sorted(os.path.relpath(p, out_dir) for p in
                                glob.glob(os.path.join(out_dir, "**", "*.pth"),
                                          recursive=True)))


# the Chrome trace's categories of device work (torch.profiler's export)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def check_trace(trace_dir: str, wall_s: float, on_card: bool, top: int = 8) -> None:
    """The CLI's ``--profile`` output, read from the file it writes: the
    Chrome trace of round 0 exists, and on the card its device events name
    both kernels of the round; logs the device time by kernel name and the
    share of the round's wall time the device was busy (one stream, so the
    sum of kernel and copy times)."""
    path = os.path.join(trace_dir, TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name: dict = {}
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
    named = {k: any(f"{k}_kernel" in n for n in by_name) for k in ("max_sim", "roc_hist")}
    log("round", trace=path, trace_mb=f"{os.path.getsize(path) / 1e6:.1f}",
        device_event_names=len(by_name), names_kernels=named)
    if on_card and not all(named.values()):
        raise AssertionError(f"the trace's device events do not name {named}")
    if not by_name:
        log("profile", device_time="not measured (the trace holds no device events)")
        return
    busy_ms = sum(by_name.values())
    log("profile", wall_s=f"{wall_s:.3f}", device_busy_ms=f"{busy_ms:.1f}",
        device_busy_share=f"{busy_ms / 1e3 / wall_s:.3f}", kernels=len(by_name))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log("profile", ms=f"{ms:.1f}", share=f"{ms / busy_ms:.3f}", kernel=name[:90])


SPAN_RE = re.compile(r"-span (\S+)\s+total\s+(\S+)s  calls\s+(\d+)")
MEMORY_RE = re.compile(r"-(memory: device .*)$")


def check_round_log(out_dir: str, rounds: int) -> dict:
    """training.log has the phase-span report and the memory line after
    every round; returns the last report ({span: seconds}) and logs it."""
    with open(os.path.join(out_dir, "training.log")) as f:
        lines = f.read().splitlines()
    memory = [m.group(1) for m in map(MEMORY_RE.search, lines) if m]
    spans = [m.groups() for m in map(SPAN_RE.search, lines) if m]
    if len(memory) != rounds or not any(name.startswith("phase/") for name, _, _ in spans):
        raise AssertionError(f"training.log: {len(memory)} memory lines for {rounds} "
                             f"rounds, span report {spans[:3]}")
    last = {}
    for name, total, calls in spans:  # later reports overwrite earlier ones
        last[name] = float(total)
    log("round", log_spans=json.dumps(last), memory=memory[-1])
    return last


def phase_round(argv: list) -> dict:
    """The training CLI's rounds (its setup, run_round and finish, as its
    main runs them); with ``--profile`` in ``argv`` round 0 is traced by the
    CLI and its device time broken down here.  Returns the kernel launches
    counted over the rounds."""
    args = train_cli.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    run = train_cli.setup(args)
    server, cfg = run.server, run.cfg
    sync = torch.cuda.synchronize if cfg.runtime.device == "cuda" else (lambda: None)
    sync()
    log("round", setup_s=f"{time.perf_counter() - t0:.2f}",
        public_images=len(server.data.public_dataset),
        local_images=[len(d) for d in server.data.client_datasets],
        veri_images=len(run.local_cb.dataset), bin_pairs=len(run.bin_cb.sets[0][1]),
        candidates=server.local_candidates)
    before = {k: v.detach().clone() for k, v in server.global_net.state_dict().items()}

    zero_launches()
    while not run.done:
        profiled = run.trace_dir is not None and server.global_round == 0
        if cfg.runtime.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rec = train_cli.run_round(run)
        sync()
        seconds = time.perf_counter() - t
        peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}"
                if cfg.runtime.device == "cuda" else "not measured")
        if profiled:
            # the CLI's trace of round 0 (its seconds include the profiler's
            # cost and the trace's export)
            check_trace(run.trace_dir, rec["train_round_s"], cfg.runtime.device == "cuda")
        clients = [server.clients[c] for c in rec["clients"]]
        log("round", round=rec["round"], seconds=f"{seconds:.2f}",
            train_s=f"{rec['train_round_s'] - rec['local_eval_s']:.3f}",
            eval_s=f"{rec['local_eval_s'] + rec['bin_eval_s']:.3f}",
            local_eval_s=f"{rec['local_eval_s']:.3f}",
            bin_eval_s=f"{rec['bin_eval_s']:.3f}", peak_memory_gib=peak,
            local_epochs=server.local_epoch,
            avg_loss=rec["avg_loss"], acc=rec["acc"],
            losses=[c.last_loss for c in clients],
            mined=[c.mined for c in clients],
            dataset_sizes=[c.dataset_size for c in clients])
        if not all(math.isfinite(c.last_loss) for c in clients):
            raise AssertionError("non-finite client loss")
        if not (rec["acc"] and all(math.isfinite(a) and 0.0 <= a <= 1.0
                                   for a in rec["acc"])):
            raise AssertionError(f"bin accuracy {rec['acc']}")
    launches = read_launches()
    train_cli.finish(run)
    check_round_log(cfg.runtime.output_dir, cfg.fed.total_rounds)

    after = server.global_net.state_dict()
    changed = max(float((after[k].float() - v.float()).abs().max())
                  for k, v in before.items() if v.is_floating_point())
    finite = all(bool(torch.isfinite(v).all()) for v in after.values()
                 if v.is_floating_point())
    if not (finite and changed > 0):
        raise AssertionError(f"global model finite={finite} max change={changed}")
    rounds = cfg.fed.total_rounds
    expected = {"max_sim": cfg.data.num_clients * rounds,
                "roc_hist": len(server.local_candidates) * (rounds + 1),
                "synth_gen": 0}
    log("round", launches=launches, expected=expected, global_max_change=changed)
    if cfg.runtime.device == "cuda" and launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected} "
                             f"(mining: clients x rounds; ROC: candidates x "
                             f"(rounds + the epoch -1 baseline))")
    check_local_logs(cfg.runtime.output_dir, server.local_candidates, rounds)
    check_exports(cfg.runtime.output_dir, rounds, server.local_candidates)
    return launches


def phase_pretrained(argv: list) -> dict:
    """One round from a pretrained root through the training CLI
    (``phase_round`` with its checks, unprofiled), then the three "loaded
    ..." lines of the JAX package's Server in training.log; returns the
    kernel launches counted over the round."""
    launches = phase_round(argv)
    out = argv[argv.index("--output_dir") + 1]
    pre = argv[argv.index("--pretrained_root") + 1]
    with open(os.path.join(out, "training.log")) as f:
        text = f.read()
    want = ["loaded pretrained backbone from " + os.path.join(pre, "backbone.pth"),
            "loaded pretrain labels (", "loaded pretrained perfect FC ("]
    missing = [w for w in want if w not in text]
    if missing or "train from scratch" in text:
        raise AssertionError(f"training.log lacks {missing} or trained from scratch")
    log("pretrained", loaded=[line.split("-", 1)[-1] for line in text.splitlines()
                              if "loaded pretrain" in line])
    return launches


def check_local_all_log(path: str, n_clients: int) -> None:
    """<ckpt_path>/local_log.txt after the three calls of phase_local_all:
    per-client 1:1 lines and their mean, the 1:n block, then the single
    backbone's 1:1 block, each line in the format parse_log.py and the
    repository's local_all.py use."""
    per_client = [LOCAL_LOG_PATTERNS[0], LOCAL_LOG_PATTERNS[1]] * n_clients
    want = (per_client + list(MEAN_PATTERNS) + list(ONE_TO_N_PATTERNS)
            + [SINGLE_PATTERN] + per_client + list(MEAN_PATTERNS))
    with open(path) as f:
        lines = f.read().splitlines()
    if len(lines) != len(want):
        raise AssertionError(f"{path}: {len(lines)} lines, expected {len(want)}")
    for k, (line, pattern) in enumerate(zip(lines, want)):
        if not pattern.match(line):
            raise AssertionError(f"{path}:{k + 1} does not parse: {line!r}")
    log("local_all", local_log=path, lines=len(lines))


def phase_local_all(out_dir: str, data_root: str, n_clients: int, ids: int,
                    network: str, embedding: int, converter_layer: int,
                    device: str = "cuda", batch: int = 512) -> dict:
    """The post-training eval CLI (``fedfr_tpu_torch.local_all``) on a
    training run's exports: per-client backbones and converters for 1:1
    (one ROC launch per client) and 1:n (against local_gallery_<N>, no ROC
    launch), then the round-0 global backbone for 1:1 (one ROC launch per
    client).  Kernel launch counts are set to 0 just before and read just
    after; returns them."""
    n = n_clients * ids
    base = ["--ckpt_path", out_dir,
            "--data_dir", os.path.join(data_root, f"local_veri_{n}"),
            "--gallery_data_dir", os.path.join(data_root, f"local_gallery_{n}"),
            "--num_client", str(n_clients), "--num_ids", str(n),
            "--network", network, "--embedding_size", str(embedding),
            "--converter_layer", str(converter_layer), "--batch_size", str(batch),
            "--device", device]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    zero_launches()
    for backbone, task, epoch in (("multi", "1:1", -1), ("multi", "1:n", -1),
                                  ("single", "1:1", 0)):
        before = roc_hist_mod.roc_hist_launches
        t0 = time.perf_counter()
        res = local_all_cli.main(local_all_cli.build_parser().parse_args(
            base + ["--backbone", backbone, "--task", task, "--epoch", str(epoch)]))
        sync()
        seconds = time.perf_counter() - t0
        launched = roc_hist_mod.roc_hist_launches - before
        expected = n_clients if task == "1:1" else 0
        log("local_all", backbone=backbone, task=task, epoch=epoch,
            seconds=f"{seconds:.2f}", roc_launches=launched, mean=res["mean"])
        if device == "cuda" and launched != expected:
            raise AssertionError(f"local_all {backbone} {task}: {launched} ROC "
                                 f"launches, expected {expected}")
        if not all(math.isfinite(v) for v in res["mean"]):
            raise AssertionError(f"local_all {backbone} {task}: mean {res['mean']}")
    launches = read_launches()
    check_local_all_log(os.path.join(out_dir, "local_log.txt"), n_clients)
    return launches


# ---------------------------------------------------------------- phase 7

# The cached-contrastive step gathers the frozen models' features from
# caches built at the embedding batch (512); the recompute step runs the
# same frozen models on the 256-image batch.  With the bf16 trunk cuDNN may
# pick other algorithms for the two batch shapes, so a feature can differ by
# a few bf16 roundings: allow delta = 2^-7 (two roundings of 2^-8) on each
# cosine of the MOON term.  Its sensitivity to a cosine is at most 1/T
# (T = 0.5), two cosines per sample, so |d con_loss| <= 2 * delta / T = 2^-5;
# the trainable forward is the same call on the same input, so the total
# loss moves by mu (5) times that at most.
MOON_TOL = 2.0 ** -5
SPREADOUT_RE = re.compile(r"round (\d+) spreadout over (\d+) rows: "
                          r"objective (\S+) -> (\S+)")
CACHE_RE = re.compile(r"contrastive caches of (\d+) imgs built in (\S+) s")
RESTORE_RE = re.compile(r"resumed at round (\d+) \(restore (\S+) s\)")


def drive(argv: list, on_setup=None, tag: str = "paths", devices=None):
    """The training CLI's setup (on ``devices``, default the CLI's), rounds
    and finish (as its main runs them), with the kernels' launch counts set
    to 0 just before the rounds and read just after; ``on_setup(run)`` runs
    between setup and the rounds; the per-round lines are logged under
    ``tag``.  Returns (run, the rounds' records, launches, the log's text)."""
    run = train_cli.setup(train_cli.build_parser().parse_args(argv), devices)
    if on_setup is not None:
        on_setup(run)
    sync = torch.cuda.synchronize if run.cfg.runtime.device == "cuda" else (lambda: None)
    zero_launches()
    history = []
    while not run.done:
        t = time.perf_counter()
        rec = train_cli.run_round(run)
        sync()
        rec["seconds"] = time.perf_counter() - t
        clients = [run.server.clients[c] for c in rec["clients"]]
        rec["losses"] = [c.last_loss for c in clients]
        rec["mined"] = [c.mined for c in clients]
        rec["dataset_sizes"] = [c.dataset_size for c in clients]
        rec["local_epochs"] = run.server.local_epoch
        history.append(rec)
        if not all(math.isfinite(x) for x in rec["losses"] + [rec["avg_loss"]]):
            raise AssertionError(f"non-finite loss in round {rec['round']}: {rec['losses']}")
    launches = read_launches()
    t = time.perf_counter()
    train_cli.finish(run)
    finish_s = time.perf_counter() - t
    with open(os.path.join(run.cfg.runtime.output_dir, "training.log")) as f:
        text = f.read()
    for rec in history:
        log(tag, out=os.path.basename(run.cfg.runtime.output_dir),
            round=rec["round"], seconds=f"{rec['seconds']:.2f}",
            train_s=f"{rec['train_round_s'] - rec['local_eval_s']:.3f}",
            local_eval_s=f"{rec['local_eval_s']:.3f}", bin_eval_s=f"{rec['bin_eval_s']:.3f}",
            ckpt_save_s=rec["ckpt_save_s"], losses=rec["losses"], mined=rec["mined"],
            dataset_sizes=rec["dataset_sizes"], acc=rec["acc"])
    log(tag, out=os.path.basename(run.cfg.runtime.output_dir), launches=launches,
        finish_s=f"{finish_s:.3f}")
    return run, history, launches, text


def expect_launches(run, launches: dict, expected: dict, part: str) -> None:
    """``expected`` names the kernels the part launches; every other kernel
    must not have launched."""
    expected = {**{k: 0 for k in KERNEL_COUNTERS}, **expected}
    if run.cfg.runtime.device == "cuda" and launches != expected:
        raise AssertionError(f"{part}: kernel launches {launches}, expected {expected}")


def compare_step_forms(run, iters: int = 10) -> dict:
    """On one batch of a local run of client 0 prepared as the next round
    would prepare it: the cached step's con_loss and loss against the
    recompute step's from the same state and flip (within MOON_TOL on the
    card, 1e-5 on the CPU's fp32), then both forms timed (CUDA events over
    ``iters`` steps back to back, in turns: cached, recompute, recompute,
    cached) with the cache build's seconds.  Launches made here are not
    the main path's: the caller has read the counts already."""
    server, cfg = run.server, run.cfg
    dev = server.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    client = server.clients[0]
    combined, loader, state, last_net = client.prepare_local_run(
        server.global_net, server.data.public_dataset, server.pretrained_fc,
        server.generate_public_features(), server.pretrained_labels,
        round_seed=server.global_round)
    sync()
    t0 = time.perf_counter()
    g_cache, l_cache = client.build_flip_caches(server.global_net, last_net, combined)
    sync()
    cache_s = time.perf_counter() - t0
    batches = DevicePrefetcher(loader, dev, depth=1).epoch(with_positions=True)
    try:
        imgs, labels, valid, idx = next(batches)
    finally:
        batches.close()
        loader.close()
    flip = torch.rand(imgs.shape[0], device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0)) < 0.5
    start = {k: v.clone() for k, v in state.backbone.state_dict().items()}
    bce0 = {k: v.clone() for k, v in state.bce.state_dict().items()} if state.bce else None
    fc0 = state.fc.detach().clone()

    def fresh():
        state.backbone.load_state_dict(start)
        if state.bce is not None:
            state.bce.load_state_dict(bce0)
        return init_client_state(state.backbone, fc0, state.bce, cfg.optim.lr,
                                 cfg.optim.momentum, cfg.optim.weight_decay)

    recompute = branch_step_for(cfg, client.num_classes)
    cached = branch_step_for(cfg, client.num_classes, cached_contrastive=True)
    steps = {
        "recompute": lambda s: recompute(s, server.global_net, last_net, imgs, labels,
                                         valid, cfg.optim.lr, flip),
        "cached": lambda s: cached(s, g_cache, l_cache, imgs, labels, valid, idx,
                                   cfg.optim.lr, flip),
    }
    metrics = {name: fn(fresh())[1] for name, fn in steps.items()}
    d_con = abs(float(metrics["cached"].con_loss) - float(metrics["recompute"].con_loss))
    d_loss = abs(float(metrics["cached"].loss) - float(metrics["recompute"].loss))
    tol = MOON_TOL if dev.type == "cuda" else 1e-5
    log("paths", step_check="cached vs recompute", batch=int(imgs.shape[0]),
        con_loss=float(metrics["recompute"].con_loss), d_con_loss=d_con,
        loss=float(metrics["recompute"].loss), d_loss=d_loss, con_tol=tol,
        loss_tol=cfg.loss.mu * tol)
    if not (d_con <= tol and d_loss <= cfg.loss.mu * tol):
        raise AssertionError(f"cached step: con_loss differs by {d_con}, loss by {d_loss} "
                             f"(tolerances {tol}, {cfg.loss.mu * tol})")
    times: dict = {"cached": [], "recompute": []}
    s = fresh()
    for name in ("cached", "recompute", "recompute", "cached"):
        sync()
        t0 = time.perf_counter()
        if dev.type == "cuda":
            times[name].append(cuda_ms(lambda: steps[name](s), 1,
                                       f"{name} step x {iters}", batch=iters))
        else:
            for _ in range(iters):
                steps[name](s)
            times[name].append((time.perf_counter() - t0) * 1e3 / iters)
    out = {"batch": int(imgs.shape[0]), "cache_build_s": cache_s,
           "cache_rows": len(combined), "d_con_loss": d_con, "d_loss": d_loss}
    for name, ms in times.items():
        out[f"{name}_ms_per_step"] = float(np.mean(ms))
        out[f"{name}_samples_per_s"] = imgs.shape[0] / float(np.mean(ms)) * 1e3
    log("paths", step_forms=out)
    del g_cache, l_cache
    return out


def _state_tensors(server) -> dict:
    """The resume state's tensors of ``server`` on the CPU, by a flat key."""
    out = {f"global.{k}": v.cpu() for k, v in server.global_net.state_dict().items()}
    out["pretrained_fc"] = server.pretrained_fc.cpu()
    for c in server.clients:
        out[f"c{c.cid}.fc_local"] = c.fc_local.cpu()
        for key, d in (("bce", c.bce_state), ("last", c.last_backbone)):
            out.update({f"c{c.cid}.{key}.{k}": v.cpu() for k, v in (d or {}).items()})
    return out


def _saved_tensors(state: dict) -> dict:
    out = {f"global.{k}": v for k, v in state["global"].items()}
    out["pretrained_fc"] = state["pretrained_fc"]
    for cid, cs in state["clients"].items():
        out[f"{cid}.fc_local"] = cs["fc_local"]
        for key in ("bce", "last"):
            out.update({f"{cid}.{key}.{k}": v for k, v in cs.get(key, {}).items()})
    return out


def resume_part(argv: list, saved: dict, meta: dict) -> dict:
    """--resume --total_round 2 on a copy of 7a's round states: the restored
    state bitwise equal to the saved one, one round, and that round's client
    sample equal to what ``sample_clients`` draws from the saved RNG state."""
    checked = {}

    def check_restored(run):
        got, want = _state_tensors(run.server), _saved_tensors(saved)
        if got.keys() != want.keys():
            raise AssertionError(f"restored keys differ: {sorted(got.keys() ^ want.keys())}")
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        if bad:
            raise AssertionError(f"restored state differs from the save: {bad[:5]}")
        checked["tensors"] = len(want)

    run, history, launches, text = drive(argv, on_setup=check_restored)
    rng = np.random.default_rng()
    rng.bit_generator.state = meta["rng_state"]
    n = run.cfg.data.num_clients
    k = int(round(run.cfg.fed.client_sampled_ratio * n))
    replay = sorted(rng.choice(n, size=k, replace=False).tolist())
    restored = RESTORE_RE.search(text)
    if not restored or int(restored.group(1)) != meta["global_round"]:
        raise AssertionError(f"training.log: no 'resumed at round {meta['global_round']}'")
    if [h["round"] for h in history] != [meta["global_round"]]:
        raise AssertionError(f"rounds run after the resume: {[h['round'] for h in history]}")
    if history[0]["clients"] != replay:
        raise AssertionError(f"client sample {history[0]['clients']} != replay {replay}")
    expect_launches(run, launches, {"max_sim": len(replay),
                                    "roc_hist": len(run.server.local_candidates)},
                    "7b resume")
    log("paths", resumed_at=restored.group(1), restore_s=restored.group(2),
        bitwise_equal_tensors=checked["tensors"], sample=replay)
    return {"launches": launches, "restore_s": float(restored.group(2)),
            "ckpt_save_s": history[0]["ckpt_save_s"]}


def phase_paths(root: str, n_clients: int, ids: int, **round_kw) -> dict:
    """Phase 7: the sequential round's other paths through the training CLI
    (7a cached contrastive + SpreadOut, 7b resume, 7c FC-row mining, 7d the
    plain objective), each part's launches counted over its rounds alone.
    Returns {part: launches} and logs the figures."""
    by_part, figures = {}, {}
    base = round_args(root, n_clients, ids, **round_kw)

    def argv_for(out_name: str, rounds: int, extra: list, drop=()) -> list:
        argv = [a for a in base if a not in drop]
        argv[argv.index("--output_dir") + 1] = os.path.join(root, out_name)
        argv[argv.index("--total_round") + 1] = str(rounds)
        return argv + extra

    # 7a: the local FC rows come from a client FC cache whose pairs lie above
    # SpreadOut's margin (--pretrained_root, --init_fc): the seeded
    # N(0, 0.01) rows are near-orthogonal at E=512 and stay so over the
    # rounds at random weights, which leaves SpreadOut's objective at 0
    pre = os.path.join(root, "pretrain_paths")
    write_client_fc_cache(pre, n_clients * ids, round_kw.get("embedding", 512), seed=7)
    paths_flags = ["--cache_contrastive", "--spreadout", "--pretrained_root", pre,
                   "--init_fc"]
    out_a = os.path.join(root, "run_paths")
    run, history, launches, text = drive(argv_for(
        "run_paths", 1, paths_flags + ["--round_ckpt_every", "1"]))
    server = run.server
    expect_launches(run, launches, {
        "max_sim": n_clients, "roc_hist": len(server.local_candidates) * 2}, "7a")
    spread = [(int(m.group(1)), float(m.group(3)), float(m.group(4)))
              for m in SPREADOUT_RE.finditer(text)]
    if [r for r, _, _ in spread] != [0] or not all(
            0 < after < before for _, before, after in spread):
        raise AssertionError(f"SpreadOut did not lower its objective each round: {spread}")
    caches = [(int(m.group(1)), float(m.group(2))) for m in CACHE_RE.finditer(text)]
    if len(caches) != n_clients:
        raise AssertionError(f"{len(caches)} cache builds logged, expected {n_clients}")
    log("paths", part="7a", spreadout=spread, cache_builds=caches)
    by_part["7a_cached_spreadout"] = launches
    figures["7a"] = {"round_s": [h["seconds"] for h in history],
                     "ckpt_save_s": [h["ckpt_save_s"] for h in history],
                     "cache_builds": caches, "spreadout": spread,
                     "steps": compare_step_forms(run)}
    del run, server

    # 7b: resume at round 1 of 7a's states, then again on a copy taken first,
    # with the async writer, the background fetch and one state kept
    ckpt = RoundCheckpointer(os.path.join(out_a, "rounds"))
    saved, meta = ckpt.load(ckpt.latest())
    out_copy = os.path.join(root, "run_paths_async")
    shutil.copytree(os.path.join(out_a, "rounds"), os.path.join(out_copy, "rounds"))
    first = resume_part(argv_for("run_paths", 2, paths_flags + ["--resume"]),
                        saved, meta)
    second = resume_part(argv_for("run_paths_async", 2, paths_flags + [
        "--resume", "--round_ckpt_async", "--round_ckpt_bg_fetch",
        "--round_ckpt_keep", "1"]), saved, meta)
    left = sorted(os.listdir(os.path.join(out_copy, "rounds")))
    if left != ["round_2.meta.json", "round_2.pt"]:
        raise AssertionError(f"--round_ckpt_keep 1 left {left}")
    by_part["7b_resume"] = {k: first["launches"][k] + second["launches"][k]
                            for k in first["launches"]}
    figures["7b"] = {"restore_s": [first["restore_s"], second["restore_s"]],
                     "ckpt_save_s": {"sync": first["ckpt_save_s"],
                                     "async_bg_fetch": second["ckpt_save_s"]}}
    del first, second

    # 7c: FC-row mining; the threshold lies between two middle per-identity
    # scores of client 0, so that its mined set is a strict subset
    def fc_threshold(run):
        s = run.server
        loc = s.clients[0].fc_local.float()
        pub = s.pretrained_fc.float()
        sim = (loc / loc.norm(dim=1, keepdim=True)) @ (pub / pub.norm(dim=1, keepdim=True)).t()
        best = sim.max(dim=0).values.sort().values.cpu()
        mid = len(best) // 2
        run.cfg.fed.hn_fc_threshold = float(best[mid - 1] + best[mid]) / 2
        log("paths", part="7c", hn_fc_threshold=run.cfg.fed.hn_fc_threshold)

    run, history, launches, text = drive(argv_for(
        "run_paths_fc", 1, ["--hn_strategy", "fc"]), on_setup=fc_threshold)
    public = len(run.server.data.public_dataset)
    mined = history[0]["mined"]
    if "public features" in text or not 0 < mined[0] < public:
        raise AssertionError(f"7c: a public embed ran, or client 0 mined {mined[0]} of {public}")
    expect_launches(run, launches, {"max_sim": 0,
                                    "roc_hist": len(run.server.local_candidates) * 2}, "7c")
    by_part["7c_fc_mining"] = launches
    figures["7c"] = {"round_s": history[0]["seconds"], "mined": mined}
    del run

    # 7d: the plain objective (no public data) at run.sh's --batch_size 64
    run, history, launches, text = drive(argv_for(
        "run_paths_plain", 1, ["--batch_size", "64"], drop=("--add_pretrained_data",)))
    own = [len(run.server.clients[c].dataset) for c in history[0]["clients"]]
    if history[0]["dataset_sizes"] != own or "public features" in text:
        raise AssertionError(f"7d: dataset sizes {history[0]['dataset_sizes']} != {own}")
    expect_launches(run, launches, {"max_sim": 0,
                                    "roc_hist": len(run.server.local_candidates) * 2}, "7d")
    by_part["7d_plain"] = launches
    figures["7d"] = {"round_s": history[0]["seconds"]}
    log("paths", figures=json.dumps(figures))
    return by_part


# ---------------------------------------------------------------- phase 8

REF_PUBLIC, REF_VERI, REF_TARGETS = 420_671, 160_000, 4_000


def reference_args(val_root: str, out: str) -> list:
    """run.sh's round at the reference's data scale on the ``synth:``
    universe at its defaults (40 clients x 100 IDs x 61-69 images, 420,671
    public images over 6,000 IDs, 4,000 x 40 veri), sphere64, E=512,
    112x112, combined batch 256, with the cuts: 2 of 40 clients, 1 local
    epoch, 1 round, the mined set capped at 6,500 images, no resume state
    or per-round client exports."""
    return [
        "--network", "sphnet", "--embedding_size", "512", "--image_size", "112",
        "--com_batch_size", "256", "--eval_batch_size", "512",
        "--public_batch_size", "512", "--lr", "0.001", "--num_client", "40",
        "--num_ids", "4000", "--client_sampled_ratio", "0.05", "--local_epoch", "1",
        "--total_round", "1", "--HN_threshold", str(THRESHOLD), "--HN_cap", "6500",
        "--num_workers", "6", "--rec_root", "synth:", "--local_rec", "synth:",
        "--val_root", val_root, "--output_dir", out, "--round_ckpt_every", "0",
        "--client_ckpt_every", "0", "--add_pretrained_data", "--combine_dataset",
        "--contrastive_bb", "--return_all", "--BCE_local", "--adaptive_local_epoch",
    ]


@contextlib.contextmanager
def launch_shapes():
    """Records the shape of every mining and ROC call of the block:
    (public rows, local rows, width) and (targets, rows, width)."""
    shapes = {"max_sim": [], "roc_hist": []}
    mine, roc = embed_mod.max_cosine_similarity, roc_histogram_mod.roc_histogram

    def mine_rec(public, local):
        shapes["max_sim"].append((public.shape[0], local.shape[0], public.shape[1]))
        return mine(public, local)

    def roc_rec(feats, labels, target_size):
        shapes["roc_hist"].append((int(target_size), feats.shape[0], feats.shape[1]))
        return roc(feats, labels, target_size)

    embed_mod.max_cosine_similarity, roc_histogram_mod.roc_histogram = mine_rec, roc_rec
    try:
        yield shapes
    finally:
        embed_mod.max_cosine_similarity, roc_histogram_mod.roc_histogram = mine, roc


def phase_reference(argv: list) -> dict:
    """Phase 8: one round at the reference's data scale through the CLI's
    setup, run_round and finish.  The local-eval candidates are cut from 10
    to 1 by this script: the first client of the round's sample, drawn from
    a copy of the server's RNG.  Checks each mining launch at 420,671 x
    n_loc x 512 and each ROC launch at 4,000 x 160,000 x 512, that every
    synth: batch of the round came from the kernel, finite losses, the span
    report and the memory line."""
    t0 = time.perf_counter()
    zero_launches()
    if torch.cuda.is_available():
        # the memory line's peak is the process's: start it at this phase
        torch.cuda.reset_peak_memory_stats()
    setup_launches = {}

    def one_candidate(run):
        s = run.server
        rng = np.random.default_rng()
        rng.bit_generator.state = s.rng.bit_generator.state
        n = run.cfg.data.num_clients
        k = int(round(run.cfg.fed.client_sampled_ratio * n))
        s.local_candidates = [sorted(rng.choice(n, size=k, replace=False).tolist())[0]]
        if s.device.type == "cuda":
            torch.cuda.synchronize()
        setup_launches.update(read_launches(), seconds=time.perf_counter() - t0)

    with launch_shapes() as shapes:
        run, history, launches, text = drive(argv, on_setup=one_candidate)
    rec, server, cfg = history[0], run.server, run.cfg
    data = server.data
    public, veri = len(data.public_dataset), len(run.local_cb.dataset)
    clients = [server.clients[c] for c in rec["clients"]]
    width = cfg.model.embedding_size
    cand = server.clients[server.local_candidates[0]]
    targets = int(np.isin(run.local_cb.dataset.all_labels(), cand.target_ids).sum())
    # every synth: batch of the round: the public embed, each client's local
    # embed and combined batches (drop_last), two veri embeds of the candidate
    bs, eb = cfg.data.combined_batch_size, cfg.data.eval_batch_size
    batches = (-(-public // cfg.data.public_batch_size)
               + sum(-(-len(c.dataset) // eb) + cfg.fed.local_epochs * (c.dataset_size // bs)
                     for c in clients)
               + 2 * -(-veri // eb))
    want_mine = [(public, len(c.dataset), width) for c in clients]
    want_roc = [(targets, veri, width)] * 2
    log("reference", setup_s=f"{setup_launches.pop('seconds'):.2f}",
        setup_launches=setup_launches, public_images=public, veri_images=veri,
        local_images=[len(c.dataset) for c in clients], candidates=server.local_candidates,
        mining_shapes=shapes["max_sim"], roc_shapes=shapes["roc_hist"],
        launches=launches, synth_batches=batches)
    if (public, veri, targets) != (REF_PUBLIC, REF_VERI, REF_TARGETS):
        raise AssertionError(f"universe of {public} public and {veri} veri images, "
                             f"{targets} targets")
    if shapes["max_sim"] != want_mine or shapes["roc_hist"] != want_roc:
        raise AssertionError(f"launch shapes {shapes}, expected {want_mine} and {want_roc}")
    expect_launches(run, launches, {"max_sim": len(clients), "roc_hist": 2,
                                    "synth_gen": batches}, "8 reference")
    if not (rec["acc"] and all(math.isfinite(a) for a in rec["acc"])):
        raise AssertionError(f"bin accuracy {rec['acc']}")
    spans = check_round_log(cfg.runtime.output_dir, 1)
    out = {"round_s": rec["seconds"],
           "train_s": rec["train_round_s"] - rec["local_eval_s"],
           "local_eval_s": rec["local_eval_s"], "bin_eval_s": rec["bin_eval_s"],
           "spans": spans, "memory": rec["memory"], "losses": rec["losses"],
           "mined": rec["mined"], "dataset_sizes": rec["dataset_sizes"],
           "acc": rec["acc"], "launches": launches, "synth_batches": batches}
    log("reference", figures=json.dumps(out))
    return launches


# ---------------------------------------------------------------- phase 9

# the synth: universe at its defaults with the public set cut to 61,440
# images (~10 an ID over all 6,000 IDs): 120 steps of 512 an epoch
PRETRAIN_SPEC = "synth:public_imgs=61440"
LOSS_LINE_RE = re.compile(r"Speed (\S+) samples/sec\s+Loss (\S+)\s+Epoch: (\d+)")


def pretrain_argv(data_dir: str, out: str, device: str = "cuda",
                  network: str = "sphnet", embedding: int = 512,
                  image_size: int = 112, batch: int = 512) -> list:
    """The pretraining CLI's argv for phase 9: the JAX CLI's defaults (lr
    0.05 with steps at 6 and 14, scale 64, margin 0.4), bf16 trunk."""
    return ["--data_dir", data_dir, "--output_dir", out, "--network", network,
            "--embedding_size", str(embedding), "--image_size", str(image_size),
            "--batch_size", str(batch), "--log_every", "20", "--device", device]


def with_flag(argv: list, flag: str, value: str) -> list:
    """``argv`` with ``flag``'s value replaced (appended if absent)."""
    argv = list(argv)
    if flag in argv:
        argv[argv.index(flag) + 1] = value
        return argv
    return argv + [flag, value]


def time_pretrain_steps(args, dataset, u8: torch.Tensor, labels: torch.Tensor,
                        iters: int = 10, devices=None,
                        forms=(("full", 1.0), ("sampled", 0.1))) -> dict:
    """The pretraining step (``forms``: the full and the sampled Partial
    FC, by sample rate) on one batch (``u8``, ``labels``) of ``dataset``
    from the CLI's initial weights, over ``devices`` (default: the
    dataset's device alone): ms per step and samples/s over ``iters`` steps
    back to back, three runs, after two warm-up steps; CUDA events on one
    card, else the host clock with every device synchronized (medians).
    Each card's peak memory over the steps."""
    devices = devices or [dataset.device]
    on_card = devices[0].type == "cuda"
    out = {}
    for name, rate in forms:
        t0 = time.perf_counter()
        state = pretrain_cli.training_state(args, dataset.num_classes, devices)
        state_s = time.perf_counter() - t0
        c_pad = sum(w.shape[0] for w in state.weights)
        num_sample = partial_fc.num_sampled(rate, c_pad, len(devices)) if rate < 1.0 else None
        step = pretrain_cli.make_train_step(args, state.num_valid, num_sample)
        key = pretrain_cli.step_key(prng_key(args.seed + 7), 0, 0)

        def one():
            return step(state, u8, labels, args.lr, key)

        loss = [float(one()) for _ in range(2)][-1]
        cards = list(dict.fromkeys(d for d in devices if d.type == "cuda"))
        for dev in cards:
            torch.cuda.reset_peak_memory_stats(dev)

        def steps():
            for _ in range(iters):
                one()
        if on_card and len(devices) == 1:
            ms = cuda_ms(one, 3, f"pretrain {name} step x {iters}", batch=iters)
        else:
            ms = wall_ms(steps, devices) / iters
        out[name] = {"ms_per_step": ms, "samples_per_s": args.batch_size / ms * 1e3,
                     "loss": loss, "num_sample": num_sample, "state_s": state_s,
                     "peak_gib": {str(d): torch.cuda.max_memory_allocated(d) / 2**30
                                  for d in cards} or "not measured"}
        del state
    return out


def feature_norms(args, num_classes: int, root: str, u8: torch.Tensor) -> dict:
    """The l2 norms (in fp64) of the features that ``root``'s backbone.pth
    gives the batch ``u8`` in eval mode: median, max, the rows with a
    non-finite value and the rows whose squared norm overflows fp32, where
    ``x / ||x||`` is 0 and the loss gets no gradient."""
    backbone, _ = pretrain_cli.initial_state(args, num_classes)
    backbone.load_state_dict(torch.load(os.path.join(root, "backbone.pth"),
                                        map_location="cpu"))
    backbone = backbone.to(u8.device).eval()
    with torch.no_grad():
        f = backbone(normalize_images(u8)).double()
    norms = torch.linalg.vector_norm(f, dim=1)
    return {"median": float(norms.median()), "max": float(norms.max()),
            "nonfinite_rows": int((~torch.isfinite(f)).any(1).sum()),
            "fp32_overflow_rows": int((norms > math.sqrt(torch.finfo(torch.float32).max)).sum())}


def phase_pretrain(argv: list, setup_argv: list) -> dict:
    """Phase 9: the pretraining CLI (``fedfr_tpu_torch.pretrain``) in
    process, launch counts set to 0 before its runs and read after: 2
    epochs of the full softmax saving each epoch, ``--resume --num_epoch
    3`` (one epoch, "resumed pretraining at epoch 2"), then 1 epoch at
    ``--sample_rate 0.1`` into a second directory.  Checks finite losses,
    the three artefacts (``fc.pth`` one row per public ID, the labels one
    per public image) and the resume state, one ``synth_gen`` launch per
    batch; then the training CLI's setup on the same universe with
    ``--pretrained_root`` set to the output logs its three "loaded
    pretrained ..." lines (no round).  Then both losses' step times."""
    out = argv[argv.index("--output_dir") + 1]
    on_card = argv[argv.index("--device") + 1] == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    runs = [("full", argv + ["--num_epoch", "2", "--sample_rate", "1.0",
                             "--save_every", "1"]),
            ("resumed", argv + ["--num_epoch", "3", "--resume"]),
            ("sampled", with_flag(argv, "--output_dir", out + "_sampled")
             + ["--num_epoch", "1", "--sample_rate", "0.1"])]
    zero_launches()
    figures, steps = {}, 0
    for name, run_argv in runs:
        t0 = time.perf_counter()
        rec = pretrain_cli.main(pretrain_cli.build_parser().parse_args(run_argv))
        sync()
        rec["seconds"] = time.perf_counter() - t0
        del rec["state"]
        figures[name] = rec
        steps += len(rec["epochs"]) * rec["steps_per_epoch"]
        log("pretrain", run=name, seconds=f"{rec['seconds']:.2f}", epochs=rec["epochs"],
            steps_per_epoch=rec["steps_per_epoch"], epoch_s=rec["epoch_s"],
            save_s=rec["save_s"], lr=rec["lr"], num_sample=rec["num_sample"],
            losses=rec["losses"])
        losses = [v for _, v in rec["losses"]]
        if not losses or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"pretrain {name}: losses {rec['losses']}")
    launches = read_launches()
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if on_card
            else "not measured")
    if [figures[k]["epochs"] for k in ("full", "resumed", "sampled")] != [[0, 1], [2], [0]]:
        raise AssertionError("pretrain epochs: " + str({k: v["epochs"] for k, v in figures.items()}))
    with open(os.path.join(out, "pretrain.log")) as f:
        text = f.read()
    if "resumed pretraining at epoch 2" not in text:
        raise AssertionError("pretrain.log lacks 'resumed pretraining at epoch 2'")
    args = pretrain_cli.build_parser().parse_args(argv)
    dataset = pretrain_cli.public_dataset(args, torch.device(args.device))
    fc = torch.load(os.path.join(out, "fc.pth"))
    labels = torch.load(os.path.join(out, "preCos_pretrain_labels.pth"))
    state = torch.load(os.path.join(out, pretrain_cli.STATE_FILE), map_location="cpu")
    want_fc = (dataset.num_classes, args.embedding_size)
    if (tuple(fc.shape) != want_fc or len(labels) != len(dataset) or state["epoch"] != 2
            or not torch.isfinite(fc).all()):
        raise AssertionError(f"artefacts: fc {tuple(fc.shape)} (want {want_fc}), "
                             f"{len(labels)} labels of {len(dataset)}, state epoch "
                             f"{state['epoch']}")
    expect = {"max_sim": 0, "roc_hist": 0, "synth_gen": steps}
    log("pretrain", launches=launches, expected=expect, fc_shape=list(fc.shape),
        labels=len(labels), peak_memory_gib=peak)
    if on_card and launches != expect:
        raise AssertionError(f"pretrain launches {launches}, expected {expect}")

    # the training CLI reads the root (its setup only)
    setup_argv = with_flag(setup_argv, "--pretrained_root", out)
    t0 = time.perf_counter()
    t = train_cli.setup(train_cli.build_parser().parse_args(setup_argv))
    setup_s = time.perf_counter() - t0
    with open(os.path.join(t.cfg.runtime.output_dir, "training.log")) as f:
        text = f.read()
    want = ["loaded pretrained backbone from " + os.path.join(out, "backbone.pth"),
            f"loaded pretrain labels ({len(dataset)},)",
            f"loaded pretrained perfect FC ({want_fc[0]}, {want_fc[1]})"]
    missing = [w for w in want if w not in text]
    if missing:
        raise AssertionError(f"the training CLI's setup did not log {missing}")
    log("pretrain", setup_s=f"{setup_s:.2f}", loaded=want)
    del t
    u8, batch_labels = dataset.device_batch(np.arange(args.batch_size))
    norms = {name: feature_norms(args, dataset.num_classes, root, u8)
             for name, root in (("full", out), ("sampled", out + "_sampled"))}
    log("pretrain", feature_norms=json.dumps(norms))
    timed = time_pretrain_steps(args, dataset, u8,
                                torch.from_numpy(batch_labels).to(dataset.device))
    log("pretrain", figures=json.dumps({
        "steps": timed, "feature_norms": norms, "peak_memory_gib": peak,
        "setup_s": setup_s,
        "runs": {k: {f: v[f] for f in ("seconds", "epoch_s", "save_s", "losses")}
                 for k, v in figures.items()}}))
    if on_card:
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 10

IJBC_IMAGES_CUT = 100_000  # of the protocol's 469,375 (~3.8 GB of cache)


def time_pair_scoring(feats: torch.Tensor, ijbc_root: str, on_card: bool) -> dict:
    """The 1:1 scoring loop alone (``ijbc.row_dot_scores``) on the card's
    template matrix of ``feats``, the row indices already there: ms (CUDA
    events, three runs; host clock on the CPU) beside its bound, by bytes:
    the fp32 template matrix read once, two int32 indices and one fp32
    score a pair.  The gathers read 2 x E x 4 bytes a pair, from L2 as far
    as the matrix stays there."""
    meta = os.path.join(ijbc_root, "meta", "IJBC_meta")
    templates, medias = ijbc.read_template_media_list(
        os.path.join(meta, "ijbc_face_tid_mid.txt"))
    p1, p2, _ = ijbc.read_template_pair_list(
        os.path.join(meta, "ijbc_template_pair_label.txt"))
    tf, ut = ijbc.image_to_template_features_device(feats, templates, medias)
    i1, i2 = (torch.from_numpy(i.astype(np.int32)).to(tf.device)
              for i in ijbc.template_rows(ut, p1, p2))
    n, e = len(p1), tf.shape[1]
    tf_bytes = tf.numel() * tf.element_size()
    if on_card:
        ms = cuda_ms(lambda: ijbc.row_dot_scores(tf, i1, i2), 3, "ijbc pair scoring")
    else:
        t0 = time.perf_counter()
        ijbc.row_dot_scores(tf, i1, i2)
        ms = (time.perf_counter() - t0) * 1e3
    out = {"pairs": n, "templates": len(ut), "ms": ms,
           "bound_ms": (tf_bytes + 3 * 4 * n) / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "template_matrix_mb": tf_bytes / 1e6,
           "l2_mb": 50, "gathered_gb": 2 * n * e * 4 / 1e9}
    log("ijbc", pair_scoring=json.dumps(out))
    return out


def _read_scores(result_dir: str) -> np.ndarray:
    return np.load(os.path.join(result_dir, "ijbc-1:1", "ijbc.npy"))


def phase_ijbc(ijbc_root: str, export: str, conti_dir: str, conti_epochs: list,
               network: str = "sphnet", embedding: int = 512, batch: int = 512,
               device: str = "cuda", spec: str = "synth:",
               counts: tuple = (IJBC_SUBJECTS, IJBC_PROBE_TEMPLATES,
                                IJBC_IMAGES_CUT, IJBC_PAIRS)) -> dict:
    """Phase 10: writes the synthetic IJB-C root (``counts``: subjects,
    probe templates, images, pairs), then the IJB-C CLIs in process, launch
    counts set to 0 before the write and read after the last run:
    ``ijbc_all --job both --engine device`` on ``export`` twice (bitwise
    equal scores), the host engine on the same image features through
    ``--load_feature`` (scores within IJBC_HOST_TOL of the device's), and
    ``ijbc_conti --job 1:1`` over ``conti_epochs`` of ``conti_dir`` (the
    cache reused).  Checks the pair and template counts, a 6-entry 1:1
    table, the top1/top5/top10 ranks and finite values."""
    n_subjects, n_probe, n_images, n_pairs = counts
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    write_s = write_synth_ijbc_root(ijbc_root, spec, n_subjects=n_subjects,
                                    n_probe_templates=n_probe, n_images=n_images,
                                    n_pairs=n_pairs, batch=batch, device=device)
    write_s["total_s"] = time.perf_counter() - t0
    log("ijbc", root=ijbc_root, images=n_images, protocol_images=IJBC_IMAGES,
        templates=n_subjects + n_probe,
        pairs=n_pairs, write=write_s)
    base = ["--model-prefix", export, "--root-path", ijbc_root, "--network", network,
            "--embedding_size", str(embedding), "--batch-size", str(batch),
            "--job", "both", "--device", device]
    runs = {}
    for name, extra in (("device", ["--engine", "device"]),
                        ("device_again", ["--engine", "device"])):
        res_dir = os.path.join(ijbc_root, "results_" + name)
        t0 = time.perf_counter()
        runs[name] = ijbc_all.main(ijbc_all.build_parser().parse_args(
            base + extra + ["--result-dir", res_dir]))
        runs[name]["wall_s"] = time.perf_counter() - t0
        runs[name]["scores"] = _read_scores(res_dir)
    # the host engine on the same image features
    model = ijbc_all.load_model(network, embedding, export, False, torch.device(device))
    feats = ijbc.image_features(model, ijbc_root, batch, engine="device", device=device)
    feat_path = os.path.join(ijbc_root, "image_features.npy")
    np.save(feat_path, feats.cpu().numpy())
    scoring = time_pair_scoring(feats, ijbc_root, on_card)
    del model, feats
    res_dir = os.path.join(ijbc_root, "results_host")
    t0 = time.perf_counter()
    runs["host"] = ijbc_all.main(ijbc_all.build_parser().parse_args(
        base + ["--engine", "host", "--load_feature", feat_path, "--result-dir", res_dir]))
    runs["host"]["wall_s"] = time.perf_counter() - t0
    runs["host"]["scores"] = _read_scores(res_dir)
    t0 = time.perf_counter()
    conti = ijbc_conti.main(ijbc_conti.build_parser().parse_args([
        "--ckpt_dir", conti_dir, "--root_path", ijbc_root, "--job", "1:1",
        "--epoch", *[str(e) for e in conti_epochs], "--network", network,
        "--embedding_size", str(embedding), "--batch_size", str(batch),
        "--gpu", "0", "--device", device]))
    conti_s = time.perf_counter() - t0
    launches = read_launches()
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if on_card
            else "not measured")

    templates, _ = ijbc.read_template_media_list(
        os.path.join(ijbc_root, "meta", "IJBC_meta", "ijbc_face_tid_mid.txt"))
    dev_s, again_s, host_s = (runs[k]["scores"] for k in ("device", "device_again", "host"))
    host_err = float(np.abs(dev_s.astype(np.float64) - host_s).max())
    for name, r in runs.items():
        log("ijbc", run=name, wall_s=f"{r['wall_s']:.2f}",
            seconds=json.dumps({k: round(v, 4) for k, v in r["seconds"].items()}),
            tpr_at_fpr=r["tpr_at_fpr"], rank=r["rank"], tpir_at_fpir=r["tpir_at_fpir"])
    log("ijbc", conti_s=f"{conti_s:.2f}", conti_tables=[r["tpr_at_fpr"] for r in conti],
        bitwise_equal=bool(np.array_equal(dev_s, again_s)), host_max_abs_err=host_err,
        host_tol=IJBC_HOST_TOL, launches=launches, peak_memory_gib=peak)
    if len(np.unique(templates)) != n_subjects + n_probe or len(dev_s) != n_pairs:
        raise AssertionError(f"{len(np.unique(templates))} templates, {len(dev_s)} scores")
    if not np.array_equal(dev_s, again_s):
        raise AssertionError("two device runs gave different scores")
    if not host_err <= IJBC_HOST_TOL:
        raise AssertionError(f"device and host scores differ by {host_err}")
    for r in list(runs.values()) + conti:
        table = r["tpr_at_fpr"]
        values = table + list(r.get("rank", {}).values()) + list(
            r.get("tpir_at_fpir", {}).values())
        if len(table) != 6 or not all(math.isfinite(v) for v in values):
            raise AssertionError(f"IJB-C tables {r}")
    for r in runs.values():
        if set(r["rank"]) != {"top1", "top5", "top10"}:
            raise AssertionError(f"rank table {r['rank']}")
    with open(os.path.join(conti_dir, "ijbc-1:1", "log.txt")) as f:
        entries = f.read().count("Epoch ")
    if entries != len(conti_epochs) or not all(np.isfinite(dev_s)):
        raise AssertionError(f"ijbc_conti log has {entries} entries")
    seconds = runs["device"]["seconds"]
    log("ijbc", figures=json.dumps({
        "write": write_s, "images": n_images, "pairs": n_pairs,
        "embed_images_per_s": n_images / seconds["embed"],
        "device": seconds, "host": runs["host"]["seconds"],
        "host_max_abs_err": host_err, "pair_scoring": scoring, "conti_s": conti_s,
        "peak_memory_gib": peak}))
    expect = {"max_sim": 0, "roc_hist": 0, "synth_gen": -(-n_images // batch)}
    if on_card and launches != expect:
        raise AssertionError(f"ijbc launches {launches}, expected {expect}")
    return launches


# ---------------------------------------------------------------- phase 11

LOCKSTEP_RE = re.compile(r"client-parallel training over 1 devices x lockstep (\d+) "
                         r"\((branch|plain) objective\)")
GROUP_RE = re.compile(r"parallel group \[([0-9, ]+)\] epoch (\d+)/(\d+) done")
PARALLEL_LOSS_RE = re.compile(r"round (\d+) \(parallel( plain)?\) avg client loss (\S+)")
# 11d holds the lockstep step to the sequential step, both with the bf16
# trunk.  They differ only in the order of the trunk's sums (the stacked
# convs run as grouped convs, the stacked BN leaves sum in their own
# order), and each carries the bf16 trunk's rounding against the same step
# in fp32, so |lockstep - sequential| <= |lockstep - fp32| + |sequential -
# fp32|.  Allowing the lockstep's rounding twice the sequential one's, the
# bound is LOCKSTEP_TOL_FACTOR x the sequential step's own distance from
# fp32 (measured in the same run), per loss term, over the updated weights
# (one max over every tensor) and over the BN running statistics.  A net
# without a bf16 trunk (the toy net) has no such distance; its bound is
# LOCKSTEP_FP32_TOL.
LOCKSTEP_TOL_FACTOR = 3.0
LOCKSTEP_FP32_TOL = 1e-5


def _set_bf16(nets, on: bool) -> None:
    for net in nets:
        if hasattr(net, "bf16"):
            net.bf16 = on


def step_members(cfg, network: str, k: int, image_size: int, batch: int,
                 num_public: int, device: torch.device, seed: int) -> dict:
    """k seeded members of one lockstep group on ``device``: a batch of
    ``batch`` u8 images each with labels over the local and public classes,
    flips, [local ; global] FC rows, BCE weights and a last-round model of
    their own; one global model, and the work modules of the sequential
    step (``network`` with the bf16 trunk)."""
    E, num_local = cfg.model.embedding_size, 100
    gen = torch.Generator(device=device).manual_seed(seed)

    def net(s, **kw):
        return build_backbone(network, E, image_size=image_size,
                              generator=torch.Generator().manual_seed(s), **kw).to(device)

    bce_kw = dict(converter_layers=cfg.model.converter_layers, m=cfg.loss.bce_margin,
                  r=cfg.loss.bce_scale, t=cfg.loss.bce_t)
    return {
        "work": net(seed), "global": net(seed + 1).eval().requires_grad_(False),
        "last": net(seed + 2).eval().requires_grad_(False),
        "lasts": [net(seed + 3 + i).state_dict() for i in range(k)],
        "bce": BCEModule(E, num_local, **bce_kw).to(device),
        "bces": [BCEModule(E, num_local, generator=torch.Generator().manual_seed(seed + 9 + i),
                           **bce_kw).to(device).state_dict() for i in range(k)],
        "fcs": 0.01 * torch.randn(k, num_local + num_public, E, generator=gen, device=device),
        "imgs": torch.randint(0, 256, (k, batch, image_size, image_size, 3), generator=gen,
                              device=device, dtype=torch.uint8),
        "labels": torch.randint(0, num_local + num_public, (k, batch), generator=gen,
                                device=device),
        "valid": torch.ones(k, batch, dtype=torch.bool, device=device),
        "flips": torch.rand(k, batch, generator=gen, device=device) < 0.5,
        "num_local": num_local,
    }


def sequential_steps(cfg, m: dict, bf16: bool = True) -> list:
    """Each member's sequential branch step from the global model (the
    work modules loaded as ``Client.prepare_local_run`` loads them), with
    the trunk in bf16 or fp32 (the nets are built bf16): its updated
    tensors and its metrics."""
    nets = (m["work"], m["global"], m["last"])
    _set_bf16(nets, bf16)
    step = branch_step_for(cfg, m["num_local"])
    out = []
    for i in range(len(m["lasts"])):
        m["work"].load_state_dict(m["global"].state_dict())
        m["bce"].load_state_dict(m["bces"][i])
        m["last"].load_state_dict(m["lasts"][i])
        state = init_client_state(m["work"], m["fcs"][i], m["bce"], cfg.optim.lr,
                                  cfg.optim.momentum, cfg.optim.weight_decay)
        _, metrics = step(state, m["global"], m["last"], m["imgs"][i], m["labels"][i],
                          m["valid"][i], cfg.optim.lr, m["flips"][i])
        tensors = {f"backbone.{k}": v.detach().clone() for k, v in m["work"].state_dict().items()}
        tensors["fc"] = state.fc.detach().clone()
        tensors.update({f"bce.{k}": v.detach().clone() for k, v in m["bce"].state_dict().items()})
        out.append((tensors, metrics))
    _set_bf16(nets, True)
    return out


def lockstep_group(cfg, m: dict, k: int, remat: bool = False):
    """The stacked state of ``k`` members (member i % len when k exceeds
    them, as a pad slot repeats one), its stacked last-round model and the
    lockstep branch step; ``remat`` checkpoints the stacked blocks."""
    n = len(m["lasts"])
    slots = [i % n for i in range(k)]
    net = client_parallel.stack_module(m["work"], k)
    net.load_state_dict(stack_trees([m["global"].state_dict()] * k))
    for mod in net.modules():
        if hasattr(mod, "remat"):
            mod.remat = remat
    last = client_parallel.stack_module(m["last"], k).eval()
    last.load_state_dict(stack_trees([m["lasts"][i] for i in slots]))
    state = client_parallel.init_group_state(
        net, m["fcs"][slots], stack_trees([m["bces"][i] for i in slots]), cfg.optim.lr,
        cfg.optim.momentum, cfg.optim.weight_decay)
    step = client_parallel.make_parallel_branch_step(
        m["work"], m["bce"], **branch_objective_kwargs(cfg, m["num_local"]))

    def run():
        return step(state, m["global"], last, m["imgs"][slots], m["labels"][slots],
                    m["valid"][slots], cfg.optim.lr, m["flips"][slots])
    return state, run


def compare_lockstep_step(cfg, m: dict, remat: bool, label: str) -> dict:
    """One K=2 lockstep step (``remat`` on its stacked blocks) against the
    two members' sequential steps without it: max abs differences of each
    loss term, of the updated weights (backbone, FC rows, BCE) and of the
    BN running statistics, each against its bound (see
    LOCKSTEP_TOL_FACTOR)."""
    has_bf16 = hasattr(m["work"], "bf16")
    seq = sequential_steps(cfg, m)
    ref = sequential_steps(cfg, m, bf16=False) if has_bf16 else seq
    state, run = lockstep_group(cfg, m, 2, remat=remat)
    _, metrics = run()
    stacked = {f"backbone.{k}": v for k, v in state.backbone.state_dict().items()}
    stacked["fc"] = state.fc.detach()
    stacked.update({f"bce.{k}": v.detach() for k, v in state.bce.items()})

    def gap(a: list, b: list, keep) -> float:
        return max((float((a[i][0][key].double() - b[i][0][key].double()).abs().max())
                    for i in range(2) for key in a[i][0] if keep(key)), default=0.0)

    is_stat = lambda key: "running" in key  # noqa: E731
    is_weight = lambda key: "running" not in key and "num_batches" not in key  # noqa: E731
    lock = [({key: v[i] for key, v in stacked.items()}, None) for i in range(2)]
    out = {"weights": gap(lock, seq, is_weight), "bn_stats": gap(lock, seq, is_stat)}
    bound = {"weights": gap(seq, ref, is_weight), "bn_stats": gap(seq, ref, is_stat)}
    for name in metrics._fields:
        out[name] = max(abs(float(getattr(metrics, name)[i]) - float(getattr(seq[i][1], name)))
                        for i in range(2))
        bound[name] = max(abs(float(getattr(seq[i][1], name)) - float(getattr(ref[i][1], name)))
                          for i in range(2))
    tol = {q: (LOCKSTEP_TOL_FACTOR * b if has_bf16 else LOCKSTEP_FP32_TOL)
           for q, b in bound.items()}
    log("lockstep", step_check=label, remat=remat,
        max_abs_diff=json.dumps(out), bf16_vs_fp32=json.dumps(bound), tol=json.dumps(tol))
    bad = {q: (d, tol[q]) for q, d in out.items() if not d <= tol[q]}
    if bad:
        raise AssertionError(f"{label}: lockstep step differs from the sequential steps "
                             f"beyond the bound: {bad}")
    return {"max_abs_diff": out, "tol": tol}


def time_lockstep_steps(cfg, m: dict, configs, iters: int = 3, batch_calls: int = 3) -> dict:
    """Milliseconds per client-step and peak device memory: the sequential
    step (K = 1) and the lockstep step at each (K, remat) of ``configs``,
    each over a steady window (two warm-up steps, then ``iters`` CUDA-event
    windows of ``batch_calls`` steps back to back) on the card, the wall
    clock on the CPU."""
    on_card = m["imgs"].is_cuda
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}

    def measure(name: str, k: int, fn) -> None:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            fn()
        sync()
        if on_card:
            ms = cuda_ms(fn, iters, f"{name} x {batch_calls}", batch=batch_calls)
        else:
            t0 = time.perf_counter()
            for _ in range(batch_calls):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / batch_calls
        peak = (round(torch.cuda.max_memory_allocated() / 2**30, 3) if on_card
                else "not measured")
        out[name] = {"k": k, "ms_per_step": ms, "ms_per_client_step": ms / k,
                     "client_samples_per_s": k * m["imgs"].shape[1] / ms * 1e3,
                     "peak_memory_gib": peak}
        log("lockstep", timed=name, **out[name])

    step = branch_step_for(cfg, m["num_local"])
    m["work"].load_state_dict(m["global"].state_dict())
    m["bce"].load_state_dict(m["bces"][0])
    m["last"].load_state_dict(m["lasts"][0])
    state = init_client_state(m["work"], m["fcs"][0], m["bce"], cfg.optim.lr,
                              cfg.optim.momentum, cfg.optim.weight_decay)
    measure("sequential_k1", 1, lambda: step(
        state, m["global"], m["last"], m["imgs"][0], m["labels"][0], m["valid"][0],
        cfg.optim.lr, m["flips"][0]))
    del state
    for k, remat in configs:
        state, run = lockstep_group(cfg, m, k, remat=remat)
        measure(f"lockstep_k{k}" + ("_remat" if remat else ""), k, run)
        del state, run
    return out


def time_stacked_convs(k: int, batch: int, shapes, device: torch.device,
                       iters: int = 10) -> dict:
    """One 3x3 conv layer, forward and backward under the bf16 autocast,
    for ``k`` clients at each (channels, size) of ``shapes`` (channels-last
    inputs, as the trunk's): k separate convs (the sequential steps), one
    grouped conv over the k clients' channels (no layout copy), and the
    stacked conv leaf that the lockstep step runs (``stack_module`` of a
    conv: vmap moves the client axis into the channels and back).  Logs
    and returns ms for the k clients' layer, CUDA events on the card."""
    gen = torch.Generator(device=device).manual_seed(5)
    out = {}
    for c, size in shapes:
        w = torch.randn(k, c, c, 3, 3, generator=gen, device=device).requires_grad_(True)

        def inputs(shape):
            return torch.randn(shape, generator=gen, device=device).contiguous(
                memory_format=torch.channels_last).requires_grad_(True)

        xs = [inputs((batch, c, size, size)) for _ in range(k)]
        wide = inputs((batch, k * c, size, size))
        flat = inputs((k * batch, c, size, size))
        leaf = client_parallel.stack_module(torch.nn.Conv2d(c, c, 3, padding=1, bias=False), k)
        leaf.to(device).weight.data.copy_(w.detach())

        def run(fn):
            def body():
                with torch.autocast(device.type, dtype=torch.bfloat16):
                    y = fn()
                y.float().sum().backward()
            return body

        forms = {
            "separate": run(lambda: torch.stack([torch.nn.functional.conv2d(
                xs[i], w[i], padding=1) for i in range(k)])),
            "grouped": run(lambda: torch.nn.functional.conv2d(
                wide, w.flatten(0, 1), padding=1, groups=k)),
            "stacked_leaf": run(lambda: leaf(flat)),
        }
        row = {}
        for name, fn in forms.items():
            for _ in range(2):
                fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
                row[name] = cuda_ms(fn, 3, f"conv {name} c={c} hw={size} k={k}",
                                    batch=iters)
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                row[name] = (time.perf_counter() - t0) * 1e3 / iters
        out[f"c{c}_hw{size}"] = row
        log("lockstep", conv_layer=f"c={c} hw={size} k={k} batch={batch}", ms=json.dumps(row))
    return out


def phase_lockstep(root: str, n_clients: int, ids: int, step_net: str = "sphnet",
                   check_net: str = "iresnet100", step_image: int = 112,
                   step_batch: int = 256, **round_kw) -> dict:
    """Phase 11: the lockstep round through the training CLI (11a
    ``--lockstep 2``, 1 round; 11b with ``--cache_contrastive --remat``,
    1 round; 11c the plain objective, 1 round), each part's launches
    counted over its rounds alone; then 11d, the lockstep step on one
    seeded batch per member: K=2 against two sequential steps (``step_net``,
    and ``check_net`` with ``--remat``, whose BN statistics must match),
    and ms per client-step with peak memory at K = 1, 2, 4 and 4 with
    ``--remat``.  Returns {part: launches} and logs the figures."""
    by_part, figures = {}, {}
    base = round_args(root, n_clients, ids, **round_kw)

    def argv_for(out_name: str, rounds: int, extra: list, drop=()) -> list:
        argv = [a for a in base if a not in drop]
        argv[argv.index("--output_dir") + 1] = os.path.join(root, out_name)
        argv[argv.index("--total_round") + 1] = str(rounds)
        return argv + extra

    def check_lines(text: str, objective: str, rounds: list, epochs: list, groups) -> None:
        lines = LOCKSTEP_RE.findall(text)
        if lines != [("2", objective)]:
            raise AssertionError(f"training.log: lockstep lines {lines}")
        losses = [int(r) for r, _, _ in PARALLEL_LOSS_RE.findall(text)]
        if losses != rounds:
            raise AssertionError(f"training.log: parallel loss lines for rounds {losses}")
        if groups is not None:
            got = [([int(c) for c in g.split(",")], int(e), int(n))
                   for g, e, n in GROUP_RE.findall(text)]
            want = [(g, e, n) for n in epochs for g in groups for e in range(1, n + 1)]
            if got != want:
                raise AssertionError(f"training.log: parallel group lines {got}, "
                                     f"expected {want}")

    groups = [list(range(n_clients))[g:g + 2] for g in range(0, n_clients, 2)]
    before = {}

    def keep_start(run):
        before.update({k: v.detach().clone()
                       for k, v in run.server.global_net.state_dict().items()})

    # 11a: --lockstep 2, 1 round (phase 12c runs two lockstep rounds): one
    # mining launch per real member (the pad slot prepares nothing), the
    # ROC per candidate plus the baselines, the exports and local_log.txt
    run, history, launches, text = drive(argv_for("run_lockstep", 1, ["--lockstep", "2"]),
                                         on_setup=keep_start, tag="lockstep")
    server, out = run.server, run.cfg.runtime.output_dir
    cands = server.local_candidates
    expect_launches(run, launches, {"max_sim": n_clients, "roc_hist": len(cands) * 2},
                    "11a")
    check_lines(text, "branch", [0], [h["local_epochs"] for h in history], groups)
    after = server.global_net.state_dict()
    changed = max(float((after[k].float() - v.float()).abs().max())
                  for k, v in before.items() if v.is_floating_point())
    finite = all(bool(torch.isfinite(v).all()) for v in after.values() if v.is_floating_point())
    if not (finite and changed > 0):
        raise AssertionError(f"11a: global model finite={finite} max change={changed}")
    check_local_logs(out, cands, 1)
    check_exports(out, 1, cands)
    log("lockstep", part="11a", groups=groups, global_max_change=changed)
    by_part["11a"] = launches
    figures["11a"] = {"round_s": [h["seconds"] for h in history],
                      "train_s": [h["train_round_s"] - h["local_eval_s"] for h in history],
                      "losses": [h["losses"] for h in history]}
    del run, server

    # 11b: the cached MOON step and --remat, 1 round
    run, history, launches, text = drive(argv_for(
        "run_lockstep_cached", 1, ["--lockstep", "2", "--cache_contrastive", "--remat"]),
        tag="lockstep")
    remat = [b.remat for b in run.server.backbone.modules() if hasattr(b, "remat")]
    caches = CACHE_RE.findall(text)
    # (the toy net of the CPU rehearsal has no residual blocks to flag)
    if not (run.cfg.model.remat_blocks and all(remat)) or len(caches) != n_clients:
        raise AssertionError(f"11b: remat flags {set(remat)}, {len(caches)} cache builds")
    expect_launches(run, launches, {"max_sim": n_clients,
                                    "roc_hist": len(run.server.local_candidates) * 2}, "11b")
    check_lines(text, "branch", [0], [history[0]["local_epochs"]], groups)
    by_part["11b"] = launches
    figures["11b"] = {"round_s": history[0]["seconds"],
                      "train_s": history[0]["train_round_s"] - history[0]["local_eval_s"]}
    del run

    # 11c: the plain objective (no public data) at run.sh's --batch_size 64
    run, history, launches, text = drive(argv_for(
        "run_lockstep_plain", 1, ["--lockstep", "2", "--batch_size", "64"],
        drop=("--add_pretrained_data",)), tag="lockstep")
    own = [len(run.server.clients[c].dataset) for c in history[0]["clients"]]
    if history[0]["dataset_sizes"] != own or "public features" in text:
        raise AssertionError(f"11c: dataset sizes {history[0]['dataset_sizes']} != {own}")
    expect_launches(run, launches, {"max_sim": 0,
                                    "roc_hist": len(run.server.local_candidates) * 2}, "11c")
    check_lines(text, "plain", [0], [], None)
    by_part["11c"] = launches
    figures["11c"] = {"round_s": history[0]["seconds"]}
    cfg = run.cfg
    device = run.server.device
    del run

    # 11d: the step on one seeded batch per member
    m = step_members(cfg, step_net, 4, step_image, step_batch, 2000, device, seed=11)
    figures["11d"] = {"step_check": compare_lockstep_step(cfg, m, False, step_net)}
    figures["11d"]["timing"] = time_lockstep_steps(
        cfg, m, [(2, False), (4, False), (4, True)])
    del m
    figures["11d"]["conv_layer_ms"] = time_stacked_convs(
        2, step_batch, [(c, step_image >> (i + 1)) for i, c in enumerate((64, 128, 256, 512))],
        device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    m = step_members(cfg, check_net, 2, step_image, step_batch, 2000, device, seed=21)
    figures["11d"]["remat_check"] = compare_lockstep_step(cfg, m, True,
                                                          f"{check_net} remat")
    del m
    log("lockstep", figures=json.dumps(figures))
    return by_part


# ---------------------------------------------------------------- phase 12

MESH_RE = re.compile(r"client-parallel training over (\d+) devices x lockstep (\d+) "
                     r"\((branch|plain) objective\)")
# 12b and 12c hold the mesh's results to the one-device ones with the bf16
# trunk.  Only the order of the trunk's sums differs between them (a batch
# split into blocks, a stacked step of another width), and each carries
# the bf16 trunk's rounding against the same computation in fp32, so as in
# phase 11d the bound is MESH_TOL_FACTOR x the one-device run's own
# distance from fp32, measured in the same run (12b: the features of the
# first images; 12c: every client's loss and the aggregate after the two
# rounds).  A net without a bf16 trunk (the toy net) is held to
# MESH_FP32_TOL.
MESH_TOL_FACTOR = 3.0
MESH_FP32_TOL = 1e-5
BUSY_SPEC = "synth:public_imgs=61440"


def mesh_devices(device: str = "cuda") -> list:
    """Phase 12's devices: every GPU when the machine has more than one,
    else two shards of the one device (``cuda:0`` or the CPU)."""
    if device == "cuda" and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    return [dev, dev]


def wall_ms(fn, devices: list, iters: int = 3) -> float:
    """Median host-clock ms of ``fn()``, each run ending with every device
    synchronized (a span over several cards)."""
    times = []
    for _ in range(iters):
        mesh_mod.synchronize(devices)
        t = time.perf_counter()
        fn()
        mesh_mod.synchronize(devices)
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def mesh_roc(devices: list, n: int, t: int, e: int) -> dict:
    """12a: the ROC at t x n x e over the data mesh against the one-shard
    kernel's histogram of the same input, bit for bit (spread unit rows:
    not dyadic, no tolerance); ms per shard (its copy included), for the
    sharded whole and for one shard of everything; launches per device."""
    home = devices[0]
    gen = torch.Generator(device=home).manual_seed(16)
    feats = torch.randn(n, e, device=home, generator=gen)
    feats = (feats / feats.norm(dim=1, keepdim=True)).contiguous()
    labels = (torch.arange(n, device=home, dtype=torch.int32) // 40).contiguous()
    m = mesh_mod.data_mesh(devices=devices)
    saved = (roc_hist_mod.roc_hist_launches, dict(roc_hist_mod.roc_hist_launches_by_device))
    roc_hist_mod.roc_hist_launches_by_device.clear()
    whole = roc_hist_mod.roc_histogram(feats, labels, t)
    roc_hist_mod.roc_hist_launches_by_device.clear()
    sharded = roc_histogram_mod.pairwise_roc_histogram_sharded(m, feats, labels, t)
    mesh_mod.synchronize(devices)
    by_device = dict(roc_hist_mod.roc_hist_launches_by_device)
    if not torch.equal(sharded, whole):
        raise AssertionError(f"12a: sharded ROC differs from the one-shard histogram in "
                             f"{int((sharded != whole).sum())} bins")
    step = -(-n // len(devices))
    shard_ms = []
    for d, dev in enumerate(devices):
        args = (feats[:t].to(dev), labels[:t].to(dev),
                feats[d * step:(d + 1) * step].to(dev), labels[d * step:(d + 1) * step].to(dev),
                d * step)
        shard_ms.append(wall_ms(lambda: roc_hist_mod.roc_histogram_range(*args), [dev]))
    whole_ms = wall_ms(lambda: roc_hist_mod.roc_histogram(feats, labels, t), [home])
    sharded_ms = wall_ms(lambda: roc_histogram_mod.pairwise_roc_histogram_sharded(
        m, feats, labels, t), devices)
    roc_hist_mod.roc_hist_launches = saved[0]
    roc_hist_mod.roc_hist_launches_by_device.clear()
    roc_hist_mod.roc_hist_launches_by_device.update(saved[1])
    out = {"shape": f"{t}x{n}x{e}", "bitwise_equal": True, "pairs": int(whole.sum()),
           "launches_by_device": by_device, "shard_ms": shard_ms,
           "sharded_ms": sharded_ms, "one_shard_ms": whole_ms}
    log("mesh", part="12a", **out)
    return out


def mesh_embed(devices: list, spec: str, batch: int, network: str, embedding: int,
               image_size: int, sample: int) -> dict:
    """12b: the data-axis embed of a ``synth:`` public set at ``batch``
    against the one-device embed of the same net (seeded random weights):
    images/s of each (host clock, every device synchronized; in turns one,
    mesh, mesh, one), the largest difference per row of the l2-normalized
    features, and its bound (MESH_TOL_FACTOR x the one-device bf16 trunk's
    distance from fp32 over the first ``sample`` images)."""
    home = devices[0]
    public = synthetic.build_fl_synthetic(synthetic.parse_synth_spec(spec), home)["public"]
    net = build_backbone(network, embedding, image_size=image_size,
                         generator=torch.Generator().manual_seed(100)).to(home).eval()
    layouts = {"one": mesh_mod.data_mesh(devices=[home]),
               "mesh": mesh_mod.data_mesh(devices=devices)}
    feats, secs = {}, {"one": [], "mesh": []}
    for name in ("one", "mesh", "mesh", "one"):
        mesh_mod.synchronize(devices)
        t0 = time.perf_counter()
        feats[name], _ = embed_mod.embed_dataset(net, public, batch, device=home,
                                                 mesh=layouts[name])
        mesh_mod.synchronize(devices)
        secs[name].append(time.perf_counter() - t0)
    diff = float((feats["mesh"] - feats["one"]).abs().amax(1).max())
    del feats
    sub = public.subset(np.arange(1, sample + 1))
    ref = []
    for bf16 in (True, False):
        _set_bf16([net], bf16)
        ref.append(embed_mod.embed_dataset(net, sub, batch, device=home,
                                           mesh=layouts["one"])[0])
    _set_bf16([net], True)
    own = float((ref[0] - ref[1]).abs().amax(1).max())
    tol = MESH_TOL_FACTOR * own if hasattr(net, "bf16") else MESH_FP32_TOL
    n = len(public)
    out = {"images": n, "batch": batch,
           "images_per_s": {k: n / min(v) for k, v in secs.items()},
           "seconds": secs, "max_row_diff": diff, "bf16_vs_fp32": own, "tol": tol}
    log("mesh", part="12b", **out)
    if not diff <= tol:
        raise AssertionError(f"12b: sharded embed differs from one device by {diff} > {tol}")
    return out


def card_busy(fn, devices: list) -> dict:
    """Runs ``fn()`` once under ``torch.profiler`` (host and device
    activity) and returns the window's wall seconds (every device
    synchronized at its end) and, for each card among ``devices``, the
    share of the window it was busy: the union of its kernel, copy and
    memset intervals over all its streams."""
    cards = list(dict.fromkeys(d.index for d in devices if d.type == "cuda"))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cards:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    mesh_mod.synchronize(devices)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        mesh_mod.synchronize(devices)
        wall = time.perf_counter() - t0
    if not cards:
        return {"wall_s": wall, "busy_share": "not measured (no card)"}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, TRACE_FILE)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = {c: [] for c in cards}
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            dev = e.get("args", {}).get("device", e.get("pid"))
            if dev in spans:
                spans[dev].append((e["ts"], e["ts"] + e.get("dur", 0.0)))
    share = {}
    for dev, intervals in spans.items():
        busy, end = 0.0, -math.inf
        for a, b in sorted(intervals):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        share[f"cuda:{dev}"] = busy / 1e6 / wall
    return {"wall_s": wall, "busy_share": share}


def mesh_busy(devices: list, spec: str, images: int, steps: int, **round_kw) -> dict:
    """12g: each card's busy share (``card_busy``) while one process drives
    the mesh: one data-axis embed pass over the first ``images`` of the
    ``synth:`` public set (beside the same pass on one device), and
    ``steps`` dispatches of the mesh round's training (on every slot's
    card in turn, one stacked step of one seeded member at the round's
    batch, as the round issues them; beside one device's K-member step);
    ms per client-step of both."""
    home = devices[0]
    network = round_kw.get("network", "sphnet")
    embedding = round_kw.get("embedding", 512)
    image_size = round_kw.get("image_size", 112)
    batch = round_kw.get("batch", 256)
    public = synthetic.build_fl_synthetic(synthetic.parse_synth_spec(spec), home)["public"]
    public = public.subset(np.arange(1, images + 1))
    net = build_backbone(network, embedding, image_size=image_size,
                         generator=torch.Generator().manual_seed(100)).to(home).eval()
    out = {"embed": {}, "step": {}}
    for name, devs in (("mesh", devices), ("one", [home])):
        m = mesh_mod.data_mesh(devices=devs)
        embed_mod.embed_dataset(net, public, round_kw.get("eval_batch", 512), device=home,
                                mesh=m)  # the replicas made, the kernels warm
        out["embed"][name] = card_busy(lambda: embed_mod.embed_dataset(
            net, public, round_kw.get("eval_batch", 512), device=home, mesh=m), devices)
        out["embed"][name]["images_per_s"] = images / out["embed"][name]["wall_s"]
    del net
    cfg = train_cli.build_config(train_cli.build_parser().parse_args(
        round_args("", 2, 100, **round_kw)))
    for name, slots, k in (("mesh", devices, 1), ("one", [home], len(devices))):
        runs = []
        for d, dev in enumerate(slots):
            m = step_members(cfg, network, k, image_size, batch, 64, dev, seed=31 + d)
            runs.append(lockstep_group(cfg, m, k)[1])
        for _ in range(2):  # warm-up
            for run in runs:
                run()

        def dispatch():
            for _ in range(steps):
                for run in runs:
                    run()
        out["step"][name] = card_busy(dispatch, devices)
        out["step"][name]["ms_per_client_step"] = (out["step"][name]["wall_s"] * 1e3
                                                   / (steps * len(devices)))
        del runs
    if home.type == "cuda":
        torch.cuda.empty_cache()
    log("mesh", part="12g", **{k: json.dumps(v) for k, v in out.items()})
    return out


def _client_steps(history: list, k: int, batch: int) -> int:
    """Client-steps the lockstep rounds of ``history`` ran (pad slots
    included): per group of ``k`` sampled clients, k x the round's local
    epochs x its longest member's batches an epoch."""
    steps = 0
    for rec in history:
        sizes = rec["dataset_sizes"]
        for g in range(0, len(sizes), k):
            steps += k * rec["local_epochs"] * max(x // batch for x in sizes[g:g + k])
    return steps


def phase_mesh(root: str, devices: list, ids: int, pub_ids: int = 64,
               roc_shape=(160_000, 4_000, 512), embed_spec: str = BUSY_SPEC,
               embed_sample: int = 4096, busy_images: int = 6_144, **round_kw) -> dict:
    """Phase 12: the round on every device of ``devices`` (``[d, d]`` is two
    shards of one device): 12f each kernel launched on the last device
    leaves the current device as it was; 12a the sharded ROC; 12b the
    data-axis embed; 12g each card's busy share while one process drives
    them (an embed pass, the round's training dispatches); 12c run.sh's round over the mesh through the CLI
    (devices + 1 clients, 2 rounds), then on one device at
    ``--lockstep`` = devices, in bf16 and in fp32; 12d one round each of
    ``--cache_contrastive`` and the plain objective over the mesh; 12e ms
    per client-step and each device's peak memory.  Returns {part:
    launches} of the rounds."""
    nd, home = len(devices), devices[0]
    on_card = home.type == "cuda"
    log("mesh", mesh_devices=[str(d) for d in devices],
        cards=len(dict.fromkeys(devices)))
    by_part, figures = {}, {}

    # 12f: the launchers give the caller its current device back
    if on_card:
        saved = read_launches()
        last = devices[-1]
        current = torch.cuda.current_device()
        gen = torch.Generator(device=last).manual_seed(3)
        x = torch.randn(300, 512, device=last, generator=gen)
        x = x / x.norm(dim=1, keepdim=True)
        checks = {"max_sim": lambda: max_sim_mod.max_cosine_similarity(x, x[:70].contiguous()),
                  "roc_hist": lambda: roc_hist_mod.roc_histogram(
                      x, torch.zeros(300, dtype=torch.int32, device=last), 50),
                  "synth_gen": lambda: synth_gen_mod.synth_generate(
                      *[v.to(last) for v in _synth_vectors(synthetic.build_fl_synthetic(
                          synthetic.parse_synth_spec("synth:"), "cpu"), 8, 5)],
                      prng_key(100), 112, 18, 4, 0.0, 8)}
        after = {}
        for name, fn in checks.items():
            fn()
            after[name] = torch.cuda.current_device()
        torch.cuda.synchronize(last)
        for name, (mod, attr) in KERNEL_COUNTERS.items():
            setattr(mod, attr, saved[name])
        log("mesh", part="12f", launched_on=str(last), current_before=current,
            current_after=json.dumps(after))
        if set(after.values()) != {current}:
            raise AssertionError(f"12f: a launch on {last} moved the current device "
                                 f"from {current}: {after}")

    n, t, e = roc_shape
    figures["12a"] = mesh_roc(devices, n, t, e)
    figures["12b"] = mesh_embed(devices, embed_spec, round_kw.get("eval_batch", 512),
                                round_kw.get("network", "sphnet"),
                                round_kw.get("embedding", 512),
                                round_kw.get("image_size", 112), embed_sample)
    figures["12g"] = mesh_busy(devices, embed_spec, busy_images, 4, **round_kw)

    # 12c: run.sh's round over the mesh, then on one device, in bf16 and fp32
    n_clients = nd + 1
    write_fl_split(root, n_clients=n_clients, ids=ids, imgs_per_id=8, pub_ids=pub_ids,
                   pub_imgs=2, size=round_kw.get("image_size", 112), seed=0, veri_imgs=4)
    write_bin(os.path.join(root, "val", "agedb_30.bin"), n_pairs=1200,
              size=round_kw.get("image_size", 112), seed=1)
    # every public image mined (HN_threshold -1) in 12c: two bf16 sum
    # orders can put a score near 0.4 on either side of it, and a client's
    # mined set, its batches and so its losses would then differ for a
    # reason other than the mesh
    base = round_args(root, n_clients, ids, **round_kw)
    base[base.index("--HN_threshold") + 1] = "-1"
    batch = int(base[base.index("--com_batch_size") + 1])

    def argv_for(out_name: str, rounds: int, extra: list, drop=()) -> list:
        argv = [a for a in base if a not in drop]
        argv[argv.index("--output_dir") + 1] = os.path.join(root, out_name)
        argv[argv.index("--total_round") + 1] = str(rounds)
        return argv + extra

    def mesh_line(text: str, objective: str) -> None:
        lines = MESH_RE.findall(text)
        if lines != [(str(nd), "1", objective)]:
            raise AssertionError(f"training.log: client-parallel lines {lines}")

    def roc_by_device(expected_total: int) -> dict:
        got = dict(roc_hist_mod.roc_hist_launches_by_device)
        want = {}
        for dev in devices:
            want[dev.index] = want.get(dev.index, 0) + expected_total // nd
        if on_card and got != want:
            raise AssertionError(f"ROC launches by device {got}, expected {want}")
        return got

    # every card of the machine: the CLI's own default device list
    mesh_arg = None if devices == mesh_mod.visible_devices(home.type) else devices
    runs = {}
    for name, devs, extra, fp32 in (("mesh", mesh_arg, [], False),
                                    ("one", [home], ["--lockstep", str(nd)], False),
                                    ("one_fp32", [home], ["--lockstep", str(nd)], True)):
        def on_setup(run, fp32=fp32):
            if fp32:
                s = run.server
                _set_bf16([s.global_net, s.backbone, s.last_net], False)
        torch.manual_seed(100)  # the toy net (the CPU rehearsal's) draws from it
        for dev in dict.fromkeys(devices) if on_card else ():
            torch.cuda.reset_peak_memory_stats(dev)  # the memory line's peak: this run's
        run, history, launches, text = drive(argv_for(f"run_mesh_{name}", 2, extra),
                                             on_setup=on_setup, tag="mesh", devices=devs)
        cands = run.server.local_candidates
        width = nd if name == "mesh" else 1
        expect_launches(run, launches, {"max_sim": n_clients * 2,
                                        "roc_hist": len(cands) * 3 * width}, f"12c {name}")
        runs[name] = {"history": history, "state": {
            k: v.detach().double() for k, v in run.server.global_net.state_dict().items()
            if v.is_floating_point()}}
        if name == "mesh":
            mesh_line(text, "branch")
            by_device = roc_by_device(len(cands) * 3 * nd)
            out = run.cfg.runtime.output_dir
            check_local_logs(out, cands, 2)
            check_exports(out, 2, cands)
            check_round_log(out, 2)
            cards = {str(d) for d in devices}
            if on_card and set(history[-1]["memory"]["devices"]) != cards:
                raise AssertionError(f"memory line cards {history[-1]['memory']}, "
                                     f"expected {sorted(cards)}")
            by_part["12c"] = launches
            figures["12c"] = {"roc_launches_by_device": by_device,
                              "memory": history[-1]["memory"]}
        runs[name]["local_train_s"] = history[-1]["spans"]["phase/local_train"]
        runs[name]["round_s"] = [h["seconds"] for h in history]
        del run

    def distance(a: str, b: str) -> dict:
        la = [x for h in runs[a]["history"] for x in h["losses"]]
        lb = [x for h in runs[b]["history"] for x in h["losses"]]
        sa, sb = runs[a]["state"], runs[b]["state"]
        return {"losses": max(abs(x - y) for x, y in zip(la, lb)),
                "aggregate": max(float((sa[k] - sb[k]).abs().max()) for k in sa)}

    got, own = distance("mesh", "one"), distance("one", "one_fp32")
    bf16_trunk = round_kw.get("network", "sphnet") != "toy"
    tol = {q: MESH_TOL_FACTOR * v if bf16_trunk else MESH_FP32_TOL for q, v in own.items()}
    log("mesh", part="12c", clients=n_clients, max_abs_diff=json.dumps(got),
        bf16_vs_fp32=json.dumps(own), tol=json.dumps(tol),
        round_s=json.dumps({k: v["round_s"] for k, v in runs.items()}))
    bad = {q: (d, tol[q]) for q, d in got.items() if not d <= tol[q]}
    if bad:
        raise AssertionError(f"12c: the mesh round differs from the one-device round "
                             f"beyond the bound: {bad}")
    figures["12c"].update({"max_abs_diff": got, "bf16_vs_fp32": own, "tol": tol})

    # 12e: ms per client-step (pad slots included) and each device's peak
    figures["12e"] = {}
    for name in ("mesh", "one"):
        steps = _client_steps(runs[name]["history"], nd, batch)
        figures["12e"][name] = {
            "client_steps": steps,
            "ms_per_client_step": runs[name]["local_train_s"] * 1e3 / max(steps, 1),
            "round_s": runs[name]["round_s"],
            "peak_mb": runs[name]["history"][-1]["memory"].get("devices")}
        log("mesh", part="12e", run=name, **figures["12e"][name])

    # 12d: the cached MOON step and the plain objective over the mesh
    run, history, launches, text = drive(argv_for("run_mesh_cached", 1,
                                                  ["--cache_contrastive"]),
                                         tag="mesh", devices=mesh_arg)
    cands = run.server.local_candidates
    if len(CACHE_RE.findall(text)) != n_clients:
        raise AssertionError(f"12d: {len(CACHE_RE.findall(text))} cache builds")
    mesh_line(text, "branch")
    expect_launches(run, launches, {"max_sim": n_clients,
                                    "roc_hist": len(cands) * 2 * nd}, "12d cached")
    roc_by_device(len(cands) * 2 * nd)
    by_part["12d_cached"] = launches
    del run
    run, history, launches, text = drive(argv_for(
        "run_mesh_plain", 1, ["--batch_size", "64"], drop=("--add_pretrained_data",)),
        tag="mesh", devices=mesh_arg)
    cands = run.server.local_candidates
    mesh_line(text, "plain")
    expect_launches(run, launches, {"max_sim": 0, "roc_hist": len(cands) * 2 * nd},
                    "12d plain")
    roc_by_device(len(cands) * 2 * nd)
    by_part["12d_plain"] = launches
    del run
    if on_card:
        torch.cuda.empty_cache()
    log("mesh", figures=json.dumps(figures, default=str))
    return by_part


# ---------------------------------------------------------------- phase 13

# 12 steps of 512 over every one of the 6,000 public IDs (~1 image an ID):
# the sampled run and the one-card comparison's first steps
SHORT_PRETRAIN_SPEC = "synth:public_imgs=6144"
# 13a: the sharded losses against the one-shard forms, in fp32 (TF32 off)
PFC_REL_TOL = 1e-5


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b| (fp64)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def sampled_union_loss(key, feats: torch.Tensor, labels: torch.Tensor,
                       weight: torch.Tensor, shards: int, num_sample: int,
                       num_valid: int, s: float, m: float) -> torch.Tensor:
    """The W-shard sampled Partial FC written as one softmax on one
    device (13a's reference): the columns are every shard's sampled rows
    (``partial_fc.shard_sample``), a padded row among them a constant 1.0
    row masked out, a row's target the column of its class if its shard
    sampled it (else the row leaves the mean)."""
    c_local = weight.shape[0] // shards
    labels = labels.long()
    cols = torch.cat([d * c_local + partial_fc.shard_sample(key, labels, d, c_local,
                                                            num_sample, num_valid)
                      for d in range(shards)])
    ok = cols < num_valid
    w_sub = torch.where(ok[:, None], weight[cols], 1.0)
    match = cols[None, :] == labels[:, None]
    has = match.any(dim=1)
    target = torch.where(has, match.float().argmax(dim=1), -1)
    cosine = l2_normalize(feats.float(), dim=1) @ l2_normalize(w_sub, dim=1).T
    logits = torch.where(ok[None, :], MARGINS["CosFace"](cosine, target, s, m),
                         float("-inf"))
    valid = (labels >= 0) & has
    per_row = torch.logsumexp(logits, dim=1) - logits.gather(
        1, target.clamp_min(0)[:, None])[:, 0]
    return torch.where(valid, per_row, 0.0).sum() / valid.sum().clamp_min(1)


def check_sharded_losses(devices: list, batch: int, embedding: int, classes: int,
                         rate: float, s: float = 64.0, m: float = 0.4) -> dict:
    """13a: the full-softmax and sampled Partial FC over ``devices``'
    shards at batch x embedding x classes (a padded FC where the shard
    count does not divide ``classes``) against one device: the full
    softmax against the one-shard function, the sampled loss against
    ``sampled_union_loss``; loss, feature and weight gradients within
    PFC_REL_TOL (relative to the reference's largest entry), the padded
    rows' gradient zero."""
    home, w_count = devices[0], len(devices)
    gen = torch.Generator(device=home).manual_seed(classes)
    feats = torch.randn(batch, embedding, device=home, generator=gen)
    labels = torch.randint(0, classes, (batch,), device=home, generator=gen,
                           dtype=torch.int32)
    labels[3] = -1
    weight = torch.randn(classes, embedding, device=home, generator=gen)
    padded, _ = partial_fc.pad_classes(weight, w_count)
    c_local = padded.shape[0] // w_count
    num_sample = partial_fc.num_sampled(rate, padded.shape[0], w_count)
    key = prng_key(13)
    out = {"classes": classes, "padded_rows": padded.shape[0], "shards": w_count,
           "num_sample": num_sample}

    def grads(fn, w, *parts):
        f = feats.clone().requires_grad_(True)
        wl = w.clone().requires_grad_(True)
        loss = fn(f, wl, *parts)
        loss.backward()
        return loss.detach(), f.grad, wl.grad

    def sharded(fn):
        def run(f, w):
            fs = [x.to(dev) for x, dev in zip(f.chunk(w_count), devices)]
            ws = [x.to(dev) for x, dev in zip(w.chunk(w_count), devices)]
            ls = [x.to(dev) for x, dev in zip(labels.chunk(w_count), devices)]
            return fn(fs, ls, ws)
        return run

    forms = {
        "full": (sharded(lambda fs, ls, ws: partial_fc.sharded_partial_fc_loss(
                     fs, ls, ws, "CosFace", s, m, num_valid=classes)),
                 lambda f, w: partial_fc.partial_fc_loss(f, labels, w[:classes],
                                                         "CosFace", s, m)),
        "sampled": (sharded(lambda fs, ls, ws: partial_fc.sharded_sampled_partial_fc_loss(
                        key, fs, ls, ws, num_sample, "CosFace", s, m, num_valid=classes)),
                    lambda f, w: sampled_union_loss(key, f, labels, w, w_count,
                                                    num_sample, classes, s, m))}
    for name, (fn, ref_fn) in forms.items():
        got, ref = grads(fn, padded), grads(ref_fn, padded)
        errs = {"loss": rel_err(got[0], ref[0]), "feature_grad": rel_err(got[1], ref[1]),
                "weight_grad": rel_err(got[2][:classes], ref[2][:classes])}
        pad_grad = float(got[2][classes:].abs().max()) if padded.shape[0] > classes else 0.0
        out[name] = {"loss": float(got[0]), "rel_err": errs, "pad_rows_grad": pad_grad}
        if not (max(errs.values()) <= PFC_REL_TOL and pad_grad == 0.0
                and all(torch.isfinite(t).all() for t in got)):
            raise AssertionError(f"13a {name} at {classes} classes over {w_count} shards: "
                                 f"relative errors {errs}, padded rows' gradient {pad_grad}")
    log("pretrain_mesh", part="13a", **{k: json.dumps(v) for k, v in out.items()})
    return out


# 13d: BN_STEPS steps from the CLI's initial weights.  The bf16 runs are
# compared after the first step, before they drift apart (at the CLI's lr
# 0.05 the losses of three runs from one start are ~10 apart after 12
# steps).  The float64 runs are compared after the last at BN_F64_TOL
# (they agree within 1e-14 on the card), at BN_F64_BATCH images a step.
BN_STEPS = 2
BN_F64_BATCH = 64
BN_F64_TOL = 1e-10


@contextlib.contextmanager
def float64_steps():
    """Every float the pretraining step makes in float64 inside (13d's
    exact check): the default dtype, and ``Tensor.float`` (the port's casts
    at the input, in iresnet and in the losses) made ``Tensor.double``."""
    cast = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(torch.float32)
        torch.Tensor.float = cast


def float_state(module: torch.nn.Module) -> dict:
    """``module``'s floating state (every parameter and BN running
    statistic), fp64 on the host."""
    return {k: v.detach().double().cpu() for k, v in module.state_dict().items()
            if v.is_floating_point()}


def bn_steps(args, num_classes: int, devices: list, batches: list,
             whole_batch: bool = True, f64: bool = False) -> dict:
    """``batches`` [(u8, labels)] through the pretraining CLI's full-softmax
    step (its ``training_state`` and ``make_train_step``) from its initial
    weights over ``devices``; ``whole_batch=False`` is 13d's control, the
    data-parallel backbone with each shard's BN over its own rows; ``f64``
    casts the state and runs the steps under ``float64_steps``.  Each
    step's loss, the backbone's ``float_state`` after the first step and
    after the last, its BN layers' names, and whether every replica equals
    shard 0's bit for bit."""
    t0 = time.perf_counter()
    state = pretrain_cli.training_state(args, num_classes, devices)
    if not whole_batch:
        state.backbone.sync_bn = False
    if f64:
        for replica in state.backbone.replicas:
            replica.double()
        for w in state.weights:
            w.data = w.data.double()
    step = pretrain_cli.make_train_step(args, state.num_valid, None)
    key = prng_key(args.seed)
    module = state.backbone.module
    losses, first = [], None
    with float64_steps() if f64 else contextlib.nullcontext():
        for i, (u8, labels) in enumerate(batches):
            losses.append(float(step(state, u8, labels, args.lr,
                                     pretrain_cli.step_key(key, 0, i))))
            first = first or float_state(module)
    out = {"losses": losses, "shards": len(state.devices), "first": first,
           "last": float_state(module),
           "bn_layers": [n for n, m in module.named_modules()
                         if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)],
           "replicas_bitwise_equal": state.backbone.replicas_equal()}
    mesh_mod.synchronize(devices)
    out["seconds"] = time.perf_counter() - t0
    del state, module
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    return out


def bn_report(got: dict, one: dict, fp32: dict) -> dict:
    """13d's bound on a bf16 run ``got`` against the one-device run in bf16
    (``one``) and with the trunk in fp32 (``fp32``), each ``bn_steps``'s:
    after the first step every BN layer's running mean and running
    variance (the forward's batch statistics) and every parameter (the
    backward's step) within MESH_TOL_FACTOR x that tensor's own
    bf16-vs-fp32 distance, distances as norms of the differences.  The
    first losses' distances are reported beside: each is one draw of the
    runs' rounding noise, and a ratio of two such draws exceeds 3 about a
    fifth of the time however right the runs are.  The tensor nearest its
    bound of each kind, the tensors beyond it, and ``ok``."""
    loss = {"max_abs_diff": abs(got["losses"][0] - one["losses"][0]),
            "bf16_vs_fp32": abs(one["losses"][0] - fp32["losses"][0])}
    beyond, nearest = {"running": [], "parameters": []}, {}
    for name, ref in one["first"].items():
        d = float((got["first"][name] - ref).norm())
        o = float((ref - fp32["first"][name]).norm())
        ratio = d / o if o > 0 else (math.inf if d > 0 else 0.0)
        kind = "running" if ".running_" in name else "parameters"
        if kind not in nearest or ratio > nearest[kind]["ratio"]:
            nearest[kind] = {"tensor": name, "norm_diff": d, "bf16_vs_fp32": o,
                             "ratio": ratio}
        if not d <= MESH_TOL_FACTOR * o:
            beyond[kind].append(name)
    return {"loss": loss, "tensors": len(one["first"]), "nearest": nearest,
            "beyond": {k: len(v) for k, v in beyond.items()},
            "beyond_first": [n for v in beyond.values() for n in v][:3],
            "ok": not any(beyond.values())}


def bn_f64_report(got: dict, one: dict) -> dict:
    """13d's exact bound on a float64 run ``got`` against one device's:
    every step's loss within BN_F64_TOL relative, and after the last step
    every BN layer's running means and variances (the later forwards' batch
    statistics, so also the backward's steps) within BN_F64_TOL of one
    device's in units of its running variance: each channel's mean
    difference over its standard deviation and its variance difference
    over its variance (a running mean can be ~0: a BN's input with
    zero-mean parts).  The largest of each, the layers beyond, and
    ``ok``."""
    losses = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], one["losses"]))
    err = {}
    for k in one["last"]:
        if k.endswith(".running_mean"):
            layer = k[:-len(".running_mean")]
            var = one["last"][layer + ".running_var"]
            d_mean = got["last"][k] - one["last"][k]
            d_var = got["last"][layer + ".running_var"] - var
            err[layer] = max(float((d_mean.abs() / var.sqrt()).max()),
                             float((d_var.abs() / var).max()))
    worst = max(err, key=err.get)
    beyond = [k for k, v in err.items() if not v <= BN_F64_TOL]
    return {"losses_rel": losses, "bn_layers": len(err),
            "worst": {"layer": worst, "err": err[worst]}, "beyond": len(beyond),
            "ok": losses <= BN_F64_TOL and not beyond}


def pretrain_bn_mesh(devices: list, argv: list, spec: str, network: str,
                     iters: int) -> tuple:
    """13d: BN over the whole batch.  ``network`` (a net with BatchNorm) at
    ``argv``'s widths: BN_STEPS full-softmax steps of the pretraining CLI
    (``bn_steps``) on the first batches of ``spec``, launch counts set to 0
    before the runs and read after (one synth_gen launch a batch).  At
    ``argv``'s batch, over the mesh, on one device, on one device with the
    trunk in fp32, and over the mesh with BN over each shard (the control):
    the mesh within ``bn_report``'s bound, the control beyond it.  At
    BN_F64_BATCH in float64, over the mesh, on one device and as the
    control: the mesh within ``bn_f64_report``'s bound, the control beyond
    it.  The replicas bit for bit shard 0's after every run.  Then the
    full-softmax step at ``argv``'s batch over the mesh and on one device:
    ms and samples/s (``iters`` steps a run), each card's peak memory and
    busy share over 2 steps.  Returns (figures, launches)."""
    home = devices[0]
    on_card = home.type == "cuda"
    base = with_flag(with_flag(argv, "--data_dir", spec), "--network", network)
    parse = pretrain_cli.build_parser().parse_args
    args, args_fp32 = parse(base), parse(base + ["--fp32"])
    b = args.batch_size
    zero_launches()
    dataset = pretrain_cli.public_dataset(args, home)
    batches = []
    for i in range(BN_STEPS):
        u8, labels = dataset.device_batch(np.arange(i * b, (i + 1) * b))
        batches.append((u8, torch.from_numpy(labels).to(home)))
    small = [(u8[:BN_F64_BATCH], labels[:BN_F64_BATCH]) for u8, labels in batches]
    recs = {}
    for name, run_args, devs, whole, f64 in (
            ("mesh", args, devices, True, False), ("one", args, [home], True, False),
            ("one_fp32", args_fp32, [home], True, False),
            ("control", args, devices, False, False),
            ("mesh_f64", args_fp32, devices, True, True),
            ("one_f64", args_fp32, [home], True, True),
            ("control_f64", args_fp32, devices, False, True)):
        recs[name] = rec = bn_steps(run_args, dataset.num_classes, devs,
                                    small if f64 else batches, whole, f64)
        log("pretrain_mesh", part="13d", run=name, network=network,
            batch=BN_F64_BATCH if f64 else b, seconds=f"{rec['seconds']:.2f}",
            shards=rec["shards"], bn_layers=len(rec["bn_layers"]),
            replicas_bitwise_equal=rec["replicas_bitwise_equal"], losses=rec["losses"])
        if (not all(math.isfinite(v) for v in rec["losses"]) or not rec["bn_layers"]
                or rec["shards"] != len(devs) or not rec["replicas_bitwise_equal"]):
            raise AssertionError(f"13d {name}: shards {rec['shards']}, losses "
                                 f"{rec['losses']}, replicas equal "
                                 f"{rec['replicas_bitwise_equal']}, "
                                 f"{len(rec['bn_layers'])} BN layers")
    launches = read_launches()
    expect = {"max_sim": 0, "roc_hist": 0, "synth_gen": BN_STEPS}
    if on_card and launches != expect:
        raise AssertionError(f"13d launches {launches}, expected {expect}")

    reports = {"mesh": bn_report(recs["mesh"], recs["one"], recs["one_fp32"]),
               "control": bn_report(recs["control"], recs["one"], recs["one_fp32"]),
               "mesh_f64": bn_f64_report(recs["mesh_f64"], recs["one_f64"]),
               "control_f64": bn_f64_report(recs["control_f64"], recs["one_f64"])}
    figures = {"network": network, "batch": b, "f64_batch": BN_F64_BATCH, "steps": BN_STEPS,
               "bn_layers": len(recs["one"]["bn_layers"]), "launches": launches, **reports,
               "runs": {k: {"seconds": v["seconds"], "losses": v["losses"]}
                        for k, v in recs.items()}}
    for name, report in reports.items():
        log("pretrain_mesh", part="13d", checked=name, network=network, report=json.dumps(report))
    for name in ("mesh", "mesh_f64"):
        if not reports[name]["ok"]:
            raise AssertionError(f"13d {name}: the mesh differs from one device beyond "
                                 f"the bound: {reports[name]}")
    for name in ("control", "control_f64"):
        if reports[name]["ok"]:
            raise AssertionError(f"13d {name}: BN over each shard is within the bound, "
                                 f"which so cannot tell it from BN over the whole batch: "
                                 f"{reports[name]}")
    del recs

    # the step over the mesh and on one device
    u8, labels = batches[0]
    figures["step"], figures["busy"] = {}, {}
    for name, devs in (("one", [home]), ("mesh", devices)):
        figures["step"][name] = time_pretrain_steps(args, dataset, u8, labels, iters, devs,
                                                    forms=(("full", 1.0),))["full"]
        state = pretrain_cli.training_state(args, dataset.num_classes, devs)
        step = pretrain_cli.make_train_step(args, state.num_valid, None)
        key = pretrain_cli.step_key(prng_key(args.seed + 7), 0, 0)
        step(state, u8, labels, args.lr, key)

        def window():
            for _ in range(2):
                step(state, u8, labels, args.lr, key)
        figures["busy"][name] = card_busy(window, devices)
        del state
        log("pretrain_mesh", part="13d", run=name, network=network, batch=b,
            step=json.dumps(figures["step"][name]), busy=json.dumps(figures["busy"][name]))
    if on_card:
        torch.cuda.empty_cache()
    return figures, launches


def phase_pretrain_mesh(root: str, devices: list, argv: list,
                        short_spec: str = SHORT_PRETRAIN_SPEC,
                        iters: int = 5, bn_network: str = "iresnet100") -> dict:
    """Phase 13: pretraining on every device of ``devices`` (the ``model``
    axis; ``[d, d]`` is two shards of one device) at ``argv``'s widths
    (``pretrain_argv``).  13a the sharded
    losses against one device at ``argv``'s batch and width, 6,000 and
    6,001 classes; 13b the CLI over the mesh, launch counts set to 0 before
    its runs and read after: 1 epoch of the full softmax on ``argv``'s data
    and 1 epoch at ``--sample_rate 0.1`` on ``short_spec`` (the log line,
    the artefacts, the replicas bit for bit, one ``synth_gen`` launch a
    batch), then the full softmax on ``short_spec`` over the mesh against
    one device in bf16 and with the trunk in fp32 (the losses of every step
    within MESH_TOL_FACTOR x the one-device run's own bf16-vs-fp32
    distance); 13c step ms and samples/s of both losses over the mesh and
    on one device, each card's peak memory and busy share; 13d BN over the
    whole batch (``pretrain_bn_mesh``): BN_STEPS of ``bn_network``'s
    pretraining steps on ``short_spec`` over the mesh against one device in
    bf16, fp32 and float64, and BN over each shard as the control.
    Returns the launches of 13b and 13d."""
    home = devices[0]
    on_card = home.type == "cuda"
    mesh_arg = None if devices == mesh_mod.visible_devices(home.type) else devices
    log("pretrain_mesh", mesh_devices=[str(d) for d in devices],
        cards=len(dict.fromkeys(devices)))
    args = pretrain_cli.build_parser().parse_args(argv)
    figures = {"13a": [
        check_sharded_losses(devices, args.batch_size, args.embedding_size, classes, 0.1,
                             args.scale, args.margin)
        for classes in (6000, 6001)]}

    out = argv[argv.index("--output_dir") + 1]
    runs = {"full": (mesh_arg, argv + ["--num_epoch", "1", "--sample_rate", "1.0"]),
            "sampled": (mesh_arg, with_flag(with_flag(with_flag(
                argv, "--output_dir", out + "_sampled"), "--data_dir", short_spec),
                "--log_every", "2") + ["--num_epoch", "1", "--sample_rate", "0.1"])}
    short = with_flag(with_flag(argv, "--data_dir", short_spec), "--log_every", "1")
    short += ["--num_epoch", "1"]
    for name, devs, extra in (("short_mesh", mesh_arg, []), ("short_one", [home], []),
                              ("short_one_fp32", [home], ["--fp32"])):
        runs[name] = (devs, with_flag(short, "--output_dir", f"{out}_{name}") + extra)
    zero_launches()
    recs, steps = {}, 0
    for name, (devs, run_argv) in runs.items():
        t0 = time.perf_counter()
        rec = pretrain_cli.main(pretrain_cli.build_parser().parse_args(run_argv), devs)
        mesh_mod.synchronize(devices)
        rec["seconds"] = time.perf_counter() - t0
        state = rec.pop("state")
        rec["replicas_bitwise_equal"] = state.backbone.replicas_equal()
        del state
        recs[name] = rec
        steps += len(rec["epochs"]) * rec["steps_per_epoch"]
        log("pretrain_mesh", part="13b", run=name, seconds=f"{rec['seconds']:.2f}",
            setup_s=f"{rec['setup_s']:.2f}", shards=rec["num_shards"], steps_per_epoch=rec["steps_per_epoch"],
            epoch_s=rec["epoch_s"], save_s=rec["save_s"], num_sample=rec["num_sample"],
            replicas_bitwise_equal=rec["replicas_bitwise_equal"],
            losses=rec["losses"][-3:])
        losses = [v for _, v in rec["losses"]]
        want_shards = 1 if name.startswith("short_one") else len(devices)
        if (not losses or not all(math.isfinite(v) for v in losses)
                or rec["num_shards"] != want_shards or not rec["replicas_bitwise_equal"]):
            raise AssertionError(f"13b {name}: shards {rec['num_shards']}, losses "
                                 f"{rec['losses']}, replicas equal "
                                 f"{rec['replicas_bitwise_equal']}")
    launches = read_launches()
    expect = {"max_sim": 0, "roc_hist": 0, "synth_gen": steps}
    log("pretrain_mesh", part="13b", launches=launches, expected=expect)
    if on_card and launches != expect:
        raise AssertionError(f"13b launches {launches}, expected {expect}")
    for name, d in (("full", out), ("sampled", out + "_sampled")):
        with open(os.path.join(d, "pretrain.log")) as f:
            text = f.read()
        line = f"partial-FC over {len(devices)} model shards"
        if line not in text:
            raise AssertionError(f"13b {name}: pretrain.log lacks '{line}'")
        fc = torch.load(os.path.join(d, "fc.pth"))
        state = torch.load(os.path.join(d, pretrain_cli.STATE_FILE), map_location="cpu")
        pad_rows = -(-recs[name]["num_classes"] // len(devices)) * len(devices)
        if (tuple(fc.shape) != (recs[name]["num_classes"], args.embedding_size)
                or not torch.isfinite(fc).all() or state["weight"].shape[0] != pad_rows):
            raise AssertionError(f"13b {name}: fc {tuple(fc.shape)}, state rows "
                                 f"{state['weight'].shape[0]} (want {pad_rows})")
    pad_rows = -(-recs["sampled"]["num_classes"] // len(devices)) * len(devices)
    if recs["sampled"]["num_sample"] != partial_fc.num_sampled(0.1, pad_rows, len(devices)):
        raise AssertionError(f"13b sampled: {recs['sampled']['num_sample']} rows a shard")

    # the mesh against one device over the same first steps
    def distance(a: str, b: str) -> float:
        la, lb = recs[a]["losses"], recs[b]["losses"]
        if [s for s, _ in la] != [s for s, _ in lb]:
            raise AssertionError(f"13b: logged steps {la} against {lb}")
        return max(abs(x - y) for (_, x), (_, y) in zip(la, lb))

    got, own = distance("short_mesh", "short_one"), distance("short_one", "short_one_fp32")
    # the toy net has no bf16 trunk: MESH_FP32_TOL of the losses' scale
    # (~10-100 at scale 64)
    scale = max(abs(v) for _, v in recs["short_one"]["losses"])
    tol = MESH_TOL_FACTOR * own if args.network != "toy" else MESH_FP32_TOL * max(scale, 1.0)
    figures["13b"] = {"max_abs_diff": got, "bf16_vs_fp32": own, "tol": tol,
                      "runs": {k: {f: v[f] for f in ("seconds", "epoch_s", "save_s",
                                                      "setup_s", "num_shards",
                                                      "num_sample")}
                               for k, v in recs.items()}}
    log("pretrain_mesh", part="13b", steps=len(recs["short_one"]["losses"]),
        max_abs_diff=got, bf16_vs_fp32=own, tol=tol)
    if not got <= tol:
        raise AssertionError(f"13b: the mesh's losses differ from one device's by {got} > {tol}")

    # 13c: both losses' steps over the mesh and on one device; busy shares
    dataset = pretrain_cli.public_dataset(args, home)
    u8, batch_labels = dataset.device_batch(np.arange(args.batch_size))
    batch_labels = torch.from_numpy(batch_labels).to(home)
    figures["13c"] = {"steps": {}, "busy": {}}
    for name, devs in (("one", [home]), ("mesh", devices)):
        figures["13c"]["steps"][name] = time_pretrain_steps(args, dataset, u8, batch_labels,
                                                            iters, devs)
        state = pretrain_cli.training_state(args, dataset.num_classes, devs)
        step = pretrain_cli.make_train_step(args, state.num_valid, None)
        key = pretrain_cli.step_key(prng_key(args.seed + 7), 0, 0)
        for _ in range(2):
            step(state, u8, batch_labels, args.lr, key)

        def window():
            for _ in range(4):
                step(state, u8, batch_labels, args.lr, key)
        figures["13c"]["busy"][name] = card_busy(window, devices)
        del state
        log("pretrain_mesh", part="13c", run=name,
            steps=json.dumps(figures["13c"]["steps"][name]),
            busy=json.dumps(figures["13c"]["busy"][name]))
    del dataset, u8, batch_labels
    if on_card:
        torch.cuda.empty_cache()

    # 13d: BN over the whole batch; iresnet100's step over the mesh takes
    # 1-3 s: 1 step a timed run
    figures["13d"], bn_launches = pretrain_bn_mesh(devices, argv, short_spec, bn_network, 1)
    launches = {k: launches[k] + bn_launches[k] for k in launches}
    log("pretrain_mesh", figures=json.dumps(figures, default=str))
    return launches


# ---------------------------------------------------------------- phase 14

# 14b's JPEG rec, the 14d round's public set: 4,096 IDs x 8 images of
# 112x112 at quality 95; 14c's rates over its first NATIVE_RATE_IMAGES
NATIVE_IMAGES = 32_768
NATIVE_RATE_IMAGES = 8_192
NATIVE_VARIANT_IMAGES = 256
NATIVE_BATCH = 512
JPEG_QUALITY = 95
# the public embed's images/s on one card (PERF.md section 5, phases 8 and
# 12b), the rate a host decode has to keep up with
EMBED_IMAGES_PER_S = 23_000
# 14b's variants: name -> (image size, jpeg_encoder options)
JPEG_VARIANTS = {"444": (112, {"sampling": "444"}), "422": (112, {"sampling": "422"}),
                 "restart": (112, {"restart": 4}),
                 "progressive": (112, {"progressive": True}),
                 "gray": (112, {"gray": True}), "40x40": (40, {})}
SAMPLING_FACTORS = {"420": 0x221111, "422": 0x211111, "444": 0x111111}


def jpeg_encoder(quality: int = JPEG_QUALITY, sampling: str = "420", restart: int = 0,
                 progressive: bool = False, gray: bool = False):
    """A function from an RGB u8 image to a JPEG payload, through cv2
    (libjpeg-turbo) where the machine has it, else PIL: ``sampling`` 420,
    422 or 444, ``restart`` an interval in MCUs, ``gray`` one component
    (the image's first channel)."""
    import importlib.util

    if importlib.util.find_spec("cv2") is not None:
        import cv2

        params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING_FACTORS[sampling],
                  cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
                  cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]

        def encode(img: np.ndarray) -> bytes:
            img = img[..., 0] if gray else img[..., ::-1]
            ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img), params)
            if not ok:
                raise RuntimeError("cv2 failed to encode a JPEG")
            return buf.tobytes()
        encode.library = "cv2"
        return encode
    import io

    from PIL import Image

    options = {"quality": quality, "progressive": progressive,
               "subsampling": {"444": 0, "422": 1, "420": 2}[sampling],
               "restart_marker_blocks": restart}

    def encode(img: np.ndarray) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(img[..., 0] if gray else img).save(buf, format="JPEG", **options)
        return buf.getvalue()
    encode.library = "PIL"
    return encode


def jpeg_rec_payloads(n: int, size: int, encode, seed: int, chunk: int = 512) -> list:
    """``n`` seeded images, 8 an ID (the smoke's patterns), as JPEG payloads
    ``encode(image)``, made a chunk a thread (numpy and cv2 release the
    GIL): one noise field of ``chunk`` images is drawn once and laid over
    every chunk's own patterns, so that a rec of tens of thousands of images
    is made in seconds."""
    noise = np.random.default_rng(seed).standard_normal(
        (min(chunk, n), size, size, 3), dtype=np.float32) * 24

    def make(start: int) -> list:
        m = min(chunk, n - start)
        rng = np.random.default_rng([seed, start])
        base = np.repeat(_patterns(rng, -(-m // 8), size), 8, axis=0)[:m]
        return [encode(im) for im in np.clip(base + noise[:m], 0, 255).astype(np.uint8)]
    with concurrent.futures.ThreadPoolExecutor(native_threads()) as pool:
        return [p for part in pool.map(make, range(0, n, chunk)) for p in part]


def machine_record() -> dict:
    """The host the card sits in: its cores, the CPU model, and the cgroup's
    CPU quota where readable (read only)."""
    out = {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0))}
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            out["cpu_model"] = next((line.split(":", 1)[1].strip() for line in f
                                     if line.startswith("model name")), "not listed")
    with contextlib.suppress(OSError):
        with open("/sys/fs/cgroup/cpu.max") as f:
            out["cgroup_cpu_max"] = f.read().strip()
    return out


def _write_payloads(d: str, payloads: list, labels, num_classes: int) -> None:
    os.makedirs(d, exist_ok=True)
    write_split(os.path.join(d, "train.idx"), os.path.join(d, "train.rec"), payloads,
                list(labels), num_classes=num_classes)


def native_rates(idx: str, rec: str, size: int, n: int, batch: int) -> dict:
    """14c: images/s of the native reader over the rec's first ``n`` images
    in batches of ``batch`` (host clock; one warm batch first) at 1, 2, 4, 8
    threads and the affinity count, and the split of the one-thread run's
    time between entropy decode and reconstruction."""
    keys = np.arange(1, n + 1)
    out = {"images": n, "rates": {}}
    for threads in sorted({1, 2, 4, 8, native_threads()}):
        reader = NativeReader(idx, rec, size, threads=threads)
        reader.read_batch(keys[:batch])
        native_mod.zero_counters()
        t0 = time.perf_counter()
        for b in range(0, n, batch):
            reader.read_batch(keys[b:b + batch])
        out["rates"][threads] = n / (time.perf_counter() - t0)
        if threads == 1:
            c = native_mod.counters
            busy = c["entropy_s"] + c["reconstruct_s"]
            out["one_thread_stages"] = {
                "entropy_s": c["entropy_s"], "reconstruct_s": c["reconstruct_s"],
                "entropy_share": c["entropy_s"] / busy,
                "entropy_us_per_image": 1e6 * c["entropy_s"] / n,
                "reconstruct_us_per_image": 1e6 * c["reconstruct_s"] / n}
        reader.close()
    return out


def phase_native(root: str, val_dir: str, n_images: int = NATIVE_IMAGES,
                 rate_images: int = NATIVE_RATE_IMAGES,
                 variant_images: int = NATIVE_VARIANT_IMAGES, clients: int = 2,
                 ids: int = 100, device: str = "cuda", network: str = "sphnet",
                 embedding: int = 512, image_size: int = 112, batch: int = 256,
                 eval_batch: int = 512, embed_batch: int = NATIVE_BATCH,
                 workers: int = 6) -> dict:
    """Phase 14, the native reader: 14a the build, the machine and the
    card's name and power limit; 14b a JPEG rec of ``n_images`` (the
    round's public set) and small variants, every image of the native
    reader against ``codec.decode`` (the Python path's, read by the CLI's
    ``BatchLoader`` with ``workers`` threads), none may differ; 14c
    images/s of the reader at 1, 2, 4, 8 and the affinity count of threads,
    of the Python loader and of one cv2 thread, beside the embed's; 14d one
    round of run.sh's flags through the CLI over the JPEG root (``clients``
    x ``ids`` IDs x 8 images, 10 veri images an ID; the .bin set at
    ``val_dir``; the mined set capped at 6,500 images, as phase 8 caps it),
    launch counts set to 0 before its rounds and read after, the native
    counters, the public embed's span, then the round's global model over
    the public set natively (its busy share) and over its first
    ``rate_images`` on the Python path: images/s of both and the largest
    difference between their features, which must be 0.  Returns the
    launches of 14d."""
    t_phase = time.perf_counter()
    card = card_lines()[0] if device == "cuda" else "not measured (cpu)"
    log("native", part="14a", card=json.dumps(card), build_s=native_mod.build_seconds,
        build=" ".join(native_mod.build_command(native_mod.library_path())),
        **{k: json.dumps(v) for k, v in machine_record().items()})
    # 14b
    encode = jpeg_encoder()
    pub_dir = os.path.join(root, "split_pretrain_6000", "client_0000")
    t0 = time.perf_counter()
    payloads = jpeg_rec_payloads(n_images, image_size, encode, seed=14)
    _write_payloads(pub_dir, payloads, np.arange(n_images) // 8, -(-n_images // 8))
    figures = {"14b": {"images": n_images, "write_s": time.perf_counter() - t0,
                       "mean_jpeg_bytes": float(np.mean([len(p) for p in payloads])),
                       "encoder": encode.library}}
    idx, rec = os.path.join(pub_dir, "train.idx"), os.path.join(pub_dir, "train.rec")
    reader = NativeReader(idx, rec, image_size, threads=native_threads())
    t0 = time.perf_counter()
    one = [codec.decode(p) for p in payloads[:min(2048, n_images)]]
    cv2_rate = len(one) / (time.perf_counter() - t0)
    del payloads, one
    differing = py_s = native_s = 0.0
    pos = 0
    with BatchLoader(FaceRecordDataset(pub_dir, use_native=False), embed_batch,
                     shuffle=False, num_workers=workers) as loader:
        batches = loader.epoch()
        while True:
            t0 = time.perf_counter()
            ref = next(batches, None)
            py_s += time.perf_counter() - t0
            if ref is None:
                break
            nv = int(ref[2].sum())
            t0 = time.perf_counter()
            got, labels = reader.read_batch(np.arange(pos + 1, pos + nv + 1))
            native_s += time.perf_counter() - t0
            differing += int((got != ref[0][:nv]).sum()) + int((labels != ref[1][:nv]).sum())
            pos += nv
    variants = {}
    for seed, (name, (size, options)) in enumerate(JPEG_VARIANTS.items()):
        payloads = jpeg_rec_payloads(variant_images, size, jpeg_encoder(**options), seed)
        d = os.path.join(root, "variants", name)
        _write_payloads(d, payloads, np.arange(variant_images) // 8, -(-variant_images // 8))
        got, _ = NativeReader(os.path.join(d, "train.idx"), os.path.join(d, "train.rec"),
                              size).read_batch(np.arange(1, variant_images + 1))
        variants[name] = sum(int((g != codec.decode(p)).sum()) for g, p in zip(got, payloads))
    figures["14b"].update(differing_bytes=int(differing), compared=pos, variants=variants)
    log("native", part="14b", **{k: json.dumps(v) for k, v in figures["14b"].items()})
    if differing or any(variants.values()) or pos != n_images:
        raise AssertionError(f"14b: the native reader differs from codec.decode: "
                             f"{differing} bytes over {pos} images, variants {variants}")
    # 14c
    rates = native_rates(idx, rec, image_size, min(rate_images, n_images), embed_batch)
    rates.update(python_loader_images_per_s=n_images / py_s, python_loader_workers=workers,
                 native_loader_pass_images_per_s=n_images / native_s,
                 cv2_one_thread_images_per_s=cv2_rate,
                 embed_images_per_s=EMBED_IMAGES_PER_S)
    rates["decode_is_slower"] = rates["rates"][native_threads()] < EMBED_IMAGES_PER_S
    figures["14c"] = rates
    log("native", part="14c", **{k: json.dumps(v) for k, v in rates.items()})

    # 14d: run.sh's round over the JPEG root
    write_fl_split(root, clients, ids, imgs_per_id=8, pub_ids=0, pub_imgs=0,
                   size=image_size, seed=0, veri_imgs=10, encode=encode)
    argv = with_flag(round_args(root, clients, ids, device=device, network=network,
                                embedding=embedding, image_size=image_size, batch=batch,
                                local_epochs=1, rounds=1, eval_batch=eval_batch),
                     "--val_root", val_dir) + ["--HN_cap", "6500"]
    native_mod.zero_counters()
    run, history, launches, _ = drive(argv, tag="native")
    counted = dict(native_mod.counters)
    expect_launches(run, launches, {"max_sim": clients,
                                    "roc_hist": 2 * len(run.server.local_candidates)}, "14d")
    span = history[0]["spans"]["phase/public_embed"]
    figures["14d"] = {"counters": counted, "launches": launches,
                      "public_embed_span_s": span, "public_embed_images_per_s": n_images / span,
                      "losses": history[0]["losses"], "round_s": history[0]["seconds"]}
    # every JPEG of the root is one the reader decodes: no split switches
    if counted["batches"] == 0 or counted["images"] < n_images or counted["switches"]:
        raise AssertionError(f"14d: the native reader decoded {counted}; the public set "
                             f"alone is {n_images} images, and no split may switch")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    feats = {}

    def native_embed():
        feats["native"] = embed_mod.embed_dataset(run.server.global_net,
                                                  FaceRecordDataset(pub_dir), embed_batch,
                                                  device=dev, num_workers=workers)[0]
    busy = card_busy(native_embed, [dev])
    # the Python path over the set's first rate_images (the same batches)
    m = min(rate_images, n_images)
    t0 = time.perf_counter()
    feats["python"] = embed_mod.embed_dataset(
        run.server.global_net,
        FaceRecordDataset(pub_dir, use_native=False).subset(np.arange(1, m + 1)),
        embed_batch, device=dev, num_workers=workers)[0]
    mesh_mod.synchronize([dev])
    python_s = time.perf_counter() - t0
    diff = float((feats["native"][:m] - feats["python"]).abs().max())
    figures["14d"].update(native_embed_images_per_s=n_images / busy["wall_s"],
                          card_busy=busy["busy_share"], python_embed_images=m,
                          python_embed_images_per_s=m / python_s,
                          max_abs_feature_diff=diff)
    log("native", part="14d", **{k: json.dumps(v) for k, v in figures["14d"].items()})
    if diff != 0.0:
        raise AssertionError(f"14d: the public features differ by {diff} between the "
                             f"native reader and the Python path")
    figures["seconds"] = time.perf_counter() - t_phase
    log("native", figures=json.dumps(figures, default=str))
    return launches


# phase 15: the convergence chain at the flagship scale of DESIGN.md:565-570
CONVERGENCE_ARGV = ["--network", "sphnet", "--embed", "512", "--image_size", "112",
                    "--num_clients", "8", "--num_ids", "32", "--imgs_per_id", "10",
                    "--pretrain_epochs", "4", "--pretrain_lr", "0.001", "--rounds", "6",
                    "--local_epoch", "4", "--lr", "0.001"]
# no per-round exports: the final round's backbone and every client's at the
# end, which local_all reads, and the pretraining's last epoch alone (the
# harness keeps both CLIs' per-round and per-epoch cadence)
CONVERGENCE_CUTS = ["--round_ckpt_every", "0", "--client_ckpt_every", "0"]
CONVERGENCE_PRETRAIN_CUTS = ["--save_every", "1000"]
# DESIGN.md:572-579 and 591-595: the JAX chain on one TPU v5e, not the
# port's; printed beside the port's rows, never gated
TPU_V5E_ROUNDS = [(0, 21.42, 0.767, 38.6), (1, 17.43, 0.795, 8.9), (2, 16.36, 0.831, 6.9),
                  (3, 16.09, 0.845, 5.7), (4, 15.80, 0.924, 4.4), (5, 15.98, 0.924, 4.4)]
TPU_V5E_LOCAL_TPR = {"at_1e-1": (75.7, 79.7), "at_1e-3": (15.2, 22.8),
                     "local_all_mean_tpr": [7.83, 8.01, 9.78, 23.26, 45.80, 79.69]}
# DESIGN.md:614-620: the same chain at pretrain lr 0.01 on the TPU
TPU_V5E_NEGATIVE = {"xnorm_entering_round_0": 1.2e18, "cos_loss_pinned_at": 14.944}


def convergence_run(part: str, argv: list, pub_ids: int, n_pairs: int,
                    train_extra: list, pretrained_root: str = None) -> tuple:
    """One chain (``fedfr_tpu_torch.convergence.run_chain``) with the
    launch counts set to 0 just before and read just after; logs its
    summary and checks that every loss and XNorm is finite and, on the
    card, the launches of each stage: mining once a client a round, the ROC
    once a candidate a round plus the epoch -1 baselines, and once a client
    in ``local_all``.  Returns (args, summary, launches)."""
    args = conv.build_parser().parse_args(argv)
    zero_launches()
    summary = conv.run_chain(args, pub_ids=pub_ids, n_pairs=n_pairs,
                             pretrain_extra=CONVERGENCE_PRETRAIN_CUTS,
                             train_extra=CONVERGENCE_CUTS + list(train_extra),
                             pretrained_root=pretrained_root)
    launches = read_launches()
    log("convergence", part=part, summary=json.dumps(summary))
    values = summary["avg_loss_per_round"] + summary["xnorm_per_round"]
    if len(summary["xnorm_per_round"]) != args.rounds or not all(map(math.isfinite, values)):
        raise AssertionError(f"{part}: losses {summary['avg_loss_per_round']}, XNorm "
                             f"{summary['xnorm_per_round']} over {args.rounds} rounds")
    candidates = min(args.num_clients, FedFRConfig().fed.num_local_eval_clients)
    expected = {"data": {"max_sim": 0, "roc_hist": 0},
                "train": {"max_sim": args.num_clients * args.rounds,
                          "roc_hist": candidates * (args.rounds + 1)},
                "local_all": {"max_sim": 0, "roc_hist": args.num_clients}}
    if args.pretrain_epochs > 0 and not pretrained_root:
        expected["pretrain"] = {"max_sim": 0, "roc_hist": 0}
    log("convergence", part=part, launches=launches,
        by_stage=json.dumps(summary["launches"]), expected=json.dumps(expected))
    if args.device == "cuda" and summary["launches"] != expected:
        raise AssertionError(f"{part}: kernel launches by stage {summary['launches']}, "
                             f"expected {expected}")
    return args, summary, launches


def phase_convergence(root: str, argv: list = CONVERGENCE_ARGV, device: str = "cuda",
                      pub_ids: int = conv.PUB_IDS, n_pairs: int = conv.BIN_PAIRS,
                      train_extra: tuple = ()) -> dict:
    """Phase 15, the convergence chain (split, pretrain, train with every
    FedFR flag, local_all) three times: (a) at ``argv``, gated on the
    repository's convergence criteria, no collapse warning and the kernels'
    launches; (b) the planted control, the same chain from (a)'s pretrained
    root at lr 0 for 2 rounds of 1 local epoch, which must fail the
    learning criterion; (c) (a) at pretrain lr 0.01 for 1 round, the
    negative result, printed and not gated.  Returns the launches of the
    three runs summed."""
    t_phase = time.perf_counter()
    base = with_flag(with_flag(argv, "--device", device), "--work_dir",
                     os.path.join(root, "a"))
    args, a, launches_a = convergence_run("15a", base, pub_ids, n_pairs, list(train_extra))
    crit = a["criteria"]
    for r, ((_, acc), loss, xnorm, (tpr1, tpr3)) in enumerate(zip(
            a["agedb_per_round"], a["avg_loss_per_round"], a["xnorm_per_round"],
            a["local_tpr_per_round"])):
        log("convergence", part="15a", round=r, avg_client_loss=loss, bin_acc=acc,
            xnorm=xnorm, mean_local_tpr_1e_1=tpr1, mean_local_tpr_1e_3=tpr3)
    log("convergence", part="15a", baseline_tpr_1e_1=a["local_tpr_at_1e-1_baseline_mean"],
        baseline_tpr_1e_3=a["local_tpr_at_1e-3_baseline_mean"],
        local_all_mean_tpr=a["local_all_mean_tpr"],
        pretrained_median_feature_norm=a["pretrained_median_feature_norm"],
        criteria=json.dumps(crit), stage_seconds=json.dumps(a["stage_seconds"]))
    for r, loss, acc, xnorm in TPU_V5E_ROUNDS:
        log("convergence", part="15a", tpu_v5e_jax_round=r, avg_client_loss=loss,
            bin_acc=acc, xnorm=xnorm, gated=False)
    log("convergence", part="15a", tpu_v5e_jax_local=json.dumps(TPU_V5E_LOCAL_TPR),
        gated=False)
    if a["collapse_warnings"]:
        raise AssertionError(f"15a: {a['collapse_warnings']} collapsed-feature warnings")
    if not (crit["not_worse"] and crit["learned"]):
        raise AssertionError(f"15a: the chain did not learn: {crit}")

    control = with_flag(with_flag(with_flag(with_flag(
        base, "--lr", "0"), "--rounds", "2"), "--local_epoch", "1"),
        "--work_dir", os.path.join(root, "b"))
    # the chain's pretraining is seeded: 15b starts from 15a's root
    _, b, launches_b = convergence_run("15b", control, pub_ids, n_pairs, list(train_extra),
                                       pretrained_root=os.path.join(root, "a", "pre"))
    log("convergence", part="15b", criteria=json.dumps(b["criteria"]))
    if b["criteria"]["learned"]:
        raise AssertionError(f"15b: the lr-0 control passed the learning criterion "
                             f"{b['criteria']}: the gate cannot fail")

    negative = with_flag(with_flag(with_flag(base, "--pretrain_lr", "0.01"),
                                   "--rounds", "1"), "--work_dir", os.path.join(root, "c"))
    _, c, launches_c = convergence_run("15c", negative, pub_ids, n_pairs, list(train_extra))
    log("convergence", part="15c", pretrain_lr=0.01,
        pretrained_median_feature_norm=c["pretrained_median_feature_norm"],
        round0_xnorm=c["xnorm_per_round"][0], round0_avg_client_loss=c["avg_loss_per_round"][0],
        collapse_warning=c["collapse_warnings"] > 0, gated=False,
        tpu_v5e_jax=json.dumps(TPU_V5E_NEGATIVE))
    log("convergence", seconds=f"{time.perf_counter() - t_phase:.2f}",
        runs_s=json.dumps({k: sum(s["stage_seconds"].values())
                           for k, s in (("15a", a), ("15b", b), ("15c", c))}))
    return {k: launches_a[k] + launches_b[k] + launches_c[k] for k in launches_a}


def main(argv: list) -> None:
    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = round(time.perf_counter() - t0, 2)
        return out

    if argv not in ([], ["--phase", "12"], ["--phase", "12g"], ["--phase", "13"],
                    ["--phase", "14"], ["--phase", "15"]):
        raise SystemExit("usage: python3 chip_smoke.py "
                         "[--phase 12 | --phase 12g | --phase 13 | --phase 14 | --phase 15]")
    smi = timed("1_device", phase_device)
    timed("2_build", phase_build)
    if argv == ["--phase", "12g"]:
        timed("12g_busy", mesh_busy, mesh_devices(), BUSY_SPEC, 12_288, 6)
        log("smoke", phase_seconds=json.dumps(seconds))
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if argv:
        # phase 12 or 13 alone, on every GPU of the machine; 14 or 15 alone
        with tempfile.TemporaryDirectory(prefix="fedfr_smoke_") as root:
            if argv[1] == "15":
                timed("15_convergence", phase_convergence, os.path.join(root, "convergence"))
            elif argv[1] == "14":
                write_bin(os.path.join(root, "val", "agedb_30.bin"), n_pairs=1200,
                          size=112, seed=1)
                timed("14_native", phase_native, os.path.join(root, "native"),
                      os.path.join(root, "val"))
            elif argv[1] == "12":
                timed("12_mesh", phase_mesh, os.path.join(root, "mesh"), mesh_devices(),
                      ids=100, local_epochs=1)
            else:
                timed("13_pretrain_mesh", phase_pretrain_mesh, root, mesh_devices(),
                      pretrain_argv(PRETRAIN_SPEC, os.path.join(root, "pretrain_mesh")))
        log("smoke", phase_seconds=json.dumps(seconds),
            total_s=round(sum(seconds.values()), 2))
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    mining = timed("3_max_sim", phase_mining, 420_671, 6_500, 512)
    roc = timed("3_roc_hist", phase_roc, 160_000, 4_000, 512)
    synth = timed("3_synth_gen", phase_synth_gen, REF_PUBLIC)
    with tempfile.TemporaryDirectory(prefix="fedfr_smoke_") as root:
        timed("4_data", write_round_data, root, n_clients=2, ids=100, size=112)
        # round 0 runs 1 local epoch: --profile traces it, and the trace's
        # post-processing grows with the round's launches
        by_phase = {"round": timed("4_round", phase_round, round_args(
            root, n_clients=2, ids=100, local_epochs=1) + ["--profile"])}
        pre = os.path.join(root, "pretrain_iresnet100")
        write_pretrained_root(pre, "iresnet100", 512, 112, pub_ids=2000,
                              pub_imgs=2, seed=100)
        argv = pretrained_args(root, 2, 100, pre, network="iresnet100")
        by_phase["pretrained_iresnet"] = timed("5_pretrained", phase_pretrained, argv)
        by_phase["local_all"] = timed(
            "6_local_all", phase_local_all, argv[argv.index("--output_dir") + 1],
            root, 2, 100, "iresnet100", 512, converter_layer=2)
        by_phase.update(timed("7_paths", phase_paths, root, n_clients=2, ids=100))
        by_phase["reference"] = timed("8_reference", phase_reference, reference_args(
            os.path.join(root, "val"), os.path.join(root, "run_reference")))
        setup_argv = reference_args(os.path.join(root, "val"),
                                    os.path.join(root, "run_from_pretrain"))
        for flag in ("--rec_root", "--local_rec"):
            setup_argv = with_flag(setup_argv, flag, PRETRAIN_SPEC)
        by_phase["pretrain"] = timed(
            "9_pretrain", phase_pretrain,
            pretrain_argv(PRETRAIN_SPEC, os.path.join(root, "pretrain_synth")), setup_argv)
        by_phase["ijbc"] = timed(
            "10_ijbc", phase_ijbc, os.path.join(root, "ijbc"),
            os.path.join(root, "run_reference", "backbone_0.pth"),
            os.path.join(root, "run"), [1])
        lock_root = os.path.join(root, "lockstep")
        timed("11_data", write_round_data, lock_root, n_clients=3, ids=100, size=112)
        # 1 local epoch: round 0 at random weights mines every public
        # image, so its epochs are the phase's longest
        parts = timed("11_lockstep", phase_lockstep, lock_root, n_clients=3, ids=100,
                      local_epochs=1)
        by_phase["lockstep"] = {k: sum(p[k] for p in parts.values())
                                for k in KERNEL_COUNTERS}
        # 1 local epoch, then 4: two rounds over two shards of the card, 50
        # IDs a client (--phase 12 on every card: 100)
        parts = timed("12_mesh", phase_mesh, os.path.join(root, "mesh"), mesh_devices(),
                      ids=50, local_epochs=1)
        by_phase["mesh"] = {k: sum(p[k] for p in parts.values()) for k in KERNEL_COUNTERS}
        # pretraining over two shards of the card
        by_phase["pretrain_mesh"] = timed(
            "13_pretrain_mesh", phase_pretrain_mesh, root, mesh_devices(),
            pretrain_argv(PRETRAIN_SPEC, os.path.join(root, "pretrain_mesh")))
        # the native reader, and run.sh's round over a JPEG root
        by_phase["native"] = timed("14_native", phase_native, os.path.join(root, "native"),
                                   os.path.join(root, "val"))
        # the convergence chain at sphere64 / E=512: split, pretrain, 6
        # rounds, local_all; its control; the pretrain-lr negative result
        by_phase["convergence"] = timed("15_convergence", phase_convergence,
                                        os.path.join(root, "convergence"))
    log("smoke", phase_seconds=json.dumps(seconds),
        total_s=round(sum(seconds.values()), 2))
    for record in (mining, roc, synth):
        counts = {k: v[record["name"]] for k, v in by_phase.items()}
        record["launches"] = sum(counts.values())
        record["launches_by_phase"] = counts
    print(smi, flush=True)
    print(json.dumps({"kernels": [mining, roc, synth]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
