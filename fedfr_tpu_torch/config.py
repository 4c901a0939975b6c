"""Single typed configuration for the whole framework (PyTorch port).

A copy of ``fedfr_tpu/config.py`` with the same fields and defaults, plus
``runtime.device``: the port's entry points run on ``cuda`` unless the
caller asks for ``cpu``.

Replaces the reference's mutable module-level easydict (reference config.py +
the ~25 argparse flags of train.py:94-126, several of which are dead).  All
values are explicit, immutable-by-convention dataclass fields; CLIs construct
one ``FedFRConfig`` and thread it through — no import-time globals.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class DataConfig:
    """Dataset locations + loader knobs (reference config.py:13-27, dataset.py)."""

    rec_root: str = ""                  # root with split_train_*/split_pretrain_6000
    val_root: str = ""                  # directory of .bin verification sets
    local_veri_dir: str = ""            # local_veri_4000 (test.rec/idx + idx_id_pair.txt)
    local_gallery_dir: str = ""         # local_gallery_4000
    num_clients: int = 40
    num_ids: int = 4000                 # total FL identities (num_clients * ids/client)
    batch_size: int = 64                # per-client local batch (train.py --batch_size)
    combined_batch_size: int = 256      # local+public combined batch (cfg.com_batch_size)
    public_batch_size: int = 512        # public set embed/eval batch
    eval_batch_size: int = 512          # embedding-extraction batch for eval
    num_workers: int = 6                # host decode threads
    prefetch: int = 2                   # device prefetch depth
    use_native_loader: bool = True      # C++ data plane when available
    image_size: int = 112               # square input resolution

    @property
    def split_dir(self) -> str:
        import os
        return os.path.join(self.rec_root, "split_train_i%04dc%04d" % (self.num_ids, self.num_clients))

    @property
    def public_dir(self) -> str:
        import os
        return os.path.join(self.rec_root, "split_pretrain_6000", "client_0000")


@dataclass
class ModelConfig:
    network: str = "sphnet"             # sphnet | iresnet18/34/50/100/200
    embedding_size: int = 512
    dropout: float = 0.0
    bf16: bool = True                   # conv trunk in bfloat16, head fp32
                                        # (mirrors reference fp16 autocast, iresnet.py:158-172)
    converter_layers: int = 1           # BCE transformation layer: 1=linear, else BottleBlock
    scan_blocks: bool = False           # nn.scan repeated blocks (faster compile)
    remat_blocks: bool = False          # nn.remat residual blocks: O(depth) lower
                                        # activation memory for ~1 extra forward
                                        # (fits lockstep K on one chip's HBM)
    freeze_bn: bool = False             # BN in inference mode during training
                                        # (reference freeze_BN, iresnet.py:140-156)


@dataclass
class LossConfig:
    loss: str = "CosFace"               # CosFace | ArcFace
    margin_s: float = 30.0              # scale used in FL training (client.py:133)
    margin_m: float = 0.4
    bce_r: float = 30.0                 # BCE_loss(r=30, lambda=0.7) (losses.py:4-15)
    bce_lambda: float = 0.7
    bce_weight: float = 10.0            # loss = cos + 10*bce + mu*con (client.py:383)
    bce_margin: float = 0.4             # BCE_module margin/scale/hardness (client.py:26)
    bce_scale: float = 30.0
    bce_t: float = 3.0
    mu: float = 5.0                     # contrastive weight (config.py:30)
    temperature: float = 0.5            # MOON temperature (client.py:155)


@dataclass
class OptimConfig:
    lr: float = 0.001                   # run.sh uses 0.001
    momentum: float = 0.9
    weight_decay: float = 5e-4
    train_decay: int = 8                # StepLR step size in local epochs (config.py:29)
    lr_gamma: float = 0.1


@dataclass
class FederatedConfig:
    total_rounds: int = 20
    local_epochs: int = 10
    client_sampled_ratio: float = 1.0
    adaptive_local_epoch: bool = True   # le = max(4, le-2) per round (server.py:278-280)
    aggr_alg: str = "FedAvg"
    fedprox_mu: float = 0.0             # FedProx proximal weight (0 = off);
                                        # the reference's --aggr_alg FedProx is
                                        # aggregation-only (server.py:327)
    spreadout: bool = False
    spreadout_iters: int = 20
    spreadout_margin: float = 0.4       # server.py:348 passes margin=0.4
    spreadout_mode: str = "mean"
    init_fc: bool = False               # mean-embedding FC init instead of pretrained fc.pth
    add_pretrained_data: bool = True    # public-data joint optimization branch
    combine_dataset: bool = True
    bce_local: bool = True              # personalized transformation-layer branch
    bce_detach: bool = False
    contrastive: bool = True            # MOON-style regularizer
    # precompute the frozen MOON features once per (client, round) at full
    # embedding MFU and gather per step instead of re-running the two frozen
    # forwards every step (exact same math — both frozen models are fixed
    # for the run and in eval mode; ~38% of step time, DESIGN.md)
    cache_contrastive: bool = False
    return_all: bool = True             # clients return global-FC shard for FC FedAvg
    reweight_cosface: bool = False
    hn_threshold: float = 0.4           # hard-negative cosine threshold (config.py:28)
    hn_strategy: str = "feature"        # 'feature': image-feature mining
                                        # (choose_hard_negative_2, client.py:191-224);
                                        # 'fc': FC-row mining (choose_hard_negative,
                                        # client.py:227-267)
    hn_fc_threshold: float = 0.2        # FC-row mining threshold (client.py:227)
    hn_cap: int = 0                     # 0 = reference semantics (everything above
                                        # threshold).  >0 caps the mined set at the
                                        # N HARDEST public images (top-N by max
                                        # cos-sim) — a bounded-cost safety valve for
                                        # universes where the fixed threshold would
                                        # saturate mining (DESIGN.md)
    num_local_eval_clients: int = 10    # clients sampled for per-round local 1:1 eval
    client_parallel: bool = True        # train clients concurrently over the mesh
                                        # 'client' axis instead of sequentially
    lockstep: int = 1                   # clients resident per client-axis slice:
                                        # each parallel group advances
                                        # lockstep * mesh client-axis size
                                        # clients per dispatch (vmapped on-
                                        # device; >1 batches multiple clients'
                                        # convs into one larger XLA program —
                                        # fewer host sync points and higher
                                        # MXU occupancy at small per-client
                                        # batch, paid for in activations HBM)


@dataclass
class RuntimeConfig:
    seed: int = 100                     # reference pins seed 100 everywhere
    device: str = "cuda"                # torch device of the run; "cpu" only
                                        # when asked for (tests)
    output_dir: str = "./ckpt/FedFR"
    pretrained_root: str = ""           # holds backbone.pth / fc.pth / *_labels.pth
    val_targets: List[str] = field(default_factory=lambda: ["agedb_30"])
    mesh_shape: Optional[Tuple[int, ...]] = None  # (client, data, model); None = auto
    log_every: int = 40
    profile: bool = False
    device_cache: bool = False          # keep client/global backbones device-
                                        # resident between rounds: a round moves
                                        # no backbone bytes host<->device
    client_ckpt_every: int = 1          # per-client artifact save period in
                                        # rounds (0 = never; reference saves
                                        # every round, client.py:484-495)
    round_ckpt_every: int = 1           # global backbone_%d + resume-state
                                        # save period in rounds (0 = never)
    round_ckpt_keep: int = 0            # retain only the newest N resume
                                        # states (0 = keep all); a reference-
                                        # scale round state is ~7.6 GB
    round_ckpt_async: bool = False      # overlap resume-state npz writes
                                        # with the next round (fetch stays
                                        # synchronous)
    round_ckpt_bg_fetch: bool = False   # also move the device->host fetch
                                        # into the writer thread (snapshots
                                        # immutable device refs; implies
                                        # round_ckpt_async)


@dataclass
class FedFRConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    fed: FederatedConfig = field(default_factory=FederatedConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "FedFRConfig":
        raw = json.loads(s)
        return FedFRConfig(
            data=DataConfig(**raw.get("data", {})),
            model=ModelConfig(**raw.get("model", {})),
            loss=LossConfig(**raw.get("loss", {})),
            optim=OptimConfig(**raw.get("optim", {})),
            fed=FederatedConfig(**{k: v for k, v in raw.get("fed", {}).items()}),
            runtime=RuntimeConfig(**{k: tuple(v) if k == "mesh_shape" and v else v
                                     for k, v in raw.get("runtime", {}).items()}),
        )
