"""Training-dynamics probes of the port against the JAX package, on the CPU:
the runs behind ROADMAP §C's two settled items, printed as JSON lines.

    python tests/torch_dynamics.py pretrain --network sphnet20 --image_size 16 \\
        --embed 64 --epochs 8
    python tests/torch_dynamics.py init_fc --network sphnet20 --image_size 16 \\
        --embed 64 --rounds 3 [--port_only] [--bf16]
    python tests/torch_dynamics.py toy_chain --seeds 6

* ``pretrain``: both pretraining CLIs' ``main`` in process from the JAX
  CLI's initial weights (carried by ``interop``), fp32, scale 64, a public
  set of 8 IDs x 8 images, batch 16, every epoch at ``--lr``; the median
  feature norm over the set before and after, and every logged loss.
* ``init_fc``: both training CLIs with run.sh's flags plus ``--init_fc``
  from one random backbone (the JAX init, a root holding only its
  ``backbone.npz``), the clients' random heads carried over and JAX's flip
  masks injected, on the convergence chain's data; per round the ``.bin``
  XNorm, accuracy and average client loss.  ``--port_only`` runs the port
  alone, on its own clients' heads and flips.
* ``toy_chain``: the port's chain at ``tests/test_convergence.py``'s sizes
  for each torch seed, from the port's own toy init and from the JAX
  test's (``PRNGKey(100)``); each run's criteria.

Sizes this small run in seconds to minutes; sphere64 at 112x112 takes
hours on a CPU.
"""

import argparse
import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pretrain as jax_pretrain  # noqa: E402
import train as jax_train  # noqa: E402
from fedfr_tpu.data.datasets import AllClientData as JData  # noqa: E402
from fedfr_tpu.federated import Server as JServer  # noqa: E402
from fedfr_tpu.federated.client import _run_key  # noqa: E402
from fedfr_tpu.federated.state import flip_mask  # noqa: E402
from fedfr_tpu.models import build_backbone as jax_backbone  # noqa: E402
from fedfr_tpu.utils.checkpoint import load_native, save_native  # noqa: E402

from fedfr_tpu_torch import convergence as conv  # noqa: E402
from fedfr_tpu_torch import interop  # noqa: E402
from fedfr_tpu_torch import pretrain as port_pretrain  # noqa: E402
from fedfr_tpu_torch import train as port_train  # noqa: E402
from fedfr_tpu_torch.data import FaceRecordDataset, codec, write_split  # noqa: E402
from fedfr_tpu_torch.federated.embed import embed_dataset  # noqa: E402
from fedfr_tpu_torch.models import build_backbone  # noqa: E402

LOSS_RE = re.compile(r"Loss (\S+)\s+Epoch: (\d+)\s+Global Step: (\d+)")


def _jax_init(network, embed, size, seed=100):
    return jax.device_get(jax_backbone(network, embed, bf16=False).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), train=False))


def _median_norm(net, root):
    feats, _ = embed_dataset(net, FaceRecordDataset(root), 16, l2norm=False, device="cpu")
    return float(feats.norm(dim=1).median())


def _port_net(network, embed, size, state):
    net = build_backbone(network, embed, bf16=False, image_size=size)
    net.load_state_dict(state)
    return net


def probe_pretrain(a, work):
    root = os.path.join(work, "public")
    os.makedirs(root)
    rng = np.random.default_rng(0)
    payloads, labels = [], []
    for pid in range(8):
        base = rng.integers(0, 200, size=(a.image_size, a.image_size, 3))
        for _ in range(8):
            img = np.clip(base + rng.integers(-20, 20, base.shape), 0, 255)
            payloads.append(codec.encode_raw(img.astype(np.uint8)))
            labels.append(pid)
    write_split(os.path.join(root, "train.idx"), os.path.join(root, "train.rec"),
                payloads, labels, num_classes=8)
    common = dict(network=a.network, loss="CosFace", embedding_size=a.embed,
                  image_size=a.image_size, batch_size=16, num_epoch=a.epochs, lr=a.lr,
                  lr_steps=str(a.epochs + 1), scale=64.0, margin=0.4, momentum=0.9,
                  weight_decay=5e-4, sample_rate=1.0, num_workers=2, log_every=1,
                  seed=100, fp32=True, scan_blocks=False)
    variables = _jax_init(a.network, a.embed, a.image_size)
    w0 = np.array(0.01 * jax.random.normal(jax.random.PRNGKey(101), (8, a.embed)))
    state = interop.backbone_state_dict(a.network, variables)
    port_pretrain.initial_state = lambda args, n: (
        _port_net(a.network, a.embed, a.image_size, state), torch.from_numpy(w0))
    jout, tout = os.path.join(work, "jax"), os.path.join(work, "port")
    os.makedirs(jout)
    jax_pretrain.main(argparse.Namespace(data_dir=root, output_dir=jout, resume=False,
                                         **common))
    args = port_pretrain.build_parser().parse_args(
        ["--data_dir", root, "--output_dir", tout, "--device", "cpu"])
    vars(args).update(common)
    port_pretrain.main(args)
    jpath = os.path.join(jout, "backbone.npz")
    jstate = (interop.backbone_state_dict(a.network, load_native(jpath))
              if os.path.exists(jpath) else torch.load(os.path.join(jout, "backbone.pth")))
    losses = {}
    for name, out in (("jax", jout), ("port", tout)):
        with open(os.path.join(out, "pretrain.log")) as f:
            losses[name] = [float(m.group(1)) for m in LOSS_RE.finditer(f.read())]
    print(json.dumps({
        "probe": "pretrain", "network": a.network, "image_size": a.image_size,
        "embed": a.embed, "epochs": a.epochs, "lr": a.lr,
        "median_norm_init": _median_norm(
            _port_net(a.network, a.embed, a.image_size, state), root),
        "median_norm_jax": _median_norm(
            _port_net(a.network, a.embed, a.image_size, jstate), root),
        "median_norm_port": _median_norm(_port_net(
            a.network, a.embed, a.image_size,
            torch.load(os.path.join(tout, "backbone.pth"))), root),
        "max_logged_loss_diff": float(np.max(np.abs(
            np.array(losses["jax"]) - np.array(losses["port"])))),
        "losses_jax": losses["jax"], "losses_port": losses["port"]}), flush=True)


ROUND_RES = {"xnorm": re.compile(r"\[agedb_30\]\[\d+\]XNorm: (\S+)"),
             "acc": re.compile(r"\[agedb_30\]\[\d+\]Accuracy-Flip: ([0-9.]+)"),
             "loss": re.compile(r"round \d+ (?:\(parallel\) )?avg client loss (\S+)")}


def _rounds(run_dir):
    with open(os.path.join(run_dir, "training.log")) as f:
        text = f.read()
    return {k: [float(v) for v in r.findall(text)] for k, r in ROUND_RES.items()}


def probe_init_fc(a, work):
    paths = conv.chain_paths(work, 8)
    conv.prepare_data(paths, image_size=a.image_size, num_clients=2, num_ids=8,
                      imgs_per_id=10, pub_ids=4, n_pairs=48)
    root = os.path.join(work, "root")
    os.makedirs(root)
    save_native(_jax_init(a.network, a.embed, a.image_size), os.path.join(root, "backbone.npz"))

    def argv(out):
        return ["--network", a.network, "--embedding_size", str(a.embed),
                "--image_size", str(a.image_size), "--output_dir", out,
                "--batch_size", "8", "--com_batch_size", "16", "--public_batch_size", "32",
                "--eval_batch_size", "32", "--local_epoch", "2", "--total_round",
                str(a.rounds), "--num_client", "2", "--num_ids", "8", "--lr", "0.001",
                "--add_pretrained_data", "--combine_dataset", "--contrastive_bb",
                "--return_all", "--BCE_local", "--adaptive_local_epoch", "--init_fc",
                "--pretrained_root", root, "--rec_root", paths["out"],
                "--local_rec", paths["veri"], "--val_root", paths["val"],
                "--num_workers", "2", "--round_ckpt_every", "0", "--client_ckpt_every", "0"]

    for mod in (jax_train, port_train):  # fp32 on both sides unless --bf16
        build = mod.build_config

        def build_config(args, build=build):
            cfg = build(args)
            cfg.model.bf16 = a.bf16
            return cfg
        mod.build_config = build_config
    out = {"probe": "init_fc", "network": a.network, "image_size": a.image_size,
           "embed": a.embed, "rounds": a.rounds, "bf16": a.bf16}
    if not a.port_only:
        jargs = port_train.build_parser().parse_args(argv(os.path.join(work, "jax")))
        jax_train.main(jargs)
        out["jax"] = _rounds(os.path.join(work, "jax"))
    t = port_train.setup(port_train.build_parser().parse_args(
        argv(os.path.join(work, "port")) + ["--device", "cpu"]))
    if not a.port_only:
        jcfg = jax_train.build_config(jargs)
        jcfg.runtime.output_dir = os.path.join(work, "jax_heads")
        js = JServer(jcfg, JData(jcfg, include_public=True))
        for c, jc in zip(t.server.clients, js.clients):
            st = interop.client_state(a.network, np.array(jc.fc_local),
                                      jax.tree_util.tree_map(np.array, jc.bce_vars),
                                      jax.tree_util.tree_map(np.array, jc.last_backbone))
            c.fc_local, c.bce_state, c.last_backbone = (
                st["fc_local"], st["bce_state"], st["last_backbone"])

            def flip_fn(step_no, imgs, cid=c.cid):
                key = jax.random.fold_in(_run_key(100, t.server.global_round, cid), step_no)
                return np.asarray(flip_mask(key, imgs.shape[0]))
            c.flip_fn = flip_fn
    try:
        while not t.done:
            port_train.run_round(t)
    finally:
        t.ckpt.wait()
    port_train.finish(t)
    out["port"] = _rounds(os.path.join(work, "port"))
    print(json.dumps(out), flush=True)


def probe_toy_chain(a, work):
    for seed in range(a.seeds):
        for init in ("port", "jax"):
            d = os.path.join(work, f"{init}{seed}")
            root = None
            if init == "jax":
                root = os.path.join(d, "init")
                os.makedirs(root)
                save_native(_jax_init("toy", 32, 24), os.path.join(root, "backbone.npz"))
            args = conv.build_parser().parse_args([
                "--work_dir", os.path.join(d, "chain"), "--network", "toy", "--embed", "32",
                "--image_size", "24", "--num_clients", "2", "--num_ids", "8",
                "--rounds", "3", "--local_epoch", "2", "--pretrain_epochs", "0",
                "--lr", "0.02", "--device", "cpu"])
            torch.manual_seed(seed)
            s = conv.run_chain(args, pub_ids=4, n_pairs=48, pretrained_root=root,
                               train_extra=["--public_batch_size", "16",
                                            "--eval_batch_size", "16", "--HN_threshold", "-1"])
            print(json.dumps({"probe": "toy_chain", "seed": seed, "init": init,
                              "criteria": s["criteria"],
                              "acc": [x for _, x in s["agedb_per_round"]],
                              "xnorm": s["xnorm_per_round"]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=["pretrain", "init_fc", "toy_chain"])
    ap.add_argument("--network", default="toy")
    ap.add_argument("--image_size", type=int, default=24)
    ap.add_argument("--embed", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--port_only", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="torch_dynamics_") as work:
        {"pretrain": probe_pretrain, "init_fc": probe_init_fc,
         "toy_chain": probe_toy_chain}[a.probe](a, work)


if __name__ == "__main__":
    main()
