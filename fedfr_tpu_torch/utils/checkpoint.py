"""Read the weights files the port evaluates and fine-tunes.

* ``.pth`` — a ``torch.save`` of a state_dict in the reference key layout:
  the port's own exports, the reference's, and the JAX package's
  (``pretrain.py`` writes ``backbone.pth`` for sphnet/iresnet).
* ``.npz`` — the JAX package's native format, a flat npz of a variable
  tree: ``pretrain.py``'s ``backbone.npz`` for nets with no torch layout
  (toy, or another input size) and ``Server.save_client_checkpoints``'s
  ``bce_module.npz`` for a BottleBlock converter.  The port's copy of the
  format's reader (``fedfr_tpu/utils/checkpoint.py:23-84``): keys are the
  tree's path joined by ``/``, list indices are written ``#<i>`` (bare
  digits in older files), and dict keys that look like either are escaped
  with a leading ``=``.  The tree then goes through ``interop``.

``RoundCheckpointer`` writes and reads the resume state of a whole run in
the port's own format (``rounds/round_<K>.pt`` + ``round_<K>.meta.json``).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..interop import backbone_state_dict, bce_state_dict

StateDict = Dict[str, torch.Tensor]


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def convert(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.startswith("#") and k[1:].isdigit() for k in keys):
            return [convert(node[k]) for k in sorted(keys, key=lambda k: int(k[1:]))]
        if keys and all(k.isdigit() for k in keys):
            return [convert(node[k]) for k in sorted(keys, key=int)]
        return {k[1:] if k.startswith("=") else k: convert(v)
                for k, v in node.items()}

    return convert(root)


def load_native(path: str) -> Any:
    """A JAX-package ``.npz`` -> its tree of numpy arrays."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        return _unflatten({k: z[k] for k in z.files})


def load_pth(path: str):
    """A ``.pth`` of tensors (a state_dict, or one tensor: ``fc.pth``, the
    pretrain labels, the ``preCos_init_AN.pth`` cache), on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_backbone_state(network: str, path: str) -> StateDict:
    """A backbone's weights file (``.pth`` or ``.npz``) -> the port's
    state_dict for ``network``, on the CPU."""
    if path.endswith(".npz"):
        return backbone_state_dict(network, load_native(path))
    return load_pth(path)


def load_bce_state(path: str) -> StateDict:
    """A BCE module's weights file (``.pth`` or ``.npz``) -> the port's
    ``BCEModule`` state_dict, on the CPU."""
    if path.endswith(".npz"):
        return bce_state_dict(load_native(path))
    return load_pth(path)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class RoundCheckpointer:
    """Round-granular save and resume of a whole federated run (the JAX
    package's ``RoundCheckpointer``, ``fedfr_tpu/utils/checkpoint.py:102-320``,
    in the port's own format).

    A save holds the global state_dict, the global FC (``pretrained_fc``)
    and every client's ``fc_local``, BCE state and last backbone, as a
    ``torch.save`` of CPU tensors at ``<directory>/round_<K>.pt``; then
    ``round_<K>.meta.json`` with the global round and epoch, the local-epoch
    schedule, the client-sampling RNG's ``bit_generator.state`` and the
    caller's ``extra``.  The meta is written only once the data file is
    complete, and ``restore`` ignores a round without one, so a crash
    mid-write never leaves a round that is picked up.

    ``keep`` > 0 keeps the newest ``keep`` complete rounds after each save
    and sweeps data files without a meta.

    ``async_write`` copies the state to the host in ``save`` and hands it
    to one writer thread; at most one write is outstanding, and a writer's
    error is raised by the next ``save``, ``restore`` or ``wait``.

    ``bg_fetch`` (implies ``async_write``) moves the device-to-host copy
    into the writer thread too.  PyTorch tensors are mutable, so ``save``
    snapshots by reference only what the next round replaces with new
    tensors (the global FC, the clients' FC rows, BCE and last-backbone
    dicts, all of which a round rebinds) and clones on the device what it
    writes in place: the global state_dict, which ``load_state_dict`` after
    FedAvg overwrites.  The clones are enqueued on the current stream
    before any later write to the global model, so the snapshot holds the
    pre-round state.
    """

    def __init__(self, directory: str, keep: int = 0, async_write: bool = False,
                 bg_fetch: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write or bg_fetch
        self.bg_fetch = bg_fetch
        self.last_extra: dict = {}
        self._writer: Optional[threading.Thread] = None
        self._write_err: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def snapshot(self, server) -> dict:
        """The server's resume state: the global state_dict cloned on its
        device, every other tensor by reference (see the class docstring)."""
        state = {
            "global": {k: v.detach().clone()
                       for k, v in server.global_net.state_dict().items()},
            "pretrained_fc": (server.pretrained_fc
                              if server.pretrained_fc is not None
                              else torch.zeros(0)),
            "clients": {},
        }
        for c in server.clients:
            cs = {"fc_local": c.fc_local}
            if c.bce_state is not None:
                cs["bce"] = dict(c.bce_state)
            if c.last_backbone is not None:
                cs["last"] = dict(c.last_backbone)
            state["clients"][f"c{c.cid}"] = cs
        return state

    @staticmethod
    def _to_host(state: dict) -> dict:
        return _tree_map(lambda t: t.detach().to("cpu", copy=True), state)

    def _path(self, round_idx: int) -> str:
        return os.path.join(self.directory, f"round_{round_idx}")

    def save(self, server, extra: Optional[dict] = None) -> str:
        """Save the server's state as round ``server.global_round`` (the
        next round to run); returns the data file's path."""
        # join the previous write before taking a new copy: two full round
        # states are never held at once
        self.wait()
        state = self.snapshot(server)
        if not self.bg_fetch:
            state = self._to_host(state)
        path = self._path(server.global_round)
        meta = {"global_round": server.global_round,
                "global_epoch": server.global_epoch,
                "local_epoch": server.local_epoch,
                "train_decay": server.train_decay,
                # without the sampling RNG a resumed run with
                # client_sampled_ratio < 1 repeats the fresh run's draws
                "rng_state": server.rng.bit_generator.state,
                "extra": extra or {}}
        if self.async_write:
            self._writer = threading.Thread(
                target=self._write, args=([state], path, meta),
                name=f"round-ckpt-write-{server.global_round}", daemon=True)
            self._writer.start()
        else:
            self._write([state], path, meta)
            self.wait()  # raise in the caller, not later
        return path + ".pt"

    def _write(self, box: list, path: str, meta: dict) -> None:
        try:
            state = box.pop()
            if self.bg_fetch:
                state = self._to_host(state)
            torch.save(state, path + ".pt")
            with open(path + ".meta.json", "w") as f:
                json.dump(meta, f)
            self._prune()
        except Exception as e:  # raised in the caller by the next wait()
            self._write_err = e

    def wait(self) -> None:
        """Join the outstanding write (call before the process exits) and
        raise any error it hit."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_err is not None:
            err, self._write_err = self._write_err, None
            raise err

    def _rounds(self) -> list:
        return sorted(int(name[len("round_"):-len(".meta.json")])
                      for name in os.listdir(self.directory)
                      if name.startswith("round_") and name.endswith(".meta.json"))

    def _prune(self) -> None:
        if self.keep <= 0:
            return
        complete = self._rounds()
        for r in complete[:-self.keep]:
            for suffix in (".pt", ".meta.json"):
                try:
                    os.remove(self._path(r) + suffix)
                except FileNotFoundError:
                    pass
        # a crash mid-write leaves a round_K.pt with no meta: restore never
        # reads it, and this sweep keeps it from defeating the disk bound
        kept = set(complete[-self.keep:])
        for name in os.listdir(self.directory):
            if not (name.startswith("round_") and name.endswith(".pt")):
                continue
            stem = name[len("round_"):-len(".pt")]
            if stem.isdigit() and int(stem) not in kept:
                os.remove(os.path.join(self.directory, name))

    def latest(self) -> Optional[int]:
        """The newest complete round, or None."""
        rounds = self._rounds()
        return rounds[-1] if rounds else None

    def load(self, round_idx: int):
        """(state, meta) of a complete round, on the CPU."""
        path = self._path(round_idx)
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        return torch.load(path + ".pt", map_location="cpu", weights_only=True), meta

    def restore(self, server, round_idx: Optional[int] = None) -> int:
        """Load round ``round_idx`` (default: the newest complete one) into
        ``server``; returns it, or 0 when there is none.  The caller's
        ``extra`` is left in ``last_extra``."""
        self.wait()
        if round_idx is None:
            round_idx = self.latest()
        if round_idx is None:
            return 0
        state, meta = self.load(round_idx)
        dev = server.device
        server.global_net.load_state_dict(state["global"])
        if state["pretrained_fc"].numel():
            server.pretrained_fc = state["pretrained_fc"].to(dev)
        for c in server.clients:
            cs = state["clients"][f"c{c.cid}"]
            c.fc_local = cs["fc_local"].to(dev)
            if "bce" in cs:
                c.bce_state = {k: v.to(dev) for k, v in cs["bce"].items()}
            if "last" in cs:
                c.last_backbone = {k: v.to(dev) for k, v in cs["last"].items()}
        server.global_round = meta["global_round"]
        server.global_epoch = meta["global_epoch"]
        server.local_epoch = meta["local_epoch"]
        server.train_decay = meta["train_decay"]
        server.rng.bit_generator.state = meta["rng_state"]
        self.last_extra = meta.get("extra", {})
        return round_idx
