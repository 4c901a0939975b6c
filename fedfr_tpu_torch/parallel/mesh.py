"""Device meshes for the federated and model-parallel axes.

Counterpart of ``fedfr_tpu/parallel/mesh.py``: one logical mesh with the
axes ``(client, data, model)``:

* ``client`` — clients trained concurrently, each on its own slice
  (``Server.train_round_parallel``; FedAvg then gathers their states);
* ``data``   — data parallelism: replicated weights, batches and ROC rows
  split over the devices (``federated/embed.py``,
  ``ops/roc_histogram.py::pairwise_roc_histogram_sharded``);
* ``model``  — class sharding of the Partial FC (``model_mesh``;
  ``parallel/partial_fc.py``, the pretraining's batch and class shards).

The port has one controller, as the JAX package has: one process drives
every device of a mesh, and tensors move between devices with
``Tensor.to(device, non_blocking=True)`` (peer to peer between cards).  A
mesh is an explicit array of ``torch.device``s, and a device may appear in
it more than once: ``[cpu, cpu]`` exercises the sharding code on the CPU,
and two shards of ``cuda:0`` on a one-card machine.  The default device
list is every visible GPU once each (``torch.cuda.device_count()``, which
``CUDA_VISIBLE_DEVICES`` limits), or ``[cpu]`` on a machine without one.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

AXES = ("client", "data", "model")

DeviceLike = Union[str, torch.device]

# distinct modules a mesh keeps replicas of (the JAX embed keeps 8)
MAX_REPLICATED = 8


def as_device(device: DeviceLike) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(device: DeviceLike = "cuda") -> List[torch.device]:
    """The default device list of a run on ``device``: every visible GPU
    once each for ``cuda``, ``[cpu]`` for ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


class Mesh:
    """An array of devices over the axes ``("client", "data", "model")``.

    ``devices`` is an object array of ``torch.device``s of shape
    (client, data, model); ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does.  The mesh also keeps one replica of a
    module per device for ``replicas`` (at most ``MAX_REPLICATED`` modules,
    by identity)."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh has {len(AXES)} axes, got shape {devices.shape}")
        self.devices = devices
        self.axis_names = AXES
        self._replicas: Dict[int, Tuple[nn.Module, Dict[torch.device, nn.Module]]] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of the other axes, in
        order (a device may repeat)."""
        index = [0] * len(AXES)
        index[AXES.index(axis)] = slice(None)
        return list(self.devices[tuple(index)])

    def distinct_devices(self) -> List[torch.device]:
        """Every device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def replicas(self, module: nn.Module, axis: str = "data") -> List[nn.Module]:
        """One copy of ``module`` for each device along ``axis``, holding
        ``module``'s current parameters and buffers: ``module`` itself where
        the device is its own, elsewhere a copy kept on that device (made
        once per module identity) into which this call copies the current
        state.  Call it once per pass over the data, not per batch."""
        home = next(module.parameters()).device
        entry = self._replicas.get(id(module))
        if entry is None or entry[0] is not module:
            if len(self._replicas) >= MAX_REPLICATED:
                self._replicas.clear()
            entry = (module, {})
            self._replicas[id(module)] = entry
        kept = entry[1]
        out = []
        for dev in self.axis_devices(axis):
            if dev == home:
                out.append(module)
                continue
            if dev not in kept:
                kept[dev] = copy.deepcopy(module).to(dev)
            else:
                kept[dev].load_state_dict(module.state_dict())
            kept[dev].train(module.training)
            out.append(kept[dev])
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def group_by_slice(devices: Sequence[DeviceLike]) -> List[List[torch.device]]:
    """Devices grouped by TPU slice in the JAX package (a multi-slice
    deployment's DCN granule).  One host is one group: every device of a
    host falls into it."""
    return [[as_device(d) for d in devices]]


def make_mesh(shape: Optional[Tuple[int, int, int]] = None,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A (client, data, model) mesh over ``devices`` (default: every
    visible GPU, else the CPU).  The default shape puts every device on
    the ``client`` axis; a shape that does not cover the devices raises."""
    devs = [as_device(d) for d in (devices if devices is not None
                                   else visible_devices(_default_type()))]
    n = len(devs)
    if shape is None:
        shape = (n, 1, 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape))


def _default_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _first(num: Optional[int], devices: Optional[Sequence[DeviceLike]]) -> list:
    devs = list(devices if devices is not None else visible_devices(_default_type()))
    return devs[:num] if num is not None else devs


def data_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Every device on the ``data`` axis (the evaluation layout:
    replicated weights, batches and ROC rows split over the devices).
    ``devices`` defaults to every visible GPU; ``num_devices`` takes the
    first of them."""
    devs = _first(num_devices, devices)
    return make_mesh((1, len(devs), 1), devs)


def model_mesh(num_shards: Optional[int] = None,
               devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Every device on the ``model`` axis (the Partial FC's layout)."""
    devs = _first(num_shards, devices)
    return make_mesh((1, 1, len(devs)), devs)


_AUTO_MESHES: Dict[int, Mesh] = {}


def auto_data_mesh(device: DeviceLike) -> Optional[Mesh]:
    """The default data layout of a run on ``device`` (JAX
    ``auto_embed_fn`` and ``pairwise_roc_histogram``): a data mesh of every
    visible GPU when the run is on the card and the host has more than one,
    else None (the caller's device alone).  One mesh per GPU count, so that
    its replicas are kept across calls."""
    if torch.device(device).type != "cuda" or torch.cuda.device_count() < 2:
        return None
    n = torch.cuda.device_count()
    if n not in _AUTO_MESHES:
        _AUTO_MESHES[n] = data_mesh(n)
    return _AUTO_MESHES[n]


def replicated(mesh: Mesh, tensor: torch.Tensor, axis: str = "data") -> List[torch.Tensor]:
    """``tensor`` placed on every device along ``axis``: one tensor per
    device, ``tensor`` itself where it lies there already."""
    return [tensor.to(dev, non_blocking=True) for dev in mesh.axis_devices(axis)]


def shard_over(mesh: Mesh, tensor: torch.Tensor, axis: str = "data") -> List[torch.Tensor]:
    """``tensor`` split on its leading dimension into contiguous blocks of
    ceil(N / D) rows over the D devices along ``axis``, in order (the last
    blocks may be shorter or empty), each on its device."""
    devs = mesh.axis_devices(axis)
    step = -(-tensor.shape[0] // len(devs))
    return [tensor[d * step:(d + 1) * step].to(dev, non_blocking=True)
            for d, dev in enumerate(devs)]


def gathered(parts: Sequence[torch.Tensor], device: DeviceLike) -> torch.Tensor:
    """The all-gather of one shard: ``parts`` (one a shard) concatenated in
    shard order on ``device``.  Autograd's backward of it sums each part's
    gradient over the shards that gathered it (the transpose of JAX's
    ``all_gather``, a reduce-scatter)."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def reduced(parts: Sequence[torch.Tensor], device: DeviceLike) -> torch.Tensor:
    """The sum of ``parts`` (one a shard) on ``device``, added in shard
    order: ``((p0 + p1) + p2) + ...``, so that every run sums alike; one
    part is returned as it is."""
    out = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        out = out + p.to(device, non_blocking=True)
    return out


def synchronize(devices: Sequence[DeviceLike]) -> None:
    """Wait for every CUDA device of ``devices`` (once each)."""
    for dev in dict.fromkeys(as_device(d) for d in devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
