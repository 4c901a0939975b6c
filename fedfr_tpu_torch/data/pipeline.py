"""Host->device input pipeline: background decode + pinned, asynchronous copies.

The port's counterpart of ``fedfr_tpu/data/pipeline.py``: a producer thread
runs the BatchLoader epoch (threaded decode; a native batch is decoded
straight into page-locked host memory, a Python-path batch is pinned by a
copy) and issues ``.to(device, non_blocking=True)``, keeping ``depth``
batches in flight so the device never waits on host decode.  uint8 on the
wire; normalization and augmentation happen inside the train step.

The copies go on the device's current stream, so they are ordered before
the compute that the consumer enqueues after taking a batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import torch


def prefetched(iterable, depth: int = 2):
    """Pull items from ``iterable`` in a background thread with ``depth``
    lookahead.

    Safe against an abandoned consumer (an exception in the consuming loop
    body, GeneratorExit): a stop event + bounded puts keep the producer from
    blocking forever on a full queue, the sentinel delivery is guaranteed,
    and the producer is joined before this generator returns.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    error: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterable:
                if not put(item):
                    return
        except Exception as e:  # re-raised in the consumer below
            error.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
    finally:  # also runs on GeneratorExit (abandoned iteration)
        stop.set()
        while True:  # drain so the producer's bounded put unblocks
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join()
    if error:
        raise error[0]


def to_device_batch(parts, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """numpy batch parts -> device tensors (pinned + non_blocking on CUDA).

    A part that is a tensor already (a ``synth:`` batch, generated on the
    device, or a native batch decoded into pinned host memory) is moved as
    it is, with no second host copy: ``Tensor.to`` returns a tensor already
    on ``device`` as it is."""
    out = []
    for p in parts:
        if isinstance(p, torch.Tensor):
            out.append(p.to(device, non_blocking=True))
            continue
        t = torch.from_numpy(p)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


class DevicePrefetcher:
    """Iterate (device_images, device_labels, device_valid) with lookahead."""

    def __init__(self, loader, device: torch.device, depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = max(1, depth)
        # a native loader feeding a card decodes into pinned memory
        loader.pin_memory = self.device.type == "cuda"

    def __len__(self) -> int:
        return len(self.loader)

    def epoch(self, **epoch_kwargs) -> Iterator[Tuple[torch.Tensor, ...]]:
        """One epoch of the loader's batches on the device; ``epoch_kwargs``
        go to the loader's ``epoch`` (``with_positions``)."""
        batches = (to_device_batch(parts, self.device)
                   for parts in self.loader.epoch(**epoch_kwargs))
        yield from prefetched(batches, self.depth)
