"""The native reader feeding a card (no JAX here: the card's machine has
none, so run with ``python -m pytest --noconftest -m cuda``): a native
batch is decoded straight into pinned memory and reaches the card with no
second host copy."""


import numpy as np
import pytest
import torch

from fedfr_tpu_torch.data import codec, write_split
from fedfr_tpu_torch.data.datasets import BatchLoader, FaceRecordDataset
from fedfr_tpu_torch.data.pipeline import to_device_batch

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)


@pytest.mark.cuda
def test_native_batch_lands_in_pinned_memory_with_no_second_copy(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(0)
    write_split(str(tmp_path / "train.idx"), str(tmp_path / "train.rec"),
                [codec.encode_raw(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8))
                 for _ in range(8)], list(range(8)), num_classes=8)
    ds = FaceRecordDataset(str(tmp_path))
    assert ds.native
    with BatchLoader(ds, 8, shuffle=False, pin_memory=True) as loader:
        imgs, labels, valid = next(loader.epoch())
    assert isinstance(imgs, torch.Tensor) and imgs.is_pinned()
    np.testing.assert_array_equal(imgs.numpy(), ds.read_batch(np.arange(8))[0])

    def no_copy(self, *a, **k):
        raise AssertionError("a second host copy")
    monkeypatch.setattr(torch.Tensor, "pin_memory", no_copy)
    (dev,) = to_device_batch((imgs,), torch.device("cuda"))
    torch.cuda.synchronize()
    assert dev.is_cuda and torch.equal(dev.cpu(), imgs)
