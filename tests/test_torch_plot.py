"""The port's ROC plot helper (``fedfr_tpu_torch/utils/plot.py``) on the
curves of ``tests/test_utils.py::test_plot_roc_curves``, and the JAX
helper's figure from the same curves for scale."""

import os

import numpy as np
import pytest


def test_plot_roc_curves(tmp_path):
    pytest.importorskip("matplotlib")
    from fedfr_tpu.utils.plot import plot_roc_curves as jax_plot
    from fedfr_tpu_torch.utils.plot import plot_roc_curves

    rng = np.random.default_rng(0)
    fpr = np.sort(rng.random(50))
    tpr = np.sort(rng.random(50))
    curves = {"clientA": (fpr, tpr), "clientB": (fpr, tpr ** 2)}
    out = plot_roc_curves(curves, str(tmp_path / "roc.png"))
    assert out == str(tmp_path / "roc.png")
    assert os.path.exists(out) and os.path.getsize(out) > 1000
    # the same figure as the JAX helper's: the same PNG size in pixels
    want = jax_plot(curves, str(tmp_path / "roc_jax.png"))
    import matplotlib.image as mpimg
    assert mpimg.imread(out).shape == mpimg.imread(want).shape
