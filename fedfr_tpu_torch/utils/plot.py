"""ROC curve plotting (counterpart of ``fedfr_tpu/utils/plot.py``, the
reference utils/plot.py without its paths): numpy and matplotlib only."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def plot_roc_curves(curves: Dict[str, Tuple[np.ndarray, np.ndarray]],
                    out_path: str, title: str = "ROC",
                    xlim: Tuple[float, float] = (1e-6, 1e-1),
                    ylim: Tuple[float, float] = (0.3, 1.0)) -> str:
    """curves: name -> (fpr, tpr).  Saves a log-x ROC figure to
    ``out_path`` (6 x 5 in at 150 dpi, the JAX package's figure) and
    returns the path.  matplotlib is imported here, with the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    for name, (fpr, tpr) in curves.items():
        order = np.argsort(fpr)
        ax.plot(fpr[order], tpr[order], label=name, linewidth=1.5)
    ax.set_xscale("log")
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(loc="lower right", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
