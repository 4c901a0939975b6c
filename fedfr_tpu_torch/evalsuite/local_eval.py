"""Personalized (per-client) local evaluation: 1:1 ROC and 1:n retrieval.

The port's counterpart of ``fedfr_tpu/evalsuite/local_eval.py`` (the
reference's eval_local.py -> roc_cuda.py chain, and local_all.py:142-177
for 1:n): embedding, the all-pairs histogram ROC and open-set retrieval run
in the same process, and the features stay on the device until the
histogram.  Over a mesh (default: every visible GPU of a run on the card)
the embed splits its batches and the ROC its rows over the ``data`` axis.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..federated.embed import embed_dataset
from ..ops.roc_histogram import client_roc
from ..parallel.mesh import Mesh
from .openset import openset_thresholds

logger = logging.getLogger("fedfr_tpu_torch.local_eval")

StateDict = Dict[str, torch.Tensor]


def append_local_log(output_dir: str, start_id: int, end_id: int, epoch: int,
                     table: List[float]) -> None:
    """Same line format as roc_cuda.plot_ROC (roc_cuda.py:84-87) so
    parse_log.py keeps working."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "local_log.txt")
    with open(path, "a") as f:
        f.write("Target label from %d to %d\n" % (start_id, end_id - 1))
        f.write("Epoch %d, TPR (-1 to -6) = %r\n" % (epoch, table))


def local_11_roc(feats: torch.Tensor, labels: np.ndarray, start_id: int,
                 end_id: int, epoch: int = 0,
                 output_dir: Optional[str] = None,
                 mesh: Optional[Mesh] = None) -> List[float]:
    """One client's 1:1 TPR@FPR(-1..-6) table over the local veri set (the
    histogram's rows over ``mesh``, default the auto layout)."""
    table = client_roc(feats, labels, start_id, end_id, mesh)
    logger.info("Target label from %d to %d", start_id, end_id - 1)
    logger.info("Epoch %d, TPR (-1 to -6) = %r", epoch, table)
    if output_dir is not None:
        append_local_log(output_dir, start_id, end_id, epoch, table)
    return table


def mean_tpr_tables(tables: Sequence[Sequence[float]]) -> List[float]:
    """Average per-client tables; reported -6..-1 (local_all.py:433-453)."""
    arr = np.asarray(tables, dtype=np.float64)
    mean = arr.mean(axis=0)
    return [float("%.2f" % mean[len(mean) - 1 - i]) for i in range(len(mean))]


def open_set_identification(query_feats: np.ndarray, gallery_feats: np.ndarray,
                            mask: np.ndarray,
                            fars: Sequence[float] = (1e-6, 1e-5, 1e-4, 1e-3),
                            recall_denominator: Optional[int] = None
                            ) -> Tuple[List[float], List[float]]:
    """Personalized 1:n evaluation (reference local_all.py:142-177).

    ``mask[i]`` is the gallery index of query i's identity, or -1 for
    out-of-gallery probes.  TPIR@FPIR: thresholds are the top-k negative
    scores; recall denominator is 40*gallery by the reference's convention
    (40 veri images per identity).
    """
    g = gallery_feats.shape[0]
    sim = query_feats @ gallery_feats.T
    # sim is local and dead after this call -> skip the defensive copy
    pos_sims, ths = openset_thresholds(sim, mask, fars, inplace=True)
    denom = recall_denominator if recall_denominator is not None else 40 * g
    result = [float(np.sum(pos_sims > th)) / denom for th in ths]
    return result, list(fars)


def client_query_mask(labels: np.ndarray, start_id: int,
                      end_id: int) -> np.ndarray:
    """Build the query->gallery mask for one client (local_all.py:399-406).

    The reference slices rows positionally ([start_id*40, end_id*40)),
    relying on the veri rec's by-identity ordering with 40 imgs each; masking
    by label value is identical on that layout and also correct for any
    image-per-identity count.
    """
    labels = np.asarray(labels)
    in_client = (labels >= start_id) & (labels < end_id)
    return np.where(in_client, labels - start_id, -1).astype(np.int64)


class LocalVerificationCallback:
    """Per-round personalized 1:1 verification for sampled clients
    (reference CallBack_LocalVerifi, eval_local.py:74-105).

    ``net`` and ``bce_module`` are eval modules that this callback owns: each
    call loads the state to be evaluated into them, so the modules the
    clients train in are never touched.  ``veri_test`` embeds the veri set
    (through the BCE converter when a BCE state is given), builds the
    client's ROC histogram on the device and appends the table to
    ``<output_dir>/clients/client_<id>/local_log.txt``.  Both run over
    ``mesh``'s ``data`` axis (default the auto layout).
    """

    def __init__(self, net: nn.Module, bce_module: Optional[nn.Module],
                 veri_dataset, output_dir: str, batch_size: int = 512,
                 device="cuda", num_workers: int = 6, prefetch: int = 2,
                 mesh: Optional[Mesh] = None):
        self.net = net.eval().requires_grad_(False)
        self.bce_module = bce_module
        self.dataset = veri_dataset
        self.output_dir = output_dir
        self.batch_size = batch_size
        self.device = device
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.mesh = mesh
        self.client_record: dict = {}

    def veri_test(self, backbone_state: StateDict, global_step: int, id_list,
                  client_id: int, bce_state: Optional[StateDict] = None
                  ) -> List[float]:
        self.net.load_state_dict(backbone_state)
        converter = None
        if bce_state is not None:
            self.bce_module.load_state_dict(bce_state)
            converter = self.bce_module.converter
        feats, labels = embed_dataset(self.net, self.dataset, self.batch_size,
                                      l2norm=True, device=self.device,
                                      num_workers=self.num_workers,
                                      prefetch=self.prefetch,
                                      converter=converter, mesh=self.mesh)
        client_dir = os.path.join(self.output_dir, "clients",
                                  f"client_{client_id}")
        table = local_11_roc(feats, labels, id_list[0], id_list[-1] + 1,
                             epoch=global_step, output_dir=client_dir, mesh=self.mesh)
        self.client_record.setdefault(client_id, []).append((global_step, table))
        return table
