"""Model FLOPs of one image of FedFR's local step (the MOON recompute
form) and of one image of an embed.

A step: the trained forward F, its backward 2F less the stem's input
gradient, the frozen global and last-round forwards 2F, and the heads:
cosine logits over C = local + global FC rows, the BCE converter (E x E)
and its local rows, each 2 E n forward and twice that backward.  Nothing
recomputed is counted.  An embed: F and the BCE converter."""

from __future__ import annotations


def step_flops(net, cfg, n_local: int, n_global: int) -> float:
    e = cfg["embedding_size"]
    f = net.forward_flops(cfg)
    heads = 6.0 * e * (n_local + n_global + e + n_local)
    return 5.0 * f - net.stem_dgrad_flops(cfg) + heads


def embed_flops(net, cfg) -> float:
    e = cfg["embedding_size"]
    return net.forward_flops(cfg) + 2.0 * e * e
