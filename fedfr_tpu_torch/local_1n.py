"""Standalone personalized open-set 1:n evaluation helper.

The port's counterpart of the repository's ``local_1n.py`` (reference
local_1n.py:8-44): ``evaluation(query_feats, gallery_feats, mask)`` returns
the TPIR list at FPIR {1e-6, 1e-5, 1e-4, 1e-3}, with the
40-images-per-identity recall denominator.
"""

from .evalsuite.local_eval import open_set_identification


def evaluation(query_feats, gallery_feats, mask):
    """(q, E) query and (g, E) gallery features (numpy) and the (q,) mask
    of each query's gallery row (-1: not in the gallery) -> TPIR list."""
    result, _ = open_set_identification(query_feats, gallery_feats, mask)
    return result
