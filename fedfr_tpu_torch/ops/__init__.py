from .losses import bce_loss, cosine_similarity, moon_contrastive, softmax_cross_entropy
from .margins import MARGINS, arcface, cosface, reweight_negatives
from .max_sim import max_cosine_similarity, max_cosine_similarity_plain
from .roc_hist import NUM_BINS, roc_histogram, roc_histogram_plain

__all__ = [
    "bce_loss",
    "cosine_similarity",
    "moon_contrastive",
    "softmax_cross_entropy",
    "MARGINS",
    "arcface",
    "cosface",
    "reweight_negatives",
    "max_cosine_similarity",
    "max_cosine_similarity_plain",
    "NUM_BINS",
    "roc_histogram",
    "roc_histogram_plain",
]
