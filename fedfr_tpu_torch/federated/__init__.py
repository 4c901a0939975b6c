from .client import Client
from .embed import (
    class_mean_features,
    embed_dataset,
    hard_negative_mask,
    max_similarity,
)
from .server import Server
from .state import ClientTrainState, apply_hflip, normalize_images, train_preprocess
from .trainer import StepMetrics, init_client_state, make_branch_train_step

__all__ = [
    "Client",
    "Server",
    "ClientTrainState",
    "StepMetrics",
    "apply_hflip",
    "normalize_images",
    "train_preprocess",
    "init_client_state",
    "make_branch_train_step",
    "class_mean_features",
    "embed_dataset",
    "hard_negative_mask",
    "max_similarity",
]
