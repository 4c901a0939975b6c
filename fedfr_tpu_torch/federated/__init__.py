from .client import Client
from .embed import (
    class_mean_features,
    embed_dataset,
    embed_flip_caches,
    hard_negative_mask,
    max_similarity,
)
from .server import Server
from .state import ClientTrainState, apply_hflip, normalize_images, train_preprocess
from .trainer import (
    StepMetrics,
    branch_step_for,
    init_client_state,
    make_branch_train_step,
    make_plain_train_step,
    use_cached_contrastive,
)

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
    "make_plain_train_step",
    "branch_step_for",
    "use_cached_contrastive",
    "class_mean_features",
    "embed_dataset",
    "embed_flip_caches",
    "hard_negative_mask",
    "max_similarity",
]
