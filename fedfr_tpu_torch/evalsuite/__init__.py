from .local_eval import (
    LocalVerificationCallback,
    append_local_log,
    client_query_mask,
    local_11_roc,
    mean_tpr_tables,
    open_set_identification,
)
from .verification import BinVerificationCallback, load_bin

__all__ = [
    "BinVerificationCallback",
    "LocalVerificationCallback",
    "append_local_log",
    "client_query_mask",
    "load_bin",
    "local_11_roc",
    "mean_tpr_tables",
    "open_set_identification",
]
