from .fedavg import fedavg_on_fc, streaming_weighted_average

__all__ = ["fedavg_on_fc", "streaming_weighted_average"]
