from .fedavg import (fedavg_on_fc, spreadout, spreadout_loss,
                     streaming_weighted_average)

__all__ = ["fedavg_on_fc", "spreadout", "spreadout_loss",
           "streaming_weighted_average"]
