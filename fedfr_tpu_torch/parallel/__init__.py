from .fedavg import (fedavg_on_fc, spreadout, spreadout_loss, stack_trees,
                     streaming_weighted_average, unstack_tree)

__all__ = ["fedavg_on_fc", "spreadout", "spreadout_loss", "stack_trees",
           "streaming_weighted_average", "unstack_tree"]
