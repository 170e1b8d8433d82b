"""Runtime of the port: the fault-tolerant training loop, the clique
scheduler and multi-lane dispatch (CUDA streams) of packed tile batches."""
from .clique_scheduler import (balanced_bins, schedule_batches,
                               schedule_tiles, tile_costs)
from .dispatch import (Dispatcher, ListDispatcher, dispatch_scheduled,
                       resolve_devices)
from .train_loop import TrainLoop, TrainLoopConfig
