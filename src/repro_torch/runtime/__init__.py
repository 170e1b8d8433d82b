"""Runtime of the port: the clique scheduler and multi-lane dispatch
(CUDA streams) of packed tile batches."""
from .clique_scheduler import (balanced_bins, schedule_batches,
                               schedule_tiles, tile_costs)
from .dispatch import (Dispatcher, ListDispatcher, dispatch_scheduled,
                       resolve_devices)
