"""Optimizer, schedules and int8 gradient compression of the port (the
reference's ``optim``)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, global_norm, tree_leaves,
                    tree_unflatten)
from .schedule import cosine_schedule, linear_schedule
from .compress import (int8_compress, int8_decompress, compressed_allreduce,
                       compressed_psum_tree)
