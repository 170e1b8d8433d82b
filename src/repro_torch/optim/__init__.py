"""Optimizer and schedules of the port (the reference's ``optim``; its
int8 compressed all-reduce, a collective, belongs to sharding, ROADMAP
A13e)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, global_norm, tree_leaves,
                    tree_unflatten)
from .schedule import cosine_schedule, linear_schedule
