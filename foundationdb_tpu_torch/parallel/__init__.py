"""Multi-resolver parallelism: key-range partitions as the leading
dimension of the conflict state on one card (REF:fdbserver/Resolver.actor.cpp's
key-range partitioning, SURVEY.md §2.6)."""

from .sharded import (ShardedConflictState, init_sharded_state,
                      make_partition_boundaries, make_sharded_resolve_step,
                      sharded_state_from_numpy, sharded_state_to_numpy)

__all__ = ["ShardedConflictState", "make_partition_boundaries",
           "make_sharded_resolve_step", "init_sharded_state",
           "sharded_state_from_numpy", "sharded_state_to_numpy"]
