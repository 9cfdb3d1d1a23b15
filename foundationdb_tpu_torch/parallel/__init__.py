"""Range-sharded conflict resolution (the port of ``foundationdb_tpu.parallel``):
``ShardedTorchConflictSet``, S key-range shards on one device, each with its
own mirror and circuit breaker."""

from .sharded_resolver import ShardedTorchConflictSet, uniform_int_split_keys

__all__ = ["ShardedTorchConflictSet", "uniform_int_split_keys"]
