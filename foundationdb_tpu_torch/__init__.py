"""PyTorch + CUDA port of the Resolver's conflict set.

A second package beside ``foundationdb_tpu`` (the JAX reference, which it
never imports).  Module names mirror the reference so each counterpart is
easy to find:

  conflict/api.py            ConflictSet: the resolver's entry point (CPU
                             mirror, circuit breaker, pipeline)
  conflict/engine_cpu.py     the chunked CPU mirror and its snapshots
  conflict/device_faults.py  fault injection and the circuit breaker
  conflict/engine_torch.py   TorchConflictSet + the flat device step
  conflict/kernels.py        wrappers of the two hand-written Hopper
                             kernels, each with its plain PyTorch twin
  conflict/csrc/*.cu         the CUDA C++ kernels (built at first use)
  parallel/sharded_resolver.py  ShardedTorchConflictSet: the key space cut
                             into shards on one device, per-shard mirrors
                             and circuit breakers
  ops/rangequery.py          multiword search + sparse-table range max/min
  ops/stabbing.py            dyadic segment-tree interval stabbing
  flow/spans.py, trace.py, flight_recorder.py  the span layer, trace
                             events and the flight recorder the conflict
                             sets report to (module globals)
  metrics.py                 counters and gauges (MetricsRegistry)

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from .conflict.api import ConflictSet
from .conflict.engine_torch import PackedBatch, TorchConflictSet
from .device import resolve_device
from .parallel.sharded_resolver import ShardedTorchConflictSet

__all__ = ["ConflictSet", "PackedBatch", "ShardedTorchConflictSet", "TorchConflictSet",
           "resolve_device"]
