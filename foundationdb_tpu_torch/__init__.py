"""PyTorch + CUDA port of the Resolver role and its conflict set.

A second package beside ``foundationdb_tpu`` (the JAX reference, which it
never imports).  Module names mirror the reference so each counterpart is
easy to find:

  server/resolver.py         Resolver: the role a proxy's
                             ResolveTransactionBatchRequest reaches (the
                             entry point), with server/interfaces.py's
                             request and reply types and
                             server/resolver_balancer.py's ShardBalancer
  flow/eventloop.py, future.py, asyncvar.py, error.py  the deterministic
                             actor runtime the role runs on
  rpc/network.py, stream.py  the simulated network and request streams
  client/types.py            the mutations state transactions carry
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
  flow/spans.py, trace.py, flight_recorder.py, timeseries.py  the span
                             layer, trace events, the flight recorder and
                             the registries' time series (module globals)
  metrics.py                 counters, gauges and histograms
                             (MetricsRegistry) and emit_metrics

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from .conflict.api import ConflictSet
from .conflict.engine_torch import PackedBatch, TorchConflictSet
from .device import resolve_device
from .parallel.sharded_resolver import ShardedTorchConflictSet
from .server.resolver import Resolver

__all__ = ["ConflictSet", "PackedBatch", "Resolver", "ShardedTorchConflictSet",
           "TorchConflictSet", "resolve_device"]
