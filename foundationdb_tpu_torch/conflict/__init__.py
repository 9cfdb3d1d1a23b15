"""MVCC conflict detection on the GPU (the port of ``foundationdb_tpu.conflict``).

Same semantics as the reference package: a step function key ->
last-committed-write version, too-old / history / intra-batch conflicts in
batch order, committed writes merged at ``now``, and the removeBefore
eviction rule.  Ported so far: ``ConflictSet`` (api.py) with its CPU
mirror, circuit breaker and pipeline around the single-device engine, in
both history modes (flat and tiered).
"""
