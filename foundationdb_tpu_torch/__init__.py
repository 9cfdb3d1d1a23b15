"""PyTorch + CUDA port of the Resolver's flat conflict step.

A second package beside ``foundationdb_tpu`` (the JAX reference, which it
never imports).  Module names mirror the reference so each counterpart is
easy to find:

  conflict/engine_torch.py   TorchConflictSet + the flat device step
  conflict/kernels.py        wrappers of the two hand-written Hopper
                             kernels, each with its plain PyTorch twin
  conflict/csrc/*.cu         the CUDA C++ kernels (built at first use)
  ops/rangequery.py          multiword search + sparse-table range max/min
  ops/stabbing.py            dyadic segment-tree interval stabbing

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from .conflict.engine_torch import PackedBatch, TorchConflictSet
from .device import resolve_device

__all__ = ["PackedBatch", "TorchConflictSet", "resolve_device"]
