"""The conflict engine's carried state, and its exchange with the reference.

The history a resolver carries across batches is the port's equivalent of
a model's weights: word-major sorted boundary keys, their versions relative
to a host-held base, the live row count, and the MVCC window floor.  The
reference engine holds the same state as (hkeys uint32 (kw1, h_cap), hvers
int32 (h_cap,), hcount, oldest, base); ``state_from_jax`` takes those numpy
arrays (exported from a reference engine) and returns the port's device
form, which ``TorchConflictSet.load_state`` adopts.
``TorchConflictSet.export_state`` gives back the same numpy form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .keys import to_device_words


@dataclass
class ConflictState:
    hkeys: torch.Tensor  # (kw1, h_cap) int32, device word encoding
    hvers: torch.Tensor  # (h_cap,) int32, relative to base
    hcount: int          # live rows
    oldest: int          # window floor, relative to base
    base: int            # absolute version of relative 0


def state_from_jax(hkeys_u32, hvers_i32, hcount, oldest, base,
                   device=None) -> ConflictState:
    """The port's device state from a reference engine's exported numpy
    arrays (``device=None`` means the GPU, as everywhere in the port)."""
    dev = resolve_device(device)
    hkeys_u32 = np.asarray(hkeys_u32, np.uint32)
    hvers_i32 = np.asarray(hvers_i32, np.int32)
    if hkeys_u32.ndim != 2 or hvers_i32.shape != (hkeys_u32.shape[1],):
        raise ValueError(
            f"inconsistent shapes: hkeys {hkeys_u32.shape}, hvers {hvers_i32.shape}"
        )
    return ConflictState(
        hkeys=torch.from_numpy(to_device_words(hkeys_u32).copy()).to(dev),
        hvers=torch.from_numpy(hvers_i32.copy()).to(dev),
        hcount=int(hcount),
        oldest=int(oldest),
        base=int(base),
    )
