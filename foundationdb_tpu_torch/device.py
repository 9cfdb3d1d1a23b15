"""Default-device resolution for the port's entry points.

The rule is fixed: no argument means the GPU.  Without one, construction
raises — there is no silent fallback to the CPU.  The CPU runs only when
the caller asks for it by name (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises if no GPU is visible); anything else is
    taken as given (``"cpu"``, ``"cuda:1"``, a ``torch.device``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
