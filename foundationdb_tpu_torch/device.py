"""Default-device resolution for the port's entry points, and what a
CUDA error says about the card.

The rule is fixed: no argument means the GPU.  Without one, construction
raises — there is no silent fallback to the CPU.  The CPU runs only when
the caller asks for it by name (the tests do).

``is_lost_device`` decides whether a CUDA runtime error means the card was
lost or reset (LOST_DEVICE_CODES); only those reach the circuit breaker.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

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


# ---------------------------------------------------------------------------
# A lost or reset card
# ---------------------------------------------------------------------------

# The cudaError_t codes that mean the card itself went away or was reset:
# the port's counterpart of the reference's JaxRuntimeError at its dispatch
# and its pipelined sync, mapped to the breaker's DeviceUnavailable (or
# CompileFailed at a shape's first dispatch).  Every other code is a fault
# of the code (209: no kernel image for the card, 700: an illegal memory
# access, 710: a device-side assert) and propagates, so no kernel fault is
# ever served quietly from the CPU mirror.
LOST_DEVICE_CODES = {
    46: "cudaErrorDevicesUnavailable",
    100: "cudaErrorNoDevice",
    214: "cudaErrorECCUncorrectable",
    702: "cudaErrorLaunchTimeout",
}


class CudaError(RuntimeError):
    """A CUDA runtime call made by the port itself (a kernel launcher)
    failed; ``code`` is the integer cudaError_t it returned."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = int(code)


@functools.lru_cache(maxsize=1)
def _cudart_library():
    """The CUDA runtime torch loaded, through ctypes (for
    cudaGetErrorName, which torch does not bind), or None."""
    names = [None]
    if torch.version.cuda:
        names.append(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            for fn in (lib.cudaGetErrorName, lib.cudaGetErrorString):
                fn.argtypes = [ctypes.c_int]
                fn.restype = ctypes.c_char_p
            return lib
        except (OSError, AttributeError):
            continue
    return None


@functools.lru_cache(maxsize=None)
def cuda_error_string(code: int) -> Optional[str]:
    """``cudaGetErrorString(code)`` from the card's runtime, asked at first
    use (torch's binding, else the library through ctypes); None where this
    torch has no CUDA runtime.  Neither asks the card, which may be gone."""
    if torch.version.cuda is None:
        return None
    try:
        rt = torch.cuda.cudart()
        return rt.cudaGetErrorString(rt.cudaError(int(code)))
    except (AttributeError, TypeError, ValueError, RuntimeError):
        lib = _cudart_library()
        return None if lib is None else lib.cudaGetErrorString(int(code)).decode()


@functools.lru_cache(maxsize=None)
def cuda_error_name(code: int) -> Optional[str]:
    """``cudaGetErrorName(code)`` from the card's runtime, or None."""
    lib = None if torch.version.cuda is None else _cudart_library()
    return None if lib is None else lib.cudaGetErrorName(int(code)).decode()


def cuda_error_code(e: BaseException) -> Optional[int]:
    """The cudaError_t an exception carries: the launcher's ``CudaError.code``
    or, where torch sets it, ``torch.AcceleratorError.error_code``."""
    code = getattr(e, "code" if isinstance(e, CudaError) else "error_code", None)
    return code if isinstance(code, int) else None


def is_lost_device(e: BaseException) -> bool:
    """True when ``e`` says the card was lost or reset (LOST_DEVICE_CODES):
    a launcher's CudaError or a torch.AcceleratorError by its code, or, an
    AcceleratorError that carries none, by the runtime's own string for the
    code on its ``CUDA error: ...`` line.  Anything else is False."""
    if not isinstance(e, (CudaError, torch.AcceleratorError)):
        return False
    code = cuda_error_code(e)
    if code is not None:
        return code in LOST_DEVICE_CODES
    lines = str(e).splitlines()
    said = next((ln[len("CUDA error: "):] for ln in lines if ln.startswith("CUDA error: ")), None)
    return said is not None and any(said == cuda_error_string(c) for c in LOST_DEVICE_CODES)
