"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), cached in
``foundationdb_tpu_torch/_build/`` under a name that carries a hash of the
source and the flags: an edited source rebuilds, an unchanged one loads.
Libraries load with ``ctypes``; every C entry takes device pointers and the
CUDA stream as ``c_void_p`` and returns a ``cudaError_t`` (0 on success).

Nothing here runs at import.  ``load`` builds on first use; ``build_all``
starts one ``nvcc`` per stale source, all at once, and waits for them.
A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..metrics import wall_now

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("phase1_search", "merge_evict")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_ptr, _c_i64, _c_int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# C signatures of every entry point, by library.
SIGNATURES = {
    "phase1_search": {
        # h_keys, n, q_keys, q_side, ranks, m, kw1, stream
        "phase1_ranks_launch": (
            _c_ptr, _c_i64, _c_ptr, _c_ptr, _c_ptr, _c_i64, _c_int, _c_ptr,
        ),
    },
    "merge_evict": {
        # a_keys, a_vers, a_keep, na, b_keys, b_vers, b_keep, b_pos, nb,
        # merged_count, window, kw1, width, scratch, out_keys, out_vers,
        # out_count, faults, stream
        "fused_merge_evict_launch": (
            _c_ptr, _c_ptr, _c_ptr, _c_i64,
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_i64,
            _c_ptr, _c_ptr, _c_int, _c_i64,
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
        ),
        # na, nb, kw1, width -> bytes of scratch the launch needs
        "merge_scratch_bytes": (_c_i64, _c_i64, _c_int, _c_i64),
    },
}
# Entry points that return something other than a cudaError_t.
RESTYPES = {"merge_scratch_bytes": _c_i64}

_loaded: dict = {}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and /usr/local/cuda/bin)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every stale library in parallel; returns {name: compiler
    log} for the ones built (ptxas register/shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out,
        )
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if stale."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all((name,))
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = RESTYPES.get(fn, ctypes.c_int)
    _loaded[name] = lib
    return lib


def timed_build():
    """Build (if stale) and load every library; returns (seconds taken,
    {name: compiler log} of the libraries built)."""
    t0 = wall_now()
    logs = build_all()
    for name in SOURCES:
        load(name)
    return wall_now() - t0, logs
