"""Committed structural fingerprints of the port's registered device programs.

The port's counterpart of the reference's ``tools/lint/jaxfingerprint.py``.
Each entry of ``conflict/programs.py``'s registry has one JSON file under
``tests/torch_fingerprints/``: an aten-op x size-class histogram of the
program's recorded CPU run (tools/lint/torchir.py), split by region
(``|kernel``, ``|compaction``), the sync summary (each kind of host read,
sanctioned or not, ``|kernel`` inside a kernel's region) and the canonical
signature.  The check diffs the current runs against the committed files,
so a change to a program's structure shows as a diff of those files, made
by the explicit update:

    python -m foundationdb_tpu_torch.tools.lint.torchir --update-baselines

Rewrites are deterministic (sorted keys, fixed layout): the same source
and the same torch give the same bytes.  A registered entry with no file
is an error, and so is a file with no registered entry (stale).  The
files are the CPU's; a run on another device (the card's torch version
and kernels differ) is compared for information only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from .torchir import _PKG_DIR, default_registry, walk_program


def size_class(dim: int, size_classes) -> str:
    """A dimension's class against the entry's descending thresholds."""
    if dim <= 0:
        return "scalar"
    for name, thr in size_classes:
        if dim >= thr:
            return f">={name}"
    return "small"


def fingerprint(entry, run=None) -> dict:
    """The structural fingerprint of one entry's recorded run (recorded on
    the CPU when not given)."""
    run = run if run is not None else walk_program(entry)
    ops: Dict[str, int] = {}
    syncs: Dict[str, Dict[str, int]] = {}
    for r in run.rows:
        key = f"{r.op}|{size_class(r.max_dim, entry.size_classes)}"
        if r.in_compaction:
            key += "|compaction"
        if r.in_kernel:
            key += "|kernel"
        ops[key] = ops.get(key, 0) + 1
        if r.sync is not None:
            s = syncs.setdefault(r.sync + ("|kernel" if r.in_kernel else ""),
                                 {"sanctioned": 0, "unsanctioned": 0})
            s["sanctioned" if r.sanctioned else "unsanctioned"] += 1
    return {
        "entry": entry.name,
        "static": {k: (v if isinstance(v, (int, str, bool)) else str(v))
                   for k, v in sorted(run.statics.items())},
        "signature": run.signature,
        "op_count": len(run.rows),
        "ops": dict(sorted(ops.items())),
        "syncs": dict(sorted(syncs.items())),
        "carried": list(entry.carried),
        "pinned": list(entry.pinned),
    }


def render(fp: dict) -> str:
    """The committed file's bytes."""
    return json.dumps(fp, indent=2, sort_keys=True) + "\n"


def baseline_dir() -> str:
    return os.path.join(os.path.dirname(_PKG_DIR), "tests", "torch_fingerprints")


def write_baselines(registry=None, dirpath: Optional[str] = None, runs=None) -> List[str]:
    """Rewrite every registered entry's file; the written paths, by entry."""
    reg = default_registry() if registry is None else registry
    d = dirpath or baseline_dir()
    os.makedirs(d, exist_ok=True)
    written = []
    for name in sorted(reg):
        path = os.path.join(d, f"{name}.json")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(render(fingerprint(reg[name], (runs or {}).get(name))))
        written.append(path)
    return written


def _flatten(d: dict, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def diff_fingerprints(base: dict, cur: dict) -> List[str]:
    """Field-level diff lines (empty when equal)."""
    fb, fc = _flatten(base), _flatten(cur)
    lines: List[str] = []
    for k in sorted(set(fb) | set(fc)):
        if k not in fb:
            lines.append(f"+ {k} = {fc[k]!r} (not in baseline)")
        elif k not in fc:
            lines.append(f"- {k} = {fb[k]!r} (gone from the current run)")
        elif fb[k] != fc[k]:
            lines.append(f"~ {k}: baseline {fb[k]!r} -> current {fc[k]!r}")
    return lines


def check_baselines(registry=None, dirpath: Optional[str] = None, runs=None) -> List[str]:
    """Every registered entry against its committed file; the problem
    lines (empty when clean).  Missing and stale files are problems."""
    reg = default_registry() if registry is None else registry
    d = dirpath or baseline_dir()
    problems: List[str] = []
    expected = set()
    for name in sorted(reg):
        expected.add(f"{name}.json")
        path = os.path.join(d, f"{name}.json")
        if not os.path.exists(path):
            problems.append(f"{name}: MISSING baseline {path}: a registered entry must ship "
                            f"a committed fingerprint (--update-baselines, then commit)")
            continue
        with open(path, encoding="utf-8") as fh:
            base = json.load(fh)
        cur = fingerprint(reg[name], (runs or {}).get(name))
        problems.extend(f"{name}: {line}" for line in diff_fingerprints(base, cur))
    if os.path.isdir(d):
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".json") and fn not in expected:
                problems.append(f"{fn}: STALE baseline (no registered entry: delete it or "
                                f"register the entry)")
    return problems
