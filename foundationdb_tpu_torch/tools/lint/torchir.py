"""torchcheck: the structural check of the port's registered device programs.

The port's counterpart of the reference package's jaxcheck
(``tools/lint/jaxir.py``).  The reference traces its programs to jaxprs;
the port's programs are eager PyTorch, so the walker runs each program of
``conflict/programs.py``'s registry once, at its canonical shapes, under a
``TorchDispatchMode`` recorder, on the CPU (``walk_program(entry,
"cuda")`` on the card).  The program runs as the engine runs it: where it takes an
``on_sync`` scope, the fixpoint's host checks run inside
``g_hostguard.allowed()``, the engine's sanctioned sync.  Each aten op
gives one row (``OpRow``): its name, the largest dimension over its inputs
and outputs, its output dtypes and the largest dimension of a 64-bit
output, whether it ran inside a kernel wrapper's region (conflict/
regions.py: the CUDA launch or, on the CPU, the plain twin; a launch adds
a ``launch:<kernel>`` row) or the tiered step's major compaction, and for
a synchronizing op (a scalar read, ``nonzero``, a blocking copy between
host and device) whether a sanctioned scope allowed it.

Rules, each against the entry's registered metadata:

  TGX001  (JXP001) a work op (sort, cumsum, cat, scatter, index_add,
          scatter_reduce, reductions) at or above the history's width
          outside the compaction region of a compaction-gated entry, or
          wider than the entry's work bound.  A kernel's region is exempt:
          on the card it holds the launch of a tile-bounded kernel, on the
          CPU the plain twin that stands for it.
  TGX002  (JXP002) a sync outside a sanctioned scope (kernel regions
          exempt as above: the kernels do not sync).
  TGX004  (JXP004) a 64-bit result on a buffer at least as wide as the
          history: 8 bytes a row where int32 takes 4.  torch's index ops
          take int64 indices, so these are expected; each goes or carries
          a reasoned pragma.
  TGX005  (JXP005) a registered bucket dimension that is not on the
          bucket table (a power of two at or above its floor), or that
          appears nowhere in the program's canonical signature.

JXP003 (donation) has no rule: the port updates its carried tensors in
place and has nothing to donate, and ``program_cost_table``'s ``temp``
measures the memory a program holds above its arguments and outputs.

Pragmas: ``# torchcheck: ignore[TGX00n]: reason`` on the factory's def
lines suppresses that rule for exactly that entry.  A pragma with no
reason still suppresses and adds PRG001; one that suppresses nothing or
names an unknown rule adds PRG002 (``base.apply_pragmas``, as perfcheck).  Fingerprints (``torchfingerprint.py``) are the companion gate:
one committed file an entry under ``tests/torch_fingerprints/``.

CLI: ``python -m foundationdb_tpu_torch.tools.lint.torchir
[--format=text|json] [--update-baselines] [--no-fingerprints]
[--list-rules] [--baseline-dir=DIR]``, on the CPU; exit 0 iff no finding
is unsuppressed and every fingerprint matches its baseline.
"""

from __future__ import annotations

import argparse
import ast
import inspect
import json
import os
import sys
import textwrap
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .base import Finding, apply_pragmas, parse_pragmas

TORCH_RULES: Dict[str, str] = {
    "TGX001": "work op at or above the history's width outside the compaction region / "
              "above the entry's work bound",
    "TGX002": "host sync outside a sanctioned sync scope",
    "TGX004": "64-bit result on a buffer as wide as the history",
    "TGX005": "static dimension outside the shape-bucket table or absent from the signature",
    "PRG001": "torchcheck ignore pragma carries no reason",
    "PRG002": "torchcheck ignore pragma suppresses nothing (stale)",
}

# aten ops (overload packet names) that do O(n) work over their operands,
# as against gathers, elementwise ops and views.
WORK_OPS = frozenset({
    "sort", "argsort", "cumsum", "cat", "scatter", "scatter_", "scatter_add",
    "scatter_add_", "scatter_reduce", "scatter_reduce_", "index_add", "index_add_",
    "index_put", "index_put_", "sum", "amax", "amin", "max", "min", "any", "all",
    "prod", "argmax", "argmin",
})

# aten ops that read a device value back to the host.
SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "nonzero", "masked_select", "_unique2", "unique_dim",
    "unique_consecutive", "bincount", "equal", "is_nonzero",
})

_64BIT = frozenset({"torch.int64", "torch.uint64", "torch.float64", "torch.complex128"})

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------


@dataclass
class OpRow:
    """One aten op of a program's run (or one kernel launch)."""

    op: str
    max_dim: int
    out_dtypes: Tuple[str, ...]
    wide64_dim: int
    in_kernel: bool
    in_compaction: bool
    sync: Optional[str] = None  # the kind of host read, None if none
    sanctioned: bool = False  # a sync inside g_hostguard.allowed()


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_flatten

    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _largest(t) -> int:
    return max(t.shape) if t.dim() else 0


def _sync_kind(op: str, args, kwargs, outs) -> Optional[str]:
    """The kind of host read an op makes, or None."""
    import torch

    if op in SYNC_OPS:
        return op
    if op in ("index", "index_put", "index_put_"):
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx or ()):
            return f"{op}[bool]"  # a boolean mask index is a nonzero
    if op in ("copy_", "_copy_from", "_to_copy"):
        if op == "_to_copy":
            src, dst = args[0], outs[0]
            blocking = not kwargs.get("non_blocking", False)
        else:
            # copy_(dst, src, non_blocking), _copy_from(src, dst, non_blocking)
            dst, src = (args[0], args[1]) if op == "copy_" else (args[1], args[0])
            blocking = not (args[2] if len(args) > 2 else kwargs.get("non_blocking", False))
        if blocking and src.device.type != dst.device.type:
            return "copy_to_host" if dst.device.type == "cpu" else "copy_to_device"
    return None


class _Recorder:
    """The dispatch-mode recorder and the regions' observer."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        recorder = self
        self.rows: List[OpRow] = []
        self._kernel: List[str] = []
        self._compaction = 0

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                recorder._record(func, args, kwargs, out)
                return out

        self.mode = _Mode()

    # -- the regions' observer (conflict/regions.py) --
    def enter(self, kind: str, name: str) -> None:
        if kind == "kernel":
            self._kernel.append(name)
        else:
            self._compaction += 1

    def exit(self, kind: str, name: str) -> None:
        if kind == "kernel":
            self._kernel.pop()
        else:
            self._compaction -= 1

    def launch(self, name: str) -> None:
        self.rows.append(OpRow(f"launch:{name}", 0, (), 0, True, self._compaction > 0))

    def _record(self, func, args, kwargs, out) -> None:
        from ...flow.hotpath import g_hostguard

        op = func.overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        wide = [t for t in outs if str(t.dtype) in _64BIT]
        sync = _sync_kind(op, args, kwargs, outs)
        self.rows.append(OpRow(
            op=op,
            max_dim=max((_largest(t) for t in ins + outs), default=0),
            out_dtypes=tuple(str(t.dtype).replace("torch.", "") for t in outs),
            wide64_dim=max((_largest(t) for t in wide), default=0),
            in_kernel=bool(self._kernel),
            in_compaction=self._compaction > 0,
            sync=sync,
            sanctioned=sync is not None and not g_hostguard.blocking(),
        ))


def _takes_on_sync(fn) -> bool:
    try:
        return "on_sync" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


@dataclass
class ProgramRun:
    """One entry's recorded run: its rows and canonical signature."""

    entry: object
    rows: List[OpRow]
    signature: List[str]
    statics: dict
    sig_dims: set = field(default_factory=set)


def _sig(a) -> str:
    import torch

    if isinstance(a, torch.Tensor):
        return f"{str(a.dtype).replace('torch.', '')}[{','.join(str(d) for d in a.shape)}]"
    return type(a).__name__


def walk_program(entry, device="cpu") -> ProgramRun:
    """Run one registered program once at its canonical shapes under the
    recorder and return its rows."""
    import torch

    from ...conflict import regions
    from ...flow.hotpath import g_hostguard

    fn, args, statics = entry.factory(torch.device(device))
    call = dict(statics)
    if _takes_on_sync(fn):
        call["on_sync"] = g_hostguard.allowed
    rec = _Recorder()
    prev, regions.OBSERVER = regions.OBSERVER, rec
    try:
        with rec.mode:
            fn(*args, **call)
    finally:
        regions.OBSERVER = prev
    sig_dims = {d for a in args if isinstance(a, torch.Tensor) for d in a.shape}
    sig_dims |= {v for v in statics.values() if isinstance(v, int) and not isinstance(v, bool)}
    return ProgramRun(entry, rec.rows, [_sig(a) for a in args], statics, sig_dims)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _where(entry) -> Tuple[str, int, List[int]]:
    """(path, def line, the def's line numbers) of an entry's factory."""
    fn = entry.factory
    path = inspect.getsourcefile(fn)
    lines, start = inspect.getsourcelines(fn)
    tree = ast.parse(textwrap.dedent("".join(lines)))
    node = tree.body[0]
    last = node.body[0].lineno - 1 if node.body else len(lines)
    def_lines = list(range(start, start + max(1, last)))
    rel = os.path.relpath(path, _PKG_DIR)
    return (path if rel.startswith("..") else rel), start, def_lines


def _next_pow2(n: int, floor: int) -> int:
    p = max(floor, 1)
    while p < n:
        p *= 2
    return p


def run_rules(run: ProgramRun, path: str, line: int) -> List[Finding]:
    """TGX001-005 over one recorded program (raw, before pragmas)."""
    ep = run.entry
    out: List[Finding] = []

    def add(rule, msg):
        out.append(Finding(rule, path, line, 0, msg, entry=ep.name))

    for r in run.rows:  # TGX001
        if r.op not in WORK_OPS or r.in_kernel:
            continue
        if ep.compaction_gated and not r.in_compaction and r.max_dim >= ep.h_threshold:
            add("TGX001", f"history-wide work outside the compaction region: {r.op} over "
                          f"dim {r.max_dim} (history width {ep.h_threshold})")
        elif ep.work_bound is not None and r.max_dim > ep.work_bound:
            add("TGX001", f"work op above the entry's work bound: {r.op} over dim "
                          f"{r.max_dim} (bound {ep.work_bound})")
    syncs: Dict[str, int] = {}
    for r in run.rows:  # TGX002
        if r.sync is not None and not r.sanctioned and not r.in_kernel:
            syncs[r.sync] = syncs.get(r.sync, 0) + 1
    for kind, n in sorted(syncs.items()):
        add("TGX002", f"host sync outside a sanctioned scope: {kind} x{n}")
    wide: Dict[Tuple[str, Tuple[str, ...]], List[int]] = {}
    for r in run.rows:  # TGX004
        if r.in_kernel or r.wide64_dim < ep.h_threshold:
            continue
        slot = wide.setdefault((r.op, tuple(d for d in r.out_dtypes if "64" in d)), [0, 0])
        slot[0] += 1
        slot[1] = max(slot[1], r.wide64_dim)
    for (op, dts), (n, dim) in sorted(wide.items()):
        add("TGX004", f"64-bit result on a history-wide buffer: {op} -> {','.join(dts)} "
                      f"over dim {dim} (x{n})")
    for nm, (val, floor) in sorted(ep.bucket_dims.items()):  # TGX005
        if _next_pow2(val, floor) != val:
            add("TGX005", f"static dim {nm}={val} is outside the shape-bucket table "
                          f"(a power of two >= {floor})")
        elif val not in run.sig_dims:
            add("TGX005", f"registered bucket dim {nm}={val} appears nowhere in the "
                          f"program's signature {sorted(run.sig_dims)}: the registry has "
                          f"drifted from the program")
    return out


def _police(findings: List[Finding], entry, path: str, def_lines: List[int],
            src: str) -> List[Finding]:
    """Suppress an entry's findings by the torchcheck pragmas on its
    factory's def lines, and police those pragmas (PRG001, PRG002), as
    perfcheck does its own."""
    found = parse_pragmas(src, tool="torchcheck")
    pragmas = {ln: found[ln] for ln in def_lines if ln in found}
    for f in findings:
        f.end_line = def_lines[-1]  # every finding sits on the def line
    out = apply_pragmas(findings, pragmas, path, rules=TORCH_RULES)
    for f in out:
        f.entry = entry.name
    return out


def default_registry():
    """The real registry: importing the modules registers their entries."""
    from ...conflict.programs import DEVICE_ENTRY_POINTS
    from ...parallel import sharded_resolver  # noqa: F401  (the sharded steps)

    return DEVICE_ENTRY_POINTS


def run_torchcheck(registry=None, device="cpu",
                   runs: Optional[Dict[str, ProgramRun]] = None) -> List[Finding]:
    """The whole check over a registry: run every program on `device`,
    apply the rules and the pragmas.  ``runs`` (name -> ProgramRun) reuses
    recorded runs."""
    reg = default_registry() if registry is None else registry
    out: List[Finding] = []
    for name in sorted(reg):
        ep = reg[name]
        run = runs[name] if runs is not None and name in runs else walk_program(ep, device)
        path, line, def_lines = _where(ep)
        with open(inspect.getsourcefile(ep.factory), encoding="utf-8") as fh:
            src = fh.read()
        out.extend(_police(run_rules(run, path, line), ep, path, def_lines, src))
    out.sort(key=lambda f: (f.path, f.line, f.entry, f.rule, f.message))
    return out


def count_by_rule(findings: List[Finding]) -> Dict[str, dict]:
    counts: Dict[str, dict] = {}
    for f in findings:
        c = counts.setdefault(f.rule, {"unsuppressed": 0, "suppressed": 0})
        c["suppressed" if f.suppressed else "unsuppressed"] += 1
    return dict(sorted(counts.items()))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="torchcheck",
        description="Structural check of the port's registered device programs "
                    "(TGX rules and committed fingerprints).")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--no-fingerprints", action="store_true",
                    help="skip the fingerprint diff")
    ap.add_argument("--update-baselines", action="store_true",
                    help="rewrite the committed fingerprints instead of diffing them")
    ap.add_argument("--baseline-dir", help="fingerprint directory (default: "
                    "tests/torch_fingerprints beside the package)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in TORCH_RULES.items():
            print(f"{rule}  {desc}")
        return 0
    from . import torchfingerprint as tfp

    reg = default_registry()
    runs = {name: walk_program(reg[name]) for name in sorted(reg)}
    findings = run_torchcheck(reg, runs=runs)
    unsuppressed = [f for f in findings if not f.suppressed]
    rc = 1 if unsuppressed else 0
    if args.format == "json":
        print(json.dumps({"findings": [f.to_dict() for f in findings], "total": len(findings),
                          "unsuppressed": len(unsuppressed),
                          "counts": count_by_rule(findings)}, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.format() + (f" (suppressed: {f.reason})" if f.suppressed else ""))
        print(f"torchcheck: {len(unsuppressed)} finding(s), "
              f"{len(findings) - len(unsuppressed)} suppressed; "
              + ", ".join(f"{r} {c['unsuppressed']}+{c['suppressed']}s"
                          for r, c in count_by_rule(findings).items()), file=sys.stderr)
    if args.update_baselines:
        for p in tfp.write_baselines(reg, dirpath=args.baseline_dir, runs=runs):
            print(f"torchcheck: wrote {p}", file=sys.stderr)
    elif not args.no_fingerprints:
        problems = tfp.check_baselines(reg, dirpath=args.baseline_dir, runs=runs)
        for line in problems:
            print(f"torchcheck fingerprint: {line}", file=sys.stderr)
        if problems:
            print("torchcheck: fingerprint baselines diverged; if the program change is "
                  "intended, rerun with --update-baselines and commit the diff",
                  file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":  # pragma: no cover - run with -m
    sys.exit(main())
