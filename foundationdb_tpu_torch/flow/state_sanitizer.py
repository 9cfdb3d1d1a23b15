"""Dynamic shared-state sanitizer: the runtime twin of fdblint RACE001-004.

The port's own copy of the reference package's ``flow/state_sanitizer.py``.
The static pass (tools/lint/races.py) proves lost-update shapes from the
ASTs; this sanitizer observes the same condition at runtime.  Audited
shared dicts record every keyed read and write as (task, await-epoch) —
the epoch bumps once per event-loop step, so two accesses at the same
epoch cannot have had another task run between them.  A write by task T
whose value derives from T's earlier read of the same key, with an OTHER
task's write landing between the read and the write, is a
stale-read→write pair: the dynamic signature of a lost update (T's write
was computed without the interleaved value and stomps it).

The sanitizer hangs off its event loop, so concurrent simulated clusters
in one process do not interfere, and is on only for a loop built with
``EventLoop(state_sanitizer=True)`` (the reference's
FDB_TPU_STATE_SANITIZER, off by default).  With it off, ``audited_dict``
returns a plain dict and the runtime cost is zero.  Like the static pass,
the check under-approximates — blind writes (no prior read) and
cross-key derivations are not flagged; what it does flag is a real
interleaving that happened, not a may-happen.  It only observes: it draws
nothing from the loop's rng and schedules nothing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

# A task label: (name, id).  The id disambiguates same-named actor
# instances; messages print only the name.
_TaskLabel = Tuple[str, int]


class StateSanitizer:
    """Per-loop recorder of audited-object accesses and violations."""

    def __init__(self, loop):
        self.loop = loop
        # (dict_name, key) -> {task: epoch of that task's last read}
        self._reads: Dict[Tuple[str, Any], Dict[_TaskLabel, int]] = {}
        # (dict_name, key) -> (task, epoch) of the last write
        self._writes: Dict[Tuple[str, Any], Tuple[_TaskLabel, int]] = {}
        self.violations: List[str] = []
        self.names: set = set()  # audited object names, for the blindness check
        # Keyed accesses recorded, for the shutdown report.
        self.n_reads = 0
        self.n_writes = 0

    def _who(self) -> _TaskLabel:
        t = self.loop.current_task
        return (t.name, id(t)) if t is not None else ("<loop>", 0)

    def on_read(self, name: str, key):
        self.n_reads += 1
        self._reads.setdefault((name, key), {})[self._who()] = self.loop.await_epoch

    def on_write(self, name: str, key):
        self.n_writes += 1
        who = self._who()
        epoch = self.loop.await_epoch
        slot = (name, key)
        read_at = self._reads.get(slot, {}).get(who)
        last = self._writes.get(slot)
        # Stale-read→write: our read predates another task's write that
        # itself predates (or shares) this step.  Same-epoch interference
        # is impossible (one task per step), so the strict `<` is exact.
        if (read_at is not None and last is not None and last[0] != who
                and read_at < last[1] <= epoch):
            self.violations.append(
                f"{name}[{key!r}]: task {who[0]!r} wrote at epoch {epoch} "
                f"from its read at epoch {read_at}, but task "
                f"{last[0][0]!r} wrote at epoch {last[1]} in between "
                f"(lost update)"
            )
        self._writes[slot] = (who, epoch)
        # The write refreshes the writer's own knowledge of the key (the
        # re-check-after-await discipline reads, then writes, in one step).
        self._reads.setdefault(slot, {})[who] = epoch


class AuditedDict(dict):
    """dict reporting every keyed read/write to the loop's sanitizer.

    Keyed accessors only: iteration (keys/values/items) is not audited —
    the violation condition is per-key, and auditing scans would drown
    the signal.  Under-approximate, like everything else in this file.
    """

    def __init__(self, san: StateSanitizer, name: str, init=()):
        super().__init__(init)
        self._san = san
        self._name = name

    # -- reads --
    def __getitem__(self, key):
        self._san.on_read(self._name, key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self._san.on_read(self._name, key)
        return super().get(key, default)

    def __contains__(self, key):
        self._san.on_read(self._name, key)
        return super().__contains__(key)

    # -- writes --
    def __setitem__(self, key, value):
        self._san.on_write(self._name, key)
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._san.on_write(self._name, key)
        super().__delitem__(key)

    def pop(self, key, *default):
        self._san.on_write(self._name, key)
        return super().pop(key, *default)

    def setdefault(self, key, default=None):
        self._san.on_read(self._name, key)
        if not super().__contains__(key):
            self._san.on_write(self._name, key)
        return super().setdefault(key, default)

    def update(self, *args, **kwargs):
        staged = dict(*args, **kwargs)
        for k in staged:
            self._san.on_write(self._name, k)
        super().update(staged)

    def clear(self):
        for k in list(super().keys()):
            self._san.on_write(self._name, k)
        super().clear()


def audited_dict(loop, name: str, init=None) -> dict:
    """A shared dict to audit under the loop's sanitizer: a plain dict when
    the loop has none (zero overhead), else an AuditedDict bound to it.
    `name` labels the object in violation reports."""
    san = loop.state_sanitizer
    if san is None:
        return dict(init or ())
    san.names.add(name)
    return AuditedDict(san, name, init or ())


def expect_clean_shared_state(loop, context: str = ""):
    """Sim-shutdown assertion: no audited shared object saw a
    stale-read→write pair during the run.  A no-op on a loop without the
    sanitizer; raises if the loop has one but no audited object was ever
    constructed on it, so the check can't silently pass while blind."""
    san = loop.state_sanitizer
    if san is None:
        return
    if not san.names:
        raise AssertionError(
            "state_sanitizer: the loop's sanitizer is on but no audited_dict "
            "was constructed on this loop — the check would be blind"
        )
    if san.violations:
        head = "; ".join(sorted(san.violations)[:8])
        raise AssertionError(
            f"state_sanitizer: {len(san.violations)} stale-read→write "
            f"pair(s) on audited shared state: {head}"
            + (f" ({context})" if context else "")
        )
