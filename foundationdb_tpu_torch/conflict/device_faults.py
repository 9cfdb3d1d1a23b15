"""Device-fault injection and the degraded-mode circuit breaker.

A copy of the reference package's ``conflict/device_faults.py``, its
observability hooks included: each breaker transition is a ``breaker.*``
marker span, a ``DeviceBackendStateChange`` trace event and, when the
circuit opens, a ``breaker_open`` flight-recorder capture.  Two pieces:

``DeviceFaultInjector``
    makes ``TorchConflictSet`` raise the failures a GPU can produce at its
    choke points — dispatch (``DeviceUnavailable``), the first dispatch of
    a shape (``CompileFailed``), ``_grow``/rebase (``DeviceOOM``), and the
    sharded set's live ``reshard`` (``DeviceUnavailable``) — from a
    scripted plan, an open-ended outage, or BUGGIFY sites that a seeded
    RNG drives (random mode).  Transient faults fire once;
    persistent ones hold a site down for a number of checks.  ``injected``
    logs every raised fault as ``[seq, site, kind]``, numbered exactly as
    the reference numbers them, so one script gives one log in both
    packages.  Every plan and check takes an optional ``shard``: a
    shard-scoped site (``"dispatch#s1"``) has its own check counter, so a
    per-shard plan of the sharded set (parallel/sharded_resolver.py)
    faults one shard alone.  ``shard=None`` is the single-device engine's
    un-scoped site.

``DeviceCircuitBreaker``
    the state machine ``ConflictSet`` consults around every device
    attempt::

        ok ──(threshold consecutive faults)──> degraded
        degraded ──(backoff device-eligible batches elapse)──> probing
        probing ──(attempt succeeds)──> ok        (backoff resets)
        probing ──(attempt faults)──> degraded    (backoff doubles)

    While not ``ok``, batches are served by the CPU mirror, which stays
    authoritative at all times, so verdicts never depend on device health.
    Transitions are counted in the engine's registry and appended to
    ``transitions``.  ``label`` names a breaker's fault domain
    (``"shard3"``) and ``counter_prefix`` namespaces its counters and
    ``backend_state`` gauge in a shared registry (``"shard3_"``); both
    default empty, the single-device engine's names.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from ..flow.buggify import buggify_with_prob
from ..flow.flight_recorder import maybe_trigger
from ..flow.spans import instant
from ..flow.trace import TraceEvent


class DeviceFault(Exception):
    """Base of every device failure the breaker handles; `site` names the
    choke point that raised (dispatch/compile/grow/rebase/reshard)."""

    def __init__(self, message: str = "", site: str = ""):
        super().__init__(message or site)
        self.site = site


class DeviceUnavailable(DeviceFault):
    """A kernel launch or a readback failed (device lost or reset)."""


class CompileFailed(DeviceFault):
    """The first dispatch of a new static shape failed."""


class DeviceOOM(DeviceFault):
    """Device allocation failed growing, rebasing or running the history."""


SITES = ("dispatch", "compile", "grow", "rebase", "reshard")

_SITE_FAULT = {
    "dispatch": DeviceUnavailable,
    "compile": CompileFailed,
    "grow": DeviceOOM,
    "rebase": DeviceOOM,
    # A live reshard of the sharded set: the device going away during the
    # handoff.  The move defers, the old partition stays whole.
    "reshard": DeviceUnavailable,
}


class DeviceFaultInjector:
    """Deterministic fault source for the engine's choke points.

    Scripted mode: ``script(site, at=n, persist=k, shard=None)`` faults the
    n-th check of a site (1-based; the shard's own count when ``shard`` is
    given) and holds it down for k checks; ``begin_outage`` /
    ``end_outage`` model an open-ended device loss.

    Random mode (``fire_probability > 0``): a check that no plan faults
    consults the BUGGIFY site ``device_fault_<site>`` (``..._s<k>`` for
    shard k) of the port's ``flow.buggify`` at ``fire_probability``; on a
    fire it draws persistent-vs-transient (``persistent_probability``) and
    a persistent fault's length (1 to ``max_persistent - 1`` more checks)
    from ``rng``, or, for a shard, from a stream forked from ``rng`` at
    that shard's first draw.  ``rng`` is any object with ``random01``,
    ``random_int`` and ``split`` (the reference's ``DeterministicRandom``
    serves too).  The defaults leave random mode off."""

    def __init__(
        self,
        rng=None,
        fire_probability: float = 0.0,
        persistent_probability: float = 0.25,
        max_persistent: int = 4,
    ):
        self.rng = rng
        self.fire_probability = fire_probability
        self.persistent_probability = persistent_probability
        self.max_persistent = max_persistent
        self.checks: Dict[str, int] = {s: 0 for s in SITES}
        self.injected: List[list] = []  # [seq, site key, kind]
        self._seq = 0
        self._outage: Dict[str, Optional[int]] = {}  # key -> remaining (None = open-ended)
        self._scripted: Dict[str, Dict[int, int]] = {}  # key -> {at: persist}
        # Per-shard persistence streams, forked from self.rng at a shard's
        # first draw (check order is deterministic, so lazy forks replay).
        self._shard_rngs: Dict[int, object] = {}

    @staticmethod
    def _site_key(site: str, shard) -> str:
        assert site in SITES, site
        return site if shard is None else f"{site}#s{int(shard)}"

    def _rng_for(self, shard):
        if shard is None or self.rng is None:
            return self.rng
        r = self._shard_rngs.get(int(shard))
        if r is None:
            r = self._shard_rngs[int(shard)] = self.rng.split()
        return r

    # -- plans --
    def script(self, site: str, at: int, persist: int = 1, shard=None) -> None:
        """Fault the `at`-th check of `site` (of `shard`'s site when given)
        and keep it down for `persist` consecutive checks."""
        key = self._site_key(site, shard)
        assert at > self.checks.get(key, 0), "cannot script the past"
        self._scripted.setdefault(key, {})[at] = persist

    def begin_outage(self, site: str, shard=None) -> None:
        """Hold `site` (on one shard when given) down until end_outage."""
        self._outage[self._site_key(site, shard)] = None

    def end_outage(self, site: str, shard=None) -> None:
        self._outage.pop(self._site_key(site, shard), None)

    # -- the choke-point hook --
    def check(self, site: str, shard=None) -> None:
        """Called by the engine before mutating state at `site` (scoped to
        one shard of the sharded set when `shard` is given); raises the
        site's fault type when the plan says so."""
        key = self._site_key(site, shard)
        self._seq += 1
        n = self.checks[key] = self.checks.get(key, 0) + 1
        kind = None
        # Scripted entries are consumed at their check number even inside
        # an outage or persistence window: overlapping plans extend the
        # window (max-merge), they never vanish.
        persist = self._scripted.get(key, {}).pop(n, None)
        remaining = self._outage.get(key, 0)
        if key in self._outage:
            if remaining is None:
                kind = "outage"
            else:
                self._outage[key] = remaining - 1
                if self._outage[key] == 0:
                    del self._outage[key]
                kind = "persistent"
        if persist is not None:
            if persist > 1:
                tail = self._outage.get(key, 0)
                if not (key in self._outage and tail is None):
                    self._outage[key] = max(tail, persist - 1)
            if kind is None:
                kind = "persistent" if persist > 1 else "transient"
        if kind is None and self.fire_probability > 0:
            suffix = "" if shard is None else f"_s{int(shard)}"
            if buggify_with_prob(f"device_fault_{site}{suffix}", self.fire_probability):
                kind = "transient"
                rng = self._rng_for(shard)
                if rng is not None and rng.random01() < self.persistent_probability:
                    self._outage[key] = int(rng.random_int(1, self.max_persistent))
                    kind = "persistent"
        if kind is not None:
            self.injected.append([self._seq, key, kind])
            raise _SITE_FAULT[site](f"injected {kind} fault", site=site)


# Breaker states (the status doc's backend_state values).
STATE_OK = "ok"
STATE_DEGRADED = "degraded"
STATE_PROBING = "probing"

_STATE_GAUGE = {STATE_OK: 0, STATE_DEGRADED: 1, STATE_PROBING: 2}

# Construction-order breaker ids (deterministic, unlike id()).
_BREAKER_SEQ = itertools.count()


class DeviceCircuitBreaker:
    """Consecutive-failure circuit breaker with deterministic exponential
    backoff, counted in device-eligible batches."""

    def __init__(
        self,
        metrics=None,
        threshold: int = 3,
        backoff_batches: int = 2,
        backoff_cap: int = 64,
        label: str = "",
        counter_prefix: str = "",
    ):
        self.breaker_id = next(_BREAKER_SEQ)
        self.metrics = metrics
        self.threshold = threshold
        self.initial_backoff = backoff_batches
        self.backoff_cap = backoff_cap
        self.label = label
        self._prefix = counter_prefix
        self.state = STATE_OK
        self.consecutive_failures = 0
        self.backoff = backoff_batches
        self._cooldown = 0  # device-eligible batches until the next probe
        self.seq = 0  # device-eligible batches observed
        self.transitions: List[list] = []  # [seq, from, to, reason]
        if metrics is not None:
            metrics.gauge(f"{counter_prefix}backend_state").set(_STATE_GAUGE[self.state])

    # -- queries --
    def allows_device(self) -> bool:
        """Gate one device-eligible batch; advances the backoff clock and
        enters `probing` when it elapses.  Call at most once per batch."""
        self.seq += 1
        if self.state == STATE_DEGRADED:
            self._cooldown -= 1
            if self._cooldown > 0:
                self._count("degraded_batches")
                return False
            self._transition(STATE_PROBING, "backoff_elapsed")
            self._count("breaker_probes")
        return True

    # -- outcomes --
    def on_success(self) -> None:
        self.consecutive_failures = 0
        if self.state != STATE_OK:
            self._transition(STATE_OK, "probe_success")
            self._count("breaker_closes")
            self.backoff = self.initial_backoff

    def on_failure(self, fault: DeviceFault) -> None:
        self.consecutive_failures += 1
        self._count("device_faults")
        self._count(f"faults_{fault.site or 'unknown'}")
        reason = f"{type(fault).__name__}:{fault.site or 'unknown'}"
        if self.state == STATE_PROBING:
            self.backoff = min(self.backoff * 2, self.backoff_cap)
            self._cooldown = self.backoff
            self._transition(STATE_DEGRADED, f"probe_failed:{reason}")
        elif self.state == STATE_OK and self.consecutive_failures >= self.threshold:
            self._cooldown = self.backoff
            self._transition(STATE_DEGRADED, f"threshold:{reason}")
            self._count("breaker_opens")

    def on_divergence(self, detail: str) -> None:
        """Confirmed mirror/device divergence (mirror_check's verdict): a
        device fault that opens the circuit at once — divergence is corrupt
        state, never a transient blip."""
        self._count("device_faults")
        self._count("faults_mirror")
        if self.state == STATE_OK:
            self._cooldown = self.backoff
            self._transition(STATE_DEGRADED, f"mirror_divergence:{detail}")
            self._count("breaker_opens")

    def note_rehydrate(self) -> None:
        self._count("rehydrates")

    def count_degraded_batch(self) -> None:
        self._count("degraded_batches")

    # -- plumbing --
    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(f"{self._prefix}{name}").add()

    def _transition(self, to: str, reason: str) -> None:
        """Record one state change: the transition log and gauge, a
        ``breaker.<to>`` marker span on the DeviceBreaker track, a
        DeviceBackendStateChange trace event and, when the circuit opens
        (ok -> degraded), a ``breaker_open`` flight-recorder capture.  The
        label (a shard's domain) rides on all three."""
        frm, self.state = self.state, to
        self.transitions.append([self.seq, frm, to, reason])
        if self.metrics is not None:
            self.metrics.gauge(f"{self._prefix}backend_state").set(_STATE_GAUGE[to])
        attrs = {"from": frm, "reason": reason, "seq": self.seq}
        if self.label:
            attrs["domain"] = self.label
        instant(f"breaker.{to}", role="DeviceBreaker", attrs=attrs)
        ev = TraceEvent("DeviceBackendStateChange", severity=20).detail(
            "from", frm).detail("to", to).detail("reason", reason).detail("seq", self.seq)
        if self.label:
            ev.detail("domain", self.label)
        ev.log()
        if frm == STATE_OK and to == STATE_DEGRADED:
            # After the event, so the capture's recent events hold it.  A
            # failed probe re-opening a degraded circuit is no new open.
            detail = {"reason": reason, "seq": self.seq}
            if self.label:
                detail["domain"] = self.label
            maybe_trigger(
                "breaker_open",
                detail=detail,
                # Copied only if the cooldown admits the capture.
                transitions=lambda: [list(t) for t in self.transitions],
                # Two breakers opening at once are two incidents: each has
                # its own cooldown (construction-order id).
                source=self.breaker_id,
            )

    def snapshot(self) -> dict:
        """Replayable view for device_metrics()."""
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "backoff": self.backoff,
            "transitions": [list(t) for t in self.transitions],
        }
