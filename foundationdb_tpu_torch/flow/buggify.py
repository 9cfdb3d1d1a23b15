"""BUGGIFY: randomized rare-path activation, in simulation only.

A copy of the reference package's ``flow/buggify.py`` (modelled on
flow/flow.h:50-67).  Each named site is "activated" with
``activated_probability`` the first time it is evaluated in a run; an
activated site then fires with ``fired_probability`` per evaluation
(``buggify_with_prob`` lets the caller pick that probability).  Every
activation and fire is counted, so a run can report which fault sites its
seed exercised (``coverage``, ``publish_coverage``).

The two probabilities are the reference's ``g_knobs.flow`` knobs
(``buggify_activated_probability``, ``buggify_fired_probability``), here
arguments of ``set_buggify_enabled`` with the reference's defaults.  The
state is module-wide, as in the reference: one simulation run at a time.
"""

from __future__ import annotations

from typing import Dict

_enabled = False
_rng = None  # any object with random01(), such as rng.DeterministicRandom
_activated_probability = 0.25
_fired_probability = 0.25
_site_activated: Dict[str, bool] = {}
fired_sites: set = set()
fired_counts: Dict[str, int] = {}


def set_buggify_enabled(enabled: bool, rng=None, activated_probability: float = 0.25,
                        fired_probability: float = 0.25) -> None:
    """Turn the sites on (drawing from `rng`, any object with ``random01``)
    or off, and forget every site's activation and count."""
    global _enabled, _rng, _activated_probability, _fired_probability
    _enabled = enabled
    _rng = rng
    _activated_probability = activated_probability
    _fired_probability = fired_probability
    _site_activated.clear()
    fired_sites.clear()
    fired_counts.clear()


def buggify_with_prob(site: str, p: float) -> bool:
    """BUGGIFY_WITH_PROB (ref flow.h:66): activated like any site, then
    fires with probability `p` per evaluation.  False when not enabled."""
    if not _enabled or _rng is None:
        return False
    if site not in _site_activated:
        _site_activated[site] = _rng.random01() < _activated_probability
    if not _site_activated[site]:
        return False
    fired = _rng.random01() < p
    if fired:
        fired_sites.add(site)
        fired_counts[site] = fired_counts.get(site, 0) + 1
    return fired


def buggify(site: str) -> bool:
    """True at random, only while enabled."""
    return buggify_with_prob(site, _fired_probability)


def coverage() -> dict:
    """How many sites this run saw, how many its seed activated, and each
    site's fire count."""
    return {
        "sites_seen": len(_site_activated),
        "sites_activated": sum(1 for v in _site_activated.values() if v),
        "sites_fired": len(fired_sites),
        "fired_counts": dict(sorted(fired_counts.items())),
    }


def publish_coverage(registry) -> dict:
    """Fold the run's coverage into gauges of a ``MetricsRegistry``."""
    cov = coverage()
    registry.gauge("buggify_sites_seen").set(cov["sites_seen"])
    registry.gauge("buggify_sites_activated").set(cov["sites_activated"])
    registry.gauge("buggify_sites_fired").set(cov["sites_fired"])
    for site, n in cov["fired_counts"].items():
        registry.gauge(f"fired:{site}").set(n)
    return cov
