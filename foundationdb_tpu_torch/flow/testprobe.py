"""Code-coverage probes: the TEST() macro's counterpart.

The part of the reference package's ``flow/testprobe.py`` the port's
request streams call: ``test_probe("name")`` counts a hit of a rare code
path in ``hit_sites``, so a test can show that path was reached.
"""

from __future__ import annotations

from typing import Dict

hit_sites: Dict[str, int] = {}


def test_probe(name: str) -> None:
    """Mark an interesting code path as reached (one dict bump)."""
    hit_sites[name] = hit_sites.get(name, 0) + 1
