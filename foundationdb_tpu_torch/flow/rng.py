"""DeterministicRandom: the seeded RNG every simulated random decision uses.

A copy of the reference package's ``flow/rng.py`` (modelled on
flow/DeterministicRandom.h) cut to what fault injection and its tests use.
It wraps a seeded ``random.Random``, so one seed gives the reference's
stream draw for draw, ``split`` chains included.
"""

from __future__ import annotations

import random as _pyrandom  # fdblint: ignore[DET002]: this module is the seeded wrapper; it only ever builds seeded Random instances


class DeterministicRandom:
    __slots__ = ("_r", "seed")

    def __init__(self, seed: int):
        self.seed = seed
        self._r = _pyrandom.Random(seed)  # fdblint: ignore[DET002]: a private Random seeded by the caller is the determinism mechanism itself

    def random01(self) -> float:
        return self._r.random()

    def random_int(self, lo: int, hi: int) -> int:
        """Uniform integer in [lo, hi), randomInt's half-open range."""
        if hi <= lo:
            raise ValueError(f"random_int empty range [{lo},{hi})")
        return self._r.randrange(lo, hi)

    def random_int64(self, lo: int, hi: int) -> int:
        return self._r.randrange(lo, hi)

    def random_choice(self, seq):
        return seq[self._r.randrange(0, len(seq))]

    def random_shuffle(self, seq: list) -> None:
        self._r.shuffle(seq)

    def coinflip(self) -> bool:
        return self._r.random() < 0.5

    def split(self) -> "DeterministicRandom":
        """An independent deterministic child stream."""
        return DeterministicRandom(self._r.getrandbits(63))
