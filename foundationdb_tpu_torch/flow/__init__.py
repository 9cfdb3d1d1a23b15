"""Simulation randomness for the port (the part of the reference package's
``flow`` that fault injection needs): ``rng.DeterministicRandom`` and the
BUGGIFY sites of ``buggify``."""

from .rng import DeterministicRandom

__all__ = ["DeterministicRandom"]
