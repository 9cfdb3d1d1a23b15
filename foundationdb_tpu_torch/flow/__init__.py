"""The parts of the reference package's ``flow`` layer the port's conflict
sets call: simulation randomness (``rng.DeterministicRandom`` and the
BUGGIFY sites of ``buggify``) and observability (``spans``, ``trace`` and
``flight_recorder``, each reached through its module globals)."""

from .rng import DeterministicRandom

__all__ = ["DeterministicRandom"]
