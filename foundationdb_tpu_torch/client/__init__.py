"""The port's client-side wire types (``types``)."""

from .types import Mutation, MutationType

__all__ = ["Mutation", "MutationType"]
