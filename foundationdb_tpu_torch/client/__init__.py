"""The port's client-side wire types (``types``) and atomic-operation
semantics (``atomic``)."""

from .types import CommitTransactionRef, Mutation, MutationType

__all__ = ["CommitTransactionRef", "Mutation", "MutationType"]
