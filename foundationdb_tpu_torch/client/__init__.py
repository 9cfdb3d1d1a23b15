"""The port's client library: the transaction API and its read-your-writes
overlay (``transaction``), atomic-operation semantics (``atomic``), the
wire types (``types``) and the management transactions
(``management``)."""

from .atomic import apply_atomic, transform_versionstamp
from .transaction import Database, Transaction, transactional
from .types import (
    ALL_KEYS,
    CommitTransactionRef,
    KeySelector,
    Mutation,
    MutationType,
    key_after,
    strinc,
)

__all__ = [
    "apply_atomic",
    "transform_versionstamp",
    "Database",
    "Transaction",
    "transactional",
    "ALL_KEYS",
    "CommitTransactionRef",
    "KeySelector",
    "Mutation",
    "MutationType",
    "key_after",
    "strinc",
]
