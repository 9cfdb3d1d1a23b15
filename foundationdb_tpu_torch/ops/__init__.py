"""Vectorized query primitives of the conflict step, in PyTorch.

Multiword lexicographic binary search, sparse-table range max/min, and a
dyadic segment-tree interval-stabbing query — the port of the reference
package's ops/, bit-identical on the same inputs.
"""

from .rangequery import (
    build_max_table,
    build_min_table,
    floor_log2,
    lex_argsort,
    lex_leq,
    lex_less,
    range_max,
    range_min,
    searchsorted_1d,
    searchsorted_words,
)
from .stabbing import stabbing_min

__all__ = [
    "build_max_table",
    "build_min_table",
    "floor_log2",
    "lex_argsort",
    "lex_leq",
    "lex_less",
    "range_max",
    "range_min",
    "searchsorted_1d",
    "searchsorted_words",
    "stabbing_min",
]
