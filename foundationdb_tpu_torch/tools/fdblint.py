"""``python -m foundationdb_tpu_torch.tools.fdblint [root]``: fdblint alone.

The twin of the reference package's ``tools/fdblint.py``: a thin
re-export of the lint package's public API, with ``main`` bound to the one
tool.  The analysis lives in ``tools/lint/`` (``local.py``, ``det101.py``,
``waitrules.py``, ``rpy.py``, ``promises.py``, ``races.py``,
``runner.py``); ``python -m foundationdb_tpu_torch.tools.lint`` runs it
beside perfcheck from the same load of the tree."""

import sys
from functools import partial

from .lint.base import RULES, Finding  # noqa: F401
from .lint.runner import lint_source, run_fdblint  # noqa: F401
from .lint.runner import main as _gate

main = partial(_gate, tools=("fdblint",),
               prog="python -m foundationdb_tpu_torch.tools.fdblint")

if __name__ == "__main__":
    sys.exit(main())
