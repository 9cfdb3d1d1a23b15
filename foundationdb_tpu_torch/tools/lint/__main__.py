"""``python -m foundationdb_tpu_torch.tools.lint`` -> the lint gate."""

import sys

from .runner import main

sys.exit(main())
