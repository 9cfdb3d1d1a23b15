"""Static checks of the port.

  base.py       findings, pragmas, name resolution
  graphs.py     module graph + call graph from per-file summaries
  hotpath.py    perfcheck: HOT001-HOT004, the host-path discipline
  runner.py     the gate (``python -m foundationdb_tpu_torch.tools.lint``):
                perfcheck, and torchcheck with ``--all``
  torchir.py    torchcheck: the torch-graph structural check of the
                registered device programs
  torchfingerprint.py  torchcheck's committed fingerprints
"""
