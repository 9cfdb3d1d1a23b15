"""Static checks of the port.

  base.py       fdblint's rule registry and allowlist, findings, pragmas,
                name resolution
  local.py      fdblint's per-module rules: DET001-003, ACT001, IO001,
                TRC001, SPN001, ERR001, ENV001
  waitrules.py  fdblint's WAIT001/WAIT002, state held across an await
  rpy.py        fdblint's RPY001, a reply path that drops the reply
  promises.py   fdblint's PRM001-004 and TSK001, the promise lifecycle
                and wait graph through the call graph
  races.py      fdblint's RACE001-004, atomicity across an await
  graphs.py     module graph + call graph from per-file summaries
  det101.py     fdblint's DET101, the interprocedural determinism taint
  hotpath.py    perfcheck: HOT001-HOT004, the host-path discipline
  runner.py     the gate (``python -m foundationdb_tpu_torch.tools.lint``):
                fdblint and perfcheck from one load of the tree, and
                torchcheck with ``--all``
  torchir.py    torchcheck: the torch-graph structural check of the
                registered device programs
  torchfingerprint.py  torchcheck's committed fingerprints

``tools/fdblint.py`` is the gate with fdblint alone.
"""
