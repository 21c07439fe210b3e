"""reprolint for the port — torch-aware static analysis, and its shape fleet.

Two halves, both zero-FLOP (nothing compiles, nothing runs on a device):

* an **AST rule engine** (:mod:`repro_torch.analysis.engine`, the JAX
  package's engine) with the same six rule ids, read for the port's
  hazards: RETRACE (a CUDA graph built in a loop), PURITY (host effects
  inside a captured step), COLLECTIVE (a ``torch.distributed``
  collective outside ``models/parallel.py``'s counted wrappers, or on
  the replicated path), DTYPE (float64 in device-adjacent code), PRNG
  (samplers on the global RNG, identically seeded generators), BENCH
  (a wall-clock delta over CUDA dispatch with no sync);
* a **shape-contract fleet** (:mod:`repro_torch.analysis.shapes`)
  building the planner/recipe/layout/byte contracts of every config x
  recipe on the meta device and diffing them against the JAX package's
  goldens under ``tests/golden/shapes/``.

Suppression: ``# reprolint: disable=RULE`` pragmas on the finding line
(the JAX package's syntax), ``# reprolint: disable-file=RULE`` file-wide,
and a baseline file (``analysis/baseline.json``, empty).  ``python -m
repro_torch.analysis`` is the CLI.

>>> findings = lint_source('''
... from repro_torch.launch.steps import CapturedStep
... def body(x):
...     print(x)          # runs at capture only
...     return x * 2
... step = CapturedStep(body)
... ''')
>>> [(f.rule, f.line) for f in findings]
[('PURITY', 4)]
>>> lint_source('''
... def body(x):
...     return x * 2      # clean: no host effects, no branching
... step = CapturedStep(body)
... ''')
[]

Pragmas silence a finding in place:

>>> lint_source('''
... def body(x):
...     print("capturing")  # reprolint: disable=PURITY
...     return x
... step = CapturedStep(body)
... ''')
[]
"""
from repro_torch.analysis.engine import (Finding, RULE_IDS, TIER_ERROR,
                                         TIER_REPORT, apply_baseline,
                                         gating, lint_file, lint_paths,
                                         lint_source, load_baseline,
                                         save_baseline, summarize)

__all__ = [
    "Finding", "RULE_IDS", "TIER_ERROR", "TIER_REPORT",
    "apply_baseline", "gating", "lint_file", "lint_paths",
    "lint_source", "load_baseline", "save_baseline", "summarize",
]
