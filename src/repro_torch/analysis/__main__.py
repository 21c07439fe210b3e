"""Static gate of the port: reprolint rules + the shape-contract fleet.

    PYTHONPATH=src python -m repro_torch.analysis [--root DIR]
        [--baseline FILE] [--update-baseline] [--no-shapes] [--no-lint] [-v]

Two zero-FLOP passes, run before anything compiles:

1. **reprolint** — the port's rules (RETRACE / COLLECTIVE / DTYPE / PRNG /
   PURITY / BENCH) over ``src/repro_torch`` at gating severity and over
   the root's ``chip_*.py`` and ``tests/test_torch_*.py`` at report
   severity.  Findings in the baseline (``--baseline``, default
   ``analysis/baseline.json`` beside this file, empty) never gate.
   Suppress single lines with ``# reprolint: disable=RULE``.
2. **shape-contract fleet** — every config x recipe built through the
   port's planner/recipe/layout stack on the meta device and diffed
   against the JAX package's ``tests/golden/shapes/*.json``, which this
   tool only reads.

``--root`` is the checkout whose files are linted (default: the one
holding this package).  Exit codes: 0 clean, 1 gating findings or
fleet drift, 2 usage error.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from repro_torch import analysis

EXIT_OK, EXIT_FAIL, EXIT_USAGE = 0, 1, 2
DEFAULT_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"
GATING = "src/repro_torch"
REPORT = ("chip_*.py", "tests/test_torch_*.py")
GOLDEN = "tests/golden/shapes"


def report_files(root: Path) -> list[Path]:
    return sorted(p for pat in REPORT for p in root.glob(pat))


def lint(root: Path, baseline: Path, update_baseline: bool = False
         ) -> tuple[list, list, float]:
    """Lint the gating and the report roots.  Returns (gating-tier
    findings with the baselined ones marked, report findings, seconds);
    with ``update_baseline`` the gating ones are written to ``baseline``
    first."""
    t0 = time.perf_counter()
    found = analysis.lint_paths([root / GATING], root=root,
                                tier=analysis.TIER_ERROR,
                                baseline=analysis.load_baseline(baseline))
    if update_baseline:
        analysis.save_baseline(analysis.gating(found), baseline)
        found = analysis.apply_baseline(found,
                                        analysis.load_baseline(baseline))
    report = analysis.lint_paths(report_files(root), root=root,
                                 tier=analysis.TIER_REPORT)
    return found, report, time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint over the port + its shape fleet against "
                    "the JAX package's goldens (zero-FLOP gate)",
        epilog="exit codes: 0 ok, 1 gating finding(s) or drift, 2 usage "
               "error")
    p.add_argument("--root", type=Path, default=DEFAULT_ROOT,
                   help="checkout to lint (src/repro_torch, chip_*.py, "
                        "tests/test_torch_*.py)")
    p.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                   help="reprolint baseline file of the port")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline from the current gating "
                        "findings (a last resort: fix, or pragma with a "
                        "reason)")
    p.add_argument("--no-shapes", action="store_true",
                   help="skip the shape-contract fleet")
    p.add_argument("--no-lint", action="store_true",
                   help="skip the AST rules")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print every report-tier and baselined finding")
    args = p.parse_args(argv)
    if args.no_shapes and args.no_lint:
        print("--no-shapes with --no-lint leaves nothing to check",
              file=sys.stderr)
        return EXIT_USAGE
    if not (args.root / GATING).is_dir():
        print(f"no {GATING} under {args.root}", file=sys.stderr)
        return EXIT_USAGE
    failed = False
    if not args.no_lint:
        found, report, secs = lint(args.root, args.baseline,
                                   args.update_baseline)
        gate = analysis.gating(found)
        for f in found:
            if f in gate or args.verbose:
                print(f.render())
        print(f"reprolint[{GATING}]: "
              f"{'clean' if not gate else analysis.summarize(gate)} "
              f"({secs:.2f} s)")
        if args.verbose:
            for f in report:
                print("  " + f.render())
        print(f"reprolint[report]: report-only: "
              f"{analysis.summarize(report)}")
        failed |= bool(gate)
    if not args.no_shapes:
        from repro_torch.analysis import shapes
        t0 = time.perf_counter()
        errs = shapes.run_fleet(args.root / GOLDEN)
        for e in errs:
            print(e)
        print(f"shape-fleet: {len(shapes.fleet_cells())} (arch x recipe) "
              f"cells vs {GOLDEN}/: {len(errs)} diff(s) "
              f"({time.perf_counter() - t0:.2f} s)")
        failed |= bool(errs)
    return EXIT_FAIL if failed else EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
