"""rttest CLI (parity: visual-testing/src/rttest/main.py).

    python -m visual_testing.rttest [backend] [--scenes a,b] [--bless |
        --bless-all] [--json] [--tolerance F] [--no-perf | --perf-only |
        --perf-baseline | --perf-history SCENE] [--perf-threshold P]
        [--tests-file F] -- <renderer args>

Exit codes: 0 = all pass, 1 = visual/perf failures, 2 = renderer errors.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import bless, perf
from .runner import run_tests
from .test_spec import load_test_suite

PROJECT_DIR = Path(__file__).resolve().parent.parent

# the renderer's --backend choices (tpu_raytracing/backend.py BACKENDS);
# spelled out so the harness does not import JAX
BACKENDS = ("jax", "cpu", "gpu")


def uses_stat_gate(backend: str, tolerance, stat_gate: bool) -> bool:
    """GPU renders differ from the CPU-blessed references by FMA-contraction
    ULPs that Monte-Carlo paths amplify, so the gpu backend is gated
    statistically unless an explicit --tolerance asks for MSE gating."""
    return stat_gate or (backend == "gpu" and tolerance is None)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        our_args, renderer_args = argv[:split], argv[split + 1 :]
    else:
        our_args, renderer_args = argv, []

    parser = argparse.ArgumentParser(
        prog="rttest",
        description="Visual + performance regression testing for the raytracer",
    )
    parser.add_argument(
        "backend", nargs="?", choices=list(BACKENDS), default="jax",
        help="Rendering backend (JAX platform)",
    )
    parser.add_argument("--scenes", help="Comma-separated list of scenes (default: all)")
    parser.add_argument("--bless", action="store_true", help="Interactively review and bless outputs")
    parser.add_argument("--bless-all", action="store_true", help="Bless all outputs without review")
    parser.add_argument("--json", action="store_true", help="JSON results output")
    parser.add_argument(
        "--tolerance", type=float, default=None,
        help="MSE tolerance for pass/fail. Default None: exact match "
        "(MSE 0.0) on same-backend runs, but the gpu backend auto-enables "
        "the statistical gate (see --stat-gate). Pass an explicit value "
        "to force MSE gating everywhere.",
    )
    parser.add_argument(
        "--stat-gate", action="store_true",
        help="Cross-backend statistical gate: beauty gated on tonemapped "
        "image-mean agreement (0.5%%) and 8x8 block means (0.2%%), AOVs "
        "on MSE<=5e-3 (default for gpu backend; "
        "per-pixel Monte-Carlo divergence from FMA ULPs is chaotic, see "
        "BASELINE.md)",
    )
    parser.add_argument("--no-perf", action="store_true", help="Disable timing capture")
    parser.add_argument("--perf-only", action="store_true", help="Skip visual comparison")
    parser.add_argument("--perf-baseline", action="store_true", help="Bless current timings as baseline")
    parser.add_argument("--perf-history", metavar="SCENE", help="Print timing history for a scene and exit")
    parser.add_argument("--perf-threshold", type=float, default=10.0, help="Regression threshold %% (default 10)")
    parser.add_argument("--tests-file", type=Path, help="TOML test spec (default tests/tests.toml)")
    args = parser.parse_args(our_args)

    output_dir = PROJECT_DIR / "outputs"
    reference_dir = PROJECT_DIR / "references"
    history = perf.PerfHistory(PROJECT_DIR / "perf_history.jsonl")
    baseline = perf.PerfBaseline(PROJECT_DIR / "perf_baseline.json")

    if args.perf_history:
        for r in history.records_for(args.perf_history):
            print(json.dumps(r.to_dict()))
        return 0

    tests_file = args.tests_file or PROJECT_DIR / "tests" / "tests.toml"
    specs = load_test_suite(tests_file)
    if args.scenes:
        wanted = {s.strip() for s in args.scenes.split(",")}
        unknown = wanted - {s.name for s in specs}
        if unknown:
            print(f"error: unknown scenes: {sorted(unknown)}", file=sys.stderr)
            return 2
        specs = [s for s in specs if s.name in wanted]

    stat_gate = uses_stat_gate(args.backend, args.tolerance, args.stat_gate)
    tolerance = 0.0 if args.tolerance is None else args.tolerance
    print(
        f"running {len(specs)} tests (backend={args.backend}"
        + (", statistical gate)" if stat_gate else ")")
    )
    results = run_tests(
        specs, output_dir, reference_dir, renderer_args, args.backend,
        PROJECT_DIR, tolerance, visual=not args.perf_only,
        stat_gate=stat_gate,
    )

    # perf capture
    regressions = []
    if not args.no_perf:
        by_name = {s.name: s for s in specs}
        for res in results:
            if res.status == "ERROR":
                continue
            spec = by_name[res.name]
            rec = perf.make_record(
                res.name, res.render_time_seconds, renderer_args,
                args.backend, spec.settings.samples_per_pixel,
                spec.settings.light_samples,
            )
            history.append(rec)
            if args.perf_baseline:
                baseline.set(rec)
            else:
                reg = baseline.check_regression(rec, args.perf_threshold)
                if reg:
                    regressions.append(reg)
        if args.perf_baseline:
            baseline.save()
            print(f"blessed perf baseline for {len(results)} scenes")

    if args.bless or args.bless_all:
        blessable = [r for r in results if r.status in ("NEW", "FAIL", "PASS", "SKIP")]
        if args.bless_all:
            bless.bless_all(blessable, reference_dir)
        else:
            bless.bless_interactive(blessable, reference_dir)

    n_error = sum(r.status == "ERROR" for r in results)
    n_fail = sum(r.status == "FAIL" for r in results)
    n_new = sum(r.status == "NEW" for r in results)
    n_pass = sum(r.status == "PASS" for r in results)

    if args.json:
        print(
            json.dumps(
                {
                    "results": [r.to_dict() for r in results],
                    "regressions": regressions,
                    "summary": {
                        "pass": n_pass, "fail": n_fail, "new": n_new,
                        "error": n_error,
                    },
                }
            )
        )
    else:
        print(
            f"\n{n_pass} passed, {n_fail} failed, {n_new} new, {n_error} errors"
        )
        for reg in regressions:
            print(
                f"PERF REGRESSION {reg['scene']}: "
                f"{reg['baseline_seconds']:.2f}s -> {reg['current_seconds']:.2f}s "
                f"(+{reg['delta_pct']:.1f}%)"
            )
        if n_new:
            print("To review and bless, run with --bless")

    if n_error:
        return 2
    if n_fail or regressions:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
