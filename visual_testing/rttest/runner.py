"""Test runner (parity: visual-testing/src/rttest/runner.py).

Per test: delete stale output, invoke the CLI as a subprocess with a 300s
timeout and perf_counter timing, then classify:
ERROR (renderer failed), NEW (no blessed reference), PASS/FAIL (MSE vs
tolerance). skip_visual tests only record timing.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

from .diff import compare_images
from .test_spec import TestSpec

# the layered coated_diffuse bunny takes >20 min single-process on the CPU
# backend
TIMEOUT_SECONDS = int(os.environ.get("RTTEST_TIMEOUT", "2400"))


@dataclass
class TestResult:
    name: str
    status: str                       # PASS | FAIL | NEW | ERROR | SKIP
    render_time_seconds: float = 0.0
    mse: Optional[float] = None
    max_diff: Optional[float] = None
    message: str = ""
    output_path: Optional[str] = None
    reference_path: Optional[str] = None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "status": self.status,
            "render_time_seconds": self.render_time_seconds,
            "mse": self.mse,
            "max_diff": self.max_diff,
            "message": self.message,
            "output": self.output_path,
            "reference": self.reference_path,
        }


def build_command(
    spec: TestSpec,
    output_path: Path,
    renderer_args: List[str],
    backend: str,
    base_dir: Path,
) -> List[str]:
    cmd = [sys.executable, "-m", "tpu_raytracing.cli"]
    cmd += spec.scene_cli_args(base_dir)
    cmd += ["-o", str(output_path), "--backend", backend]
    cmd += renderer_args
    cmd += spec.settings.to_cli_args()
    return cmd


def run_single_test(
    spec: TestSpec,
    output_dir: Path,
    reference_dir: Path,
    renderer_args: List[str],
    backend: str,
    base_dir: Path,
    tolerance: float,
    visual: bool = True,
    stat_gate: bool = False,
) -> TestResult:
    output_path = output_dir / f"{spec.name}.exr"
    reference_path = reference_dir / f"{spec.name}.exr"
    output_path.unlink(missing_ok=True)
    output_dir.mkdir(parents=True, exist_ok=True)

    # external scene assets are not version-controlled (the reference ships
    # them as .MISSING_LARGE_BLOBS); classify their absence as a one-line
    # missing-asset ERROR, not a renderer traceback
    if spec.scene_path is not None:
        scene_file = base_dir / spec.scene_path
        if not scene_file.exists():
            return TestResult(
                spec.name, "ERROR", 0.0,
                message=f"missing scene asset: {spec.scene_path} "
                        "(external blob, not in checkout)",
            )

    # the CLI writes under scenes/output/<path>; hand it an absolute path
    cmd = build_command(spec, output_path.resolve(), renderer_args, backend, base_dir)
    t0 = time.perf_counter()
    try:
        env = dict(os.environ)
        repo = Path(__file__).resolve().parents[2]
        env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=TIMEOUT_SECONDS,
            cwd=base_dir, env=env,
        )
    except subprocess.TimeoutExpired:
        return TestResult(
            spec.name, "ERROR", time.perf_counter() - t0,
            message=f"renderer timed out after {TIMEOUT_SECONDS}s",
        )
    elapsed = time.perf_counter() - t0

    # absolute -o still lands under scenes/output with the abs path joined;
    # normalize by finding where the CLI actually wrote
    actual = _locate_output(base_dir, output_path)
    if proc.returncode != 0:
        return TestResult(
            spec.name, "ERROR", elapsed,
            message=_error_summary(proc.stderr, proc.returncode),
        )
    if actual is None:
        return TestResult(
            spec.name, "ERROR", elapsed, message="renderer produced no output"
        )
    if actual != output_path:
        output_path.parent.mkdir(parents=True, exist_ok=True)
        actual.replace(output_path)

    if not visual or spec.skip_visual:
        return TestResult(
            spec.name, "SKIP", elapsed, output_path=str(output_path)
        )

    if not reference_path.exists():
        return TestResult(
            spec.name, "NEW", elapsed,
            message="no blessed reference; run with --bless",
            output_path=str(output_path),
        )

    try:
        diff = compare_images(output_path, reference_path)
    except Exception as e:
        return TestResult(
            spec.name, "ERROR", elapsed, message=f"diff failed: {e}",
            output_path=str(output_path), reference_path=str(reference_path),
        )
    if stat_gate:
        # cross-backend statistical gate (GPU vs CPU-blessed references):
        # beauty gated on tonemapped image-mean agreement, AOVs on a
        # small MSE bound; specular-transport scenes carry a larger
        # per-scene bound in tests.toml (delta chains make whole paths
        # flip under FMA-contraction ULPs, so the cross-backend spread
        # of even the tonemapped mean stays several percent at gate spp)
        ok = diff.stat_passes(
            spec.settings.stat_rel_mean, spec.settings.stat_block_rel
        )
        tol = spec.settings.stat_rel_mean
        msg = (
            f"stat gate [{diff.channel_group}]: rel_mean="
            f"{diff.rel_mean:.4f}"
            + (f" (tol {tol})" if tol is not None else "")
            + f" block_rel={diff.block_rel:.4f}"
            + f" mse={diff.mse:.2e}"
        )
    else:
        ok = diff.passes(tolerance)
        msg = ""
    status = "PASS" if ok else "FAIL"
    return TestResult(
        spec.name, status, elapsed, mse=diff.mse, max_diff=diff.max_diff,
        message=msg,
        output_path=str(output_path), reference_path=str(reference_path),
    )


def _error_summary(stderr: str, returncode: int) -> str:
    """One readable line from a failed renderer's stderr.

    Prefers the actual exception line over trailing boilerplate (JAX
    appends 'For simplicity, JAX has removed its internal frames...'
    AFTER the exception, so the last line is useless evidence)."""
    if not stderr:
        return f"renderer failed (exit {returncode})"
    lines = [ln.strip() for ln in stderr.strip().splitlines() if ln.strip()]
    for ln in reversed(lines):
        # 'SomeError: message' / 'Exception: message' shaped lines
        head = ln.split(":", 1)[0]
        if head.endswith(("Error", "Exception", "Interrupt")) and " " not in head:
            return ln[:300]
    for ln in reversed(lines):
        if "error" in ln.lower() or "crash" in ln.lower():
            return ln[:300]
    return lines[-1][:300]


def _locate_output(base_dir: Path, requested: Path) -> Optional[Path]:
    """The CLI joins -o onto scenes/output/; find the file it wrote."""
    if requested.exists():
        return requested
    joined = base_dir / "scenes" / "output" / requested.name
    if joined.exists():
        return joined
    # absolute -o joined onto scenes/output keeps the abs path's tail on
    # POSIX (Path('/a') / Path('/b/c.exr') -> '/b/c.exr'), so requested is
    # normally correct; this is a fallback for relative -o
    rel = base_dir / "scenes" / "output" / requested
    return rel if rel.exists() else None


def run_tests(
    specs: List[TestSpec],
    output_dir: Path,
    reference_dir: Path,
    renderer_args: List[str],
    backend: str,
    base_dir: Path,
    tolerance: float,
    visual: bool = True,
    stat_gate: bool = False,
) -> List[TestResult]:
    results = []
    for spec in specs:
        res = run_single_test(
            spec, output_dir, reference_dir, renderer_args, backend,
            base_dir, tolerance, visual, stat_gate,
        )
        icon = {
            "PASS": "✓", "FAIL": "✗", "NEW": "?", "ERROR": "!", "SKIP": "-"
        }[res.status]
        print(
            f"  {icon} {res.name:<24} {res.status:<5} "
            f"{res.render_time_seconds:7.2f}s"
            + (f"  mse={res.mse:.3e}" if res.mse is not None else "")
            + (f"  {res.message}" if res.message else ""),
            flush=True,
        )
        results.append(res)
    return results
