"""Distribution bundler (parity: crates/xtask `cargo xtask bundle`).

The reference bundler builds the CLI, collects libembree4.so /
libraytracing_optix.so next to it, and patches $ORIGIN rpaths
(crates/xtask/src/bundle.rs:36-82). The equivalent here builds the native
runtime library, copies the Python package + visual-testing harness into a
self-contained dist/ tree, and emits launcher scripts that pin PYTHONPATH —
so `dist/tpu-raytracing ...` runs anywhere with the baked environment.

Usage: python -m tpu_raytracing.bundle [--output-dir dist]
"""
from __future__ import annotations

import argparse
import os
import shutil
import stat
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def bundle(output_dir: Path) -> Path:
    output_dir = output_dir.resolve()
    if output_dir.exists():
        shutil.rmtree(output_dir)
    output_dir.mkdir(parents=True)

    # 1. build the native runtime
    csrc = REPO / "csrc"
    try:
        subprocess.run(["make", "-C", str(csrc)], check=True, capture_output=True)
    except subprocess.CalledProcessError as e:
        print(f"warning: native build failed ({e}); bundling python-only",
              file=sys.stderr)

    # 2. copy the package + harness
    def ignore(_, names):
        return [n for n in names if n == "__pycache__" or n.endswith(".pyc")]

    shutil.copytree(REPO / "tpu_raytracing", output_dir / "tpu_raytracing",
                    ignore=ignore)
    shutil.copytree(REPO / "visual_testing", output_dir / "visual_testing",
                    ignore=ignore)
    (output_dir / "csrc").mkdir()
    shutil.copy(csrc / "Makefile", output_dir / "csrc/Makefile")
    shutil.copy(csrc / "bvh_builder.cpp", output_dir / "csrc/bvh_builder.cpp")
    so = csrc / "librtnative.so"
    if so.exists():
        shutil.copy(so, output_dir / "csrc/librtnative.so")
    for extra in ("bench.py", "__graft_entry__.py", "README.md"):
        src = REPO / extra
        if src.exists():
            shutil.copy(src, output_dir / extra)

    # 3. launcher scripts (the $ORIGIN-rpath equivalent: pin PYTHONPATH)
    for name, module in (
        ("tpu-raytracing", "tpu_raytracing.cli"),
        ("tpu-raytracing-viewer", "tpu_raytracing.viewer"),
        ("rttest", "visual_testing.rttest"),
    ):
        path = output_dir / name
        path.write_text(
            "#!/bin/sh\n"
            'HERE="$(cd "$(dirname "$0")" && pwd)"\n'
            f'PYTHONPATH="$HERE${{PYTHONPATH:+:$PYTHONPATH}}" '
            f'exec {sys.executable} -m {module} "$@"\n'
        )
        path.chmod(path.stat().st_mode | stat.S_IEXEC | stat.S_IXGRP | stat.S_IXOTH)
    return output_dir


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu-raytracing-bundle")
    p.add_argument("--output-dir", type=Path, default=REPO / "dist")
    args = p.parse_args(argv)
    out = bundle(args.output_dir)
    print(f"bundled -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
