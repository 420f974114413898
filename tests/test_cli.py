"""CLI contract tests (the rttest harness depends on this surface)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(args, cwd, timeout=420, env_extra=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # the package is run from the repo tree, not an installed wheel
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    if env_extra:
        env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-m", "tpu_raytracing.cli", *args],
        capture_output=True, text=True, timeout=timeout, cwd=cwd, env=env,
    )


def test_list_scenes(tmp_path):
    r = _run(["list-scenes"], tmp_path)
    assert r.returncode == 0
    names = json.loads(r.stdout)
    assert "sphere" in names and "coated_diffuse_bunny" in names
    assert len(names) == 11


def test_missing_scene_is_error(tmp_path):
    r = _run(["full"], tmp_path)
    assert r.returncode == 1
    assert "scene-path or --scene-name" in r.stderr


def test_full_render_exr_channels(tmp_path):
    r = _run(
        ["--scene-name", "sphere", "-s", "1", "-o", "out.exr", "full",
         "--aov", "n,u"],
        tmp_path,
    )
    assert r.returncode == 0, r.stderr
    out = tmp_path / "scenes/output/out.exr"
    assert out.exists()
    from tpu_raytracing.utils.exr import read_exr

    channels, w, h = read_exr(out)
    # sphere builtin settings are NORMALS-only; --aov adds UV
    assert {"Normal.X", "Normal.Y", "Normal.Z", "U", "V"} <= set(channels)
    assert (w, h) == (400, 400)


def test_pixel_subcommand(tmp_path):
    r = _run(
        ["--scene-name", "checkered_plane", "-s", "1", "pixel", "250", "250"],
        tmp_path,
    )
    assert r.returncode == 0, r.stderr
    assert "sample 0" in r.stdout
    assert "hit: True" in r.stdout
    assert "radiance:" in r.stdout


def test_multichip_flag_bit_exact(tmp_path):
    """cli.py --multichip (8 virtual CPU devices) produces the same EXR,
    bit for bit, as the single-device render — the reference's determinism-
    across-workers contract (visual-testing/README.md:103)."""
    from tpu_raytracing.utils.exr import read_exr

    common = ["--scene-name", "checkered_plane", "-s", "1", "-l", "1"]
    r1 = _run([*common, "-o", "single.exr", "full"], tmp_path)
    assert r1.returncode == 0, r1.stderr
    r8 = _run(
        [*common, "-o", "multi.exr", "--multichip", "full"],
        tmp_path,
        env_extra={"XLA_FLAGS": "--xla_force_host_platform_device_count=8"},
    )
    assert r8.returncode == 0, r8.stderr
    single, w, h = read_exr(tmp_path / "scenes/output/single.exr")
    multi, w2, h2 = read_exr(tmp_path / "scenes/output/multi.exr")
    assert (w, h) == (w2, h2)
    for ch in ("R", "G", "B"):
        np.testing.assert_array_equal(multi[ch], single[ch])
