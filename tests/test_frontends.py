"""Frontend smoke tests: bundler output, headless viewer, TUI form logic."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("DISPLAY", None)
    env.pop("WAYLAND_DISPLAY", None)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_bundle_creates_launchers(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "tpu_raytracing.bundle", "--output-dir",
         str(tmp_path / "dist")],
        capture_output=True, text=True, timeout=180, env=_env(),
    )
    assert r.returncode == 0, r.stderr
    dist = tmp_path / "dist"
    for launcher in ("tpu-raytracing", "tpu-raytracing-viewer", "rttest"):
        assert (dist / launcher).exists()
        assert os.access(dist / launcher, os.X_OK)
    assert (dist / "tpu_raytracing/cli.py").exists()
    assert (dist / "visual_testing/rttest/main.py").exists()
    # the launcher actually runs from the bundle
    r = subprocess.run(
        [str(dist / "tpu-raytracing"), "list-scenes"],
        capture_output=True, text=True, timeout=120, env=_env(),
    )
    assert r.returncode == 0 and "sphere" in r.stdout


def test_viewer_headless_writes_png(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "tpu_raytracing.viewer", "--scene-name",
         "checkered_plane", "-s", "1", "-d", "2", "--backend", "cpu"],
        capture_output=True, text=True, timeout=400, env=_env(),
        cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "checkered_plane_view.png").exists()


def test_tui_cycle_logic():
    from tpu_raytracing.tui import _cycle_list

    assert _cycle_list(["a", "b", "c"], "a", 1) == "b"
    assert _cycle_list(["a", "b", "c"], "a", -1) == "c"
    assert _cycle_list(["a", "b"], "zz", 1) == "a"


def test_tui_form_state_roundtrip():
    """build_form_state/apply_form_state map CLI args <-> form fields."""
    import argparse

    from tpu_raytracing.tui import (
        _toggle_aov, apply_form_state, build_form_state,
    )

    args = argparse.Namespace(
        command="full", scene_name=None, scene_path=None, backend="jax",
        sampler=None, spp=None, ray_depth=None, light_samples=None,
        output=None, output_format=None, aov=["n,u"], no_beauty=False,
        interactive=True,
    )
    st = build_form_state(args, ["sphere", "cube"])
    assert st["scene"] == "sphere" and st["aov"] == ["n", "u"]
    _toggle_aov(st, "a")
    _toggle_aov(st, "n")
    st["spp"] = "16"
    st["command"] = "pixel"
    st["px"], st["py"], st["count"] = "3", "7", "2"
    out = apply_form_state(args, st)
    assert out.command == "pixel" and out.spp == 16
    assert (out.x, out.y, out.sample_count) == (3, 7, 2)
    st["command"] = "full"
    out = apply_form_state(args, st)
    assert out.aov == ["u,a"] and out.no_beauty is False
