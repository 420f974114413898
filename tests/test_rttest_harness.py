"""Unit tests for the rttest harness internals (spec parsing, perf gating,
diff channel detection) — the harness itself gates the renderer, so its
logic needs its own coverage."""
from pathlib import Path

import numpy as np
import pytest

from visual_testing.rttest.diff import compare_images, load_exr_channels
from visual_testing.rttest.perf import (
    PerfBaseline, PerfHistory, make_record, settings_hash,
)
from visual_testing.rttest.test_spec import TestSettings, load_test_suite


def test_load_suite(tmp_path):
    (tmp_path / "t.toml").write_text(
        """
[defaults]
samples_per_pixel = 4

[[test]]
name = "a"
builtin_scene = "sphere"

[[test]]
name = "b"
scene_path = "x/y.pbrt"
skip_visual = true
[test.settings]
samples_per_pixel = 16
aov = ["normal", "uv"]
no_beauty = true
"""
    )
    specs = load_test_suite(tmp_path / "t.toml")
    assert [s.name for s in specs] == ["a", "b"]
    assert specs[0].settings.samples_per_pixel == 4  # default applied
    assert specs[1].settings.samples_per_pixel == 16  # overridden
    args = specs[1].settings.to_cli_args()
    assert args == ["-s", "16", "full", "--aov", "normal,uv", "--no-beauty"]
    assert specs[1].skip_visual


def test_suite_rejects_ambiguous_scene(tmp_path):
    (tmp_path / "t.toml").write_text(
        '[[test]]\nname = "x"\nbuiltin_scene = "a"\nscene_path = "b"\n'
    )
    with pytest.raises(ValueError, match="exactly one"):
        load_test_suite(tmp_path / "t.toml")


def test_perf_regression_gate(tmp_path):
    baseline = PerfBaseline(tmp_path / "b.json")
    rec = make_record("s", 1.0, ["-s", "2"], "cpu", 2, 1)
    baseline.set(rec)
    baseline.save()

    b2 = PerfBaseline(tmp_path / "b.json")
    slow = make_record("s", 1.2, ["-s", "2"], "cpu", 2, 1)
    reg = b2.check_regression(slow, threshold_pct=10.0)
    assert reg is not None and reg["delta_pct"] == pytest.approx(20.0)
    # same slowdown but different settings hash: not gated
    other = make_record("s", 1.2, ["-s", "4"], "cpu", 4, 1)
    assert b2.check_regression(other, 10.0) is None
    # within threshold: not gated
    ok = make_record("s", 1.05, ["-s", "2"], "cpu", 2, 1)
    assert b2.check_regression(ok, 10.0) is None


def test_settings_hash_order_independent():
    assert settings_hash(["-s", "2", "-l", "1"], "cpu") == settings_hash(
        ["-l", "1", "-s", "2"], "cpu"
    )
    assert settings_hash(["-s", "2"], "cpu") != settings_hash(["-s", "2"], "gpu")


def test_perf_history_roundtrip(tmp_path):
    h = PerfHistory(tmp_path / "h.jsonl")
    h.append(make_record("a", 1.0, [], "cpu", 1, 1))
    h.append(make_record("b", 2.0, [], "cpu", 1, 1))
    h.append(make_record("a", 3.0, [], "cpu", 1, 1))
    recs = h.records_for("a")
    assert [r.render_time_seconds for r in recs] == [1.0, 3.0]


def test_diff_channel_groups(tmp_path):
    from tpu_raytracing.utils.exr import write_exr

    h, w = 8, 16
    rng = np.random.default_rng(0)
    img = rng.random((h, w)).astype(np.float32)
    # normals-only EXR picks the Normal group
    write_exr(
        tmp_path / "n.exr",
        {"Normal.X": img, "Normal.Y": img, "Normal.Z": img},
    )
    group, data = load_exr_channels(tmp_path / "n.exr")
    assert group == "Normal" and data.shape == (h, w, 3)

    write_exr(tmp_path / "n2.exr",
              {"Normal.X": img, "Normal.Y": img, "Normal.Z": img + 0.5})
    d = compare_images(tmp_path / "n.exr", tmp_path / "n2.exr")
    assert d.mse == pytest.approx(0.25 / 3)
    assert d.max_diff == pytest.approx(0.5)
    assert not d.passes(0.0)
    assert d.passes(0.1)
