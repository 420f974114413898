"""TOML test specifications (parity: visual-testing/src/rttest/test_spec.py).

Format:
    [defaults]                     # render settings applied to every test
    [[test]]
    name = "sphere"
    builtin_scene = "sphere"       # or scene_path = "relative/to/tests.toml"
    description = "..."
    tags = ["geometry"]
    skip_visual = false
    [test.settings]                # per-test overrides, appended to CLI args
    samples_per_pixel = 4
    light_samples = 2
    aov = ["normal", "uv"]
    no_beauty = true
"""
from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional


@dataclass
class TestSettings:
    samples_per_pixel: Optional[int] = None
    light_samples: Optional[int] = None
    aov: List[str] = field(default_factory=list)
    no_beauty: bool = False
    # per-scene cross-backend statistical tolerance override (tonemapped
    # rel-mean bound for the gpu gate); None = the gate default
    stat_rel_mean: Optional[float] = None
    # per-scene spatial (block-mean) bound; None = BLOCK_TOL_FACTOR x the
    # effective rel-mean tolerance
    stat_block_rel: Optional[float] = None

    @staticmethod
    def from_dict(d: dict) -> "TestSettings":
        return TestSettings(
            samples_per_pixel=d.get("samples_per_pixel"),
            light_samples=d.get("light_samples"),
            aov=list(d.get("aov", [])),
            no_beauty=bool(d.get("no_beauty", False)),
            stat_rel_mean=d.get("stat_rel_mean"),
            stat_block_rel=d.get("stat_block_rel"),
        )

    def merged_with(self, defaults: "TestSettings") -> "TestSettings":
        return TestSettings(
            samples_per_pixel=(
                self.samples_per_pixel
                if self.samples_per_pixel is not None
                else defaults.samples_per_pixel
            ),
            light_samples=(
                self.light_samples
                if self.light_samples is not None
                else defaults.light_samples
            ),
            aov=self.aov or list(defaults.aov),
            no_beauty=self.no_beauty or defaults.no_beauty,
            stat_rel_mean=(
                self.stat_rel_mean
                if self.stat_rel_mean is not None
                else defaults.stat_rel_mean
            ),
            stat_block_rel=(
                self.stat_block_rel
                if self.stat_block_rel is not None
                else defaults.stat_block_rel
            ),
        )

    def to_cli_args(self) -> List[str]:
        """Settings that override/extend the user's renderer args."""
        args: List[str] = []
        if self.samples_per_pixel is not None:
            args += ["-s", str(self.samples_per_pixel)]
        if self.light_samples is not None:
            args += ["-l", str(self.light_samples)]
        full_args: List[str] = []
        if self.aov:
            full_args += ["--aov", ",".join(self.aov)]
        if self.no_beauty:
            full_args += ["--no-beauty"]
        return args + ["full"] + full_args


@dataclass
class TestSpec:
    name: str
    builtin_scene: Optional[str] = None
    scene_path: Optional[Path] = None
    description: str = ""
    tags: List[str] = field(default_factory=list)
    skip_visual: bool = False
    settings: TestSettings = field(default_factory=TestSettings)

    def scene_cli_args(self, base_dir: Path) -> List[str]:
        if self.builtin_scene is not None:
            return ["--scene-name", self.builtin_scene]
        return ["--scene-path", str(base_dir / self.scene_path)]


def load_test_suite(path: Path) -> List[TestSpec]:
    with open(path, "rb") as f:
        tree = tomllib.load(f)
    defaults = TestSettings.from_dict(tree.get("defaults", {}))
    specs = []
    for t in tree.get("test", []):
        if "name" not in t:
            raise ValueError("test entry without name")
        if ("builtin_scene" in t) == ("scene_path" in t):
            raise ValueError(
                f"test {t['name']}: exactly one of builtin_scene/scene_path required"
            )
        settings = TestSettings.from_dict(t.get("settings", {})).merged_with(defaults)
        specs.append(
            TestSpec(
                name=t["name"],
                builtin_scene=t.get("builtin_scene"),
                scene_path=Path(t["scene_path"]) if "scene_path" in t else None,
                description=t.get("description", ""),
                tags=list(t.get("tags", [])),
                skip_visual=bool(t.get("skip_visual", False)),
                settings=settings,
            )
        )
    return specs
