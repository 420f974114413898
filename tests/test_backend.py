"""The per-platform policy (tpu_raytracing/backend.py) and what it rules out."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_raytracing import backend
from visual_testing.rttest.main import uses_stat_gate

REPO = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_gpu_backend_raises_without_gpu():
    r = subprocess.run(
        [sys.executable, "-c",
         "from tpu_raytracing import backend; backend.select_platform('gpu')"],
        capture_output=True, text=True, timeout=120, env=_env(),
    )
    assert r.returncode != 0
    assert "RuntimeError" in r.stderr and "gpu" in r.stderr


def test_cli_gpu_backend_fails_without_gpu(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "tpu_raytracing.cli", "--scene-name",
         "sphere", "-s", "1", "--backend", "gpu", "full"],
        capture_output=True, text=True, timeout=120, env=_env(), cwd=tmp_path,
    )
    assert r.returncode == 2
    assert "error: --backend gpu" in r.stderr
    assert not (tmp_path / "scenes").exists()


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown backend"):
        backend.select_platform("rocm")


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir_rule(monkeypatch, tmp_path, env_dir):
    before = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "set-by-jax")
    try:
        jax.config.update("jax_compilation_cache_dir", sentinel)
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path / env_dir))
        backend.setup_compile_cache()
        got = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_dir is None:
        # fixed <checkout>/.jax_cache, never a temporary path
        assert got == str(REPO / ".jax_cache")
        assert Path(got) == backend.DEFAULT_CACHE_DIR
    else:
        # the variable is JAX's own; the code sets no other directory
        assert got == sentinel


def test_chunk_width_constants():
    assert backend.chunk_pixels() == backend.CPU_CHUNK_PIXELS  # CPU run
    g = backend.GPU_CHUNK_PIXELS
    assert g & (g - 1) == 0 and (1 << 14) <= g <= (1 << 19)


def test_coherence_sort_off_by_default():
    assert backend.coherence_sort(None) is False


@pytest.mark.parametrize(
    "platform,tolerance,flag,expected",
    [
        ("gpu", None, False, True),    # cross-backend: statistical gate
        ("gpu", 1e-3, False, False),   # explicit tolerance: MSE gate
        ("cpu", None, False, False),   # same backend: bit-exact
        ("jax", None, True, True),     # forced
    ],
)
def test_rttest_gate_choice(platform, tolerance, flag, expected):
    assert uses_stat_gate(platform, tolerance, flag) is expected


def test_rttest_backend_choices_match_policy():
    from visual_testing.rttest import main as rt_main

    assert rt_main.BACKENDS == backend.BACKENDS


def test_no_tpu_platform_code():
    """No module imports the Pallas TPU dialect or branches on a TPU."""
    dialect = re.compile(r"pallas\s*(\.|import)\s*" + "tpu" + r"\b")
    branch = re.compile(r"""(==|!=)\s*["']""" + "tpu" + r"""["']|["']"""
                        + "tpu" + r"""["']\s*(==|!=)""")
    files = [p for p in REPO.rglob("*.py")
             if ".git" not in p.parts and "chiprun_out" not in p.parts]
    assert len(files) > 50
    bad = []
    for p in files:
        text = p.read_text(errors="replace")
        if dialect.search(text) or branch.search(text):
            bad.append(str(p.relative_to(REPO)))
    assert bad == []


def _primitives(jaxpr, out):
    for eqn in jaxpr.eqns:
        out.add(eqn.primitive.name)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            _primitives(sub, out)
    return out


@pytest.mark.parametrize("scene", ["metal", "grid_pair"])
def test_beauty_jaxpr_has_no_dot_general(scene):
    """Geometry and shading contract in explicit f32 elementwise math, so a
    TF32 or bf16 matmul default can never touch them."""
    from tpu_raytracing.device import compile_scene
    from tpu_raytracing.integrator.render import (
        StaticSettings, render_beauty_chunk,
    )
    from tpu_raytracing.ops.rng import SamplerConfig
    from tpu_raytracing.scene import test_scenes as TS
    from tpu_raytracing.settings import RaytracerSettings

    sc = TS.metal_scene() if scene == "metal" else TS.grid_pair_scene(True)
    ds = compile_scene(sc)
    s = RaytracerSettings(samples_per_pixel=1, light_sample_count=1,
                          max_ray_depth=3)
    cfg = SamplerConfig.from_settings(s.sampler, s.seed)
    st = StaticSettings.from_settings(s)
    px = jnp.zeros(64, jnp.uint32)
    jaxpr = jax.make_jaxpr(
        lambda ds_, a, b: render_beauty_chunk(ds_, cfg, st, a, b)
    )(ds, px, px)
    prims = _primitives(jaxpr.jaxpr, set())
    assert "while" in prims
    assert "dot_general" not in prims


def test_linalg_ignores_matmul_precision():
    from tpu_raytracing.ops.linalg import (
        apply_point, apply_vector, apply_vector_transposed,
    )

    rng = np.random.default_rng(4)
    m = jnp.asarray(rng.normal(size=(32, 4, 4)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(32, 3)).astype(np.float32))
    outs = {}
    for prec in ("bfloat16", "tensorfloat32", "highest"):
        with jax.default_matmul_precision(prec):
            outs[prec] = [
                np.asarray(jax.jit(f)(m, v))
                for f in (apply_point, apply_vector, apply_vector_transposed)
            ]
    for prec in ("bfloat16", "tensorfloat32"):
        for a, b in zip(outs[prec], outs["highest"]):
            np.testing.assert_array_equal(a, b)
