"""The CUDA BVH walk, checked without a GPU.

The kernel itself runs only on the card (chip_smoke.py phase 3). Here: the walk's core (csrc/bvh_walk.cuh, the
same source the kernel compiles) built for the host must agree with the
XLA walk; lowering intersect_scene for CUDA emits one FFI custom call per
traversal pass with the XLA walk's operands; the CPU lowering emits none.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import export

from tpu_raytracing.device import compile_scene
from tpu_raytracing.ops import bvh_walk_cuda
from tpu_raytracing.ops import traverse as T
from tpu_raytracing.ops.traverse import intersect_scene
from tpu_raytracing.scene.test_scenes import (
    coated_diffuse_bunny_scene, cornell_box, cube_scene, grid_pair_scene,
    metal_scene,
)

B = 64
_CALL = re.compile(
    r"stablehlo\.custom_call @" + bvh_walk_cuda.TARGET
    + r"\((?P<ops>[^)]*)\) \{mhlo\.backend_config = \{(?P<cfg>[^}]*)\}"
    r".*?: \((?P<types>[^)]*)\) -> "
)
_SCENES = {
    "bunny": coated_diffuse_bunny_scene,       # one main-accel pass
    "instanced": lambda: grid_pair_scene(True),  # one pass per instance
    "metal": metal_scene,                      # spheres + main accel
}
_DS: dict = {}


def _ds(name):
    if name not in _DS:
        _DS[name] = compile_scene(_SCENES[name]())
    return _DS[name]


def _lowered_text(ds, any_hit, platform):
    def f(ds_, o, d, tmin, tmax):
        return intersect_scene(ds_, o, d, tmin, tmax, early_exit=any_hit)

    args = (ds, jnp.zeros((B, 3)), jnp.ones((B, 3)), jnp.zeros(B),
            jnp.full(B, jnp.inf))
    if platform == "cpu":
        return jax.jit(f).lower(*args).as_text()
    exp = export.export(
        jax.jit(f), platforms=(platform,),
        disabled_checks=[
            export.DisabledSafetyCheck.custom_call(bvh_walk_cuda.TARGET)
        ],
    )(*args)
    return exp.mlir_module()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("name", list(_SCENES))
def test_cuda_lowering_has_one_walk_call_per_pass(name, any_hit):
    ds = _ds(name)
    calls = list(_CALL.finditer(_lowered_text(ds, any_hit, "cuda")))
    n_passes = int(ds.meta.n_tris > 0) + len(ds.meta.instances)
    assert len(calls) == n_passes
    for m in calls:
        types = [t.strip() for t in m.group("types").split(", ")]
        assert types[0].endswith("x16xf32>")   # child-pair rows
        assert types[1].endswith("x9xf32>")    # triangles
        assert types[2:] == [
            f"tensor<{B}x3xf32>", f"tensor<{B}x3xf32>", f"tensor<{B}xf32>",
            f"tensor<{B}xf32>", f"tensor<{B}xi32>", f"tensor<{B}xi1>",
        ]
        assert f"any_hit = {str(any_hit).lower()}" in m.group("cfg")
        assert "root = " in m.group("cfg") and ": i32" in m.group("cfg")


@pytest.mark.parametrize("name", list(_SCENES))
def test_cpu_lowering_has_no_walk_call(name):
    text = _lowered_text(_ds(name), False, "cpu")
    assert bvh_walk_cuda.TARGET not in text


_HOST_SHIM = r"""
#include <cstdint>
#include "bvh_walk.cuh"
extern "C" void host_walk(const float* rows, const float* tris,
                          const float* o, const float* d, const float* tmin,
                          float* t_best, int32_t* best, const uint8_t* active,
                          int64_t n, int root, int any_hit) {
  for (int64_t i = 0; i < n; ++i) {
    if (!active[i] || root == rt::kDone || (any_hit && best[i] >= 0)) continue;
    const rt::Ray r = rt::make_ray(o + 3 * i, d + 3 * i, tmin[i]);
    float tb = t_best[i];
    int b = best[i];
    if (any_hit) rt::walk<true>(rows, tris, root, r, tb, b);
    else rt::walk<false>(rows, tris, root, r, tb, b);
    t_best[i] = tb;
    best[i] = b;
  }
}
"""


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    """The kernel's per-ray walk compiled for the host (no CUDA needed)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of the walk")
    d = tmp_path_factory.mktemp("host_walk")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib_path = d / "libhostwalk.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
         f"-DRT_MAX_STACK={bvh_walk_cuda.MAX_STACK}",
         "-I", str(bvh_walk_cuda._CSRC), "-o", str(lib_path),
         str(d / "shim.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(lib_path))
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.host_walk.argtypes = [
        f32, f32, f32, f32, f32, f32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ]
    lib.host_walk.restype = None
    return lib


_HOST_SCENES = {
    "bunny": coated_diffuse_bunny_scene,
    "cornell": lambda: cornell_box().build(),
    "cube": cube_scene,
}


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("name", list(_HOST_SCENES))
def test_walk_core_on_host_matches_xla_walk(host_walk, name, any_hit):
    key = "host_" + name
    if key not in _DS:
        _DS[key] = compile_scene(_HOST_SCENES[name]())
    ds = _DS[key]
    rng = np.random.default_rng(len(name))
    n = 4096
    c = np.asarray(ds.bounds_center)
    r = float(ds.bounds_radius)
    o = (c + rng.uniform(-1.2, 1.2, (n, 3)) * r).astype(np.float32)
    d = (c + rng.uniform(-0.5, 0.5, (n, 3)) * r - o).astype(np.float32)
    d[::37, 2] = 0.0  # axis-parallel components: inf/NaN slab terms
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(n, 1e-4, np.float32)
    t_best = np.full(n, np.inf, np.float32)
    t_best[::4] = r
    best = np.full(n, -1, np.int32)
    best[::9] = 0  # an earlier winner: any-hit lanes skip, closest keeps t
    active = rng.uniform(size=n) > 0.2

    tx, px = T._walk_xla(
        ds.bvh2_rows, ds.tri_pack, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_min), jnp.asarray(t_best), jnp.asarray(best),
        jnp.asarray(active), root=ds.meta.root_meta,
        depth=ds.meta.bvh2_depth, early_exit=any_hit,
    )
    th, ph = t_best.copy(), best.copy()
    host_walk.host_walk(
        np.ascontiguousarray(ds.bvh2_rows, np.float32),
        np.ascontiguousarray(ds.tri_pack, np.float32), o, d, t_min, th, ph,
        active.astype(np.uint8), n, ds.meta.root_meta, int(any_hit),
    )
    tx, px = np.asarray(tx), np.asarray(px)
    assert (px != best).sum() > 50, "rays must find new winners"
    if any_hit:
        assert np.mean((px >= 0) == (ph >= 0)) >= 0.9999
    else:
        same = px == ph
        assert np.mean(same) >= 0.9999
        hit = same & (px >= 0)
        np.testing.assert_allclose(th[hit], tx[hit], rtol=1e-5)
    # inactive lanes come back untouched
    np.testing.assert_array_equal(ph[~active], best[~active])
    np.testing.assert_array_equal(th[~active], t_best[~active])
