"""The XLA BVH walk against brute force, scene by scene.

The walk (ops/traverse.py::_walk_xla) is what runs on the CPU and the
reference the CUDA walk is held to on the card, so it is checked here
against an all-triangles brute force for closest hit and any hit, with
inactive lanes that must stay missed.
"""
from __future__ import annotations

import zlib

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_raytracing.device import compile_scene
from tpu_raytracing.geometry import Mesh, TriangleMesh, v3, v4
from tpu_raytracing.materials import Diffuse
from tpu_raytracing.ops import bvh_walk_cuda
from tpu_raytracing.ops.intersect import ray_triangle
from tpu_raytracing.ops.traverse import intersect_scene
from tpu_raytracing.scene import SceneBuilder
from tpu_raytracing.scene.camera import Camera
from tpu_raytracing.scene.test_scenes import (
    coated_diffuse_bunny_scene, cornell_box, cube_scene, grid_pair_scene,
)

F = np.float32
N_RAYS = 384


def bumpy_sphere_mesh(n_lat: int = 160, n_lon: int = 160) -> Mesh:
    """Seeded displaced UV sphere: 2 * n_lat * n_lon triangles."""
    rng = np.random.default_rng(11)
    th = np.linspace(0.0, np.pi, n_lat + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_lon + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    r = 1.0 + 0.05 * rng.standard_normal(tt.shape)
    r[:, -1] = r[:, 0]
    verts = np.stack(
        [r * np.sin(tt) * np.cos(pp), r * np.sin(tt) * np.sin(pp),
         r * np.cos(tt)], axis=-1,
    ).reshape(-1, 3)
    idx = np.arange((n_lat + 1) * (n_lon + 1)).reshape(n_lat + 1, n_lon + 1)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, c, d], 1), np.stack([a, d, b], 1)])
    return Mesh(vertices=verts, tris=tris)


def bumpy_sphere_scene():
    sb = SceneBuilder()
    mat = sb.add_material(Diffuse(albedo=sb.add_constant_texture(v4(1, 1, 1, 1))))
    sb.add_shape_at_position(TriangleMesh(bumpy_sphere_mesh()), mat, v3(0, 0, 0))
    sb.add_camera(
        Camera.lookat_camera_perspective(
            v3(0, -4, 0), v3(0, 0, 0), v3(0, 0, 1), False, 0.7, 32, 32
        )
    )
    return sb.build()


SCENES = {
    "cube": lambda: compile_scene(cube_scene()),
    "bunny": lambda: compile_scene(coated_diffuse_bunny_scene()),
    "cornell": lambda: compile_scene(cornell_box().build()),
    "instanced_pair": lambda: compile_scene(grid_pair_scene(shared=True)),
    "bumpy_sphere": lambda: compile_scene(bumpy_sphere_scene()),
}
_CACHE: dict = {}


def _scene(name):
    if name not in _CACHE:
        ds = SCENES[name]()
        # brute-force reference geometry: the instanced pair is checked
        # against its world-space-baked twin's triangles
        tri_ds = (compile_scene(grid_pair_scene(shared=False))
                  if name == "instanced_pair" else ds)
        n = tri_ds.meta.n_tris
        tris = np.asarray(tri_ds.tri_pack)[:n]
        _CACHE[name] = (ds, tris)
    return _CACHE[name]


def _rays(ds, rng):
    c = np.asarray(ds.bounds_center)
    r = float(ds.bounds_radius)
    o = c + rng.uniform(-1.5, 1.5, (N_RAYS, 3)) * r
    target = c + rng.uniform(-0.5, 0.5, (N_RAYS, 3)) * r
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::41, 1] = 0.0  # axis-parallel components: inf/NaN slab terms
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(N_RAYS, np.inf, F)
    t_max[::3] = 0.8 * r * rng.uniform(0.5, 2.0, t_max[::3].shape)
    active = rng.uniform(size=N_RAYS) > 0.25
    return o.astype(F), d.astype(F), np.full(N_RAYS, 1e-4, F), t_max, active


def _brute(tris, o, d, t_min, t_max):
    _, t, _, _ = ray_triangle(
        jnp.asarray(o)[:, None, :], jnp.asarray(d)[:, None, :],
        jnp.asarray(tris[None, :, 0:3]), jnp.asarray(tris[None, :, 3:6]),
        jnp.asarray(tris[None, :, 6:9]),
        jnp.asarray(t_min)[:, None], jnp.asarray(t_max)[:, None],
    )
    return np.asarray(jnp.min(t, axis=1))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("name", list(SCENES))
def test_xla_walk_matches_brute_force(name, any_hit):
    ds, tris = _scene(name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    o, d, t_min, t_max, active = _rays(ds, rng)
    t, prim = intersect_scene(
        ds, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
        jnp.asarray(t_max), early_exit=any_hit, active=jnp.asarray(active),
    )
    t, prim = np.asarray(t), np.asarray(prim)
    tb = _brute(tris, o, d, t_min, t_max)
    hit_ref = np.isfinite(tb) & active

    # inactive lanes are held missed
    assert np.all(prim[~active] == -1) and np.all(np.isinf(t[~active]))
    assert hit_ref.sum() > 10, "ray set must hit something"
    hit = prim >= 0
    # hit/miss flips only from cross-space FMA ULPs at instance silhouettes
    flips = np.mean(hit != hit_ref)
    assert flips <= (0.01 if name == "instanced_pair" else 0.0), flips
    both = hit & hit_ref
    if any_hit:
        # any hit: a real triangle within [t_min, t_max]
        assert np.all(t[both] <= t_max[both]) and np.all(t[both] >= t_min[both])
    else:
        np.testing.assert_allclose(t[both], tb[both], rtol=1e-4)


def test_scene_deeper_than_kernel_stack_is_refused(monkeypatch):
    monkeypatch.setattr(bvh_walk_cuda, "MAX_STACK", 4)
    with pytest.raises(ValueError, match="traversal stack"):
        compile_scene(coated_diffuse_bunny_scene())
