"""Shared-BLAS instancing: geometry stored once, per-instance ray transform.

Counterpart of the reference's nested-BVH / IAS instancing
(raytracing-cpu/src/accel.rs:119-214, raytracing-optix/csrc/host/scene.cu:
162-250): a BasicPrimitive reached through multiple transform chains is
compiled to ONE object-space BLAS plus per-instance transforms, and must
render the same image as the world-space-flattened (baked) equivalent.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from tpu_raytracing.device import compile_scene
from tpu_raytracing.ops.traverse import hit_details, intersect_scene
from tpu_raytracing.scene.test_scenes import grid_pair_scene


@pytest.fixture(scope="module")
def pair():
    return (compile_scene(grid_pair_scene(shared=True)),
            compile_scene(grid_pair_scene(shared=False)))


def test_blas_built_once(pair):
    ds_i, ds_b = pair
    assert len(ds_i.meta.instances) == 2
    assert len(ds_i.blas_tables) == 1
    # instanced: main table holds NO copies of the mesh; baked holds two
    assert ds_i.meta.n_tris == 0
    assert ds_b.meta.n_tris == 2 * 32
    # geometry stored once: one BLAS of 32 tris regardless of instance count
    assert ds_i.meta.blas_meta[0][0] == 32


def test_instanced_matches_baked_traversal(pair):
    ds_i, ds_b = pair
    rng = np.random.default_rng(7)
    B = 512
    o = jnp.asarray(
        (np.array([0, 0, 0]) + rng.normal(0, 0.3, (B, 3))).astype(np.float32)
    )
    d = rng.normal(0, 1, (B, 3)).astype(np.float32)
    d[:, 2] -= 1.5  # bias toward the grids
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    tmin = jnp.full(B, 1e-3)
    tmax = jnp.full(B, np.inf)
    t_i, p_i = intersect_scene(ds_i, o, d, tmin, tmax)
    t_b, p_b = intersect_scene(ds_b, o, d, tmin, tmax)
    hit_i = np.asarray(p_i) >= 0
    hit_b = np.asarray(p_b) >= 0
    # hit/miss flips only from cross-space FMA ULPs at silhouettes
    assert (hit_i != hit_b).mean() < 0.01
    both = hit_i & hit_b
    np.testing.assert_allclose(
        np.asarray(t_i)[both], np.asarray(t_b)[both], rtol=1e-4
    )
    # shading geometry must transform out correctly
    h_i = hit_details(ds_i, o, d, t_i, p_i)
    h_b = hit_details(ds_b, o, d, t_b, p_b)
    np.testing.assert_allclose(
        np.asarray(h_i.normal)[both], np.asarray(h_b.normal)[both], atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(h_i.point)[both], np.asarray(h_b.point)[both], atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(h_i.uv)[both], np.asarray(h_b.uv)[both], atol=1e-4
    )
    assert np.array_equal(
        np.asarray(h_i.material)[both], np.asarray(h_b.material)[both]
    )


def test_instanced_render_matches_baked(pair):
    from tpu_raytracing.integrator.render import render
    from tpu_raytracing.settings import AovFlags, RaytracerSettings

    ds_i, ds_b = pair
    s = RaytracerSettings(
        samples_per_pixel=1, light_sample_count=1, max_ray_depth=2,
        outputs=AovFlags.BEAUTY,
    )
    img_i = render(ds_i, s).beauty
    img_b = render(ds_b, s).beauty
    mse = float(np.mean((img_i - img_b) ** 2))
    assert mse < 1e-6, mse
