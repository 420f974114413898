"""Bit-exactness across integrator scheduling modes.

The mode combinations {sequential, path-regeneration} x {unsorted,
per-bounce coherence sort} re-schedule the same per-(pixel, sample)
estimates (RNG is counter-based). The coherence sort (forced on through
backend.coherence_sort, which is off by default) is pure lane routing and
must be BIT-IDENTICAL over the XLA walk; regeneration builds a different
graph whose fusions reassociate FMAs, so it matches to ULP-tight allclose
only (reference contract: one image per settings, lib.rs:645).
"""
from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_raytracing import backend
from tpu_raytracing.device import compile_scene
from tpu_raytracing.integrator.render import (
    StaticSettings, trace_radiance, trace_radiance_spp,
)
from tpu_raytracing.ops.rng import SamplerConfig
from tpu_raytracing.scene.test_scenes import get_test_scene

SPP = 3


def _pixels():
    # a block straddling the metal sphere's specular highlight plus the
    # image corner: mixed hit kinds, some lanes dying at depth 1
    xs, ys = np.meshgrid(np.arange(235, 251), np.arange(160, 176))
    px = xs.reshape(-1).astype(np.uint32)
    py = ys.reshape(-1).astype(np.uint32)
    return jnp.asarray(px), jnp.asarray(py)


@pytest.fixture(scope="module")
def scene_setup():
    ts = get_test_scene("metal")
    scene, settings = ts.scene_func(), ts.settings_func()
    settings.samples_per_pixel = SPP
    settings.light_sample_count = 1
    ds = compile_scene(scene)
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    return ds, cfg, st


def _seq(ds, cfg, st, px, py, active=None):
    acc = jnp.zeros((px.shape[0], 3), jnp.float32)
    rays = 0
    for s in range(SPP):
        r, n = trace_radiance(ds, cfg, st, px, py, s, active=active)
        acc = acc + r
        rays += int(n)
    return np.asarray(acc), rays


def _sort(monkeypatch, on: bool):
    monkeypatch.setattr(backend, "coherence_sort", lambda _ds: on)


def test_modes_bit_identical(monkeypatch, scene_setup):
    ds, cfg, st = scene_setup
    px, py = _pixels()

    # bit-exact reference: the default schedule (no coherence sort)
    _sort(monkeypatch, False)
    ref, ref_rays = _seq(ds, cfg, st, px, py)
    assert np.isfinite(ref).all() and (ref.max() > 0)

    # per-bounce state sort (default: merged (B,19) permutation gather +
    # scalar-carry cond, TPU_RT_JOIN_PERM=1)
    _sort(monkeypatch, True)
    b, b_rays = _seq(ds, cfg, st, px, py)
    np.testing.assert_array_equal(ref, b)
    assert b_rays == ref_rays

    # split-gather carry shape (round-3 executable): the join knob is
    # pure routing of the same bits and must be BIT-identical
    monkeypatch.setenv("TPU_RT_JOIN_PERM", "0")
    bs, bs_rays = _seq(ds, cfg, st, px, py)
    monkeypatch.delenv("TPU_RT_JOIN_PERM")
    np.testing.assert_array_equal(b, bs)
    assert bs_rays == ref_rays

    # shadow own-sort (P1s): shadow batches re-sort by their own key
    # inside occluded() instead of inheriting the bounce order — pure
    # lane routing both ways, so the image AND ray count must be
    # BIT-identical to the inherited-order leg
    monkeypatch.setenv("TPU_RT_SHADOW_SORT", "1")
    ss, ss_rays = _seq(ds, cfg, st, px, py)
    monkeypatch.delenv("TPU_RT_SHADOW_SORT")
    np.testing.assert_array_equal(b, ss)
    assert ss_rays == ref_rays

    # NEE gate off (every NEE lane walks occluded()): the gate only
    # skips walks whose contribution is exactly zero (cos==0 or pdf<=0
    # lanes), so the image must be BIT-identical; rays_traced counts
    # actually-walked rays, so the ungated leg counts at least as many
    monkeypatch.setenv("TPU_RT_NEE_GATE", "0")
    ng, ng_rays = _seq(ds, cfg, st, px, py)
    monkeypatch.delenv("TPU_RT_NEE_GATE")
    np.testing.assert_array_equal(b, ng)
    assert ng_rays >= ref_rays

    # path regeneration re-schedules the same per-(pixel, sample)
    # estimates, but its different graph fuses differently; near-tangent
    # sphere hits amplify those FMA ULPs by ~1/sqrt(disc), so agreement
    # is allclose at ~1e-3, NOT bit-exact (rays counts ARE exact)
    _sort(monkeypatch, False)
    r0, r0_rays = trace_radiance_spp(ds, cfg, st, px, py, 0, SPP)
    np.testing.assert_allclose(ref, np.asarray(r0), rtol=2e-3, atol=1e-3)
    assert int(r0_rays) == ref_rays

    # regen + per-bounce state sort (pixel identity, sample and depth
    # counters, differentials all cross the packed permutation): must be
    # bit-exact vs regen-without-sort — the permutation is pure routing
    _sort(monkeypatch, True)
    r1, r1_rays = trace_radiance_spp(ds, cfg, st, px, py, 0, SPP)
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))
    assert int(r1_rays) == ref_rays


def test_regen_sort_respects_active_mask(monkeypatch, scene_setup):
    ds, cfg, st = scene_setup
    px, py = _pixels()
    act = np.ones(px.shape[0], bool)
    act[::3] = False
    act_j = jnp.asarray(act)

    _sort(monkeypatch, False)
    ref, ref_rays = _seq(ds, cfg, st, px, py, active=act_j)

    _sort(monkeypatch, True)
    r1, r1_rays = trace_radiance_spp(ds, cfg, st, px, py, 0, SPP,
                                     active=act_j)
    r1 = np.asarray(r1)
    # regen is a different graph: fusion-order ULPs only (see above)
    np.testing.assert_allclose(ref[act], r1[act], rtol=2e-3, atol=1e-3)
    # inactive (padding) lanes contribute nothing and count no rays
    np.testing.assert_array_equal(r1[~act], 0.0)
    assert int(r1_rays) == ref_rays


def test_nee_stack_bit_identical(monkeypatch, scene_setup):
    """NEE shadow-walk stacking (TPU_RT_NEE_STACK): the n_s area-light
    shadow walks per bounce run as ONE occluded() call over a lane-major
    interleaved (n_s*B) batch. Stacking only regroups lanes — per-lane
    walk results are grouping-invariant (the chunk-size invariance
    property) — so image AND ray count must be BIT-identical to the
    sequential per-sample calls."""
    ds, cfg, st = scene_setup
    st = st._replace(light_sample_count=3, max_ray_depth=3)
    px, py = _pixels()

    _sort(monkeypatch, True)
    monkeypatch.setenv("TPU_RT_NEE_STACK", "0")
    off, off_rays = trace_radiance(ds, cfg, st, px, py, 0)
    off = np.asarray(off)
    assert np.isfinite(off).all() and off.max() > 0

    monkeypatch.setenv("TPU_RT_NEE_STACK", "1")
    on, on_rays = trace_radiance(ds, cfg, st, px, py, 0)
    np.testing.assert_array_equal(off, np.asarray(on))
    assert int(on_rays) == int(off_rays)


def test_ladder_bit_identical(monkeypatch, scene_setup):
    """Alive-prefix ladder (TPU_RT_LADDER): running the post-bounce-1
    while_loop on the sorted B/2 alive prefix must be bit-identical to
    the full-width loop — per-lane results are batch-width-invariant and
    the dead tail is inert. Uses a 2048-lane batch (the ladder's minimum
    width) with enough depth for the loop to run laddered bounces."""
    ds, cfg, st = scene_setup
    st = st._replace(max_ray_depth=4)
    rng = np.random.default_rng(5)
    px = jnp.asarray(
        rng.integers(0, ds.meta.width, 2048).astype(np.uint32))
    py = jnp.asarray(
        rng.integers(0, ds.meta.height, 2048).astype(np.uint32))

    _sort(monkeypatch, True)
    monkeypatch.setenv("TPU_RT_LADDER", "0")
    off, off_rays = trace_radiance(ds, cfg, st, px, py, 0)
    off = np.asarray(off)

    monkeypatch.setenv("TPU_RT_LADDER", "1")
    on, on_rays = trace_radiance(ds, cfg, st, px, py, 0)
    np.testing.assert_array_equal(off, np.asarray(on))
    assert int(on_rays) == int(off_rays)
