"""The path-tracing integrator: batched bounce loop + render driver.

Batched restructuring of the reference's per-pixel recursive integrator
(raytracing-cpu/src/lib.rs:247-393, §3.2 of SURVEY.md) and its OptiX
megakernel twin (kernels/pathtracer.cu:34-99): the whole ray batch advances
one bounce per masked while_loop iteration, with SoA path state
{origin, direction, radiance, path_weight, specular, alive, RNG stream}
in device arrays instead of payload registers. Semantics preserved:

- primary rays respect near/far clip, secondary use t_min = 1e-4
- misses add environment radiance and terminate
- directly-hit emitters contribute only after specular bounces
  (and only when accumulate_bounces gates allow)
- NEE over every light: light_sample_count samples for area lights, 1 for
  delta lights, shadow rays from the light toward the point
- BSDF importance sampling continues the path; no MIS, no russian roulette
  (parity with the reference's TODO at lib.rs:373)

The driver splits the image into fixed-size pixel chunks (static shapes for
XLA) and runs the sample loop on device; tiles are just array slices — the
mutex work queue of the CPU backend becomes data parallelism.
"""
from __future__ import annotations

import functools
import logging
import time
from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .. import backend
from ..device import DeviceScene, compile_scene
from ..ops import bsdf as B
from ..ops.bsdf_dispatch import bsdf_eval, bsdf_sample
from ..ops.camera_rays import generate_rays
from ..ops.light_sampling import (
    environment_radiance, light_emitted_radiance, sample_light,
)
from ..ops.linalg import dot, make_orthonormal_basis
from ..ops.rng import SamplerConfig, SampleStream, make_stream
from ..ops.textures import (
    EvalCtx, eval_ctx_from_differentials, eval_texture, texture_mip_level,
)
from ..ops.traverse import hit_details, intersect_scene, occluded
from ..settings import AovFlags, RaytracerSettings, RenderOutput, SinglePixelOutput
from ..device.scene_buffers import LIGHT_AREA, LIGHT_DIRECTION, LIGHT_POINT, MAT_COATED_DIFFUSE, MAT_DIFFUSE

log = logging.getLogger("tpu_raytracing")


class StaticSettings(NamedTuple):
    """Hashable subset of RaytracerSettings that specializes the kernel."""

    max_ray_depth: int
    accumulate_bounces: bool
    light_sample_count: int
    samples_per_pixel: int
    antialias_primary_rays: bool

    @staticmethod
    def from_settings(s: RaytracerSettings) -> "StaticSettings":
        return StaticSettings(
            max_ray_depth=int(s.max_ray_depth),
            accumulate_bounces=bool(s.accumulate_bounces),
            light_sample_count=int(s.light_sample_count),
            samples_per_pixel=int(s.samples_per_pixel),
            antialias_primary_rays=bool(s.antialias_primary_rays),
        )


def _to_local(x, y, n, v):
    return jnp.stack([dot(v, x), dot(v, y), dot(v, n)], axis=-1)


def _to_world(x, y, n, v):
    return v[..., 0:1] * x + v[..., 1:2] * y + v[..., 2:3] * n


def trace_radiance(
    ds: DeviceScene,
    cfg: SamplerConfig,
    st: StaticSettings,
    px, py,            # (B,) pixel coords
    sample_idx,        # scalar or (B,)
    active=None,       # optional (B,) bool: lanes to trace (padding mask)
):
    """Estimate radiance for one sample of each pixel (ray_radiance semantics)."""
    stream = make_stream(px, py, sample_idx)
    ray_o, ray_d, diff, stream = generate_rays(
        ds, px, py, cfg, stream, st.samples_per_pixel, jitter=True
    )
    B_ = px.shape[0]
    f32 = ray_o.dtype
    kinds = ds.meta.mat_kinds_present

    # once-per-bounce path-state coherence sort (backend.coherence_sort):
    # the whole state crosses ONE wide packed gather per bounce and every
    # traversal/shadow call runs presorted, replacing two sort+pack+unsort
    # round-trips per bounce.
    from ..ops.traverse import ray_sort_key

    import os as _os

    sort_bounces = backend.coherence_sort(ds)
    # shadow batches re-sort by their OWN key inside occluded() instead of
    # inheriting the bounce order: NEE ray directions point at the light,
    # not along the continuation ray (A/B knob, default off)
    shadow_own_sort = (
        sort_bounces
        and _os.environ.get("TPU_RT_SHADOW_SORT", "0") == "1"
    )
    # merged (B,19) i32 permutation gather + scalar-carry while cond
    # (A/B knob, default on)
    join_perm = _os.environ.get("TPU_RT_JOIN_PERM", "1") == "1"

    _ib = lambda a: jax.lax.bitcast_convert_type(  # noqa: E731
        a, jnp.int32)[:, None]
    _ru = lambda c: jax.lax.bitcast_convert_type(  # noqa: E731
        c, jnp.uint32)

    def _pack(ray_o, ray_d, radiance, pw, alive, specular, stream, src):
        """Path state as TWO wide row matrices ((B,14) f32 + (B,5) i32).

        When the bounce sort is on, these packs ARE the while carry: the
        sorted matrices cross the loop boundary directly, so the carry
        holds 2 wide buffers instead of ~12 narrow ones. Int lanes stay in
        the INTEGER domain: a backend may canonicalize NaN/denormal f32
        bit patterns, which would corrupt ints bitcast to f32."""
        pk = jnp.concatenate(
            [
                ray_o, ray_d, radiance, pw,
                alive.astype(f32)[:, None],
                specular.astype(f32)[:, None],
            ],
            axis=1,
        )
        pk_i = jnp.concatenate(
            [_ib(stream.px), _ib(stream.py), _ib(stream.sample),
             _ib(stream.dim), src[:, None]],
            axis=1,
        )
        return pk, pk_i

    def _unpack(pk, pk_i):
        stream = SampleStream(
            px=_ru(pk_i[:, 0]), py=_ru(pk_i[:, 1]),
            sample=_ru(pk_i[:, 2]), dim=_ru(pk_i[:, 3]),
        )
        return (pk[:, 0:3], pk[:, 3:6], pk[:, 6:9], pk[:, 9:12],
                pk[:, 12] > 0, pk[:, 13] > 0, stream, pk_i[:, 4])

    alive0 = jnp.ones(B_, bool) if active is None else active
    if sort_bounces:
        pk0, pki0 = _pack(
            ray_o, ray_d, jnp.zeros((B_, 3), f32), jnp.ones((B_, 3), f32),
            alive0, jnp.ones(B_, bool), stream,
            jnp.arange(B_, dtype=jnp.int32),
        )
        state = dict(
            depth=jnp.zeros((), jnp.int32),
            pk=pk0,
            pk_i=pki0,
            rays=jnp.zeros((), jnp.int32),
        )
        if join_perm:
            # scalar alive count: the while cond reads THIS instead of
            # re-reducing the whole (B, 14) pack every iteration
            state["n_alive"] = jnp.sum(alive0.astype(jnp.int32))
    else:
        state = dict(
            depth=jnp.zeros((), jnp.int32),
            ray_o=ray_o,
            ray_d=ray_d,
            alive=alive0,
            specular=jnp.ones(B_, bool),
            radiance=jnp.zeros((B_, 3), f32),
            path_weight=jnp.ones((B_, 3), f32),
            stream=stream,
            rays=jnp.zeros((), jnp.int32),
            src=jnp.arange(B_, dtype=jnp.int32),
        )

    def cond(s):
        if sort_bounces:
            if join_perm:
                return s["n_alive"] > 0
            return jnp.any(s["pk"][:, 12] > 0)
        return jnp.any(s["alive"])

    def body(s, static_primary=None):
        # static_primary: Python-level bounce specialization. True = the
        # peeled depth-0 bounce (clip range + AA differentials are compiled
        # in); False = the while_loop body for every later bounce (the
        # trilinear-mip/checker-AA texture machinery is statically absent —
        # secondary bounces carry zero uv footprints, so the skip is
        # bit-exact); None = unspecialized (regen path semantics).
        depth = s["depth"]
        if sort_bounces:
            (ray_o, ray_d, radiance, pw, alive, specular, stream,
             src) = _unpack(s["pk"], s["pk_i"])
        else:
            alive = s["alive"]
            ray_o, ray_d = s["ray_o"], s["ray_d"]
            radiance, pw = s["radiance"], s["path_weight"]
            specular = s["specular"]
            stream = s["stream"]
            src = s["src"]
        # batch width from the STATE, not the closure: the alive-prefix
        # ladder re-enters this body with a sliced (B/2) state
        Bb = ray_o.shape[0]

        rays = s["rays"] + jnp.sum(alive.astype(jnp.int32))

        if static_primary is None:
            primary = depth == 0
            t_min = jnp.where(primary, ds.meta.near_clip, 1.0e-4)
            t_max = jnp.where(primary, ds.meta.far_clip, jnp.inf)
        elif static_primary:
            primary = jnp.ones((), bool)
            t_min = jnp.asarray(ds.meta.near_clip, f32)
            t_max = jnp.asarray(ds.meta.far_clip, f32)
        else:
            primary = jnp.zeros((), bool)
            t_min = jnp.asarray(1.0e-4, f32)
            t_max = jnp.asarray(jnp.inf, f32)
        t, prim = intersect_scene(
            ds, ray_o, ray_d,
            jnp.broadcast_to(t_min, (Bb,)),
            jnp.broadcast_to(t_max, (Bb,)),
            active=alive,
            presorted=sort_bounces,
        )
        hit_mask = prim >= 0
        miss = alive & ~hit_mask
        if ds.meta.has_env:
            radiance = radiance + jnp.where(
                miss[:, None], pw * environment_radiance(ds, ray_d), 0.0
            )
        alive = alive & hit_mask

        hit = hit_details(ds, ray_o, ray_d, t, prim)

        add_zero_bounce = st.accumulate_bounces | (st.max_ray_depth == depth)
        emit_mask = alive & specular & add_zero_bounce & (hit.light >= 0)
        radiance = radiance + jnp.where(
            emit_mask[:, None], pw * light_emitted_radiance(ds, hit.light), 0.0
        )

        # material evaluation context (antialiased on primary hits)
        plain_ctx = EvalCtx.without_antialiasing(hit.uv)
        has_derivs = st.antialias_primary_rays and static_primary is not False
        if has_derivs:
            aa_ctx = eval_ctx_from_differentials(hit, ray_o, ray_d, diff)
            use_aa = primary & alive

            def sel(a, b):
                return jnp.where(use_aa, a, b)

            ctx = EvalCtx(
                uv=hit.uv,
                dudx=sel(aa_ctx.dudx, plain_ctx.dudx),
                dudy=sel(aa_ctx.dudy, plain_ctx.dudy),
                dvdx=sel(aa_ctx.dvdx, plain_ctx.dvdx),
                dvdy=sel(aa_ctx.dvdy, plain_ctx.dvdy),
            )
        else:
            ctx = plain_ctx

        from ..ops.bsdf import get_bsdf_params, is_delta_bsdf

        params = get_bsdf_params(ds, hit.material, ctx, has_derivs=has_derivs)
        bx, by = make_orthonormal_basis(hit.normal)
        wo = _to_local(bx, by, hit.normal, -ray_d)

        depth = depth + 1
        alive = alive & (depth <= st.max_ray_depth)

        delta = is_delta_bsdf(params)
        add_direct = st.accumulate_bounces | (depth == st.max_ray_depth)
        nee_mask = alive & ~delta & add_direct

        direct = jnp.zeros((Bb, 3), f32)
        for li, lk in enumerate(ds.meta.light_kinds):
            n_s = 1 if lk in (LIGHT_POINT, LIGHT_DIRECTION) else st.light_sample_count
            contrib = jnp.zeros((Bb, 3), f32)
            # NEE stacking (TPU_RT_NEE_STACK, sorted path only): the n_s
            # shadow walks of an area light run as ONE occluded() call
            # over a lane-major interleaved (n_s*B) batch [lane0 s0..s3,
            # lane1 s0..s3, ...] instead of n_s sequential full-B calls,
            # so near-identical rays (same light, neighbouring sample
            # points) sit next to each other with no permutation: the
            # interleave is a reshape of the stacked tensor. Per-lane walk
            # results are independent of lane grouping (the chunk-
            # invariance property), so occlusion bits are bit-identical to
            # the sequential calls.
            nee_stack = (
                n_s > 1
                and sort_bounces
                and not shadow_own_sort
                and _os.environ.get("TPU_RT_NEE_STACK", "0") == "1"
            )
            samples = []
            for _ in range(n_s):
                ls, stream = sample_light(ds, li, hit.point, cfg, stream)
                wi = _to_local(bx, by, hit.normal, -ls.direction)
                cos_theta = jnp.maximum(wi[..., 2], 0.0)
                # zero-contribution NEE samples (back-facing cos==0 or
                # pdf<=0) skip the occlusion walk entirely: occlusion
                # cannot change their exactly-zero contribution.
                # Per-lane walk results are independent of OTHER lanes'
                # active bits, so surviving lanes are bit-identical (same
                # guarantee the padding mask relies on,
                # tests/test_parallel.py).
                if _os.environ.get("TPU_RT_NEE_GATE", "1") == "1":
                    shadow_act = (nee_mask & (ls.pdf > 0.0)
                                  & (cos_theta > 0.0))
                else:  # gate off: walk every NEE lane
                    shadow_act = nee_mask
                # rays_traced counts rays actually WALKED (per-sample
                # shadow_act sum, inside the n_s loop) so Mrays/s stays
                # honest under the NEE gate: skipped zero-contribution
                # shadow rays do not inflate it. (The reference casts
                # unconditionally, lib.rs:340.)
                rays = rays + jnp.sum(shadow_act.astype(jnp.int32))
                if nee_stack:
                    samples.append((ls, wi, cos_theta, shadow_act))
                    continue
                occ = occluded(
                    ds, ls.origin, ls.direction,
                    jnp.full(Bb, 1.0e-3, f32),
                    ls.distance - 1.0e-3,
                    active=shadow_act,
                    presorted=sort_bounces and not shadow_own_sort,
                )
                samples.append((ls, wi, cos_theta, shadow_act, occ))
            if nee_stack:
                stk = lambda xs: jnp.stack(xs, axis=1).reshape(  # noqa: E731
                    (n_s * Bb,) + xs[0].shape[1:])
                occ_all = occluded(
                    ds,
                    stk([s[0].origin for s in samples]),
                    stk([s[0].direction for s in samples]),
                    jnp.full(n_s * Bb, 1.0e-3, f32),
                    stk([s[0].distance - 1.0e-3 for s in samples]),
                    active=stk([s[3] for s in samples]),
                    presorted=True,
                ).reshape(Bb, n_s)
                samples = [
                    s + (occ_all[:, k],) for k, s in enumerate(samples)
                ]
            for ls, wi, cos_theta, shadow_act, occ in samples:
                good = shadow_act & ~occ
                f = bsdf_eval(params, wo, wi, kinds, active=good)
                safe_pdf = jnp.where(ls.pdf == 0.0, 1.0, ls.pdf)
                c = f * ls.radiance * (cos_theta / safe_pdf)[:, None]
                contrib = contrib + jnp.where(good[:, None], c, 0.0)
            direct = direct + contrib / n_s
        radiance = radiance + pw * direct

        # continuation via BSDF importance sampling
        samp, stream = bsdf_sample(
            params, wo, jnp.full(Bb, B.ALL_COMPONENTS, jnp.int32),
            cfg, stream, kinds, active=alive,
        )
        ok = (
            samp.valid
            & (samp.pdf > 0.0)
            & jnp.any(samp.f != 0.0, axis=-1)
        )
        alive = alive & ok
        cos_theta = jnp.abs(samp.wi[..., 2])
        safe_pdf = jnp.where(samp.pdf == 0.0, 1.0, samp.pdf)
        pw = jnp.where(
            alive[:, None], pw * samp.f * (cos_theta / safe_pdf)[:, None], pw
        )
        specular = jnp.where(alive, (samp.component & B.SPECULAR) != 0, specular)
        new_d = _to_world(bx, by, hit.normal, samp.wi)
        ray_o = jnp.where(alive[:, None], hit.point, ray_o)
        ray_d = jnp.where(alive[:, None], new_d, ray_d)

        if sort_bounces:
            # permute the whole path state toward the NEXT bounce's ray
            # coherence; dead lanes sort last. The sorted packs ARE the
            # carry.
            # NOTE: the closure-captured ray differentials `diff` are NOT
            # permuted — structurally safe: differentials are consumed only
            # in the PEELED depth-0 bounce (static_primary=True), which runs
            # before the first sort's output is ever read back. The
            # while_loop body (static_primary=False) never touches diff.
            key = ray_sort_key(ds, ray_o, ray_d)
            key = key | ((~alive).astype(jnp.int32) << 25)
            iota = jnp.arange(Bb, dtype=jnp.int32)
            _, order = jax.lax.sort_key_val(key, iota, is_stable=True)
            pk, pk_i = _pack(
                ray_o, ray_d, radiance, pw, alive, specular, stream, src
            )
            if not join_perm:
                return dict(
                    depth=depth, pk=pk[order], pk_i=pk_i[order], rays=rays
                )
            # ONE (B, 19) i32 permutation gather instead of two (f32 14 +
            # i32 5). Floats ride bitcast f32->i32 (the SAFE direction:
            # i32 transport is bit-exact on every backend, while f32
            # transport may canonicalize NaN payloads).
            joined = jnp.concatenate(
                [jax.lax.bitcast_convert_type(pk, jnp.int32), pk_i], axis=1
            )[order]
            pk_s = jax.lax.bitcast_convert_type(joined[:, :14], f32)
            pki_s = joined[:, 14:]
            return dict(
                depth=depth, pk=pk_s, pk_i=pki_s, rays=rays,
                n_alive=jnp.sum(alive.astype(jnp.int32)),
            )

        return dict(
            depth=depth,
            ray_o=ray_o,
            ray_d=ray_d,
            alive=alive,
            specular=specular,
            radiance=radiance,
            path_weight=pw,
            stream=stream,
            rays=rays,
            src=src,
        )

    # peel the primary bounce: clip range, AA differentials, and the
    # trilinear/checker-AA texture paths compile only into this one call;
    # the loop body below is statically secondary (plain uv contexts)
    state = body(state, static_primary=True)

    def loop_body(s):
        return body(s, static_primary=False)

    # Alive-prefix ladder (TPU_RT_LADDER, sorted path only): the while
    # body's work runs at full B every bounce although most lanes are
    # dead after the first bounces. The sort puts dead lanes last, so
    # when n_alive <= B/2 the remaining bounces run on the static B/2
    # prefix and the dead tail is re-attached afterwards; lax.cond keeps
    # the full-width loop for the n_alive > B/2 case.
    #
    # Exactness structure: bounce 1 is peeled whenever the LADDER COULD
    # run (peel2), independent of the knob — a peeled body fuses in the
    # enclosing graph while a loop iteration fuses inside the while
    # body, and that context difference alone can move FMA contraction
    # by ~1 ULP. With the peel held fixed, knob on/off differ only in
    # loop WIDTH, and per-lane results are width-invariant (the same
    # property chunk-size invariance already relies on; locked by the
    # trace-mode ladder test). Peeling bounce 1 outside the while is
    # output-identical even when everything is already dead: a dead-state
    # body only re-sorts dead lanes, which the final src-unsort undoes.
    peel2 = (
        sort_bounces
        and join_perm
        and st.max_ray_depth >= 3
        and B_ >= 2048
        and B_ % 2048 == 0
    )
    ladder = peel2 and _os.environ.get("TPU_RT_LADDER", "1") == "1"
    if peel2:
        state = body(state, static_primary=False)  # bounce 1 at full B
    if ladder:
        H = B_ // 2

        def _run_half(s):
            sub = dict(
                depth=s["depth"],
                pk=jax.lax.slice(s["pk"], (0, 0), (H, 14)),
                pk_i=jax.lax.slice(s["pk_i"], (0, 0), (H, 5)),
                rays=s["rays"],
                n_alive=s["n_alive"],
            )
            o = jax.lax.while_loop(cond, loop_body, sub)
            return dict(
                depth=o["depth"],
                pk=jnp.concatenate(
                    [o["pk"], jax.lax.slice(s["pk"], (H, 0), (B_, 14))],
                    axis=0,
                ),
                pk_i=jnp.concatenate(
                    [o["pk_i"], jax.lax.slice(s["pk_i"], (H, 0), (B_, 5))],
                    axis=0,
                ),
                rays=o["rays"],
                n_alive=o["n_alive"],
            )

        def _run_full(s):
            return jax.lax.while_loop(cond, loop_body, s)

        out = jax.lax.cond(
            state["n_alive"] <= H, _run_half, _run_full, state
        )
    else:
        out = jax.lax.while_loop(cond, loop_body, state)
    if sort_bounces:
        iota = jnp.arange(B_, dtype=jnp.int32)
        _, inv = jax.lax.sort_key_val(out["pk_i"][:, 4], iota, is_stable=True)
        radiance = out["pk"][:, 6:9][inv]
    else:
        radiance = out["radiance"]
    return radiance, out["rays"]


def trace_radiance_spp(
    ds: DeviceScene,
    cfg: SamplerConfig,
    st: StaticSettings,
    px, py,            # (B,) pixel coords
    spp_base: int,
    n_spp: int,
    active=None,
):
    """Sum of n_spp radiance samples per pixel via PATH REGENERATION.

    The sequential spp loop wastes the batch: the alive fraction decays
    per bounce, but every fixed-shape bounce processes all B lanes. Here
    a lane whose path terminates immediately starts its pixel's NEXT
    sample (per-lane depth + sample counters), so lanes stay ~fully
    utilized until the whole sample budget drains — the SPMD rendering of
    the reference megakernel's per-thread spp loop
    (kernels/pathtracer.cu:103-134).

    Matches the sequential loop to fusion-order ULPs: the per-(pixel,
    sample, dim) RNG makes each sample's estimate independent of
    scheduling and per pixel the accumulation stays in ascending-sample
    order, but regeneration is a different XLA graph whose fusions
    reassociate FMAs (tests/test_trace_modes.py pins the contract; the
    coherence sort inside either mode IS bit-exact).
    """
    B_ = px.shape[0]
    stream = make_stream(px, py, jnp.uint32(spp_base))
    ray_o, ray_d, diff, stream = generate_rays(
        ds, px, py, cfg, stream, st.samples_per_pixel, jitter=True
    )
    f32 = ray_o.dtype
    kinds = ds.meta.mat_kinds_present
    act0_in = jnp.ones(B_, bool) if active is None else active

    # per-bounce coherence sort (same policy as trace_radiance):
    # regenerated lanes mix fresh primaries with deep bounces, so the
    # whole state — pixel identity included — rides one packed
    # permutation per bounce and traversal runs presorted.
    from ..ops.traverse import ray_sort_key

    import os as _os

    sort_bounces = backend.coherence_sort(ds)
    # see trace_radiance: shadow batches optionally re-sort by their own key
    shadow_own_sort = (
        sort_bounces
        and _os.environ.get("TPU_RT_SHADOW_SORT", "0") == "1"
    )

    state = dict(
        sample_i=jnp.full(B_, spp_base, jnp.uint32),
        depth=jnp.zeros(B_, jnp.int32),
        px=px.astype(jnp.int32),
        py=py.astype(jnp.int32),
        ray_o=ray_o,
        ray_d=ray_d,
        diff=diff,
        act0=act0_in,
        alive=act0_in & (n_spp > 0),
        specular=jnp.ones(B_, bool),
        path_rad=jnp.zeros((B_, 3), f32),
        acc=jnp.zeros((B_, 3), f32),
        path_weight=jnp.ones((B_, 3), f32),
        stream=stream,
        rays=jnp.zeros((), jnp.int32),
        src=jnp.arange(B_, dtype=jnp.int32),
    )

    def cond(s):
        return jnp.any(s["alive"])

    def body(s):
        depth = s["depth"]
        alive = s["alive"]
        ray_o, ray_d, diff = s["ray_o"], s["ray_d"], s["diff"]
        path_rad, pw = s["path_rad"], s["path_weight"]
        specular = s["specular"]
        stream = s["stream"]
        sample_i = s["sample_i"]
        acc = s["acc"]
        lane_px, lane_py, act0 = s["px"], s["py"], s["act0"]

        rays = s["rays"] + jnp.sum(alive.astype(jnp.int32))

        primary = depth == 0
        t_min = jnp.where(primary, ds.meta.near_clip, 1.0e-4)
        t_max = jnp.where(primary, ds.meta.far_clip, jnp.inf)
        t, prim = intersect_scene(
            ds, ray_o, ray_d, t_min, t_max, active=alive,
            presorted=sort_bounces,
        )
        hit_mask = prim >= 0
        miss = alive & ~hit_mask
        if ds.meta.has_env:
            path_rad = path_rad + jnp.where(
                miss[:, None], pw * environment_radiance(ds, ray_d), 0.0
            )
        alive = alive & hit_mask

        hit = hit_details(ds, ray_o, ray_d, t, prim)

        add_zero_bounce = st.accumulate_bounces | (st.max_ray_depth == depth)
        emit_mask = alive & specular & add_zero_bounce & (hit.light >= 0)
        path_rad = path_rad + jnp.where(
            emit_mask[:, None], pw * light_emitted_radiance(ds, hit.light), 0.0
        )

        plain_ctx = EvalCtx.without_antialiasing(hit.uv)
        if st.antialias_primary_rays:
            aa_ctx = eval_ctx_from_differentials(hit, ray_o, ray_d, diff)
            use_aa = primary & alive

            def sel(a, b):
                return jnp.where(use_aa, a, b)

            ctx = EvalCtx(
                uv=hit.uv,
                dudx=sel(aa_ctx.dudx, plain_ctx.dudx),
                dudy=sel(aa_ctx.dudy, plain_ctx.dudy),
                dvdx=sel(aa_ctx.dvdx, plain_ctx.dvdx),
                dvdy=sel(aa_ctx.dvdy, plain_ctx.dvdy),
            )
        else:
            ctx = plain_ctx

        from ..ops.bsdf import get_bsdf_params, is_delta_bsdf

        params = get_bsdf_params(
            ds, hit.material, ctx,
            has_derivs=bool(st.antialias_primary_rays),
        )
        bx, by = make_orthonormal_basis(hit.normal)
        wo = _to_local(bx, by, hit.normal, -ray_d)

        depth = depth + 1
        alive = alive & (depth <= st.max_ray_depth)

        delta = is_delta_bsdf(params)
        add_direct = st.accumulate_bounces | (depth == st.max_ray_depth)
        nee_mask = alive & ~delta & add_direct

        direct = jnp.zeros((B_, 3), f32)
        for li, lk in enumerate(ds.meta.light_kinds):
            n_s = 1 if lk in (LIGHT_POINT, LIGHT_DIRECTION) else st.light_sample_count
            contrib = jnp.zeros((B_, 3), f32)
            for _ in range(n_s):
                ls, stream = sample_light(ds, li, hit.point, cfg, stream)
                wi = _to_local(bx, by, hit.normal, -ls.direction)
                cos_theta = jnp.maximum(wi[..., 2], 0.0)
                # zero-contribution NEE samples skip the occlusion walk
                # (see trace_radiance)
                if _os.environ.get("TPU_RT_NEE_GATE", "1") == "1":
                    shadow_act = (nee_mask & (ls.pdf > 0.0)
                                  & (cos_theta > 0.0))
                else:  # gate off: walk every NEE lane
                    shadow_act = nee_mask
                # count rays actually walked (see beauty-pass note above)
                rays = rays + jnp.sum(shadow_act.astype(jnp.int32))
                occ = occluded(
                    ds, ls.origin, ls.direction,
                    jnp.full(B_, 1.0e-3, f32),
                    ls.distance - 1.0e-3,
                    active=shadow_act,
                    presorted=sort_bounces and not shadow_own_sort,
                )
                good = shadow_act & ~occ
                f = bsdf_eval(params, wo, wi, kinds, active=good)
                safe_pdf = jnp.where(ls.pdf == 0.0, 1.0, ls.pdf)
                c = f * ls.radiance * (cos_theta / safe_pdf)[:, None]
                contrib = contrib + jnp.where(good[:, None], c, 0.0)
            direct = direct + contrib / n_s
        path_rad = path_rad + pw * direct

        samp, stream = bsdf_sample(
            params, wo, jnp.full(B_, B.ALL_COMPONENTS, jnp.int32),
            cfg, stream, kinds, active=alive,
        )
        ok = (
            samp.valid
            & (samp.pdf > 0.0)
            & jnp.any(samp.f != 0.0, axis=-1)
        )
        alive = alive & ok
        cos_theta = jnp.abs(samp.wi[..., 2])
        safe_pdf = jnp.where(samp.pdf == 0.0, 1.0, samp.pdf)
        pw = jnp.where(
            alive[:, None], pw * samp.f * (cos_theta / safe_pdf)[:, None], pw
        )
        specular = jnp.where(alive, (samp.component & B.SPECULAR) != 0, specular)
        new_d = _to_world(bx, by, hit.normal, samp.wi)
        ray_o = jnp.where(alive[:, None], hit.point, ray_o)
        ray_d = jnp.where(alive[:, None], new_d, ray_d)

        # ---- path regeneration: finished lanes bank their estimate and
        # start the pixel's next sample in place
        was = s["alive"]
        done = was & ~alive
        acc = acc + jnp.where(done[:, None], path_rad, 0.0)
        next_i = sample_i + 1
        has_more = next_i < jnp.uint32(spp_base + n_spp)
        regen = done & has_more & act0

        stream_new = make_stream(
            lane_px.astype(jnp.uint32), lane_py.astype(jnp.uint32), next_i
        )
        n_o, n_d, n_diff, stream_new = generate_rays(
            ds, lane_px, lane_py, cfg, stream_new, st.samples_per_pixel,
            jitter=True,
        )
        sample_i = jnp.where(done, next_i, sample_i)
        sel_l = regen[:, None]
        ray_o = jnp.where(sel_l, n_o, ray_o)
        ray_d = jnp.where(sel_l, n_d, ray_d)
        diff = jnp.where(regen[:, None, None], n_diff, diff)
        path_rad = jnp.where(sel_l, 0.0, path_rad)
        pw = jnp.where(sel_l, 1.0, pw)
        specular = jnp.where(regen, True, specular)
        depth = jnp.where(regen, 0, depth)
        alive = alive | regen
        stream = jax.tree.map(
            lambda n, o: jnp.where(regen, n, o), stream_new, stream
        )

        src = s["src"]
        if sort_bounces:
            # permute the whole regen state toward the NEXT bounce's ray
            # coherence: fresh primaries and deep bounces interleave in
            # lane space, so pixel identity (lane_px/py), per-lane sample
            # and depth counters, differentials, and the banked
            # accumulator all cross the same packed permutation.
            key = ray_sort_key(ds, ray_o, ray_d)
            key = key | ((~alive).astype(jnp.int32) << 25)
            iota = jnp.arange(B_, dtype=jnp.int32)
            _, order = jax.lax.sort_key_val(key, iota, is_stable=True)
            pk = jnp.concatenate(
                [
                    ray_o, ray_d, path_rad, pw, acc,
                    diff.reshape(B_, 12),
                    alive.astype(f32)[:, None],
                    specular.astype(f32)[:, None],
                ],
                axis=1,
            )[order]
            # int lanes stay in the INTEGER domain across the permutation
            # (see trace_radiance's _pack)
            u32 = jnp.uint32
            ib = lambda a: jax.lax.bitcast_convert_type(  # noqa: E731
                a, jnp.int32)[:, None]
            pk_i = jnp.concatenate(
                [ib(stream.px), ib(stream.py), ib(stream.sample),
                 ib(stream.dim), ib(sample_i), depth[:, None],
                 lane_px[:, None], lane_py[:, None],
                 act0.astype(jnp.int32)[:, None], src[:, None]],
                axis=1,
            )[order]
            ray_o, ray_d = pk[:, 0:3], pk[:, 3:6]
            path_rad, pw, acc = pk[:, 6:9], pk[:, 9:12], pk[:, 12:15]
            diff = pk[:, 15:27].reshape(B_, 4, 3)
            alive = pk[:, 27] > 0
            specular = pk[:, 28] > 0
            reu = lambda c: jax.lax.bitcast_convert_type(  # noqa: E731
                pk_i[:, c], u32)
            stream = stream._replace(
                px=reu(0), py=reu(1), sample=reu(2), dim=reu(3),
            )
            sample_i = reu(4)
            depth = pk_i[:, 5]
            lane_px, lane_py = pk_i[:, 6], pk_i[:, 7]
            act0 = pk_i[:, 8] > 0
            src = pk_i[:, 9]

        return dict(
            sample_i=sample_i,
            depth=depth,
            px=lane_px,
            py=lane_py,
            ray_o=ray_o,
            ray_d=ray_d,
            diff=diff,
            act0=act0,
            alive=alive,
            specular=specular,
            path_rad=path_rad,
            acc=acc,
            path_weight=pw,
            stream=stream,
            rays=rays,
            src=src,
        )

    out = jax.lax.while_loop(cond, body, state)
    acc = out["acc"]
    if sort_bounces:
        iota = jnp.arange(B_, dtype=jnp.int32)
        _, inv = jax.lax.sort_key_val(out["src"], iota, is_stable=True)
        acc = acc[inv]
    return acc, out["rays"]


@partial(jax.jit, static_argnums=(1, 2))
def render_beauty_chunk(ds: DeviceScene, cfg, st: StaticSettings, px, py,
                        active=None):
    """Average radiance over spp for one pixel chunk.

    Sequential per-sample loop by default; TPU_RT_REGEN=1 switches to
    path regeneration (A/B knob; outputs agree to fusion-order ULPs). Which
    schedule is faster on a GPU is not measured yet."""
    import os as _os

    if _os.environ.get("TPU_RT_REGEN", "0") == "1":
        total, rays = trace_radiance_spp(
            ds, cfg, st, px, py, 0, st.samples_per_pixel, active=active
        )
        return total / st.samples_per_pixel, rays

    def body(s, carry):
        acc, rays = carry
        r, n = trace_radiance(ds, cfg, st, px, py, s, active=active)
        return acc + r, rays + n

    total, rays = jax.lax.fori_loop(
        0, st.samples_per_pixel, body,
        (jnp.zeros((px.shape[0], 3), jnp.float32), jnp.zeros((), jnp.int32)),
    )
    return total / st.samples_per_pixel, rays


@partial(jax.jit, static_argnums=(1, 2))
def _aov_hit_chunk(ds: DeviceScene, cfg, st: StaticSettings, px, py):
    """First-hit pass of the AOV render: rays, intersection, eval context."""
    stream = make_stream(px, py, 0)
    ray_o, ray_d, diff, stream = generate_rays(
        ds, px, py, cfg, stream, st.samples_per_pixel, jitter=False
    )
    B_ = px.shape[0]
    t, prim = intersect_scene(
        ds, ray_o, ray_d,
        jnp.full(B_, ds.meta.near_clip, jnp.float32),
        jnp.full(B_, ds.meta.far_clip, jnp.float32),
    )
    hit = hit_details(ds, ray_o, ray_d, t, prim)
    ctx = eval_ctx_from_differentials(hit, ray_o, ray_d, diff)
    ctx = EvalCtx(
        uv=hit.uv,
        dudx=jnp.where(hit.hit, ctx.dudx, 0.0),
        dudy=jnp.where(hit.hit, ctx.dudy, 0.0),
        dvdx=jnp.where(hit.hit, ctx.dvdx, 0.0),
        dvdy=jnp.where(hit.hit, ctx.dvdy, 0.0),
    )
    normals = jnp.where(hit.hit[:, None], hit.normal, 0.0)
    uv = jnp.where(hit.hit[:, None], hit.uv, 0.0)
    return normals, uv, hit.hit, hit.material, ctx


@partial(jax.jit, static_argnums=(1,))
def _aov_tex_chunk(ds: DeviceScene, aovs: tuple, hit_mask, material,
                   ctx: EvalCtx):
    """Texture-dependent AOVs (albedo, mip level) from first-hit data."""
    B_ = hit_mask.shape[0]
    mat = jnp.maximum(material, 0)
    kind = ds.mat_kind[mat]
    albedo_tex = ds.mat_tex[mat, 0]

    if "a" in aovs:
        # albedo: diffuse/coated sample their albedo texture, others are
        # white (materials.rs get_albedo)
        sk = ds.meta.slot_kinds
        sampled = eval_texture(
            ds, albedo_tex, ctx, kinds=sk[0] if sk else None)[:, :3]
        has_albedo = (kind == MAT_DIFFUSE) | (kind == MAT_COATED_DIFFUSE)
        albedo = jnp.where(has_albedo[:, None], sampled, 1.0)
        albedo = jnp.where(hit_mask[:, None], albedo, 0.0)
    else:
        albedo = jnp.zeros((B_, 3), jnp.float32)

    if "m" in aovs:
        # mip level: the material's primary texture when it is a trilinear
        # image (materials.rs get_mip_level: only Diffuse has one)
        mip_tid = jnp.where(kind == MAT_DIFFUSE, albedo_tex, -1)
        mip, mip_valid = texture_mip_level(ds, mip_tid, ctx)
        mip = jnp.where(hit_mask & mip_valid & (kind == MAT_DIFFUSE), mip, 0.0)
    else:
        mip = jnp.zeros((B_,), jnp.float32)
    return albedo, mip


def render_aov_chunk(ds: DeviceScene, cfg, st: StaticSettings, px, py,
                     aovs: tuple = ("n", "a", "u", "m")):
    """First-hit AOVs: normals, albedo, uv, mip level (lib.rs:403-444).

    Two executables, split at the eval-context boundary: (1) rays +
    intersection + differentials, shared by every AOV request, (2)
    texture/mip evaluation, specialized on `aovs` (static), which drops
    unrequested texture subgraphs entirely."""
    normals, uv, hit_mask, material, ctx = _aov_hit_chunk(
        ds, cfg, st, px, py
    )
    if ("a" in aovs) or ("m" in aovs):
        albedo, mip = _aov_tex_chunk(ds, aovs, hit_mask, material, ctx)
    else:
        B_ = px.shape[0]
        albedo = jnp.zeros((B_, 3), jnp.float32)
        mip = jnp.zeros((B_,), jnp.float32)
    return normals, albedo, uv, mip


def _interleave_bits(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64)
    v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << 2)) & np.uint64(0x3333333333333333)
    v = (v | (v << 1)) & np.uint64(0x5555555555555555)
    return v


@functools.lru_cache(maxsize=8)
def _pixel_grid(width: int, height: int):
    """Flat pixel lists in Morton order (+ the inverse permutation).

    Morton-ordered chunks hold spatially coherent primary rays, so the
    per-chunk worst-case traversal depth — what a batched while_loop pays
    for — tracks the local scene complexity instead of a whole image row.
    Per-pixel results are order-independent (RNG keyed by pixel), so this
    never changes the image. Cached per resolution, so repeated renders
    skip the argsort. Callers treat the arrays as read-only.
    """
    xs = np.arange(width, dtype=np.uint32)
    ys = np.arange(height, dtype=np.uint32)
    px, py = np.meshgrid(xs, ys)
    px, py = px.reshape(-1), py.reshape(-1)
    morton = _interleave_bits(px) | (_interleave_bits(py) << np.uint64(1))
    order = np.argsort(morton, kind="stable")
    inverse = np.empty_like(order)
    inverse[order] = np.arange(order.shape[0])
    return px[order], py[order], inverse


def _run_chunked(fn, px, py, n_outputs, chunk=None):
    """Dispatch fn over fixed-size pixel chunks (padded; static shapes).

    All chunk dispatches are issued asynchronously (device arrays are only
    fetched after the loop) so host dispatch latency overlaps device
    execution.
    """
    if chunk is None:
        chunk = backend.chunk_pixels()
    n = px.shape[0]
    chunk = min(chunk, n)
    outs = None
    sizes = []
    for start in range(0, n, chunk):
        cpx = px[start:start + chunk]
        cpy = py[start:start + chunk]
        act = np.ones(chunk, bool)
        if cpx.shape[0] < chunk:
            # padded lanes are flagged inactive: traced as dead (no work)
            # and excluded from ray counts
            pad = chunk - cpx.shape[0]
            act[chunk - pad:] = False
            cpx = np.concatenate([cpx, np.zeros(pad, cpx.dtype)])
            cpy = np.concatenate([cpy, np.zeros(pad, cpy.dtype)])
        res = fn(jnp.asarray(cpx), jnp.asarray(cpy), jnp.asarray(act))
        if not isinstance(res, tuple):
            res = (res,)
        sizes.append(min(chunk, n - start))
        if outs is None:
            outs = [[r] for r in res]
        else:
            for o, r in zip(outs, res):
                o.append(r)
    return [
        np.concatenate(
            [np.asarray(r)[:sz] for r, sz in zip(o, sizes)], axis=0
        )
        for o in outs
    ]


def render(
    scene_or_device,
    settings: RaytracerSettings,
    chunk_pixels: int | None = None,
) -> RenderOutput:
    """Full-frame render (counterpart of raytracing_cpu::render, lib.rs:645)."""
    if isinstance(scene_or_device, DeviceScene):
        ds = scene_or_device
    else:
        t0 = time.perf_counter()
        ds = compile_scene(scene_or_device)
        log.info("scene compile took %.3fs", time.perf_counter() - t0)

    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    width, height = ds.meta.width, ds.meta.height
    px, py, unmorton = _pixel_grid(width, height)
    out = RenderOutput(width=width, height=height)

    if settings.outputs & AovFlags.FIRST_HIT_AOVS:
        t0 = time.perf_counter()
        aovs = tuple(
            k for k, fl in (
                ("n", AovFlags.NORMALS), ("a", AovFlags.ALBEDO),
                ("u", AovFlags.UV_COORDS), ("m", AovFlags.MIP_LEVEL),
            ) if settings.outputs & fl
        )
        normals, albedo, uv, mip = _run_chunked(
            lambda a, b, _act: render_aov_chunk(ds, cfg, st, a, b, aovs),
            px, py, 4, chunk_pixels,
        )
        log.info("aov pass took %.3fs", time.perf_counter() - t0)
        if settings.outputs & AovFlags.NORMALS:
            out.normals = normals[unmorton].reshape(height, width, 3)
        if settings.outputs & AovFlags.ALBEDO:
            out.albedo = albedo[unmorton].reshape(height, width, 3)
        if settings.outputs & AovFlags.UV_COORDS:
            out.uv = uv[unmorton].reshape(height, width, 2)
        if settings.outputs & AovFlags.MIP_LEVEL:
            out.mip_level = mip[unmorton].reshape(height, width)

    if settings.outputs & AovFlags.BEAUTY:
        # compile ahead of the first dispatch so compile time is measured
        # apart: a dispatch that runs device while loops can return only
        # after the loops finish, so timing the first call would mix the
        # two
        chunk = min(chunk_pixels or backend.chunk_pixels(), px.shape[0])
        t0 = time.perf_counter()
        lane = lambda dt: jax.ShapeDtypeStruct((chunk,), dt)  # noqa: E731
        step = render_beauty_chunk.lower(
            ds, cfg, st, lane(px.dtype), lane(py.dtype), lane(jnp.bool_)
        ).compile()
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ray_counts = []

        def beauty_fn(a, b, act):
            r, n = step(ds, a, b, act)
            ray_counts.append(n)  # device scalar; fetched after the loop
            return r

        (beauty,) = _run_chunked(beauty_fn, px, py, 1, chunk)
        # one stacked fetch for the per-chunk ray counts, after the
        # (overlapped) beauty fetches, instead of one sync per chunk
        out.rays_traced = int(np.asarray(jnp.stack(ray_counts)).sum())
        run = time.perf_counter() - t0
        log.info(
            "beauty pass took %.3fs (compile %.3fs, run %.3fs: %d rays, "
            "%.2f Mrays/s)",
            compile_s + run, compile_s, run, out.rays_traced,
            out.rays_traced / run / 1e6,
        )
        beauty = beauty[unmorton].reshape(height, width, 3)
        _nan_scan(beauty)
        out.beauty = beauty

    return out


def _nan_scan(beauty: np.ndarray) -> None:
    """NaN/Inf scan of the radiance buffer (lib.rs:815-854)."""
    bad = ~np.isfinite(beauty)
    if bad.any():
        ys, xs = np.nonzero(bad.any(axis=-1))
        log.warning(
            "%d non-finite radiance pixels (first at x=%d y=%d) — "
            "repro with: tpu_raytracing.cli <scene> pixel %d %d "
            "(lib.rs:815-854 NaN scan + panic-hook repro workflow)",
            len(ys), xs[0], ys[0], xs[0], ys[0],
        )


def render_single_pixel(
    scene, settings: RaytracerSettings, x: int, y: int,
    sample_count: int = 1, sample_offset: int = 0,
) -> list:
    """Replay the exact sampler streams of one pixel
    (counterpart of render_single_pixel, lib.rs:860-932)."""
    ds = compile_scene(scene)
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    x = min(max(x, 0), ds.meta.width - 1)
    y = min(max(y, 0), ds.meta.height - 1)
    px = jnp.asarray([x], jnp.uint32)
    py = jnp.asarray([y], jnp.uint32)
    outputs = []
    for s in range(sample_offset, sample_offset + sample_count):
        radiance = np.asarray(
            trace_radiance(ds, cfg, st, px, py, jnp.uint32(s))[0]
        )[0]
        # first-hit data for the debug record
        stream = make_stream(px, py, jnp.uint32(s))
        ray_o, ray_d, _, stream = generate_rays(
            ds, px, py, cfg, stream, st.samples_per_pixel, jitter=True
        )
        t, prim = intersect_scene(
            ds, ray_o, ray_d,
            jnp.full(1, ds.meta.near_clip, jnp.float32),
            jnp.full(1, ds.meta.far_clip, jnp.float32),
        )
        hit = hit_details(ds, ray_o, ray_d, t, prim)
        outputs.append(
            SinglePixelOutput(
                sample_index=s,
                hit=bool(hit.hit[0]),
                uv=np.asarray(hit.uv[0]),
                normal=np.asarray(hit.normal[0]),
                radiance=radiance,
            )
        )
    return outputs
