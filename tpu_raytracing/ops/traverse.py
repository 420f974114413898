"""Batched scene intersection: near-first BVH traversal (device).

Counterpart of the reference's per-ray DFS stack traversal
(raytracing-cpu/src/accel.rs:65-259) and its OptiX traversal. Two walks
read the same child-pair rows and return the same answers:

- ``_walk_xla``: plain XLA. The whole batch advances in masked while
  loops. It runs on every platform but CUDA, and it is the reference the
  tests compare against.
- the CUDA kernel of ``ops/bvh_walk_cuda.py``: one thread per ray with a
  private stack. It runs where XLA lowers for an NVIDIA GPU.

``backend.bvh_walk`` chooses between them per lowering platform. Analytic
spheres are brute-forced in object space before traversal so their t
tightens BVH pruning.

Winning primitive encoding: prim < n_tris -> triangle index (BVH order);
prim >= n_tris -> sphere index (prim - n_tris); prim < 0 -> miss.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import backend
from ..accel.bvh import MAX_LEAF_SIZE
from ..device.scene_buffers import DeviceScene
from . import bvh_walk_cuda
from .intersect import ray_aabb, ray_sphere, ray_triangle, sphere_hit_geom
from .linalg import (
    apply_point, apply_vector, apply_vector_transposed, cross, normalize,
)

INF = jnp.inf


def _walk_xla(rows, tris, origin, direction, t_min, t_best, best, active,
              *, root, depth, early_exit):
    """Near-first stack walk over child-pair rows, batched in XLA.

    Each internal step gathers ONE 16-wide row holding both children's
    AABBs + metas, tests both slabs, descends into the nearer hit child and
    pushes the farther onto a per-lane stack ((B, depth) selects). Leaf
    phases are batched while-while style: the inner loop parks every live
    lane on a leaf meta, the outer loop intersects parked leaves.
    meta encoding: leaf -> (first<<3)|count (count>0), internal -> row<<3.

    Returns (t_best, best) with only hit lanes changed; with early_exit a
    lane stops at its first leaf hit.
    """
    B = origin.shape[0]
    D = max(int(depth), 1)
    n_rows = tris.shape[0]
    inv_dir = 1.0 / direction

    DONE = jnp.int32(-1)
    cur0 = jnp.where(active, jnp.int32(root), DONE)
    if early_exit:
        cur0 = jnp.where(best >= 0, DONE, cur0)
    sp0 = jnp.zeros(B, jnp.int32)
    stack0 = jnp.zeros((B, D), jnp.int32)
    lane_iota = jnp.arange(D, dtype=jnp.int32)[None, :]

    def is_leaf(meta):
        return (meta & 7) > 0

    def pop(cur, sp, stack, do):
        """Lanes in `do` pop (or finish when their stack is empty)."""
        can = sp > 0
        top = jnp.sum(
            jnp.where(lane_iota == (sp - 1)[:, None], stack, 0), axis=1
        )
        cur = jnp.where(do, jnp.where(can, top, DONE), cur)
        sp = jnp.where(do & can, sp - 1, sp)
        return cur, sp

    def inner(cur, sp, stack, t_best):
        def cond(s):
            cur, _, _ = s
            return jnp.any((cur != DONE) & ~is_leaf(cur))

        def body(s):
            cur, sp, stack = s
            live = (cur != DONE) & ~is_leaf(cur)
            row = rows[jnp.maximum(cur >> 3, 0)]
            tl0, tl1 = ray_aabb(origin, inv_dir, row[:, 0:3], row[:, 3:6])
            tr0, tr1 = ray_aabb(origin, inv_dir, row[:, 6:9], row[:, 9:12])
            hit_l = (tl0 <= tl1) & (tl1 >= t_min) & (tl0 <= t_best)
            hit_r = (tr0 <= tr1) & (tr1 >= t_min) & (tr0 <= t_best)
            meta_l = jax.lax.bitcast_convert_type(row[:, 12], jnp.int32)
            meta_r = jax.lax.bitcast_convert_type(row[:, 13], jnp.int32)

            both = hit_l & hit_r & live
            l_near = tl0 <= tr0
            near = jnp.where(l_near, meta_l, meta_r)
            far = jnp.where(l_near, meta_r, meta_l)

            # push the far child when both hit
            stack = jnp.where(
                (both[:, None]) & (lane_iota == sp[:, None]),
                far[:, None], stack,
            )
            sp = jnp.where(both, sp + 1, sp)

            one = (hit_l ^ hit_r) & live
            nxt = jnp.where(both, near, jnp.where(hit_l, meta_l, meta_r))
            cur = jnp.where(live & (both | one), nxt, cur)
            none = live & ~hit_l & ~hit_r
            cur, sp = pop(cur, sp, stack, none)
            return cur, sp, stack

        return jax.lax.while_loop(cond, body, (cur, sp, stack))

    def outer_cond(state):
        cur, _, _, _, _ = state
        return jnp.any(cur != DONE)

    def outer_body(state):
        cur, sp, stack, t_best, best = state
        cur, sp, stack = inner(cur, sp, stack, t_best)

        do_leaf = (cur != DONE) & is_leaf(cur)
        count = jnp.where(do_leaf, cur & 7, 0)
        first = jnp.maximum(cur >> 3, 0)
        offs = jnp.arange(MAX_LEAF_SIZE, dtype=jnp.int32)
        tid = jnp.minimum(first[:, None] + offs[None, :], n_rows - 1)
        lane_ok = do_leaf[:, None] & (offs[None, :] < count[:, None])
        pack = tris[tid]
        valid, t, _, _ = ray_triangle(
            origin[:, None, :], direction[:, None, :],
            pack[..., 0:3], pack[..., 3:6], pack[..., 6:9],
            t_min[:, None], t_best[:, None],
        )
        t = jnp.where(valid & lane_ok, t, INF)
        k = jnp.argmin(t, axis=1)
        t_leaf = jnp.take_along_axis(t, k[:, None], axis=1)[:, 0]
        leaf_hit = jnp.isfinite(t_leaf)
        t_best = jnp.where(leaf_hit, t_leaf, t_best)
        best = jnp.where(leaf_hit, first + k.astype(jnp.int32), best)

        if early_exit:
            fin = do_leaf & (best >= 0)
            cur = jnp.where(fin, DONE, cur)
            sp = jnp.where(fin, 0, sp)
            do_leaf = do_leaf & ~fin
        cur, sp = pop(cur, sp, stack, do_leaf)
        return cur, sp, stack, t_best, best

    _, _, _, t_best, best = jax.lax.while_loop(
        outer_cond, outer_body, (cur0, sp0, stack0, t_best, best)
    )
    return t_best, best


def _walk_cuda(rows, tris, origin, direction, t_min, t_best, best, active,
               *, root, depth, early_exit):
    """The CUDA kernel; same arguments and results as `_walk_xla`.

    The library is built and registered while tracing for a process that
    has a GPU; tracing elsewhere (CPU tests, a CUDA export) only emits the
    custom call. `depth` is bounded by bvh_walk_cuda.MAX_STACK at
    compile_scene."""
    del depth
    if backend.has_gpu():
        bvh_walk_cuda.register()
    return bvh_walk_cuda.walk(
        rows, tris, root, origin, direction, t_min, t_best, best, active,
        early_exit,
    )


def _tri_pass(ds, blas, origin, direction, t_min, t_best, best, active,
              early_exit):
    """One walk over the main world-space accel (blas=None) or over shared
    BLAS `blas` with object-space rays."""
    if blas is None:
        rows, tris = ds.bvh2_rows, ds.tri_pack
        root, depth = ds.meta.root_meta, ds.meta.bvh2_depth
    else:
        bt = ds.blas_tables[blas]
        rows, tris = bt.bvh2_rows, bt.tri_pack
        _n, root, depth = ds.meta.blas_meta[blas]
    statics = dict(root=int(root), depth=int(depth), early_exit=early_exit)
    return backend.bvh_walk(
        (rows, tris, origin, direction, t_min, t_best, best, active),
        partial(_walk_cuda, **statics), partial(_walk_xla, **statics),
    )


class Hit(NamedTuple):
    """SoA hit records (counterpart of accel.rs HitInfo)."""

    hit: jax.Array       # (B,) bool
    t: jax.Array         # (B,) f32
    prim: jax.Array      # (B,) i32 encoded winner
    uv: jax.Array        # (B, 2)
    point: jax.Array     # (B, 3) world
    normal: jax.Array    # (B, 3) world, unit
    dpdu: jax.Array      # (B, 3)
    dpdv: jax.Array      # (B, 3)
    material: jax.Array  # (B,) i32
    light: jax.Array     # (B,) i32 (-1 = not an emitter)


def _intersect_spheres(ds: DeviceScene, origin, direction, t_min, t_max):
    """Brute-force all spheres in object space. Returns (t, sphere_idx)."""
    S = ds.sph_center.shape[0]
    # (B, S, 3): transform rays into each sphere's object space
    o_o = apply_point(ds.sph_w2o[None, :], origin[:, None, :])
    d_o = apply_vector(ds.sph_w2o[None, :], direction[:, None, :])
    valid, t = ray_sphere(
        o_o, d_o, ds.sph_center[None, :], ds.sph_radius[None, :],
        t_min[:, None], t_max[:, None],
    )
    # padded entries have radius 0 -> c = |omc|^2 > 0 unless ray at origin;
    # mask them explicitly anyway
    real = (
        jnp.arange(S, dtype=jnp.int32)[None, :] < ds.meta.n_spheres
    )
    t = jnp.where(valid & real, t, INF)
    best = jnp.argmin(t, axis=1).astype(jnp.int32)
    t_best = jnp.take_along_axis(t, best[:, None], axis=1)[:, 0]
    return t_best, best


def intersect_scene(
    ds: DeviceScene,
    origin: jax.Array,     # (B, 3)
    direction: jax.Array,  # (B, 3)
    t_min: jax.Array,      # (B,)
    t_max: jax.Array,      # (B,)
    early_exit: bool = False,
    active: jax.Array | None = None,
    presorted: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Closest-hit (or any-hit) query. Returns (t, encoded prim or -1).

    With backend.coherence_sort on, lanes are walked in coherence-sorted
    order and unsorted after; presorted=True says the caller already
    ordered them (the integrator's once-per-bounce path-state sort). Lanes
    are independent, so the order never changes a result.
    """
    B = origin.shape[0]
    n_tris = ds.meta.n_tris
    t_best = jnp.broadcast_to(t_max, (B,)).astype(jnp.float32)
    best = jnp.full((B,), -1, jnp.int32)

    if active is None:
        active = jnp.ones((B,), bool)

    from ..utils import raydump

    raydump.emit(early_exit, origin, direction, t_min, t_max, active)

    if ds.meta.n_spheres:
        st, sidx = _intersect_spheres(ds, origin, direction, t_min, t_best)
        sph_hit = jnp.isfinite(st) & active
        t_best = jnp.where(sph_hit, st, t_best)
        best = jnp.where(sph_hit, n_tris + sidx, best)

    instances = ds.meta.instances
    if n_tris == 0 and not instances:
        t = jnp.where(best >= 0, t_best, INF)
        return t, best

    sort = backend.coherence_sort(ds) and not presorted
    if sort:
        # dead lanes sort last; the per-lane state crosses the permutation
        # as one packed gather in and one out. Integer lanes stay in the
        # integer domain (best = -1 is a NaN bit pattern as f32).
        key = ray_sort_key(ds, origin, direction)
        key = key | ((~active).astype(jnp.int32) << 25)
        iota = jnp.arange(B, dtype=jnp.int32)
        _, order = jax.lax.sort_key_val(key, iota, is_stable=True)
        _, inv = jax.lax.sort_key_val(order, iota, is_stable=True)
        packed = jnp.concatenate(
            [origin, direction, t_min[:, None], t_best[:, None],
             active.astype(jnp.float32)[:, None]],
            axis=1,
        )[order]
        origin, direction = packed[:, 0:3], packed[:, 3:6]
        t_min, t_best = packed[:, 6], packed[:, 7]
        active = packed[:, 8] > 0
        best = best[order]

    if n_tris:
        t_best, best = _tri_pass(
            ds, None, origin, direction, t_min, t_best, best, active,
            early_exit,
        )

    # shared-BLAS instances: one pass per instance over the shared
    # object-space BVH with locally transformed rays; t is preserved by
    # the (unnormalized) affine ray transform, so t chains across passes
    # exactly like the reference's nested-BVH traversal (accel.rs:183-214)
    # and IAS (scene.cu:162-250). Each pass is masked by the instance's
    # world-AABB slab test.
    inv_dir = 1.0 / direction
    for i, (blas_id, vtri_base, _nt_b, _so) in enumerate(instances):
        w2o = ds.inst_xf[i][16:].reshape(4, 4)
        o_l = apply_point(w2o[None], origin)
        d_l = apply_vector(w2o[None], direction)
        a0, a1 = ray_aabb(
            origin, inv_dir,
            jnp.broadcast_to(ds.inst_aabb_min[i], (B, 3)),
            jnp.broadcast_to(ds.inst_aabb_max[i], (B, 3)),
        )
        act_i = active & (a0 <= a1) & (a1 >= t_min) & (a0 <= t_best)
        if early_exit:
            act_i = act_i & (best < 0)
        pt, pbest = _tri_pass(
            ds, blas_id, o_l, d_l, t_min, t_best,
            jnp.full((B,), -1, jnp.int32), act_i, early_exit,
        )
        ihit = pbest >= 0
        t_best = jnp.where(ihit, pt, t_best)
        best = jnp.where(ihit, vtri_base + pbest, best)

    if sort:
        t_best, best = t_best[inv], best[inv]
    t = jnp.where(best >= 0, t_best, INF)
    return t, best


def _interleave3(v):
    """Spread the low 7 bits of v 3 apart (canonical part-1-by-2)."""
    v = v & 0x7F
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def ray_sort_key(ds: DeviceScene, origin, direction):
    """Coherence key: 3 direction-octant bits + 21-bit origin Morton code
    (< 2^25; callers OR a dead-lane bit at 25). Rays sharing a key start
    near each other and point the same way. The key only affects lane
    order; results are identical under any permutation."""
    c = ds.bounds_center
    r = jnp.maximum(ds.bounds_radius, 1e-6)
    q = jnp.clip((origin - c) / (2.0 * r) + 0.5, 0.0, 1.0)
    qi = (q * 127.0).astype(jnp.int32)
    morton = (
        _interleave3(qi[:, 0])
        | (_interleave3(qi[:, 1]) << 1)
        | (_interleave3(qi[:, 2]) << 2)
    )
    octant = (
        (direction[:, 0] < 0).astype(jnp.int32)
        | ((direction[:, 1] < 0).astype(jnp.int32) << 1)
        | ((direction[:, 2] < 0).astype(jnp.int32) << 2)
    )
    return (octant << 21) | morton


def hit_details(
    ds: DeviceScene, origin, direction, t, prim
) -> Hit:
    """Expand an encoded (t, prim) query result into full shading geometry.

    Triangles are world-space so interpolation happens directly in world
    coordinates; spheres are recomputed in object space and transformed out
    (geometry.rs:92-136 semantics).
    """
    B = origin.shape[0]
    n_tris = ds.meta.n_tris
    instances = ds.meta.instances
    hit = prim >= 0
    is_tri = hit & (prim < n_tris)

    point = origin + t[:, None] * direction

    # -------- triangle path: ONE wide row gather replaces 13 narrow ones
    if instances:
        # virtual-tri decode: instanced winners map to shared object-space
        # BLAS shade rows + a per-instance transform (applied below)
        base0 = ds.meta.inst_vtri_base0
        is_inst = hit & (prim >= base0)
        row = jnp.where(is_tri, prim, 0)
        xf_id = jnp.zeros_like(prim)
        for i, (_b, vbase, nt_b, shade_off) in enumerate(instances):
            m = (prim >= vbase) & (prim < vbase + nt_b)
            row = jnp.where(m, prim - vbase + shade_off, row)
            xf_id = jnp.where(m, i, xf_id)
        tid = jnp.clip(row, 0, ds.tri_shade.shape[0] - 1)
        xf = ds.inst_xf[xf_id]                    # (B, 32)
        o2w = xf[:, :16].reshape(B, 4, 4)
        w2o = xf[:, 16:].reshape(B, 4, 4)
        sel_i = is_inst[:, None]
        o_sel = jnp.where(sel_i, apply_point(w2o, origin), origin)
        d_sel = jnp.where(sel_i, apply_vector(w2o, direction), direction)
    else:
        is_inst = None
        tid = jnp.clip(jnp.where(is_tri, prim, 0), 0, max(n_tris - 1, 0))
        o_sel, d_sel = origin, direction
    sh = ds.tri_shade[tid]                       # (B, 32)
    p0, p1, p2 = sh[:, 0:3], sh[:, 3:6], sh[:, 6:9]
    sh_ints = jax.lax.bitcast_convert_type(sh[:, 24:28], jnp.int32)
    # recompute barycentrics for the winning triangle (per-lane space:
    # local rays against local rows for instanced lanes, world otherwise)
    _, _, u, v = ray_triangle(
        o_sel, d_sel, p0, p1, p2,
        jnp.full_like(t, -INF), jnp.full_like(t, INF),
    )
    w = 1.0 - u - v
    geo_n = normalize(cross(p2 - p0, p1 - p0))
    sn = (
        w[:, None] * sh[:, 9:12]
        + u[:, None] * sh[:, 12:15]
        + v[:, None] * sh[:, 15:18]
    )
    tri_normal = jnp.where(
        (sh_ints[:, 2] != 0)[:, None], normalize(sn), geo_n
    )
    default_uv0 = jnp.array([0.0, 0.0], jnp.float32)
    default_uv1 = jnp.array([1.0, 0.0], jnp.float32)
    default_uv2 = jnp.array([0.0, 1.0], jnp.float32)
    has_uv = (sh_ints[:, 3] != 0)[:, None]
    uv0 = jnp.where(has_uv, sh[:, 18:20], default_uv0)
    uv1 = jnp.where(has_uv, sh[:, 20:22], default_uv1)
    uv2 = jnp.where(has_uv, sh[:, 22:24], default_uv2)
    tri_uv = w[:, None] * uv0 + u[:, None] * uv1 + v[:, None] * uv2
    # pbrt 4ed eq. 6.7
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dp02 = p0 - p2
    dp12 = p1 - p2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    degenerate = jnp.abs(det) < 1e-9
    inv_det = jnp.where(degenerate, 0.0, 1.0 / jnp.where(degenerate, 1.0, det))
    tri_dpdu = inv_det[:, None] * (
        duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12
    )
    tri_dpdv = inv_det[:, None] * (
        duv02[:, 0:1] * dp12 - duv12[:, 0:1] * dp02
    )
    tri_mat = sh_ints[:, 0]
    tri_light = sh_ints[:, 1]

    if instances:
        # instanced lanes computed in object space: transform out (normals
        # via inverse-transpose — geometry.rs:92-136 / transform.rs:67-72)
        tri_normal = jnp.where(
            sel_i, normalize(apply_vector_transposed(w2o, tri_normal)),
            tri_normal,
        )
        tri_dpdu = jnp.where(sel_i, apply_vector(o2w, tri_dpdu), tri_dpdu)
        tri_dpdv = jnp.where(sel_i, apply_vector(o2w, tri_dpdv), tri_dpdv)
        is_tri = is_tri | is_inst

    # -------- sphere path
    if ds.meta.n_spheres:
        sid = jnp.clip(jnp.where(is_tri, 0, prim - n_tris), 0, ds.sph_center.shape[0] - 1)
        w2o = ds.sph_w2o[sid]
        o2w = ds.sph_o2w[sid]
        o_o = apply_point(w2o, origin)
        d_o = apply_vector(w2o, direction)
        p_o = o_o + t[:, None] * d_o
        # robust sphere hit point: reproject onto the surface and inflate a few
        # ULPs outward. o + t*d rounding can land the point INSIDE the sphere;
        # a grazing reflection from an inside point re-enters on a real chord
        # (t >> t_min), which self-shadows the whole silhouette band —
        # backend-dependent (FMA contraction can land inside far more often
        # than the CPU does). An outside point on a convex surface cannot be
        # re-hit by any reflected ray, and transmitted rays re-enter at t ~
        # 1e-7 << t_min. (Robustness fix over geometry.rs:92-136, which keeps
        # the raw o + t*d point.)
        ctr = ds.sph_center[sid]
        rel = p_o - ctr
        rn = jnp.sqrt(jnp.sum(rel * rel, axis=-1, keepdims=True))
        safe_rn = jnp.where(rn == 0.0, 1.0, rn)
        p_o = ctr + rel * (
            ds.sph_radius[sid][:, None] / safe_rn) * (1.0 + 4.0e-7)
        sph_uv, n_o, dpdu_o, dpdv_o = sphere_hit_geom(
            p_o, ctr, ds.sph_radius[sid]
        )
        sph_point = apply_point(o2w, p_o)
        sph_normal = normalize(apply_vector_transposed(w2o, n_o))
        sph_dpdu = apply_vector(o2w, dpdu_o)
        sph_dpdv = apply_vector(o2w, dpdv_o)
        sph_mat = ds.sph_mat[sid]
        sph_light = ds.sph_light[sid]

        sel = is_tri[:, None]
        uv = jnp.where(sel, tri_uv, sph_uv)
        point = jnp.where(sel, point, sph_point)
        normal = jnp.where(sel, tri_normal, sph_normal)
        dpdu = jnp.where(sel, tri_dpdu, sph_dpdu)
        dpdv = jnp.where(sel, tri_dpdv, sph_dpdv)
        material = jnp.where(is_tri, tri_mat, sph_mat)
        light = jnp.where(is_tri, tri_light, sph_light)
    else:
        uv, normal, dpdu, dpdv = tri_uv, tri_normal, tri_dpdu, tri_dpdv
        material, light = tri_mat, tri_light

    zero3 = jnp.zeros((B, 3), jnp.float32)
    return Hit(
        hit=hit,
        t=jnp.where(hit, t, INF),
        prim=prim,
        uv=jnp.where(hit[:, None], uv, jnp.zeros((B, 2), jnp.float32)),
        point=jnp.where(hit[:, None], point, zero3),
        normal=jnp.where(hit[:, None], normal, zero3),
        dpdu=jnp.where(hit[:, None], dpdu, zero3),
        dpdv=jnp.where(hit[:, None], dpdv, zero3),
        material=jnp.where(hit, material, 0),
        light=jnp.where(hit, light, -1),
    )


def intersect_closest(ds: DeviceScene, origin, direction, t_min, t_max) -> Hit:
    t, prim = intersect_scene(ds, origin, direction, t_min, t_max)
    return hit_details(ds, origin, direction, t, prim)


def occluded(ds: DeviceScene, origin, direction, t_min, t_max, active=None,
             presorted=False):
    """Any-hit query for shadow rays (accel.rs early_exit semantics)."""
    _, prim = intersect_scene(
        ds, origin, direction, t_min, t_max, early_exit=True, active=active,
        presorted=presorted,
    )
    return prim >= 0
