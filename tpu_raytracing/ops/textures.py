"""Device texture evaluation over the flattened texture tables.

Batched counterpart of the CPU texture sampler
(raytracing-cpu/src/texture.rs) and the GPU one-level-of-indirection scheme
(csrc/kernels/texture.hpp:86-95): Scale/Mix textures reference *leaf*
textures, so evaluation is two fixed passes instead of recursion. Image
sampling is gather-based over the flat mip atlas (no hardware samplers):
wrap math from texture.rs:44-69, point/bilinear taps from
texture.rs:235-272, trilinear = lerp of two bilinear mip taps with the mip
level chosen from uv-footprint derivatives (texture.rs:274-356). Checker
textures use the reference's erf-based analytic antialiasing
(texture.rs:376-434).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..device.scene_buffers import (
    DeviceScene, TEX_CHECKER, TEX_CONSTANT, TEX_IMAGE, TEX_MIX, TEX_SCALE,
)
from ..materials import FilterMode, WrapMode
from .tables import select_rows


class EvalCtx(NamedTuple):
    """uv + screen-space uv derivatives (materials.rs MaterialEvalContext)."""

    uv: jax.Array     # (B, 2)
    dudx: jax.Array   # (B,)
    dudy: jax.Array
    dvdx: jax.Array
    dvdy: jax.Array

    @staticmethod
    def without_antialiasing(uv) -> "EvalCtx":
        z = jnp.zeros(uv.shape[:-1], uv.dtype)
        return EvalCtx(uv=uv, dudx=z, dudy=z, dvdx=z, dvdy=z)


def eval_ctx_from_differentials(hit, ray_o, ray_d, diff) -> EvalCtx:
    """Chain-rule + least-squares duv/dxy from world-space ray differentials
    (materials.rs:715-809). diff: (B, 4, 3) rows x_o, y_o, x_d, y_d."""
    n, p = hit.normal, hit.point
    rx_o = ray_o + diff[:, 0]
    ry_o = ray_o + diff[:, 1]
    rx_d = ray_d + diff[:, 2]
    ry_d = ray_d + diff[:, 3]

    def dot(a, b):
        return jnp.sum(a * b, axis=-1)

    d = -dot(n, p)
    tx = -(dot(n, rx_o) + d) / dot(n, rx_d)
    ty = -(dot(n, ry_o) + d) / dot(n, ry_d)
    px = rx_o + tx[:, None] * rx_d
    py = ry_o + ty[:, None] * ry_d
    dpdx = px - p
    dpdy = py - p

    dpdu, dpdv = hit.dpdu, hit.dpdv
    ata00 = dot(dpdu, dpdu)
    ata11 = dot(dpdv, dpdv)
    ata01 = dot(dpdu, dpdv)
    det = ata00 * ata11 - ata01 * ata01
    inv_det = 1.0 / det
    atb0x = dot(dpdu, dpdx)
    atb1x = dot(dpdv, dpdx)
    atb0y = dot(dpdu, dpdy)
    atb1y = dot(dpdv, dpdy)

    def clamp(v):
        v = jnp.where(jnp.isfinite(v), v, 0.0)
        return jnp.clip(v, -1.0e8, 1.0e8)

    return EvalCtx(
        uv=hit.uv,
        dudx=clamp(inv_det * (ata11 * atb0x - ata01 * atb1x)),
        dvdx=clamp(inv_det * (ata00 * atb1x - ata01 * atb0x)),
        dudy=clamp(inv_det * (ata11 * atb0y - ata01 * atb1y)),
        dvdy=clamp(inv_det * (ata00 * atb1y - ata01 * atb0y)),
    )


def _apply_wrap(wrap_kind, x):
    frac = x - jnp.floor(x)
    repeat = frac  # jnp floor-based frac is already in [0,1)
    mirrored = jnp.where(
        jnp.mod(jnp.floor(x).astype(jnp.int32), 2) == 1, 1.0 - repeat, repeat
    )
    clamped = jnp.clip(x, 0.0, 1.0)
    out = jnp.where(wrap_kind == int(WrapMode.MIRROR), mirrored, repeat)
    return jnp.where(wrap_kind == int(WrapMode.CLAMP), clamped, out)


def _level_info(ds: DeviceScene, level):
    """(offset, w_i, h_i) of a mip level — one packed fetch (select-chain
    for the usual <=16-level pyramids, ops/tables.py; measured 62 ms per
    gather per cb_texture render)."""
    lv = select_rows(ds.lvl_pack, level)
    return lv[:, 0], lv[:, 1], lv[:, 2]


def _fetch_texel(ds: DeviceScene, offset, w, x, y):
    """Gather a texel from the mip atlas; x/y already clamped in range."""
    return ds.img_texels[offset + y * w + x]


def _bilerp(ds: DeviceScene, level, u, v):
    offset, w_i, h_i = _level_info(ds, level)
    w = w_i.astype(jnp.float32)
    h = h_i.astype(jnp.float32)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.clip(jnp.floor(x), 0.0, w - 1.0).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(y), 0.0, h - 1.0).astype(jnp.int32)
    xf = jnp.clip(x - jnp.floor(x), 0.0, 1.0)[:, None]
    yf = jnp.clip(y - jnp.floor(y), 0.0, 1.0)[:, None]
    if ds.img_quads is not None:
        # ONE row gather returns the whole 2x2 footprint. The quad row
        # bakes the HIGH-edge clamp (x+1 -> min(x+1, w-1)); the LOW edge
        # (x < 0 after the -0.5 pixel-center shift: ceil(x) clamps to 0,
        # so both taps read column 0) is replicated with selects so the
        # blend arithmetic below stays bit-identical to the 4-gather path.
        q = ds.img_quads[offset + y0 * w_i + x0]
        q00, q01 = q[:, 0:4], q[:, 4:8]
        q10, q11 = q[:, 8:12], q[:, 12:16]
        xneg = (x < 0.0)[:, None]
        yneg = (y < 0.0)[:, None]
        p00 = q00
        p01 = jnp.where(xneg, q00, q01)
        p10 = jnp.where(yneg, q00, q10)
        p11 = jnp.where(
            xneg, jnp.where(yneg, q00, q10), jnp.where(yneg, q01, q11)
        )
    else:
        x1 = jnp.clip(jnp.ceil(x), 0.0, w - 1.0).astype(jnp.int32)
        y1 = jnp.clip(jnp.ceil(y), 0.0, h - 1.0).astype(jnp.int32)
        p00 = _fetch_texel(ds, offset, w_i, x0, y0)
        p01 = _fetch_texel(ds, offset, w_i, x1, y0)
        p10 = _fetch_texel(ds, offset, w_i, x0, y1)
        p11 = _fetch_texel(ds, offset, w_i, x1, y1)
    u0 = p00 * (1.0 - xf) + p01 * xf
    u1 = p10 * (1.0 - xf) + p11 * xf
    return u0 * (1.0 - yf) + u1 * yf


def _point_sample(ds: DeviceScene, level, u, v):
    offset, w_i, h_i = _level_info(ds, level)
    w = w_i.astype(jnp.float32)
    h = h_i.astype(jnp.float32)
    x = jnp.clip(jnp.round(u * w - 0.5), 0.0, w - 1.0).astype(jnp.int32)
    y = jnp.clip(jnp.round(v * h - 0.5), 0.0, h - 1.0).astype(jnp.int32)
    return _fetch_texel(ds, offset, w_i, x, y)


def _mip_level_value(ds: DeviceScene, mip0, ctx: EvalCtx):
    """Raw (unclamped) mip level from uv footprint (texture.rs:274-298).
    Returns (level, valid)."""
    _, w0_i, _ = _level_info(ds, mip0)
    w0 = w0_i.astype(jnp.float32)
    dx = jnp.sqrt(ctx.dudx**2 + ctx.dvdx**2)
    dy = jnp.sqrt(ctx.dudy**2 + ctx.dvdy**2)
    larger = jnp.maximum(dx, dy)
    valid = larger > 0.0
    half_pixel = 1.0 / (2.0 * w0)
    level = jnp.log2(jnp.where(valid, larger, 1.0) / half_pixel)
    return level, valid


def _sample_image(ds: DeviceScene, row, ints, ctx: EvalCtx, has_derivs=True):
    mip0 = jnp.maximum(ints[:, 0], 0)   # first mip level (baked by compiler)
    filt = ints[:, 4]
    wrap = ints[:, 5]
    n_levels = ints[:, 6]
    u = _apply_wrap(wrap, ctx.uv[:, 0])
    v = _apply_wrap(wrap, ctx.uv[:, 1])

    # has_derivs=False (static) ⇒ ctx derivatives are all zero ⇒ the mip
    # footprint is invalid and trilinear falls back to bilinear anyway —
    # skip the two extra mip taps entirely. Bit-exact.
    if ds.meta.any_trilinear and has_derivs:
        # 2 atlas gathers instead of 3 (atlas rows pay a fixed per-row
        # DMA descriptor, so gather count IS the cost): non-trilinear /
        # invalid-footprint lanes route both mip taps to the base level,
        # where tap `a` IS the bilinear value (_bilerp is per-lane in
        # its level argument) — the dedicated base-level gather the old
        # shape did for every lane compiles out. Bit-exact: each lane
        # computes the same _bilerp(level) it did before.
        level, valid = _mip_level_value(ds, mip0, ctx)
        max_level = (n_levels - 1).astype(jnp.float32)
        lower = jnp.floor(jnp.clip(level, 0.0, max_level)).astype(jnp.int32)
        upper = jnp.ceil(jnp.clip(level, 0.0, max_level)).astype(jnp.int32)
        t = (level - jnp.floor(level))[:, None]
        tri_lane = (filt == int(FilterMode.TRILINEAR)) & valid
        a = _bilerp(ds, jnp.where(tri_lane, mip0 + lower, mip0), u, v)
        b = _bilerp(ds, jnp.where(tri_lane, mip0 + upper, mip0), u, v)
        out = jnp.where(tri_lane[:, None], (1.0 - t) * a + t * b, a)
    else:
        out = _bilerp(ds, mip0, u, v)
    # no NEAREST-filtered image texture in the scene (static fact) ⇒ the
    # point-sample tap (one gather/lane/bounce) compiles out entirely
    if ds.meta.any_nearest:
        nearest = _point_sample(ds, mip0, u, v)
        out = jnp.where(
            (filt == int(FilterMode.NEAREST))[:, None], nearest, out
        )
    return out


def _checker(row, ctx: EvalCtx, has_derivs=True):
    c1 = row[:, 0:4]
    c2 = row[:, 4:8]
    u = ctx.uv[:, 0] - jnp.floor(ctx.uv[:, 0])
    v = ctx.uv[:, 1] - jnp.floor(ctx.uv[:, 1])
    plain = jnp.where(
        ((u > 0.5) != (v > 0.5))[:, None], c1, c2
    )
    # zero derivatives select the point-sampled path for every lane —
    # statically skip the erf AA transcendentals (bit-exact)
    if not has_derivs:
        return plain
    point_sampled = ((ctx.dudx == 0.0) & (ctx.dvdx == 0.0)) | (
        (ctx.dudy == 0.0) & (ctx.dvdy == 0.0)
    )
    # erf-based analytic antialiasing
    rate_x = jnp.sqrt(ctx.dudx**2 + ctx.dvdx**2)
    rate_y = jnp.sqrt(ctx.dudy**2 + ctx.dvdy**2)
    sigma = 0.1 * jnp.maximum(rate_x, rate_y)
    sigma = jnp.where(sigma == 0.0, 1.0, sigma)

    def fold(x):
        return jnp.where(
            x < 0.25, x, jnp.where(x < 0.75, -(x - 0.5), x - 1.0)
        )

    sqrt2 = jnp.sqrt(jnp.float32(2.0))
    x_factor = 0.5 * (1.0 + jax.scipy.special.erf(fold(u) / (sqrt2 * sigma)))
    y_factor = 0.5 * (1.0 + jax.scipy.special.erf(fold(v) / (sqrt2 * sigma)))
    x_factor = jnp.where(v > 0.5, x_factor, 1.0 - x_factor)
    y_factor = jnp.where(u > 0.5, y_factor, 1.0 - y_factor)
    factor = (x_factor * y_factor)[:, None]
    aa = factor * c1 + (1.0 - factor) * c2
    return jnp.where(point_sampled[:, None], plain, aa)


def _leaf_from_row(ds: DeviceScene, row, ctx: EvalCtx, has_derivs=True,
                   kinds=None):
    if kinds is None:
        kinds = ds.meta.tex_kinds_present
    ints = jax.lax.bitcast_convert_type(row[:, 8:16], jnp.int32)
    kind = ints[:, 3]
    out = row[:, 0:4]  # constant path covers CONSTANT (and default)
    if TEX_IMAGE in kinds:
        out = jnp.where(
            (kind == TEX_IMAGE)[:, None],
            _sample_image(ds, row, ints, ctx, has_derivs),
            out,
        )
    if TEX_CHECKER in kinds:
        out = jnp.where(
            (kind == TEX_CHECKER)[:, None], _checker(row, ctx, has_derivs), out
        )
    return out


def _eval_leaf(ds: DeviceScene, tid, ctx: EvalCtx, has_derivs=True,
               kinds=None):
    return _leaf_from_row(ds, ds.tex_pack[tid], ctx, has_derivs, kinds)


def eval_texture(ds: DeviceScene, tid, ctx: EvalCtx, has_derivs=True,
                 kinds=None):
    """Evaluate texture ids (B,) at ctx -> (B, 4).

    has_derivs is a STATIC flag: False promises every ctx derivative is
    zero (secondary bounces, light/env lookups), which lets the trilinear
    mip taps and checker erf AA be skipped at trace time — both paths
    already degenerate to the bilinear/plain result when the footprint is
    zero, so the skip is bit-exact.

    kinds is a STATIC iterable of the texture kinds reachable at this
    call site (scene compile computes per-material-slot / env sets,
    scene_buffers.py slot_kinds) — kinds absent from it skip their whole
    sampling path at trace time. Bit-exact: a lane whose row kind is in
    the set computes the identical value; rows outside the set can only
    be unset-slot / masked-out lanes whose values are never consumed.
    None = all kinds present in the scene.
    """
    tid = jnp.maximum(tid, 0)
    row = ds.tex_pack[tid]  # one wide gather
    return eval_texture_from_row(ds, row, ctx, has_derivs, kinds)


def eval_texture_from_row(ds: DeviceScene, row, ctx: EvalCtx,
                          has_derivs=True, kinds=None):
    """eval_texture on a pre-gathered (B, 16) tex_pack row — the bounce
    body gathers all of a material's slot rows in ONE join
    (ds.mat_tex_rows) instead of five separate table gathers."""
    if kinds is None:
        kinds = ds.meta.tex_kinds_present
    out = _leaf_from_row(ds, row, ctx, has_derivs, kinds)
    if TEX_SCALE in kinds or TEX_MIX in kinds:
        ints = jax.lax.bitcast_convert_type(row[:, 8:16], jnp.int32)
        kind = ints[:, 3]
        # slot 0 holds a mip level for IMAGE rows — clamp into table range
        # (the scale/mix selects mask those lanes out). The child evals
        # reuse this call site's kinds: the reach-closure includes every
        # scale/mix child, and non-scale/mix lanes' garbage-id reads are
        # masked out by the selects below.
        hi = ds.tex_pack.shape[0] - 1
        a = _eval_leaf(ds, jnp.clip(ints[:, 0], 0, hi), ctx, has_derivs,
                       kinds)
        b = _eval_leaf(ds, jnp.clip(ints[:, 1], 0, hi), ctx, has_derivs,
                       kinds)
        if TEX_SCALE in kinds:
            out = jnp.where((kind == TEX_SCALE)[:, None], a * b, out)
        if TEX_MIX in kinds:
            c = _eval_leaf(ds, jnp.clip(ints[:, 2], 0, hi), ctx,
                           has_derivs, kinds)
            out = jnp.where(
                (kind == TEX_MIX)[:, None], (1.0 - c) * a + c * b, out
            )
    return out


def texture_mip_level(ds: DeviceScene, tid, ctx: EvalCtx):
    """Mip level of trilinear image textures; (level, valid) per lane
    (texture.rs:460-481 semantics: None unless trilinear image texture)."""
    tid = jnp.maximum(tid, 0)
    B = tid.shape[0]
    if TEX_IMAGE not in ds.meta.tex_kinds_present or not ds.meta.any_trilinear:
        return jnp.zeros(B, jnp.float32), jnp.zeros(B, bool)
    ints = jax.lax.bitcast_convert_type(ds.tex_pack[tid][:, 8:16], jnp.int32)
    kind = ints[:, 3]
    filt = ints[:, 4]
    mip0 = jnp.maximum(ints[:, 0], 0)
    level, valid = _mip_level_value(ds, mip0, ctx)
    valid = valid & (kind == TEX_IMAGE) & (filt == int(FilterMode.TRILINEAR))
    return jnp.where(valid, level, 0.0), valid
