"""Top-level BSDF dispatch over per-lane material kinds (device).

Each material kind present in the scene (static, from SceneMeta) is evaluated
on the full batch and per-lane kinds select the result — predication instead
of the reference CPU's enum match / OptiX's SBT program selection.

Exception: the stochastic layered BSDF (CoatedDiffuse) is ~100x the vector work
of every other kind (8 samples x 8 depth random walk, layered.py), so paying it
on every lane just to mask the result can dominate device time. The
MATERIAL-PARTITIONED path sorts lanes so coated ones are contiguous, then a
while_loop runs the walk on only ceil(n_coated / TILE) fixed-shape tiles — cost
proportional to the actual coated+active fraction, with static shapes
throughout (the SBT-dispatch role of the OptiX backend, SURVEY.md §2.3, recast
as a compacted tile queue). Results merge back through the same per-lane kind
masks, so the predicated and partitioned paths agree (TPU_RT_MAT_PART=0/1 A/B
knob).

Every bsdf_sample call consumes exactly 3 sampler dimensions regardless of
the lane's material so streams stay aligned across the batch; the layered
BSDF derives an internal hashed sub-stream for its random walk.
"""
from __future__ import annotations

import os as _os
from typing import Tuple

import jax
import jax.numpy as jnp

from ..device.scene_buffers import (
    MAT_COATED_DIFFUSE, MAT_DIFFUSE, MAT_ROUGH_CONDUCTOR,
    MAT_ROUGH_DIELECTRIC, MAT_SMOOTH_CONDUCTOR, MAT_SMOOTH_DIELECTRIC,
)
from . import bsdf as B
from .layered import layered_eval, layered_sample
from .rng import SampleStream, SamplerConfig, hash_u32, sample_uniform, sample_uniform2

MAT_TILE = int(_os.environ.get("TPU_RT_MAT_TILE", "4096"))


def _mat_partition(B_: int) -> bool:
    """Partitioned layered dispatch: off unless TPU_RT_MAT_PART=1.

    The choice never depends on the batch size, so a render takes the same
    numerical path at every pixel-chunk size — the cross-chunking
    determinism invariant. Tiles are fixed-shape (MAT_TILE) with padding,
    so small batches just waste part of one tile. The partitioned walk
    differs from the predicated one by shape-dependent XLA fusion ULPs
    (tests/test_mat_partition.py). Whether it pays on a GPU is not
    measured yet."""
    return _os.environ.get("TPU_RT_MAT_PART", "0") == "1"


def _coated_order(kind, active):
    """Stable order putting active coated lanes first; returns
    (order, inverse, n_coated)."""
    B_ = kind.shape[0]
    wanted = kind == MAT_COATED_DIFFUSE
    if active is not None:
        wanted = wanted & active
    key = (~wanted).astype(jnp.int32)
    iota = jnp.arange(B_, dtype=jnp.int32)
    _, order = jax.lax.sort_key_val(key, iota, is_stable=True)
    _, inv = jax.lax.sort_key_val(order, iota, is_stable=True)
    return order, inv, jnp.sum(wanted.astype(jnp.int32))


def _pad_tile(a, T):
    """Pad axis 0 up to T rows so dynamic_slice windows always fit.

    The tile shape is always exactly (T, ...) regardless of the batch
    size, so the layered walk compiles to ONE executable shape — renders
    stay identical across pixel-chunk sizes (determinism invariant)."""
    B_ = a.shape[0]
    if B_ >= T:
        return a
    pad = [(0, T - B_)] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, pad)


def _tile_loop(n_wanted, T, bufs, tile_fn):
    """Run tile_fn over the first ceil(n_wanted/T) T-sized windows of the
    sorted buffers. dynamic_slice clamps the final window into bounds;
    the overlap just recomputes identical values (pure function of lane
    inputs), so clamping is harmless."""
    n_tiles = (n_wanted + T - 1) // T

    def cond(c):
        return c[0] < n_tiles

    def body(c):
        i = c[0]
        start = i * T
        outs = tile_fn(start, *c[1:])
        return (i + 1,) + outs

    out = jax.lax.while_loop(cond, body, (jnp.int32(0),) + bufs)
    return out[1:]


def _layered_eval_partitioned(params: B.BsdfParams, wo, wi, active):
    """layered_eval computed only on (active) coated tiles."""
    B_ = wo.shape[0]
    T = MAT_TILE
    order, inv, n_coated = _coated_order(params.kind, active)
    packf = jnp.concatenate(
        [
            wo, wi, params.albedo, params.eta,
            params.alpha_x[:, None], params.alpha_y[:, None],
            params.thickness[:, None], params.coat_albedo,
        ],
        axis=1,
    )[order]
    top_kind = params.top_kind[order]  # int domain: no f32 bitcast
    packf = _pad_tile(packf, T)
    top_kind = _pad_tile(top_kind, T)
    Bp = packf.shape[0]
    zero_t = jnp.zeros((T, 3), wo.dtype)

    def tile_fn(start, out):
        tf = jax.lax.dynamic_slice(packf, (start, 0), (T, packf.shape[1]))
        tk = jax.lax.dynamic_slice(top_kind, (start,), (T,))
        p = B.BsdfParams(
            kind=jnp.full((T,), MAT_COATED_DIFFUSE, jnp.int32),
            albedo=tf[:, 6:9], eta=tf[:, 9:12], kappa=zero_t,
            alpha_x=tf[:, 12], alpha_y=tf[:, 13], top_kind=tk,
            thickness=tf[:, 14], coat_albedo=tf[:, 15:18],
        )
        f = layered_eval(p, tf[:, 0:3], tf[:, 3:6])
        return (jax.lax.dynamic_update_slice(out, f, (start, 0)),)

    (out,) = _tile_loop(
        n_coated, T, (jnp.zeros((Bp, 3), wo.dtype),), tile_fn
    )
    return out[:B_][inv]


def _layered_sample_partitioned(params: B.BsdfParams, wo, draw_base, active):
    """layered_sample computed only on (active) coated tiles."""
    B_ = wo.shape[0]
    T = MAT_TILE
    order, inv, n_coated = _coated_order(params.kind, active)
    packf = jnp.concatenate(
        [
            wo, params.albedo, params.eta,
            params.alpha_x[:, None], params.alpha_y[:, None],
            params.thickness[:, None], params.coat_albedo,
        ],
        axis=1,
    )[order]
    packi = jnp.stack(
        [
            jax.lax.bitcast_convert_type(draw_base, jnp.int32),
            params.top_kind.astype(jnp.int32),
        ],
        axis=1,
    )[order]
    packf = _pad_tile(packf, T)
    packi = _pad_tile(packi, T)
    Bp = packf.shape[0]
    zero_t = jnp.zeros((T, 3), wo.dtype)

    def tile_fn(start, outf, outi):
        tf = jax.lax.dynamic_slice(packf, (start, 0), (T, packf.shape[1]))
        ti = jax.lax.dynamic_slice(packi, (start, 0), (T, 2))
        p = B.BsdfParams(
            kind=jnp.full((T,), MAT_COATED_DIFFUSE, jnp.int32),
            albedo=tf[:, 3:6], eta=tf[:, 6:9], kappa=zero_t,
            alpha_x=tf[:, 9], alpha_y=tf[:, 10], top_kind=ti[:, 1],
            thickness=tf[:, 11], coat_albedo=tf[:, 12:15],
        )
        db = jax.lax.bitcast_convert_type(ti[:, 0], jnp.uint32)
        s = layered_sample(p, tf[:, 0:3], db)
        sf = jnp.concatenate([s.wi, s.f, s.pdf[:, None]], axis=1)
        si = jnp.stack(
            [s.component, s.valid.astype(jnp.int32)], axis=1
        )
        return (
            jax.lax.dynamic_update_slice(outf, sf, (start, 0)),
            jax.lax.dynamic_update_slice(outi, si, (start, 0)),
        )

    outf, outi = _tile_loop(
        n_coated, T,
        (jnp.zeros((Bp, 7), wo.dtype), jnp.zeros((Bp, 2), jnp.int32)),
        tile_fn,
    )
    outf = outf[:B_][inv]
    outi = outi[:B_][inv]
    return B.BsdfSample(
        wi=outf[:, 0:3], f=outf[:, 3:6], pdf=outf[:, 6],
        component=outi[:, 0], valid=outi[:, 1] != 0,
    )


def _rough_kinds(kinds: Tuple[int, ...]):
    """Kinds that can appear at runtime given the compile-time kind set
    (rough kinds can degrade to smooth per-lane)."""
    out = set(kinds)
    if MAT_ROUGH_CONDUCTOR in out:
        out.add(MAT_SMOOTH_CONDUCTOR)
    if MAT_ROUGH_DIELECTRIC in out:
        out.add(MAT_SMOOTH_DIELECTRIC)
    return out


def bsdf_eval(params: B.BsdfParams, wo, wi, kinds: Tuple[int, ...],
              active=None):
    """f(wo, wi) per lane; delta BSDFs evaluate to zero.

    active (optional bool mask): lanes whose result is actually consumed —
    the partitioned layered path skips coated lanes outside it. Inactive
    lanes may return garbage; callers must mask (they already do)."""
    kinds = _rough_kinds(kinds)
    k = params.kind
    f = jnp.zeros_like(wo)
    if MAT_DIFFUSE in kinds:
        f = jnp.where(
            (k == MAT_DIFFUSE)[..., None],
            B.diffuse_eval(params.albedo, wo, wi),
            f,
        )
    if MAT_ROUGH_CONDUCTOR in kinds:
        f = jnp.where(
            (k == MAT_ROUGH_CONDUCTOR)[..., None],
            B.ts_refl_eval(
                wo, wi, params.eta, params.kappa, params.alpha_x, params.alpha_y
            ),
            f,
        )
    if MAT_ROUGH_DIELECTRIC in kinds:
        f = jnp.where(
            (k == MAT_ROUGH_DIELECTRIC)[..., None],
            B.ts_eval(wo, wi, params.eta[..., 0], params.alpha_x, params.alpha_y),
            f,
        )
    if MAT_COATED_DIFFUSE in kinds:
        if _mat_partition(wo.shape[0]):
            lf = _layered_eval_partitioned(params, wo, wi, active)
        else:
            lf = layered_eval(params, wo, wi)
        f = jnp.where((k == MAT_COATED_DIFFUSE)[..., None], lf, f)
    return f


def bsdf_pdf(params: B.BsdfParams, wo, wi, allowed, kinds: Tuple[int, ...]):
    kinds = _rough_kinds(kinds)
    k = params.kind
    pdf = jnp.zeros(wo.shape[:-1], wo.dtype)
    if MAT_DIFFUSE in kinds:
        pdf = jnp.where(
            k == MAT_DIFFUSE, B.diffuse_pdf(wo, wi, allowed), pdf
        )
    if MAT_ROUGH_CONDUCTOR in kinds:
        ok = (allowed & B.NONSPECULAR_REFLECTION) != 0
        p = B.ts_refl_pdf(wo, wi, params.alpha_x, params.alpha_y)
        pdf = jnp.where((k == MAT_ROUGH_CONDUCTOR) & ok, p, pdf)
    if MAT_ROUGH_DIELECTRIC in kinds:
        p = B.ts_pdf(
            wo, wi, params.eta[..., 0], params.alpha_x, params.alpha_y, allowed
        )
        pdf = jnp.where(k == MAT_ROUGH_DIELECTRIC, p, pdf)
    # layered pdf is not defined (reference: todo!()); never needed at top
    # level because the integrator has no BSDF-vs-light MIS.
    return pdf


def bsdf_sample(
    params: B.BsdfParams,
    wo,
    allowed,
    cfg: SamplerConfig,
    stream: SampleStream,
    kinds: Tuple[int, ...],
    active=None,
) -> Tuple[B.BsdfSample, SampleStream]:
    kinds = _rough_kinds(kinds)
    k = params.kind
    u2, stream = sample_uniform2(cfg, stream)
    u1, stream = sample_uniform(cfg, stream)

    B_ = wo.shape[0]
    out = B.BsdfSample(
        wi=jnp.zeros_like(wo),
        f=jnp.zeros_like(wo),
        pdf=jnp.zeros(B_, wo.dtype),
        component=jnp.zeros(B_, jnp.int32),
        valid=jnp.zeros(B_, bool),
    )

    def merge(out, mask, s: B.BsdfSample):
        m = mask[..., None]
        return B.BsdfSample(
            wi=jnp.where(m, s.wi, out.wi),
            f=jnp.where(m, s.f, out.f),
            pdf=jnp.where(mask, s.pdf, out.pdf),
            component=jnp.where(mask, s.component, out.component),
            valid=jnp.where(mask, s.valid, out.valid),
        )

    if MAT_DIFFUSE in kinds:
        ok = (allowed & B.NONSPECULAR_REFLECTION) != 0
        s = B.diffuse_sample(params.albedo, wo, u2)
        s = s._replace(valid=s.valid & ok)
        out = merge(out, k == MAT_DIFFUSE, s)
    if MAT_SMOOTH_DIELECTRIC in kinds:
        s = B.smooth_dielectric_sample(params.eta[..., 0], wo, u1, allowed)
        out = merge(out, k == MAT_SMOOTH_DIELECTRIC, s)
    if MAT_SMOOTH_CONDUCTOR in kinds:
        ok = (allowed & B.SPECULAR_REFLECTION) != 0
        s = B.smooth_conductor_sample(params.eta, params.kappa, wo)
        s = s._replace(valid=s.valid & ok)
        out = merge(out, k == MAT_SMOOTH_CONDUCTOR, s)
    if MAT_ROUGH_CONDUCTOR in kinds:
        ok = (allowed & B.REFLECTION) != 0
        s = B.ts_refl_sample(
            wo, params.eta, params.kappa, params.alpha_x, params.alpha_y, u2
        )
        s = s._replace(valid=s.valid & ok)
        out = merge(out, k == MAT_ROUGH_CONDUCTOR, s)
    if MAT_ROUGH_DIELECTRIC in kinds:
        s = B.ts_sample(
            wo, params.eta[..., 0], params.alpha_x, params.alpha_y,
            allowed, u2, u1,
        )
        out = merge(out, k == MAT_ROUGH_DIELECTRIC, s)
    if MAT_COATED_DIFFUSE in kinds:
        draw_base = hash_u32(
            stream.px, stream.py, stream.sample, stream.dim,
            jnp.uint32(0xC0A7ED),
        )
        if _mat_partition(wo.shape[0]):
            s = _layered_sample_partitioned(params, wo, draw_base, active)
        else:
            s = layered_sample(params, wo, draw_base)
        out = merge(out, k == MAT_COATED_DIFFUSE, s)

    return out, stream
