"""Batched BSDF evaluation/sampling in the local shading frame (device).

Batched counterpart of raytracing-cpu/src/materials.rs: the same BSDF set
(diffuse, smooth/rough dielectric + conductor, coated-diffuse layered in
layered.py) restructured from enum dispatch into masked SIMD evaluation over
the whole ray batch — every kind present in the scene is evaluated on all
lanes and per-lane kinds select the result (OptiX used SBT program selection;
a vector machine prefers predication).

Conventions (identical to the reference):
- wo/wi in local shading coordinates, +z = shading normal
- microfacet model is Trowbridge-Reitz with Smith masking and VNDF sampling
  (PBRT 4ed 9.6), dielectric uses the generalized half-vector (9.7)
- rough surfaces fall back to the smooth BSDF below MINIMUM_ROUGHNESS
- pdfs of delta BSDFs are "1 against the implied delta"
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..device.scene_buffers import (
    DeviceScene, MAT_COATED_DIFFUSE, MAT_DIFFUSE, MAT_ROUGH_CONDUCTOR,
    MAT_ROUGH_DIELECTRIC, MAT_SMOOTH_CONDUCTOR, MAT_SMOOTH_DIELECTRIC,
)
from .complexmath import fresnel_complex
from .linalg import dot, normalize
from .tables import select_rows
from .rng import sample_unit_disk
from .textures import EvalCtx, eval_texture, eval_texture_from_row

MINIMUM_ROUGHNESS = 1.0e-3

# component flags (bitmask per lane)
NONSPECULAR_REFLECTION = 1
SPECULAR_REFLECTION = 2
NONSPECULAR_TRANSMISSION = 4
SPECULAR_TRANSMISSION = 8
REFLECTION = NONSPECULAR_REFLECTION | SPECULAR_REFLECTION
TRANSMISSION = NONSPECULAR_TRANSMISSION | SPECULAR_TRANSMISSION
SPECULAR = SPECULAR_REFLECTION | SPECULAR_TRANSMISSION
NONSPECULAR = NONSPECULAR_REFLECTION | NONSPECULAR_TRANSMISSION
ALL_COMPONENTS = REFLECTION | TRANSMISSION


class BsdfParams(NamedTuple):
    """Per-lane material parameters after texture evaluation.

    kind is the *effective* kind (rough kinds degrade to their smooth
    counterpart below MINIMUM_ROUGHNESS, materials.rs:884-908)."""

    kind: jax.Array       # (B,) i32
    albedo: jax.Array     # (B, 3) diffuse / layered-bottom albedo
    eta: jax.Array        # (B, 3) ior (dielectric uses [...,0])
    kappa: jax.Array      # (B, 3)
    alpha_x: jax.Array    # (B,)
    alpha_y: jax.Array    # (B,)
    top_kind: jax.Array   # (B,) layered top (smooth/rough dielectric)
    thickness: jax.Array  # (B,)
    coat_albedo: jax.Array  # (B, 3)


class BsdfSample(NamedTuple):
    wi: jax.Array         # (B, 3)
    f: jax.Array          # (B, 3)
    pdf: jax.Array        # (B,)
    component: jax.Array  # (B,) i32 flags (single bit)
    valid: jax.Array      # (B,) bool: usable sample (not null/invalid)


def get_bsdf_params(
    ds: DeviceScene, mat_id, ctx: EvalCtx, has_derivs=True
) -> BsdfParams:
    """Gather + evaluate material textures -> per-lane BSDF parameters
    (materials.rs get_bsdf semantics incl. roughness remap + smooth fallback).
    has_derivs: static no-footprint promise, see ops/textures.eval_texture."""
    mat_id = jnp.maximum(mat_id, 0)
    # tiny static tables: select-chain beats a per-lane row gather (~10x,
    # ops/tables.py); falls back to the gather for big material sets
    mp = select_rows(ds.mat_pack, mat_id)  # kind, tex0..4, remap
    kind = mp[:, 0]
    tex = mp[:, 1:6]
    remap = mp[:, 6] != 0
    # the 5 slot textures' rows in one material-major join (one row
    # gather instead of five tex_pack gathers; rows identical bits to
    # tex_pack[max(tex[:, j], 0)], so evaluation is bit-exact)
    rows = select_rows(ds.mat_tex_rows, mat_id)

    def slot(j):
        return rows[:, 16 * j:16 * (j + 1)]

    # per-slot static kind sets: a slot whose textures are all constants
    # skips the image/checker paths (and their atlas gathers) entirely
    sk = ds.meta.slot_kinds or (ds.meta.tex_kinds_present,) * 5
    t0 = eval_texture_from_row(ds, slot(0), ctx, has_derivs, sk[0])  # albedo/eta
    t1 = eval_texture_from_row(ds, slot(1), ctx, has_derivs, sk[1])  # kappa/eta
    t2 = eval_texture_from_row(ds, slot(2), ctx, has_derivs, sk[2])  # roughness
    has_rough_tex = tex[:, 2] >= 0

    is_layered = kind == MAT_COATED_DIFFUSE
    albedo = t0[:, :3]
    eta = jnp.where(is_layered[:, None], t1[:, :3], t0[:, :3])
    kappa = t1[:, :3]

    alpha = t2[:, :2]
    alpha = jnp.where(remap[:, None], jnp.sqrt(jnp.maximum(alpha, 0.0)), alpha)
    # materials with an unset roughness slot are perfectly smooth
    alpha = jnp.where(has_rough_tex[:, None], alpha, 0.0)
    alpha_x, alpha_y = alpha[:, 0], alpha[:, 1]
    too_smooth = jnp.maximum(alpha_x, alpha_y) < MINIMUM_ROUGHNESS

    effective = kind
    effective = jnp.where(
        (kind == MAT_ROUGH_CONDUCTOR) & too_smooth, MAT_SMOOTH_CONDUCTOR, effective
    )
    effective = jnp.where(
        (kind == MAT_ROUGH_DIELECTRIC) & too_smooth, MAT_SMOOTH_DIELECTRIC, effective
    )
    top_kind = jnp.where(
        too_smooth, MAT_SMOOTH_DIELECTRIC, MAT_ROUGH_DIELECTRIC
    ).astype(jnp.int32)

    if MAT_COATED_DIFFUSE in ds.meta.mat_kinds_present:
        thickness = eval_texture_from_row(
            ds, slot(3), ctx, has_derivs, sk[3])[:, 0]
        coat_albedo = eval_texture_from_row(
            ds, slot(4), ctx, has_derivs, sk[4])[:, :3]
    else:
        thickness = jnp.zeros_like(alpha_x)
        coat_albedo = jnp.zeros_like(albedo)

    # clamp alphas so rough-path math stays finite on lanes that use the
    # smooth fallback (their results are masked out anyway)
    safe_ax = jnp.maximum(alpha_x, MINIMUM_ROUGHNESS)
    safe_ay = jnp.maximum(alpha_y, MINIMUM_ROUGHNESS)

    return BsdfParams(
        kind=effective.astype(jnp.int32),
        albedo=albedo,
        eta=eta,
        kappa=kappa,
        alpha_x=safe_ax,
        alpha_y=safe_ay,
        top_kind=top_kind,
        thickness=thickness,
        coat_albedo=coat_albedo,
    )


def is_delta_bsdf(params: BsdfParams):
    return (params.kind == MAT_SMOOTH_DIELECTRIC) | (
        params.kind == MAT_SMOOTH_CONDUCTOR
    )


def bsdf_components(params: BsdfParams):
    """Component flags supported per lane (materials.rs components())."""
    k = params.kind
    out = jnp.zeros_like(k)
    out = jnp.where(k == MAT_DIFFUSE, NONSPECULAR_REFLECTION, out)
    out = jnp.where(
        k == MAT_SMOOTH_DIELECTRIC, SPECULAR_REFLECTION | SPECULAR_TRANSMISSION, out
    )
    out = jnp.where(k == MAT_SMOOTH_CONDUCTOR, SPECULAR_REFLECTION, out)
    out = jnp.where(k == MAT_ROUGH_CONDUCTOR, NONSPECULAR_REFLECTION, out)
    out = jnp.where(
        k == MAT_ROUGH_DIELECTRIC,
        NONSPECULAR_REFLECTION | NONSPECULAR_TRANSMISSION,
        out,
    )
    out = jnp.where(k == MAT_COATED_DIFFUSE, NONSPECULAR, out)
    return out


# ------------------------------------------------------------ scalar pieces

def reflect_z(wo, n):
    return 2.0 * dot(wo, n)[..., None] * n - wo


def fresnel_dielectric(cos_theta_i, eta):
    """(materials.rs:1018-1042). Backside flips eta; TIR -> 1."""
    flip = cos_theta_i < 0.0
    eta = jnp.where(flip, 1.0 / eta, eta)
    cos_theta_i = jnp.abs(cos_theta_i)
    sin2_i = 1.0 - cos_theta_i * cos_theta_i
    sin2_t = sin2_i / (eta * eta)
    tir = sin2_t >= 1.0
    cos_theta_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    r_parl = (eta * cos_theta_i - cos_theta_t) / (eta * cos_theta_i + cos_theta_t)
    r_perp = (cos_theta_i - eta * cos_theta_t) / (cos_theta_i + eta * cos_theta_t)
    r = (r_parl * r_parl + r_perp * r_perp) * 0.5
    return jnp.where(tir, 1.0, r)


def fresnel_complex_rgb(cos_theta, eta3, kappa3):
    return jnp.stack(
        [
            fresnel_complex(cos_theta, eta3[..., i], kappa3[..., i])
            for i in range(3)
        ],
        axis=-1,
    )


def refract(eta, wo, normal):
    """(materials.rs:992-1009). Returns (wi, tir_mask)."""
    cos_i = dot(wo, normal)
    flip = cos_i < 0.0
    eta = jnp.where(flip, 1.0 / eta, eta)
    cos_i = jnp.abs(cos_i)
    normal = jnp.where(flip[..., None], -normal, normal)
    sin2_i = 1.0 - cos_i * cos_i
    sin2_t = sin2_i / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    wi = -wo / eta[..., None] + (cos_i / eta - cos_t)[..., None] * normal
    return wi, tir


# ------------------------------------------------------------ microfacet

def tr_distribution(wm, ax, ay):
    """Anisotropic Trowbridge-Reitz D in its compact form
    D = 1 / (pi ax ay ((x/ax)^2 + (y/ay)^2 + z^2)^2)  (PBRT 4ed 9.16).

    Note: the reference's distribution() (materials.rs:1080-1092) uses the
    unnormalized wm.x/wm.y as cos_phi/sin_phi, scaling its D by sin^2(theta)
    relative to PBRT; we use the correct form (self-consistent with the VNDF
    sampler below, and we bless snapshots against our own output).
    """
    q = (wm[..., 0] / ax) ** 2 + (wm[..., 1] / ay) ** 2 + wm[..., 2] ** 2
    safe_q = jnp.where(q == 0.0, 1.0, q)
    d = 1.0 / (jnp.pi * ax * ay * safe_q * safe_q)
    return jnp.where(q == 0.0, 0.0, d)


def tr_lambda(w, ax, ay):
    """Smith Lambda: ( sqrt(1 + ((ax x)^2 + (ay y)^2) / z^2) - 1 ) / 2."""
    z2 = w[..., 2] ** 2
    a2 = (ax * w[..., 0]) ** 2 + (ay * w[..., 1]) ** 2
    safe_z2 = jnp.where(z2 == 0.0, 1.0, z2)
    lam = (jnp.sqrt(1.0 + a2 / safe_z2) - 1.0) * 0.5
    return jnp.where(z2 == 0.0, 1e8, lam)


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_visible_distribution(w, wm, ax, ay):
    cos_theta = jnp.abs(w[..., 2])
    safe = jnp.where(cos_theta == 0.0, 1.0, cos_theta)
    return (
        (tr_g1(w, ax, ay) / safe)
        * tr_distribution(wm, ax, ay)
        * jnp.abs(dot(w, wm))
    )


def tr_sample_wm(w, ax, ay, u):
    """VNDF sampling (materials.rs:1125-1165 / PBRT 4ed 9.6.4)."""
    wh = normalize(
        jnp.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], axis=-1)
    )
    wh = jnp.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    p = sample_unit_disk(u)
    z_axis = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], w.dtype), w.shape)
    x_axis = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], w.dtype), w.shape)
    t1 = jnp.where(
        (wh[..., 2] < 0.9999)[..., None], jnp.cross(z_axis, wh), x_axis
    )
    t2 = jnp.cross(wh, t1)
    h = jnp.sqrt(jnp.maximum(1.0 - p[..., 0] ** 2, 0.0))
    offset = 0.5 * h * (1.0 - wh[..., 2])
    scale = 0.5 * (1.0 + wh[..., 2])
    py = offset + scale * p[..., 1]
    px = p[..., 0]
    pz = jnp.sqrt(jnp.maximum(1.0 - px * px - py * py, 0.0))
    nh = px[..., None] * t1 + py[..., None] * t2 + pz[..., None] * wh
    wm = jnp.stack(
        [
            ax * nh[..., 0],
            ay * nh[..., 1],
            jnp.maximum(nh[..., 2], 1.0e-6),
        ],
        axis=-1,
    )
    return normalize(wm)


# ---------------------------------------------------------------- diffuse

def diffuse_eval(albedo, wo, wi):
    same_side = wo[..., 2] * wi[..., 2] >= 0.0
    return jnp.where(same_side[..., None], albedo / jnp.pi, 0.0)


def diffuse_pdf(wo, wi, allowed):
    ok = (allowed & NONSPECULAR_REFLECTION) != 0
    same_side = wo[..., 2] * wi[..., 2] > 0.0
    return jnp.where(ok & same_side, 1.0 / (2.0 * jnp.pi), 0.0)


def diffuse_sample(albedo, wo, u2) -> BsdfSample:
    from .rng import sample_cosine_hemisphere

    wi = sample_cosine_hemisphere(u2)
    pdf = wi[..., 2] / jnp.pi
    return BsdfSample(
        wi=wi,
        f=albedo / jnp.pi,
        pdf=pdf,
        component=jnp.full(wo.shape[:-1], NONSPECULAR_REFLECTION, jnp.int32),
        valid=pdf > 0.0,
    )


# ------------------------------------------------------------ smooth kinds

def smooth_dielectric_sample(eta, wo, u1, allowed) -> BsdfSample:
    """(materials.rs:398-486)."""
    R = fresnel_dielectric(wo[..., 2], eta)
    T = 1.0 - R
    p_reflect = jnp.where((allowed & SPECULAR_REFLECTION) != 0, R, 0.0)
    p_transmit = jnp.where((allowed & SPECULAR_TRANSMISSION) != 0, T, 0.0)
    p_total = p_reflect + p_transmit
    safe_total = jnp.where(p_total == 0.0, 1.0, p_total)
    choose_reflect = u1 * safe_total < p_reflect

    # reflection branch
    wi_r = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    cos_r = jnp.abs(wi_r[..., 2])
    safe_cos_r = jnp.where(cos_r == 0.0, 1.0, cos_r)
    f_r = R / safe_cos_r
    pdf_r = R / safe_total

    # transmission branch
    normal = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], wo.dtype), wo.shape)
    wi_t, tir = refract(eta, wo, normal)
    eta_corr = jnp.where(wo[..., 2] < 0.0, 1.0 / eta, eta)
    cos_t = jnp.abs(wi_t[..., 2])
    safe_cos_t = jnp.where(cos_t == 0.0, 1.0, cos_t)
    f_t = (T / safe_cos_t) / (eta_corr * eta_corr)
    pdf_t = T / safe_total

    wi = jnp.where(choose_reflect[..., None], wi_r, wi_t)
    f = jnp.where(choose_reflect, f_r, f_t)
    pdf = jnp.where(choose_reflect, pdf_r, pdf_t)
    component = jnp.where(
        choose_reflect, SPECULAR_REFLECTION, SPECULAR_TRANSMISSION
    ).astype(jnp.int32)
    valid = (p_total > 0.0) & (pdf > 0.0) & ~(~choose_reflect & tir)
    return BsdfSample(
        wi=wi, f=jnp.repeat(f[..., None], 3, axis=-1), pdf=pdf,
        component=component, valid=valid,
    )


def smooth_conductor_sample(eta3, kappa3, wo) -> BsdfSample:
    wi = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    cos = wo[..., 2]
    safe_cos = jnp.where(cos == 0.0, 1.0, cos)
    f = fresnel_complex_rgb(cos, eta3, kappa3) / safe_cos[..., None]
    pdf = jnp.ones_like(cos)
    # cos <= 0 means the lane hit the conductor from INSIDE (a grazing
    # self-reintersection artifact on spheres); the reference's F/wo.z
    # would emit a huge NEGATIVE weight there (materials.rs:486-489 has
    # no sign guard), which explodes on any backend where ULP-level
    # geometry flips whole grazing bands. Killing the path is the
    # physical behavior; divergence recorded in PARITY.md.
    return BsdfSample(
        wi=wi, f=f, pdf=pdf,
        component=jnp.full(cos.shape, SPECULAR_REFLECTION, jnp.int32),
        valid=cos > 0.0,
    )


# --------------------------------------------------- rough conductor (BRDF)

def ts_refl_pdf(wo, wi, ax, ay):
    h = wo + wi
    degenerate = jnp.all(h == 0.0, axis=-1)
    wm = normalize(jnp.where(degenerate[..., None], 1.0, h))
    wm = jnp.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    safe_dot = jnp.maximum(jnp.abs(dot(wo, wm)), 1e-20)
    pdf = tr_visible_distribution(wo, wm, ax, ay) / (4.0 * safe_dot)
    return jnp.where(degenerate, 0.0, pdf)


def ts_refl_eval(wo, wi, eta3, kappa3, ax, ay):
    h = wo + wi
    degenerate = jnp.all(h == 0.0, axis=-1)
    wm = normalize(jnp.where(degenerate[..., None], 1.0, h))
    cos_theta = jnp.abs(dot(wm, wi))
    fres = fresnel_complex_rgb(cos_theta, eta3, kappa3)
    denom = 4.0 * wo[..., 2] * wi[..., 2]
    safe_denom = jnp.where(denom == 0.0, 1.0, denom)
    f = (
        (tr_distribution(wm, ax, ay) * tr_g(wo, wi, ax, ay) / safe_denom)[..., None]
        * fres
    )
    # opposite-hemisphere pairs (inside-hits) would yield a negative
    # denominator and negative reflectance — physically zero for a
    # reflection-only conductor (guard absent in materials.rs:1210-1213;
    # divergence recorded in PARITY.md)
    bad = degenerate | (denom <= 0.0)
    return jnp.where(bad[..., None], 0.0, f)


def ts_refl_sample(wo, eta3, kappa3, ax, ay, u2) -> BsdfSample:
    wm = tr_sample_wm(wo, ax, ay, u2)
    wi = reflect_z(wo, wm)
    below = wo[..., 2] * wi[..., 2] < 0.0
    pdf = ts_refl_pdf(wo, wi, ax, ay)
    f = ts_refl_eval(wo, wi, eta3, kappa3, ax, ay)
    return BsdfSample(
        wi=wi, f=f, pdf=pdf,
        component=jnp.full(pdf.shape, NONSPECULAR_REFLECTION, jnp.int32),
        valid=~below & (pdf > 0.0),
    )


# -------------------------------------------------- rough dielectric (BSDF)

def _ts_halfvector(wo, wi, eta):
    reflect_case = wo[..., 2] * wi[..., 2] > 0.0
    eta_wm = jnp.where(
        reflect_case, 1.0, jnp.where(wo[..., 2] > 0.0, eta, 1.0 / eta)
    )
    h = wi * eta_wm[..., None] + wo
    degenerate = jnp.all(h == 0.0, axis=-1)
    wm = normalize(jnp.where(degenerate[..., None], 1.0, h))
    wm = jnp.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    grazing = (wi[..., 2] == 0.0) | (wo[..., 2] == 0.0) | degenerate
    backfacing = (dot(wm, wi) * wi[..., 2] < 0.0) | (
        dot(wm, wo) * wo[..., 2] < 0.0
    )
    return reflect_case, eta_wm, wm, grazing | backfacing


def ts_pdf(wo, wi, eta, ax, ay, allowed):
    reflect_case, eta_wm, wm, invalid = _ts_halfvector(wo, wi, eta)
    R = fresnel_dielectric(dot(wo, wm), eta)
    T = 1.0 - R
    p_reflect = jnp.where((allowed & NONSPECULAR_REFLECTION) != 0, R, 0.0)
    p_transmit = jnp.where((allowed & NONSPECULAR_TRANSMISSION) != 0, T, 0.0)
    p_total = p_reflect + p_transmit
    safe_total = jnp.where(p_total == 0.0, 1.0, p_total)
    vd = tr_visible_distribution(wo, wm, ax, ay)
    safe_dot = jnp.maximum(jnp.abs(dot(wo, wm)), 1e-20)
    pdf_r = (p_reflect / safe_total) * vd / (4.0 * safe_dot)
    denom = (dot(wi, wm) + dot(wo, wm) / eta_wm) ** 2
    safe_denom = jnp.where(denom == 0.0, 1.0, denom)
    dwm_dwi = jnp.abs(dot(wi, wm)) / safe_denom
    pdf_t = (p_transmit / safe_total) * vd * dwm_dwi
    pdf = jnp.where(reflect_case, pdf_r, pdf_t)
    return jnp.where(invalid | (p_total == 0.0) | (denom == 0.0), 0.0, pdf)


def ts_eval(wo, wi, eta, ax, ay):
    reflect_case, eta_wm, wm, invalid = _ts_halfvector(wo, wi, eta)
    F = fresnel_dielectric(dot(wo, wm), eta)
    d = tr_distribution(wm, ax, ay)
    g = tr_g(wo, wi, ax, ay)
    denom_r = jnp.abs(4.0 * wo[..., 2] * wi[..., 2])
    safe_r = jnp.where(denom_r == 0.0, 1.0, denom_r)
    brdf = d * F * g / safe_r
    denom_t = (
        wi[..., 2] * wo[..., 2] * (dot(wi, wm) + dot(wo, wm) / eta_wm) ** 2
    )
    safe_t = jnp.where(denom_t == 0.0, 1.0, denom_t)
    btdf = (
        d * (1.0 - F) * g
        * jnp.abs(dot(wi, wm) * dot(wo, wm) / safe_t)
        / (eta_wm * eta_wm)
    )
    f = jnp.where(reflect_case, brdf, btdf)
    f = jnp.where(invalid | (denom_r == 0.0) & reflect_case, 0.0, f)
    return jnp.repeat(f[..., None], 3, axis=-1)


def ts_sample(wo, eta, ax, ay, allowed, u2, u1) -> BsdfSample:
    """(materials.rs:1388-1473)."""
    wm = tr_sample_wm(wo, ax, ay, u2)
    R = fresnel_dielectric(dot(wo, wm), eta)
    T = 1.0 - R
    p_reflect = jnp.where((allowed & REFLECTION) != 0, R, 0.0)
    p_transmit = jnp.where((allowed & TRANSMISSION) != 0, T, 0.0)
    p_total = p_reflect + p_transmit
    safe_total = jnp.where(p_total == 0.0, 1.0, p_total)
    choose_reflect = u1 * safe_total < p_reflect

    wi_r = reflect_z(wo, wm)
    null_r = wo[..., 2] * wi_r[..., 2] < 0.0
    wi_t, tir = refract(eta, wo, wm)
    null_t = (wo[..., 2] * wi_t[..., 2] > 0.0) | (wi_t[..., 2] == 0.0) | tir

    wi = jnp.where(choose_reflect[..., None], wi_r, wi_t)
    null = jnp.where(choose_reflect, null_r, null_t) | (p_total == 0.0)
    pdf = ts_pdf(wo, wi, eta, ax, ay, allowed)
    f = ts_eval(wo, wi, eta, ax, ay)
    component = jnp.where(
        choose_reflect, NONSPECULAR_REFLECTION, NONSPECULAR_TRANSMISSION
    ).astype(jnp.int32)
    return BsdfSample(
        wi=wi, f=f, pdf=pdf, component=component,
        valid=~null & (pdf > 0.0),
    )
