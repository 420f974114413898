"""Stochastic layered BSDF (CoatedDiffuse) — batched, masked, fixed-trip.

Batched restructuring of the reference's LayeredBsdf
(raytracing-cpu/src/materials.rs:171-335 eval, :540-666 sample; PBRT 4ed 14.3):
a dielectric coat (smooth or rough per lane) over a diffuse base with an
optional homogeneous scattering medium between (HG phase, g = 0). The
reference's data-dependent random walk becomes MAX_DEPTH masked iterations of
a lax.fori_loop; per-lane "break"/"continue" are alive/branch masks.

Randomness: evaluation uses a one-off stream derived from hashing the (wo, wi)
bit patterns — the same trick the reference uses for deterministic eval
(materials.rs:207-212) — so eval is a pure function. Sampling draws from hash
of the caller-provided per-lane stream state.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..device.scene_buffers import MAT_SMOOTH_DIELECTRIC
from . import bsdf as B
from .linalg import dot, make_orthonormal_basis
from .rng import hash_u32, power_heuristic, sample_exponential, uniform_from_bits

N_SAMPLES = 8
MAX_DEPTH = 8
G_HG = 0.0  # reference hardcodes g = 0 (materials.rs:943)
U32 = jnp.uint32


# ------------------------------------------------------- phase function (HG)

def hg_p(wo, wi, g):
    cos_theta = dot(wo, wi)
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (0.25 / jnp.pi) * (1.0 - g * g) / (denom * jnp.sqrt(denom))


def hg_sample(wo, g, u):
    small_g = abs(g) < 1.0e-3
    if small_g:
        cos_theta = 1.0 - 2.0 * u[..., 0]
    else:
        term = (1.0 - g * g) / (1.0 + g - 2.0 * g * u[..., 0])
        cos_theta = -1.0 / (2.0 * g) * (1.0 + g * g - term * term)
    phi = 2.0 * jnp.pi * u[..., 1]
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    local = jnp.stack(
        [jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta], axis=-1
    )
    x, y = make_orthonormal_basis(wo)
    wi = local[..., 0:1] * x + local[..., 1:2] * y + local[..., 2:3] * wo
    p = hg_p_cos(cos_theta, g)
    return wi, p, p  # (wi, p, pdf): exact importance sampling


def hg_p_cos(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (0.25 / jnp.pi) * (1.0 - g * g) / (denom * jnp.sqrt(denom))


def _tr_layer(dz, w):
    """Beer-Lambert transmittance through slab of optical depth |dz/w.z|."""
    wz = jnp.where(w[..., 2] == 0.0, 1.0, w[..., 2])
    return jnp.exp(-jnp.abs(dz / wz))


# ---------------------------------------------------- interface dispatchers

def _top_sample(params: B.BsdfParams, w, allowed, u2, u1) -> B.BsdfSample:
    """Dielectric coat sample; per-lane smooth/rough select."""
    eta = params.eta[..., 0]
    smooth = params.top_kind == MAT_SMOOTH_DIELECTRIC
    # smooth path interprets NONSPECULAR flags as their specular twins
    allowed_s = jnp.where((allowed & B.REFLECTION) != 0, B.SPECULAR_REFLECTION, 0) | jnp.where(
        (allowed & B.TRANSMISSION) != 0, B.SPECULAR_TRANSMISSION, 0
    )
    s_smooth = B.smooth_dielectric_sample(eta, w, u1, allowed_s)
    s_rough = B.ts_sample(w, eta, params.alpha_x, params.alpha_y, allowed, u2, u1)
    sel = smooth[..., None]
    return B.BsdfSample(
        wi=jnp.where(sel, s_smooth.wi, s_rough.wi),
        f=jnp.where(sel, s_smooth.f, s_rough.f),
        pdf=jnp.where(smooth, s_smooth.pdf, s_rough.pdf),
        component=jnp.where(smooth, s_smooth.component, s_rough.component),
        valid=jnp.where(smooth, s_smooth.valid, s_rough.valid),
    )


def _top_eval(params: B.BsdfParams, wo, wi):
    eta = params.eta[..., 0]
    smooth = params.top_kind == MAT_SMOOTH_DIELECTRIC
    f = B.ts_eval(wo, wi, eta, params.alpha_x, params.alpha_y)
    return jnp.where(smooth[..., None], 0.0, f)


def _top_pdf(params: B.BsdfParams, wo, wi, allowed):
    eta = params.eta[..., 0]
    smooth = params.top_kind == MAT_SMOOTH_DIELECTRIC
    pdf = B.ts_pdf(wo, wi, eta, params.alpha_x, params.alpha_y, allowed)
    return jnp.where(smooth, 0.0, pdf)


def _top_is_delta(params: B.BsdfParams):
    return params.top_kind == MAT_SMOOTH_DIELECTRIC


# --------------------------------------------------------------- evaluation

def _eval_base_stream(wo, wi):
    """Per-lane one-off stream seed from the (wo, wi) bit patterns."""
    h = hash_u32(
        *(jax.lax.bitcast_convert_type(wo[..., i], U32) for i in range(3)),
        *(jax.lax.bitcast_convert_type(wi[..., i], U32) for i in range(3)),
    )
    return h


def layered_eval(params: B.BsdfParams, wo, wi):
    """Stochastic estimate of the layered BSDF value (materials.rs:170-335)."""
    flip = wo[..., 2] < 0.0
    wo = jnp.where(flip[..., None], -wo, wo)
    wi = jnp.where(flip[..., None], -wi, wi)
    # bottom (diffuse) is opaque: transmission through the stack is zero, so
    # the only reachable configuration after the two-sided flip is wi.z > 0
    # with exit interface = top, exit_z = thickness.
    reachable = wi[..., 2] > 0.0

    thickness = params.thickness
    albedo = params.coat_albedo
    g = G_HG
    has_medium = jnp.any(albedo != 0.0, axis=-1)

    f = N_SAMPLES * _top_eval(params, wo, wi)

    base = _eval_base_stream(wo, wi)

    def u1(s, d):
        return uniform_from_bits(hash_u32(base, s, d))

    def u2(s, d):
        return jnp.stack([u1(s, d), u1(s, d + U32(1))], axis=-1)

    def per_sample(s, f):
        enter = _top_sample(
            params, wo, B.TRANSMISSION, u2(s, U32(0)), u1(s, U32(2))
        )
        exit_s = _top_sample(
            params, wi, B.TRANSMISSION, u2(s, U32(3)), u1(s, U32(5))
        )
        ok = enter.valid & exit_s.valid
        safe_exit_pdf = jnp.where(exit_s.pdf <= 0.0, 1.0, exit_s.pdf)
        beta = exit_s.f * jnp.abs(exit_s.wi[..., 2:3]) / safe_exit_pdf[..., None]
        exit_delta = _top_is_delta(params)

        def depth_body(depth, carry):
            w, z, beta, alive, f = carry
            d0 = U32(8) + depth.astype(U32) * U32(8)

            # russian roulette (after depth 3)
            beta_max = jnp.max(beta, axis=-1)
            rr_on = (depth > 3) & (beta_max < 0.25) & alive
            q = jnp.maximum(0.0, beta_max)
            kill = rr_on & (u1(s, d0) < q)
            alive = alive & ~kill
            beta = jnp.where(
                (rr_on & ~kill)[..., None], beta / (1.0 - q)[..., None], beta
            )

            # medium transit
            wz = jnp.where(w[..., 2] == 0.0, 1.0, jnp.abs(w[..., 2]))
            dz = sample_exponential(
                jnp.minimum(u1(s, d0 + U32(1)), 0.9999995), 1.0 / wz
            )
            zp = jnp.where(w[..., 2] > 0.0, z + dz, z - dz)
            scatter = has_medium & (zp > 0.0) & (zp < thickness) & alive

            # -- scattering event between interfaces (NEE toward exit + phase)
            wt = jnp.where(
                exit_delta,
                1.0,
                power_heuristic(
                    1.0, exit_s.pdf, 1.0, hg_p(-w, -exit_s.wi, g)
                ),
            )
            contrib1 = (
                beta * albedo
                * hg_p(-w, -exit_s.wi, g)[..., None]
                * wt[..., None]
                * _tr_layer(zp - thickness, exit_s.wi)[..., None]
                * exit_s.f
                / safe_exit_pdf[..., None]
            )
            f = f + jnp.where(scatter[..., None], contrib1, 0.0)

            ph_wi, ph_p, ph_pdf = hg_sample(-w, g, u2(s, d0 + U32(2)))
            safe_ph_pdf = jnp.where(ph_pdf == 0.0, 1.0, ph_pdf)
            beta_sc = beta * albedo * (ph_p / safe_ph_pdf)[..., None]
            # after scattering, if the new direction faces the exit (top),
            # add its contribution through the exit interface
            facing_exit = (zp < thickness) & (ph_wi[..., 2] > 0.0)
            exit_f = _top_eval(params, -ph_wi, wi)
            exit_pdf = _top_pdf(params, -ph_wi, wi, B.TRANSMISSION)
            wt2 = power_heuristic(1.0, ph_pdf, 1.0, exit_pdf)
            contrib2 = (
                beta_sc
                * _tr_layer(zp - thickness, ph_wi)[..., None]
                * exit_f
                * wt2[..., None]
            )
            add2 = scatter & ~exit_delta & facing_exit & (
                jnp.any(exit_f != 0.0, axis=-1)
            )
            f = f + jnp.where(add2[..., None], contrib2, 0.0)

            # -- no-scatter transit: advance to an interface
            z_nomedium = jnp.where(z == thickness, 0.0, thickness)
            beta_nomedium = beta * _tr_layer(thickness, w)[..., None]
            z_medium = jnp.clip(zp, 0.0, thickness)

            new_z_transit = jnp.where(has_medium, z_medium, z_nomedium)
            new_beta_transit = jnp.where(
                has_medium[..., None], beta, beta_nomedium
            )

            at_interface = alive & ~scatter
            at_top = at_interface & (new_z_transit == thickness)
            at_bottom = at_interface & ~at_top

            # top interface: reflect back down
            top_s = _top_sample(
                params, -w, B.REFLECTION, u2(s, d0 + U32(4)), u1(s, d0 + U32(6))
            )
            safe_top_pdf = jnp.where(top_s.pdf <= 0.0, 1.0, top_s.pdf)
            beta_top = (
                new_beta_transit
                * top_s.f
                * jnp.abs(top_s.wi[..., 2:3])
                / safe_top_pdf[..., None]
            )
            top_dead = at_top & ~top_s.valid

            # bottom interface (diffuse): NEE toward the exit direction via
            # exit_s, then cosine-sample a new upward direction
            bot_f1 = B.diffuse_eval(params.albedo, -w, -exit_s.wi)
            bot_pdf1 = B.diffuse_pdf(-w, -exit_s.wi, B.NONSPECULAR_REFLECTION)
            wt3 = power_heuristic(1.0, exit_s.pdf, 1.0, bot_pdf1)
            contrib3 = (
                new_beta_transit
                * bot_f1
                * jnp.abs(exit_s.wi[..., 2:3])
                * wt3[..., None]
                * _tr_layer(thickness, exit_s.wi)[..., None]
                * exit_s.f
                / safe_exit_pdf[..., None]
            )
            f = f + jnp.where(at_bottom[..., None], contrib3, 0.0)

            bot_s = B.diffuse_sample(params.albedo, -w, u2(s, d0 + U32(4)))
            # diffuse samples the upper hemisphere of -w; -w has w.z<0 at the
            # bottom so wi points up, back into the medium
            safe_bot_pdf = jnp.where(bot_s.pdf <= 0.0, 1.0, bot_s.pdf)
            beta_bot = (
                new_beta_transit
                * bot_s.f
                * jnp.abs(bot_s.wi[..., 2:3])
                / safe_bot_pdf[..., None]
            )
            bot_dead = at_bottom & ~bot_s.valid

            # second NEE term after bottom bounce
            exit_f2 = _top_eval(params, -bot_s.wi, wi)
            exit_pdf2 = _top_pdf(params, -bot_s.wi, wi, B.ALL_COMPONENTS)
            wt4 = power_heuristic(1.0, bot_s.pdf, 1.0, exit_pdf2)
            contrib4 = (
                beta_bot
                * _tr_layer(thickness, bot_s.wi)[..., None]
                * exit_f2
                * wt4[..., None]
            )
            add4 = at_bottom & ~bot_dead & ~exit_delta & jnp.any(
                exit_f2 != 0.0, axis=-1
            )
            f = f + jnp.where(add4[..., None], contrib4, 0.0)

            new_w = jnp.where(
                scatter[..., None],
                ph_wi,
                jnp.where(at_top[..., None], top_s.wi, bot_s.wi),
            )
            new_beta = jnp.where(
                scatter[..., None],
                beta_sc,
                jnp.where(at_top[..., None], beta_top, beta_bot),
            )
            new_z = jnp.where(scatter, zp, new_z_transit)
            alive = alive & ~(top_dead | bot_dead)
            w = jnp.where(alive[..., None], new_w, w)
            beta = jnp.where(alive[..., None], new_beta, beta)
            z = jnp.where(alive, new_z, z)
            return w, z, beta, alive, f

        w0 = enter.wi
        z0 = thickness
        alive0 = ok
        _, _, _, _, f = jax.lax.fori_loop(
            0, MAX_DEPTH, depth_body,
            (w0, z0, jnp.where(ok[..., None], beta, 0.0), alive0, f),
        )
        return f

    f = jax.lax.fori_loop(0, N_SAMPLES, lambda s, acc: per_sample(s, acc), f)
    f = f / N_SAMPLES
    return jnp.where(reachable[..., None], f, 0.0)


# ----------------------------------------------------------------- sampling

def layered_sample(params: B.BsdfParams, wo, draw_base) -> B.BsdfSample:
    """Sample the layered BSDF with a random walk (materials.rs:540-666).

    draw_base: per-lane uint32 stream seed (caller derives it from the pixel
    sample stream so results stay deterministic)."""
    flip = wo[..., 2] < 0.0
    wo_f = jnp.where(flip[..., None], -wo, wo)
    thickness = params.thickness
    albedo = params.coat_albedo
    g = G_HG
    has_medium = jnp.any(albedo != 0.0, axis=-1)

    def u1(d):
        return uniform_from_bits(hash_u32(draw_base, d))

    def u2(d):
        return jnp.stack([u1(d), u1(d + U32(1))], axis=-1)

    enter = _top_sample(params, wo_f, B.ALL_COMPONENTS, u2(U32(0)), u1(U32(2)))
    enter_reflect = (enter.component & B.REFLECTION) != 0

    # early-out result: reflection off the coat
    refl_sample = B.BsdfSample(
        wi=jnp.where(flip[..., None], -enter.wi, enter.wi),
        f=enter.f,
        pdf=enter.pdf,
        component=enter.component,
        valid=enter.valid,
    )

    # walk state
    w = enter.wi
    f = enter.f * jnp.abs(enter.wi[..., 2:3])
    pdf = enter.pdf
    z = jnp.broadcast_to(thickness, pdf.shape)
    specular_path = (enter.component & B.SPECULAR) != 0
    walking = enter.valid & ~enter_reflect

    done = jnp.zeros_like(walking)  # escaped with a transmission event
    out_wi = jnp.zeros_like(wo)
    out_f = jnp.zeros_like(f)
    out_pdf = jnp.zeros_like(pdf)
    out_comp = jnp.zeros(pdf.shape, jnp.int32)

    def body(depth, carry):
        (w, z, f, pdf, specular_path, walking, done,
         out_wi, out_f, out_pdf, out_comp) = carry
        d0 = U32(8) + depth.astype(U32) * U32(8)

        # russian roulette
        fmax = jnp.max(f, axis=-1)
        safe_pdf = jnp.where(pdf == 0.0, 1.0, pdf)
        rr_beta = fmax / safe_pdf
        rr_on = (depth > 3) & (rr_beta < 0.25) & walking
        q = jnp.maximum(0.0, 1.0 - rr_beta)
        kill = rr_on & (u1(d0) < q)
        walking = walking & ~kill & (w[..., 2] != 0.0)
        pdf = jnp.where(rr_on & ~kill, pdf * (1.0 - q), pdf)

        # medium event?
        wz = jnp.where(w[..., 2] == 0.0, 1.0, jnp.abs(w[..., 2]))
        dz = sample_exponential(jnp.minimum(u1(d0 + U32(1)), 0.9999995), 1.0 / wz)
        zp = jnp.where(w[..., 2] > 0.0, z + dz, z - dz)
        scatter = has_medium & (zp > 0.0) & (zp < thickness) & walking

        ph_wi, ph_p, ph_pdf = hg_sample(-w, g, u2(d0 + U32(2)))
        f_sc = f * albedo * ph_p[..., None]
        pdf_sc = pdf * ph_pdf

        z_transit = jnp.where(
            has_medium,
            jnp.clip(zp, 0.0, thickness),
            jnp.where(z == thickness, 0.0, thickness),
        )
        f_transit = jnp.where(
            has_medium[..., None], f, f * _tr_layer(thickness, w)[..., None]
        )

        at_interface = walking & ~scatter
        at_bottom = at_interface & (z_transit == 0.0)

        # interface sample (top dielectric or bottom diffuse)
        top_s = _top_sample(
            params, -w, B.ALL_COMPONENTS, u2(d0 + U32(4)), u1(d0 + U32(6))
        )
        bot_s = B.diffuse_sample(params.albedo, -w, u2(d0 + U32(4)))
        i_wi = jnp.where(at_bottom[..., None], bot_s.wi, top_s.wi)
        i_f = jnp.where(at_bottom[..., None], bot_s.f, top_s.f)
        i_pdf = jnp.where(at_bottom, bot_s.pdf, top_s.pdf)
        i_comp = jnp.where(at_bottom, bot_s.component, top_s.component)
        i_valid = jnp.where(at_bottom, bot_s.valid, top_s.valid)

        f_if = f_transit * i_f
        pdf_if = pdf * i_pdf
        spec_if = specular_path & ((i_comp & B.SPECULAR) != 0)
        transmitted = at_interface & i_valid & ((i_comp & B.TRANSMISSION) != 0)

        # record escapes
        same_dir = wo_f[..., 2] * i_wi[..., 2] > 0.0
        comp_escape = jnp.where(
            same_dir,
            jnp.where(spec_if, B.SPECULAR_REFLECTION, B.NONSPECULAR_REFLECTION),
            jnp.where(spec_if, B.SPECULAR_TRANSMISSION, B.NONSPECULAR_TRANSMISSION),
        ).astype(jnp.int32)
        escape = transmitted & ~done
        out_wi = jnp.where(
            escape[..., None], jnp.where(flip[..., None], -i_wi, i_wi), out_wi
        )
        out_f = jnp.where(escape[..., None], f_if, out_f)
        out_pdf = jnp.where(escape, pdf_if, out_pdf)
        out_comp = jnp.where(escape, comp_escape, out_comp)
        done = done | escape

        # update walk state
        interface_dead = at_interface & ~i_valid
        walking = walking & ~escape & ~interface_dead
        new_w = jnp.where(scatter[..., None], ph_wi, i_wi)
        new_f = jnp.where(
            scatter[..., None], f_sc, f_if * jnp.abs(i_wi[..., 2:3])
        )
        new_pdf = jnp.where(scatter, pdf_sc, pdf_if)
        new_spec = jnp.where(scatter, jnp.zeros_like(spec_if), spec_if)
        new_z = jnp.where(scatter, zp, z_transit)
        w = jnp.where(walking[..., None], new_w, w)
        f = jnp.where(walking[..., None], new_f, f)
        pdf = jnp.where(walking, new_pdf, pdf)
        specular_path = jnp.where(walking, new_spec, specular_path)
        z = jnp.where(walking, new_z, z)
        return (
            w, z, f, pdf, specular_path, walking, done,
            out_wi, out_f, out_pdf, out_comp,
        )

    carry = (
        w, z, f, pdf, specular_path, walking, done,
        out_wi, out_f, out_pdf, out_comp,
    )
    carry = jax.lax.fori_loop(0, MAX_DEPTH, body, carry)
    (_, _, _, _, _, _, done, out_wi, out_f, out_pdf, out_comp) = carry

    # combine: coat reflection takes priority; else walk escape; else null
    sel = enter_reflect[..., None]
    return B.BsdfSample(
        wi=jnp.where(sel, refl_sample.wi, out_wi),
        f=jnp.where(sel, refl_sample.f, out_f),
        pdf=jnp.where(enter_reflect, refl_sample.pdf, out_pdf),
        component=jnp.where(enter_reflect, refl_sample.component, out_comp),
        valid=jnp.where(enter_reflect, refl_sample.valid, done),
    )
