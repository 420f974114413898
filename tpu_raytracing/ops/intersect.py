"""Batched ray-primitive intersection (device).

Vectorized counterparts of raytracing-cpu/src/geometry.rs: slab AABB test
(:51-78), Moller-Trumbore triangles (:301-340), stable-quadratic spheres with
spherical uv/dpdu/dpdv (:139-227). All functions broadcast over leading batch
dimensions; misses are reported with t = +inf masks rather than Options.
"""
from __future__ import annotations

import jax.numpy as jnp

from .linalg import cross, dot

INF = jnp.inf


def ray_aabb(origin, inv_dir, bb_min, bb_max):
    """Slab test. Returns (t0, t1); hit iff t0 <= t1 (range may be negative)."""
    a = (bb_min - origin) * inv_dir
    b = (bb_max - origin) * inv_dir
    t0 = jnp.max(jnp.minimum(a, b), axis=-1)
    t1 = jnp.min(jnp.maximum(a, b), axis=-1)
    return t0, t1


# seam-inclusive barycentric bound: adjacent triangles' Moller-Trumbore
# tests use different edge vectors, so a ray crossing their SHARED edge can
# be rejected by both under FP rounding ("falls through the seam") — which
# side of zero u/v lands on is backend-dependent (FMA contraction can send
# whole reflected beams through the cornell ceiling's diagonal seam).
# Expanding the bounds by 1e-5 makes seam hits double-claimed instead of
# dropped; for closed meshes the equal-t tie is resolved like any other
# coincident hit, and open-boundary overreach is a 1e-5-barycentric sliver.
BARY_EPS = 1e-5


def ray_triangle(origin, direction, p0, p1, p2, t_min, t_max):
    """Moller-Trumbore. Returns (valid, t, u, v); invalid lanes have t=inf."""
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = cross(direction, e2)
    denom = dot(pvec, e1)
    safe_denom = jnp.where(denom == 0.0, 1.0, denom)
    tvec = origin - p0
    u = dot(pvec, tvec) / safe_denom
    qvec = cross(tvec, e1)
    v = dot(qvec, direction) / safe_denom
    t = dot(qvec, e2) / safe_denom
    valid = (
        (denom != 0.0)
        & (u >= -BARY_EPS) & (u <= 1.0 + BARY_EPS)
        & (v >= -BARY_EPS) & (u + v <= 1.0 + BARY_EPS)
        & (t >= t_min) & (t <= t_max)
    )
    return valid, jnp.where(valid, t, INF), u, v


def ray_sphere(origin, direction, center, radius, t_min, t_max):
    """Stable-quadratic sphere intersection. Returns (valid, t)."""
    omc = origin - center
    a = dot(direction, direction)
    b = 2.0 * dot(direction, omc)
    c = dot(omc, omc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.where(b >= 0.0, sq, -sq))
    safe_a = jnp.where(a == 0.0, 1.0, a)
    safe_q = jnp.where(q == 0.0, 1.0, q)
    ta = q / safe_a
    tb = c / safe_q
    t1 = jnp.minimum(ta, tb)
    t2 = jnp.maximum(ta, tb)
    t1_ok = (t1 >= t_min) & (t1 <= t_max)
    t2_ok = (t2 >= t_min) & (t2 <= t_max)
    t = jnp.where(t1_ok, t1, t2)
    valid = (disc >= 0.0) & (a != 0.0) & (t1_ok | t2_ok)
    return valid, jnp.where(valid, t, INF)


def sphere_hit_geom(point, center, radius):
    """Spherical uv + dpdu/dpdv at an object-space hit point
    (geometry.rs:180-224 conventions: u = phi/2pi, v = theta/pi, z-up)."""
    local = point - center
    cos_theta = jnp.clip(local[..., 2] / radius, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    sin_theta = jnp.sin(theta)
    safe_rst = jnp.where(sin_theta == 0.0, 1.0, radius * sin_theta)
    cos_phi = jnp.clip(local[..., 0] / safe_rst, -1.0, 1.0)
    sin_phi = local[..., 1] / safe_rst
    acos_cp = jnp.arccos(cos_phi)
    phi = jnp.where(local[..., 1] > 0.0, acos_cp, 2.0 * jnp.pi - acos_cp)
    u = phi / (2.0 * jnp.pi)
    v = theta / jnp.pi
    dpdu = jnp.stack(
        [
            -2.0 * jnp.pi * local[..., 1],
            2.0 * jnp.pi * local[..., 0],
            jnp.zeros_like(local[..., 0]),
        ],
        axis=-1,
    )
    dpdv = jnp.pi * jnp.stack(
        [
            local[..., 2] * cos_phi,
            local[..., 2] * sin_phi,
            -radius * sin_theta,
        ],
        axis=-1,
    )
    normal = local / jnp.asarray(radius)[..., None]
    return jnp.stack([u, v], axis=-1), normal, dpdu, dpdv
