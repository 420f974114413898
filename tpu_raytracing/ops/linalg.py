"""Batched vector helpers for SoA device math (last axis = xyz)."""
from __future__ import annotations

import jax.numpy as jnp


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def norm(a):
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a, eps: float = 0.0):
    n = norm(a)
    safe = jnp.where(n > eps, n, 1.0)
    return a / safe[..., None]


# The 4x4 applies below are spelled as explicit f32 mul/adds, NOT
# einsum/matmul: a float32 dot_general may run at reduced precision
# (TF32 on a GPU keeps ~3 decimal digits), enough to move a reflected
# ray's origin ~1e-3 INSIDE an analytic sphere and flip whole grazing
# bands to self-reintersections. Length-3 contractions are elementwise
# math anyway; never reintroduce dot_general here without
# precision=HIGHEST (tests/test_backend.py checks the beauty jaxpr).

def _mat3_apply(m, v, transposed: bool = False):
    ix = (lambda i, j: (j, i)) if transposed else (lambda i, j: (i, j))
    return jnp.stack(
        [
            m[(..., *ix(i, 0))] * v[..., 0]
            + m[(..., *ix(i, 1))] * v[..., 1]
            + m[(..., *ix(i, 2))] * v[..., 2]
            for i in range(3)
        ],
        axis=-1,
    )


def apply_point(m, p):
    """Apply 4x4 (row-major, column-vector) to points; m: (..., 4, 4), p: (..., 3)."""
    r = _mat3_apply(m, p) + m[..., :3, 3]
    w = (
        m[..., 3, 0] * p[..., 0]
        + m[..., 3, 1] * p[..., 1]
        + m[..., 3, 2] * p[..., 2]
        + m[..., 3, 3]
    )
    return r / w[..., None]


def apply_vector(m, v):
    return _mat3_apply(m, v)


def apply_vector_transposed(m, v):
    """M^T v on the 3x3 block (inverse-transpose normal transform)."""
    return _mat3_apply(m, v, transposed=True)


def make_orthonormal_basis(z):
    """Batched ONB: from unit z produce (x, y) (geometry.rs:8-20 semantics)."""
    a = jnp.where(
        (jnp.abs(z[..., 2]) < 0.8)[..., None],
        jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], z.dtype), z.shape),
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], z.dtype), z.shape),
    )
    x = normalize(jnp.cross(a, z))
    y = jnp.cross(z, x)
    return x, y
