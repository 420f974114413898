"""Counter-based deterministic RNG + sampling distributions (device side).

Replacement for the reference's per-(pixel,sample) PCG32 streams
(raytracing-cpu/src/sample.rs:69-87): instead of seeding a stateful generator,
every draw is a pure hash of (seed, pixel, sample_index, dimension). This is
natively parallel, needs no state carried between kernels, and makes renders
bit-deterministic regardless of how pixels/samples are sharded across chips —
the property the reference's bit-exact snapshot harness relies on.

The stratified sampler mirrors the reference's correlated-multi-jitter
construction (sample.rs:89-181): stratum = kensler_permute(sample_index,
n_strata, hash(dim, seed)) — the same permutation across pixels, per-pixel
jitter — with the dimension-indexed permute from the Pixar CMJ paper.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..sampling import Independent, Sampler, Stratified

U32 = jnp.uint32
_INV_2_24 = np.float32(1.0 / (1 << 24))


def _fmix32(h):
    """murmur3 finalizer: full avalanche on 32 bits."""
    h = h ^ (h >> 16)
    h = h * U32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * U32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def hash_u32(*words):
    """Mix an arbitrary number of uint32 words (scalars or arrays) into one."""
    h = U32(0x811C9DC5)
    for w in words:
        w = jnp.asarray(w).astype(U32)
        h = (h ^ w) * U32(0x01000193)
        h = h ^ (h >> 15)
    return _fmix32(h)


def uniform_from_bits(bits):
    """uint32 -> f32 in [0, 1) using the top 24 bits."""
    return (bits >> 8).astype(jnp.float32) * _INV_2_24


class SamplerConfig(NamedTuple):
    """Static sampler configuration (hashable; part of the jit cache key)."""

    kind: str  # "independent" | "stratified"
    jitter: bool = True
    x_strata: int = 4
    y_strata: int = 4
    seed: int = 42

    @staticmethod
    def from_settings(sampler: Sampler, seed) -> "SamplerConfig":
        s = 42 if seed is None else int(seed) & 0xFFFFFFFF
        if isinstance(sampler, Stratified):
            return SamplerConfig(
                "stratified", sampler.jitter, sampler.x_strata,
                sampler.y_strata, s,
            )
        assert isinstance(sampler, Independent)
        return SamplerConfig("independent", seed=s)


class SampleStream(NamedTuple):
    """Per-ray sampling stream state: pixel coords + sample index + dim counter."""

    px: jax.Array       # (B,) u32 pixel x
    py: jax.Array       # (B,) u32 pixel y
    sample: jax.Array   # (B,) u32 sample index
    dim: jax.Array      # (B,) u32 next dimension


def make_stream(px, py, sample_index) -> SampleStream:
    px = jnp.asarray(px).astype(U32)
    return SampleStream(
        px=px,
        py=jnp.asarray(py).astype(U32),
        sample=jnp.broadcast_to(jnp.asarray(sample_index).astype(U32), px.shape),
        dim=jnp.zeros_like(px),
    )


def kensler_permute(index, length: int, seed):
    """Stateless permutation of [0, length) (Kensler, Pixar CMJ paper §6).

    Cycle-walks a keyed bijection on the next power of two until the value
    lands inside [0, length); vectorized via a masked while_loop.
    """
    length = int(length)
    if length <= 1:
        return jnp.zeros_like(jnp.asarray(index).astype(U32))
    mask = U32((1 << (length - 1).bit_length()) - 1)
    length_u = U32(length)
    seed = jnp.asarray(seed).astype(U32)
    index = jnp.asarray(index).astype(U32)

    def round_fn(i):
        i = i ^ seed
        i = i * U32(0xE170893D)
        i = i ^ (seed >> 16)
        i = i ^ ((i & mask) >> 4)
        i = i ^ (seed >> 8)
        i = i * U32(0x0929EB3F)
        i = i ^ (seed >> 23)
        i = i ^ ((i & mask) >> 1)
        i = i * (U32(1) | (seed >> 27))
        i = i * U32(0x6935FA69)
        i = i ^ ((i & mask) >> 11)
        i = i * U32(0x74DCB303)
        i = i ^ ((i & mask) >> 2)
        i = i * U32(0x9E501CC3)
        i = i ^ ((i & mask) >> 2)
        i = i * U32(0xC860A3DF)
        i = i & mask
        i = i ^ (i >> 5)
        return i

    def cond(state):
        i, _ = state
        return jnp.any(i >= length_u)

    def body(state):
        i, done = state
        nxt = round_fn(i)
        i = jnp.where(done, i, nxt)
        done = i < length_u
        return i, done

    first = round_fn(index)
    out, _ = jax.lax.while_loop(
        cond, body, (first, first < length_u)
    )
    return (out + seed) % length_u


def _draw_bits(cfg: SamplerConfig, stream: SampleStream, dim):
    return hash_u32(
        U32(cfg.seed), stream.px, stream.py, stream.sample, dim,
        U32(0x5F3759DF),
    )


@partial(jax.jit, static_argnums=0)
def sample_uniform(cfg: SamplerConfig, stream: SampleStream):
    """Draw one f32 in [0,1) per lane; returns (value, new stream)."""
    dim = stream.dim
    u = uniform_from_bits(_draw_bits(cfg, stream, dim))
    if cfg.kind == "stratified":
        total = cfg.x_strata * cfg.y_strata
        pseed = hash_u32(dim, U32(cfg.seed), U32(0xA5A5A5A5))
        strata = kensler_permute(stream.sample, total, pseed)
        delta = u if cfg.jitter else jnp.full_like(u, 0.5)
        u = (strata.astype(jnp.float32) + delta) / np.float32(total)
    return u, stream._replace(dim=dim + U32(1))


@partial(jax.jit, static_argnums=0)
def sample_uniform2(cfg: SamplerConfig, stream: SampleStream):
    """Draw a 2D sample per lane; returns ((B,2) values, new stream)."""
    dim = stream.dim
    u0 = uniform_from_bits(_draw_bits(cfg, stream, dim))
    u1 = uniform_from_bits(_draw_bits(cfg, stream, dim + U32(1)))
    if cfg.kind == "stratified":
        total = cfg.x_strata * cfg.y_strata
        pseed = hash_u32(dim, U32(cfg.seed), U32(0xA5A5A5A5))
        strata = kensler_permute(stream.sample, total, pseed)
        y, x = strata // U32(cfg.x_strata), strata % U32(cfg.x_strata)
        if cfg.jitter:
            dx, dy = u0, u1
        else:
            dx = dy = jnp.full_like(u0, 0.5)
        u0 = (x.astype(jnp.float32) + dx) / np.float32(cfg.x_strata)
        u1 = (y.astype(jnp.float32) + dy) / np.float32(cfg.y_strata)
    return jnp.stack([u0, u1], axis=-1), stream._replace(dim=dim + U32(2))


def sample_u32(cfg: SamplerConfig, stream: SampleStream, n: int):
    """Draw an integer in [0, n) per lane (float-path, like the reference's
    stratified sample_u32; we use it for both sampler kinds)."""
    u, stream = sample_uniform(cfg, stream)
    idx = jnp.minimum((u * n).astype(jnp.int32), n - 1)
    return idx, stream


# ------------------------------------------------------------ distributions

def sample_unit_disk(u):
    r = jnp.sqrt(u[..., 0])
    theta = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def sample_unit_disk_concentric(u):
    uo = 2.0 * u - 1.0
    ux, uy = uo[..., 0], uo[..., 1]
    x_dominant = jnp.abs(ux) > jnp.abs(uy)
    safe_ux = jnp.where(ux == 0.0, 1.0, ux)
    safe_uy = jnp.where(uy == 0.0, 1.0, uy)
    theta = jnp.where(
        x_dominant,
        (jnp.pi / 4.0) * (uy / safe_ux),
        (jnp.pi / 2.0) - (jnp.pi / 4.0) * (ux / safe_uy),
    )
    r = jnp.where(x_dominant, ux, uy)
    zero = (ux == 0.0) & (uy == 0.0)
    d = r[..., None] * jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
    return jnp.where(zero[..., None], 0.0, d)


def sample_cosine_hemisphere(u):
    d = sample_unit_disk(u)
    z = jnp.sqrt(jnp.maximum(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, 0.0))
    return jnp.stack([d[..., 0], d[..., 1], z], axis=-1)


def sample_exponential(u, a):
    return -jnp.log1p(-u) / a


def power_heuristic(n_a, p_a, n_b, p_b):
    w_a = (n_a * p_a) ** 2
    w_b = (n_b * p_b) ** 2
    return w_a / (w_a + w_b)
