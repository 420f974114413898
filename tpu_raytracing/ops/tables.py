"""Tiny-table row fetch: broadcast select-chain instead of a row gather.

For a table with a handful of static rows, a where-chain over broadcast
rows fuses into one elementwise loop with no gather at all.

Bit-exact by construction: every output row is the original row's bits
moved by selects (no arithmetic), and the index is clamped exactly like
XLA's gather semantics. Works for any dtype and trailing shape.

Counterpart of the reference's SBT-style direct struct indexing
(kernels/pathtracer.cu material/light lookups).

Off unless TPU_RT_SELECT_ROWS=N>0 sets a row-count cutoff: restructuring
the fused shading loops can make XLA:CPU's FMA contraction chunk-shape-
dependent at the last ULP, and the CPU backend keeps a strict bit-exact
chunk-invariance contract. On a GPU a row gather is a plain load, and
whether the select-chain pays there is not measured yet.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

def _limit() -> int:
    return int(os.environ.get("TPU_RT_SELECT_ROWS", "0"))


def select_rows(table: jax.Array, idx: jax.Array) -> jax.Array:
    """table[idx] (idx: (B,) int) — as a select-chain when the table is
    statically tiny, else the plain gather."""
    n = int(table.shape[0])
    if n == 0 or n > _limit():
        return table[idx]
    idx = jnp.clip(idx, 0, n - 1)  # match XLA gather clamping bit-exactly
    mask_shape = (idx.shape[0],) + (1,) * (table.ndim - 1)
    out = jnp.broadcast_to(table[0], (idx.shape[0],) + tuple(table.shape[1:]))
    for k in range(1, n):
        out = jnp.where((idx == k).reshape(mask_shape), table[k], out)
    return out
