"""Env-gated ray-batch capture for offline traversal analysis.

TPU_RT_DUMP_RAYS=1 makes every intersect_scene call record its ray batch
(origin, direction, t range, active mask, early_exit kind) through an
ordered io_callback — honest per-bounce workloads straight from the real
integrator, for evaluating traversal organizations offline. Zero overhead
when the knob is off (the callback is never staged).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

BATCHES: List[dict] = []


def enabled() -> bool:
    return os.environ.get("TPU_RT_DUMP_RAYS", "0") == "1"


def clear() -> None:
    BATCHES.clear()


def _record(kind, o, d, t_min, t_max, act):
    BATCHES.append(
        dict(
            kind=int(kind),
            o=np.asarray(o).copy(),
            d=np.asarray(d).copy(),
            t_min=np.asarray(t_min).copy(),
            t_max=np.asarray(t_max).copy(),
            act=np.asarray(act).copy(),
        )
    )


def emit(early_exit: bool, o, d, t_min, t_max, act) -> None:
    """Stage an ordered dump of one traversal call's inputs (trace-time
    no-op unless TPU_RT_DUMP_RAYS=1)."""
    if not enabled():
        return
    import jax
    import jax.numpy as jnp

    jax.experimental.io_callback(
        _record, None, jnp.int32(1 if early_exit else 0),
        o, d, t_min, t_max, act, ordered=True,
    )


def save(path: str) -> None:
    arrs = {}
    for i, b in enumerate(BATCHES):
        for k, v in b.items():
            arrs[f"b{i}_{k}"] = v
    arrs["n"] = np.asarray(len(BATCHES))
    np.savez_compressed(path, **arrs)


def load(path: str) -> List[dict]:
    z = np.load(path)
    n = int(z["n"])
    return [
        {k: z[f"b{i}_{k}"] for k in ("kind", "o", "d", "t_min", "t_max",
                                     "act")}
        for i in range(n)
    ]
