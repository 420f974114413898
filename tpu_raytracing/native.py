"""ctypes bindings for the native runtime library (csrc/ -> librtnative.so).

The native library carries the framework's host-side hot paths — currently
the binned-SAH BVH builder (the role Embree plays for the reference,
crates/embree4/src/bvh.rs). Python fallbacks exist for every entry point;
`build_bvh_native` returns None when the library is unavailable and the
caller falls back. Both builders emit bit-identical layouts (tested), so
availability of the .so never changes render output.

Build: `make -C csrc` (done automatically on first import when a compiler
is available).
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("tpu_raytracing")

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_LIB_PATH = _CSRC / "librtnative.so"
_ABI_VERSION = 2

_lib = None
_load_attempted = False


def _try_build() -> bool:
    if os.environ.get("TPU_RAYTRACING_NO_NATIVE"):
        return False
    try:
        subprocess.run(
            ["make", "-C", str(_CSRC)],
            capture_output=True, check=True, timeout=120,
        )
        return _LIB_PATH.exists()
    except Exception as e:
        log.debug("native build failed: %s", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if os.environ.get("TPU_RAYTRACING_NO_NATIVE"):
        return None
    if not _LIB_PATH.exists() and not _try_build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.tpu_rt_abi_version.restype = ctypes.c_int
        if lib.tpu_rt_abi_version() != _ABI_VERSION:
            log.warning("native library ABI mismatch; rebuilding")
            if not _try_build():
                return None
            lib = ctypes.CDLL(str(_LIB_PATH))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.tpu_rt_build_bvh.restype = ctypes.c_int
        lib.tpu_rt_build_bvh.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, i32p, i32p, i32p, i32p, ctypes.c_int,
        ]
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        lib.tpu_rt_huf_uncompress.restype = ctypes.c_int
        lib.tpu_rt_huf_uncompress.argtypes = [
            u8p, ctypes.c_int64, u16p, ctypes.c_int64,
        ]
        _lib = lib
    except Exception as e:
        log.debug("native library load failed: %s", e)
        _lib = None
    return _lib


def build_bvh_native(prim_min, prim_max, max_leaf_size):
    """Native BVH build; returns LinearBVH-compatible arrays or None."""
    lib = get_lib()
    if lib is None:
        return None
    prim_min = np.ascontiguousarray(prim_min, np.float32).reshape(-1, 3)
    prim_max = np.ascontiguousarray(prim_max, np.float32).reshape(-1, 3)
    n = prim_min.shape[0]
    cap = max(2 * n + 1, 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left_first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    prim_order = np.empty(max(n, 1), np.int32)
    n_nodes = lib.tpu_rt_build_bvh(
        prim_min, prim_max, n, int(max_leaf_size),
        node_min, node_max, left_first, count, skip, prim_order, cap,
    )
    if n_nodes < 0:
        log.warning("native BVH build overflow; falling back to python")
        return None
    return (
        node_min[:n_nodes].copy(),
        node_max[:n_nodes].copy(),
        left_first[:n_nodes].copy(),
        count[:n_nodes].copy(),
        skip[:n_nodes].copy(),
        prim_order[:n].copy(),
    )
