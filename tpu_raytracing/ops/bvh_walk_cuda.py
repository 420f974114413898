"""CUDA BVH walk (csrc/bvh_walk.cu), called through ``jax.ffi``.

One thread per ray walks the child-pair rows (``DeviceScene.bvh2_rows``)
with a private stack in local memory. It reads the tables the XLA walk
reads and returns what the XLA walk returns
(``ops/traverse.py::_walk_xla``), which is its reference.

The shared library is built from the committed sources with ``nvcc`` the
first time a process traces the walk for a GPU (or by ``make -C csrc
cuda``), into ``csrc/build/``, which git ignores. The file name carries a
hash of the sources and flags, so an edited kernel is never loaded stale.
A failed build or load raises with nvcc's message: on a GPU there is no
quiet fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

TARGET = "rt_bvh_walk"
# per-thread stack entries; compile_scene refuses deeper trees
MAX_STACK = 64

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_SOURCES = (_CSRC / "bvh_walk.cu", _CSRC / "bvh_walk.cuh")
BUILD_DIR = _CSRC / "build"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        f"nvcc not found (looked in {cuda_home}/bin and on PATH); the CUDA "
        "BVH walk cannot be built"
    )


def _flags() -> list[str]:
    return [
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        f"-DRT_MAX_STACK={MAX_STACK}",
        "-I", str(_CSRC), "-I", jax.ffi.include_dir(),
    ]


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(_flags()).encode())
    return BUILD_DIR / f"libbvhwalk-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this exact build exists. Returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(), "-o", str(tmp), str(_SOURCES[0])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.cache
def register() -> Path:
    """Build (if needed), load and register the FFI target for CUDA."""
    path = build()
    lib = ctypes.CDLL(str(path))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.RtBvhWalk), platform="CUDA"
    )
    return path


def walk(rows, tris, root: int, origin, direction, t_min, t_best, best,
         active, early_exit: bool):
    """The FFI call: same arguments and results as the XLA walk."""
    b = t_min.shape[0]
    return jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((b,), jnp.float32),
         jax.ShapeDtypeStruct((b,), jnp.int32)),
    )(
        rows, tris, origin, direction, t_min, t_best, best, active,
        root=np.int32(root), any_hit=bool(early_exit),
    )


if __name__ == "__main__":
    print(build())
