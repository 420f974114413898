"""Per-platform policy, in one place.

- which JAX platform renders (``--backend jax|cpu|gpu``);
- where compiled programs are cached;
- how many pixels one device dispatch holds;
- which BVH walk runs: the CUDA kernel where XLA lowers for an NVIDIA GPU,
  the plain XLA walk everywhere else;
- whether the integrator sorts path state for coherence.

Nothing here falls back silently: asking for a GPU where there is none
raises.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

BACKENDS = ("jax", "cpu", "gpu")

# <checkout>/.jax_cache (listed in .gitignore): a fixed path, because the
# path is part of the cache key
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"

# Pixels per device dispatch. GPU: the winner of a 2^14..2^19 sweep on the
# bunny beauty render (CHANGES.md): wall fell with every doubling up to a
# whole 500x500 frame in one dispatch (not traced yet; a fixed cost per
# kernel launch and loop trip would fit). CPU: XLA:CPU slows down on very
# wide dispatches, so it keeps a modest width. The RNG is keyed by pixel
# and sample, so on the CPU images are bit-identical across widths
# (tests/test_integrator.py). On a GPU they are not quite: XLA:GPU fuses a
# program differently at different array lengths, some pixels differ in
# their last bits, and a few Monte-Carlo paths diverge from them
# (scripts/gpu_width_probe.py; PERF.md).
GPU_CHUNK_PIXELS = 1 << 18
CPU_CHUNK_PIXELS = 1 << 13


def setup_compile_cache() -> None:
    """Persistent compile cache: JAX_COMPILATION_CACHE_DIR when set (JAX
    reads it itself), else <checkout>/.jax_cache."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def select_platform(backend: str) -> None:
    """Point JAX at `backend` and set up the compile cache.

    jax: whatever JAX finds (JAX_PLATFORMS is honoured); cpu: the host;
    gpu: an NVIDIA GPU, or RuntimeError.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif backend == "gpu":
        try:
            jax.devices("gpu")
        except RuntimeError as e:
            raise RuntimeError(f"--backend gpu: no usable GPU ({e})") from e
        if jax.default_backend() != "gpu":
            raise RuntimeError(
                f"--backend gpu: JAX renders on {jax.default_backend()}"
            )
    setup_compile_cache()


def has_gpu() -> bool:
    """True when the process's default JAX devices are GPUs."""
    return jax.devices()[0].platform == "gpu"


def chunk_pixels() -> int:
    """Pixels per device dispatch on the default platform."""
    return GPU_CHUNK_PIXELS if jax.default_backend() == "gpu" else CPU_CHUNK_PIXELS


def bvh_walk(args, cuda_walk, xla_walk):
    """Run one BVH walk pass: `cuda_walk(*args)` where XLA lowers for CUDA,
    `xla_walk(*args)` on every other platform.

    The choice is made per lowering platform (``lax.platform_dependent``),
    so one traced function serves CPU tests and GPU renders alike.
    """
    return jax.lax.platform_dependent(*args, cuda=cuda_walk, default=xla_walk)


def coherence_sort(ds) -> bool:
    """Sort path state by a ray-coherence key once per bounce (and with it
    the shadow own-sort, NEE stacking and the alive-prefix ladder).

    Off: whether the per-thread CUDA walk gains enough from warp
    coherence to pay for the sort is not measured yet. Tests
    turn it on by monkeypatching this function."""
    del ds
    return False
