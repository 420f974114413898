#!/usr/bin/env python3
"""End-to-end A/B of the BVH walk, and the pixel-chunk sweep, on one GPU.

    python scripts/gpu_walk_ab.py [--spp 8] [--depth 8] [--reps 2]
        [--chunks 14,15,16,17,18,19] [--no-ab] [--no-sweep]

Renders the bunny Cornell box (coated_diffuse_bunny) beauty pass with
integrator.render. The A/B swaps the CUDA walk for the XLA walk by
monkeypatching ops.traverse._walk_cuda (there is no switch for it) and runs
the two in turns: cuda, xla, xla, cuda. Every timed render follows a warm
render of the same executable, so walls exclude compilation; compile
seconds are reported apart. One JSON object per measurement on stdout.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--chunks", default="14,15,16,17,18,19")
    ap.add_argument("--no-ab", action="store_true")
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()

    import jax

    from tpu_raytracing import backend
    from tpu_raytracing.device import compile_scene
    from tpu_raytracing.integrator.render import render
    from tpu_raytracing.ops import traverse as T
    from tpu_raytracing.scene.test_scenes import get_test_scene
    from tpu_raytracing.settings import AovFlags

    backend.select_platform("gpu")
    dev = jax.devices()[0]
    card = _gpu_line()
    print(f"# {card} | {dev.device_kind} x{len(jax.devices())}", flush=True)

    ts = get_test_scene("coated_diffuse_bunny")
    settings = ts.settings_func()
    settings.samples_per_pixel = args.spp
    settings.max_ray_depth = args.depth
    settings.outputs = AovFlags.BEAUTY
    ds = compile_scene(ts.scene_func())
    cuda_walk = T._walk_cuda

    def measure(label, walk, chunk):
        T._walk_cuda = walk
        jax.clear_caches()
        t0 = time.perf_counter()
        render(ds, settings, chunk_pixels=chunk)  # compile + warm
        warm = time.perf_counter() - t0
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = render(ds, settings, chunk_pixels=chunk)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        rec = {
            "label": label, "chunk": chunk, "spp": args.spp,
            "depth": args.depth, "walls_s": walls, "wall_s": wall,
            "warm_s": warm, "rays": out.rays_traced,
            "mrays_s": out.rays_traced / wall / 1e6, "card": card,
        }
        print(json.dumps(rec), flush=True)
        return rec

    try:
        if not args.no_ab:
            chunk = backend.GPU_CHUNK_PIXELS
            for label in ("cuda", "xla", "xla", "cuda"):
                walk = cuda_walk if label == "cuda" else T._walk_xla
                measure(f"walk={label}", walk, chunk)
        if not args.no_sweep:
            for e in (int(x) for x in args.chunks.split(",")):
                measure("chunk_sweep", cuda_walk, 1 << e)
    finally:
        T._walk_cuda = cuda_walk
    return 0


if __name__ == "__main__":
    sys.exit(main())
