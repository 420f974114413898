#!/usr/bin/env python3
"""Does a pixel's result on the GPU depend on how many lanes share its
dispatch?

    python scripts/gpu_width_probe.py
        [--stages rays,walk,walkxla,d1,d8,d8xla,spp8,frame] [--row0 R]
        [--hlo DIR]

Runs 125 rows of the bunny frame (62,500 pixels, from row R, default 0)
once in a 62,500-lane dispatch and once as the first lanes of the whole
250,000-lane frame (the other rows follow them), and
compares the shared lanes bit for bit, stage by stage (lanes differing,
how many of those by at most 4 float32 ULPs, the largest difference):

  rays    camera rays (origin, direction)
  walk    closest-hit walk of those rays (t, prim) and the hit details
  walkxla the same with the XLA walk swapped in for the CUDA walk
  d1, d8  the beauty step at 1 spp and depth 1 / depth 8, CUDA walk
  d8xla   the depth-8 step with the XLA walk swapped in
  spp8    as chip_smoke.py --four renders (8 spp, depth 8, 1 light
          sample, CUDA walk): each sample's radiance, then the step's
          8-sample average
  frame   wall of a whole 8-spp frame through integrator.render (one
          dispatch), median of 3 after a warm render

With --hlo, the optimized HLO of both widths' depth-8 step is written to
DIR and the fusion count of each is printed. One line per stage.
"""
from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SMALL, FULL = 62_500, 250_000


def _bits(x):
    import numpy as np

    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _report(stage, small, big):
    """Lanes whose outputs differ in any bit, and the largest difference."""
    import numpy as np

    n_diff, worst = np.zeros(SMALL, bool), 0.0
    ulps = np.zeros(SMALL, np.int64)
    for a, b in zip(small, big):
        a, b = np.asarray(a), np.asarray(b)[:SMALL]
        d = (_bits(a) != _bits(b)).reshape(SMALL, -1).any(axis=1)
        n_diff |= d
        if a.dtype == np.float32 and d.any():
            u = np.abs(a.view(np.int32).astype(np.int64)
                       - b.view(np.int32).astype(np.int64))
            ulps = np.maximum(ulps, u.reshape(SMALL, -1).max(axis=1))
            with np.errstate(invalid="ignore"):
                worst = max(worst, float(np.nanmax(np.abs(
                    a.astype(np.float64) - b.astype(np.float64)))))
    near = int((n_diff & (ulps <= 4)).sum())
    print(f"{stage}: lanes differing {int(n_diff.sum())} of {SMALL} "
          f"({near} by <= 4 ulp), max |diff| {worst:.6g}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages",
                    default="rays,walk,walkxla,d1,d8,d8xla,spp8,frame")
    ap.add_argument("--row0", type=int, default=0)
    ap.add_argument("--hlo", type=Path)
    args = ap.parse_args()
    stages = args.stages.split(",")

    import numpy as np

    import jax
    import jax.numpy as jnp

    from tpu_raytracing import backend
    from tpu_raytracing.device import compile_scene
    from tpu_raytracing.integrator.render import (
        StaticSettings, render, render_beauty_chunk, trace_radiance,
    )
    from tpu_raytracing.ops import traverse as T
    from tpu_raytracing.ops.camera_rays import generate_rays
    from tpu_raytracing.ops.rng import SamplerConfig, make_stream
    from tpu_raytracing.scene.test_scenes import get_test_scene
    from tpu_raytracing.settings import AovFlags

    backend.select_platform("gpu")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"# {card} | {jax.devices()[0].device_kind}", flush=True)

    ts = get_test_scene("coated_diffuse_bunny")
    settings = ts.settings_func()
    ds = compile_scene(ts.scene_func())
    w, h = ds.meta.width, ds.meta.height
    assert w * h == FULL
    gx, gy = np.meshgrid(np.arange(w, dtype=np.uint32),
                         np.arange(h, dtype=np.uint32))
    order = np.roll(np.arange(FULL), -args.row0 * w)
    px_all, py_all = gx.reshape(-1)[order], gy.reshape(-1)[order]
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)

    def lanes(n):
        return (jnp.asarray(px_all[:n]), jnp.asarray(py_all[:n]),
                jnp.ones(n, bool))

    @jax.jit
    def rays(ds_, px, py):
        o, d, _, _ = generate_rays(ds_, px, py, cfg, make_stream(px, py, 0),
                                   1, jitter=True)
        return o, d

    @jax.jit
    def walk(ds_, px, py):
        o, d = rays(ds_, px, py)
        n = px.shape[0]
        t, p = T.intersect_scene(
            ds_, o, d, jnp.full(n, ds_.meta.near_clip, jnp.float32),
            jnp.full(n, ds_.meta.far_clip, jnp.float32))
        hit = T.hit_details(ds_, o, d, t, p)
        return t, p, hit.point, hit.normal, hit.uv

    def step(depth, n, spp=1):
        settings.samples_per_pixel, settings.max_ray_depth = spp, depth
        st = StaticSettings.from_settings(settings)
        lane = lambda dt: jax.ShapeDtypeStruct((n,), dt)  # noqa: E731
        return render_beauty_chunk.lower(
            ds, cfg, st, lane(jnp.uint32), lane(jnp.uint32), lane(jnp.bool_)
        ).compile()

    def by_width(fn):
        return [fn(n) for n in (SMALL, FULL)]

    if "rays" in stages:
        _report("rays", *by_width(lambda n: rays(ds, *lanes(n)[:2])))
    cuda_walk = T._walk_cuda
    for stage in ("walk", "walkxla"):
        if stage not in stages:
            continue
        T._walk_cuda = T._walk_xla if stage == "walkxla" else cuda_walk
        jax.clear_caches()
        try:
            _report(stage, *by_width(lambda n: walk(ds, *lanes(n)[:2])))
        finally:
            T._walk_cuda = cuda_walk
    for stage, depth in (("d1", 1), ("d8", 8), ("d8xla", 8)):
        if stage not in stages:
            continue
        T._walk_cuda = T._walk_xla if stage == "d8xla" else cuda_walk
        jax.clear_caches()
        try:
            exes = by_width(lambda n: step(depth, n))
            outs = [exe(ds, *lanes(n))
                    for exe, n in zip(exes, (SMALL, FULL))]
        finally:
            T._walk_cuda = cuda_walk
        _report(f"{stage} (walk {'xla' if 'xla' in stage else 'cuda'})",
                *([o[0]] for o in outs))
        if args.hlo and stage == "d8":
            args.hlo.mkdir(parents=True, exist_ok=True)
            for exe, n in zip(exes, (SMALL, FULL)):
                text = exe.as_text()
                (args.hlo / f"beauty_d8_{n}.hlo.txt").write_text(text)
                n_fus = len(re.findall(r"^\s*\S+ = \S+ fusion\(", text, re.M))
                print(f"hlo: width {n} fusions {n_fus} "
                      f"lines {text.count(chr(10))}", flush=True)
    if "spp8" in stages:
        lights = settings.light_sample_count
        settings.light_sample_count = 1
        exes = by_width(lambda n: step(8, n, spp=8))
        st = StaticSettings.from_settings(settings)
        sample = jax.jit(lambda ds_, px, py, s: trace_radiance(
            ds_, cfg, st, px, py, s)[0])
        for s in range(8):
            _report(f"spp8 sample {s}", *by_width(lambda n: [sample(
                ds, *lanes(n)[:2], jnp.uint32(s))]))
        _report("spp8 average", *([exe(ds, *lanes(n))[0]]
                                  for exe, n in zip(exes, (SMALL, FULL))))
        settings.light_sample_count = lights
    if "frame" in stages:
        settings.samples_per_pixel, settings.max_ray_depth = 8, 8
        settings.outputs = AovFlags.BEAUTY
        jax.clear_caches()
        render(ds, settings)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = render(ds, settings)
            walls.append(time.perf_counter() - t0)
        print(f"frame: 8 spp depth 8 walls {walls} median "
              f"{statistics.median(walls):.4f}s rays {out.rays_traced} "
              f"({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
