"""Headline benchmark: Mrays/s on the cbbunny Cornell-box scene.

Prints ONE JSON line: {"metric", "value", "unit", "device"}, naming the
device it ran on (cbbunny_area_light.glb when available, else the builtin
coated_diffuse_bunny scene).

Cold-cache survival:

1. The first dispatch is a SINGLE pixel chunk — the same executable the
   full render uses — so right after the one unavoidable compile we
   already hold a measured throughput number.
2. A watchdog thread prints the best measurement so far and exits 0 when
   BENCH_BUDGET_S (default 540) runs out, so a JSON line is printed even
   if the full-frame render can't finish in time.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

_result_lock = threading.Lock()
_best: dict | None = None
_printed = False


def _emit_and_exit(code: int = 0) -> None:
    """Print the best-known measurement exactly once and hard-exit."""
    global _printed
    with _result_lock:
        if _printed:
            os._exit(code)
        _printed = True
        if _best is None:
            # nothing measured: no number is better than a fabricated one
            print(
                json.dumps(
                    {
                        "metric": "pathtrace_bench_incomplete",
                        "value": 0.0,
                        "unit": "Mrays/s",
                    }
                ),
                flush=True,
            )
            os._exit(3)
        print(json.dumps(_best), flush=True)
        os._exit(code)


def _loadavg() -> float:
    try:
        return os.getloadavg()[0]
    except OSError:
        return -1.0


_best_rank = -1
_DEVICE: dict = {}


def _record(name: str, spp: int, mrays: float, kind: str) -> None:
    """Record the headline metric: best full-frame wall seen so far.

    The single-chunk measurement (rank 0) is only a watchdog fallback —
    it excludes frame-edge overheads, so any full-frame measurement
    (rank 1) replaces it even if numerically lower. Within full-frame
    measurements, keep the BEST of the repeats (min wall): concurrent
    host work can only slow a repeat down.
    """
    global _best, _best_rank
    rank = 0 if kind.startswith("single-chunk") else 1
    with _result_lock:
        if _best is not None and rank <= _best_rank and \
                _best["value"] >= mrays and rank == _best_rank:
            print(f"# {kind}: {mrays:.3f} Mrays/s (load={_loadavg():.2f})"
                  " [kept earlier best]", file=sys.stderr, flush=True)
            return
        if _best is not None and rank < _best_rank:
            return
        _best_rank = rank
        _best = {
            "metric": f"pathtrace_{name}_{spp}spp_mrays_per_s",
            "value": round(mrays, 3),
            "unit": "Mrays/s",
            "device": _DEVICE,
        }
        # host load rides along: concurrent host work slows a wall down
        print(f"# {kind}: {mrays:.3f} Mrays/s (load={_loadavg():.2f})",
              file=sys.stderr, flush=True)


def _load_scene():
    from tpu_raytracing.scene.loaders import scene_from_file
    from tpu_raytracing.scene.test_scenes import get_test_scene

    glb = Path("/root/reference/scenes/cbbunny_area_light.glb")
    if glb.exists():
        return "cbbunny", scene_from_file(glb)
    ts = get_test_scene("coated_diffuse_bunny")
    return "coated_diffuse_bunny", ts.scene_func()


def main() -> None:
    budget = float(os.environ.get("BENCH_BUDGET_S", "540"))
    watchdog = threading.Timer(budget, _emit_and_exit)
    watchdog.daemon = True
    watchdog.start()

    import jax

    from tpu_raytracing import backend

    backend.setup_compile_cache()
    dev = jax.devices()[0]
    global _DEVICE
    _DEVICE = {"platform": dev.platform, "kind": dev.device_kind,
               "count": len(jax.devices())}
    spp = int(os.environ.get("BENCH_SPP", "8"))

    from tpu_raytracing.device import compile_scene
    from tpu_raytracing.integrator.render import (
        StaticSettings, _pixel_grid, render,
        render_beauty_chunk,
    )
    from tpu_raytracing.ops.rng import SamplerConfig
    from tpu_raytracing.settings import AovFlags, RaytracerSettings

    name, scene = _load_scene()
    settings = RaytracerSettings(
        samples_per_pixel=spp,
        light_sample_count=1,
        max_ray_depth=8,
        outputs=AovFlags.BEAUTY,
    )

    ds = compile_scene(scene)
    chunk = backend.chunk_pixels()

    # --- phase 1: one chunk (same executable as the full render).
    # First call pays the compile; the repeat gives an early honest number.
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    px, py, _ = _pixel_grid(ds.meta.width, ds.meta.height)
    n_chunk = min(chunk, px.shape[0])
    cpx, cpy = px[:n_chunk], py[:n_chunk]
    act = np.ones(n_chunk, bool)
    t0 = time.perf_counter()
    r, n = render_beauty_chunk(ds, cfg, st, cpx, cpy, act)
    np.asarray(r)
    print(
        f"# chunk compile+run: {time.perf_counter() - t0:.1f}s",
        file=sys.stderr, flush=True,
    )
    t0 = time.perf_counter()
    r, n = render_beauty_chunk(ds, cfg, st, cpx, cpy, act)
    r = np.asarray(r)
    wall = time.perf_counter() - t0
    assert np.isfinite(r).all()
    _record(name, spp, int(n) / wall / 1e6, "single-chunk fallback")

    # --- phase 2: full-frame timed render (cache-warm; refines the number)
    t0 = time.perf_counter()
    out = render(ds, settings, chunk_pixels=chunk)
    wall = time.perf_counter() - t0
    assert out.beauty is not None and np.isfinite(out.beauty).all()
    _record(name, spp, out.rays_traced / wall / 1e6, "full frame")

    # --- phase 3 (stderr only; headline already banked, watchdog-safe):
    # N-repeat multi-scene table with min/median + loadavg.
    # Skipped when the budget is nearly spent or BENCH_TABLE=0.
    start = time.perf_counter()
    deadline = budget - 90.0
    if os.environ.get("BENCH_TABLE", "1") == "1":
        try:
            _stderr_table(name, ds, settings, spp, deadline, start, render)
        except Exception as e:  # the table must never kill the JSON line
            print(f"# table skipped: {e}", file=sys.stderr, flush=True)

    _emit_and_exit(0)


def _stderr_table(head_name, head_ds, settings, spp, deadline, start,
                  render) -> None:
    from statistics import median

    from tpu_raytracing.device import compile_scene
    from tpu_raytracing.scene.loaders import scene_from_file

    others = {
        "cb": Path("/root/reference/scenes/cb.glb"),
        "cb_texture": Path("/root/reference/scenes/cb_texture.glb"),
        "cbbunny_transforms": Path(
            "/root/reference/scenes/cbbunny_area_light_transforms.glb"),
    }
    reps = int(os.environ.get("BENCH_REPS", "3"))
    rows = []
    work = [(head_name, head_ds)]
    for nm, p in others.items():
        if p.exists():
            work.append((nm, p))
    for nm, src in work:
        if time.perf_counter() - start > deadline:
            print("# table truncated: budget", file=sys.stderr, flush=True)
            break
        ds_i = src if not isinstance(src, Path) else compile_scene(
            scene_from_file(src))
        vals = []
        render(ds_i, settings)  # warm (compile if cold)
        for _ in range(reps):
            if time.perf_counter() - start > deadline:
                break
            t0 = time.perf_counter()
            out_i = render(ds_i, settings)
            w = time.perf_counter() - t0
            mrays = out_i.rays_traced / w / 1e6
            vals.append((mrays, _loadavg()))
            if nm == head_name:
                # same full-frame metric as phase 2: fold the repeats
                # into the headline best-of
                _record(nm, spp, mrays, "table repeat")
        if vals:
            ms = [v for v, _ in vals]
            flag = sum(1 for _, la in vals if la > 0.7)
            rows.append((nm, min(ms), max(ms), median(ms), flag))
    print(f"# {'scene':<20} {'min':>7} {'best':>7} {'median':>7} loaded",
          file=sys.stderr, flush=True)
    for nm, lo, hi, med, flag in rows:
        print(f"# {nm:<20} {lo:7.3f} {hi:7.3f} {med:7.3f} {flag}",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
