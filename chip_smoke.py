#!/usr/bin/env python3
"""Smoke test of the path tracer on an NVIDIA GPU.

    python chip_smoke.py          # phases 1-5 on one GPU
    python chip_smoke.py --four   # only the four-GPU mesh phase

Phases:
  1. device   every JAX device is a GPU; the card's name and power limit
  2. build    the CUDA BVH walk is built (or loaded) and registered
  3. parity   CUDA walk vs the XLA walk on the same card: 2^20 primary,
              bounce and shadow rays on the bunny, the Cornell box and a
              two-instance scene; prim / occlusion agreement >= 99.99%,
              |dt| <= 1e-5 max(1, t) where the prim agrees; ms per 2^20
              rays for both walks
  4. render   the CLI main path: coated_diffuse_bunny, 64 spp, depth 8,
              stratified; finite EXR with a non-zero mean
  5. images   builtin scenes rendered on the GPU and in a CPU-only child,
              compared with rttest's statistical gate
  6. four     (--four) (tiles=4, spp=1) and (tiles=2, spp=2) mesh renders
              pass the gate against the one-card render; tiles=4 equals
              one card at the same per-card width bit for bit

The parent process never imports JAX: each phase that uses the card runs
in its own child process, one after another, so only one process holds
the card at a time. Any failure exits non-zero without the result line.
The last line of stdout is the result:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
N_RAYS = 1 << 20
PRIM_AGREE = 0.9999
T_TOL = 1e-5

# phase 5: (builtin scene, CLI-equivalent overrides, outputs)
IMAGE_SCENES = (
    ("sphere", {}, ("normals",)),
    ("cube_orthographic", {}, ("normals",)),
    ("checkered_plane", {}, ("beauty", "normals", "uv")),
    ("dielectric", {}, ("beauty",)),
    ("metal", {}, ("beauty",)),
    ("environment_light", {}, ("beauty",)),
    ("coated_diffuse_bunny", {"spp": 1, "depth": 8}, ("beauty",)),
)


class SmokeFailure(RuntimeError):
    pass


def _log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- parent

def _run_child(args: list[str], env_extra: dict | None = None,
               timeout: float = 900.0, background: bool = False):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    if env_extra:
        env.update(env_extra)
    cmd = [sys.executable, *args]
    if background:
        return subprocess.Popen(
            cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
    proc = subprocess.run(
        cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=timeout,
    )
    return proc.returncode, proc.stdout


def _child_phase(name: str, out_dir: Path, extra: list[str] = (),
                 env_extra: dict | None = None, timeout: float = 900.0):
    rc, out = _run_child(
        [str(REPO / "chip_smoke.py"), "--child", name, "--out", str(out_dir),
         *extra],
        env_extra=env_extra, timeout=timeout,
    )
    for line in out.splitlines():
        _log(f"  [{name}] {line}")
    if rc != 0:
        raise SmokeFailure(f"phase {name} failed (exit {rc})")
    return out


def _nvidia_smi() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi cannot be run: {e}") from e
    if proc.returncode != 0 or not proc.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def _phase_render(out_dir: Path) -> None:
    exr = out_dir / "bunny_64spp.exr"
    t0 = time.perf_counter()
    rc, out = _run_child(
        ["-m", "tpu_raytracing.cli", "--scene-name", "coated_diffuse_bunny",
         "-s", "64", "-d", "8", "--sampler", "stratified", "-o", str(exr),
         "full"],
        timeout=900,
    )
    wall = time.perf_counter() - t0
    beauty_lines = [ln for ln in out.splitlines() if "beauty pass took" in ln]
    for line in out.splitlines():
        if "took" in line or "Error" in line or "error" in line:
            _log(f"  [render] {line}")
    if rc != 0 or not beauty_lines:
        _log(out[-4000:])
        raise SmokeFailure(f"CLI render failed (exit {rc})")
    sys.path.insert(0, str(REPO))
    from tpu_raytracing.utils.exr import read_exr  # numpy only, no JAX

    import numpy as np

    channels, w, h = read_exr(exr)
    img = np.stack([channels[c] for c in "RGB"], axis=-1)
    if img.shape != (h, w, 3) or not np.isfinite(img).all():
        raise SmokeFailure("render: EXR not finite or wrong shape")
    mean = float(img.mean())
    if not mean > 0.0:
        raise SmokeFailure(f"render: EXR mean {mean} is not positive")
    _log(f"render: process wall {wall:.3f}s, {beauty_lines[-1].split(': ', 1)[-1]}"
         f", image {w}x{h} mean {mean:.6f}")


def _phase_images(out_dir: Path) -> None:
    gpu_dir, cpu_dir = out_dir / "img_gpu", out_dir / "img_cpu"
    # The CPU child never touches the card, so it runs beside the GPU one.
    # It compiles afresh: XLA:CPU code is specific to the host's CPU, and a
    # compile cache shared between machines could hand it code built for
    # another CPU model.
    cpu = _run_child(
        [str(REPO / "chip_smoke.py"), "--child", "images", "--out",
         str(cpu_dir)],
        env_extra={"JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": "",
                   "JAX_ENABLE_COMPILATION_CACHE": "false"},
        background=True,
    )
    try:
        _child_phase("images", gpu_dir)
        cpu_out, _ = cpu.communicate(timeout=900)
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    if cpu.returncode != 0:
        for line in cpu_out.splitlines()[-60:]:
            _log(f"  [images-cpu] {line}")
        raise SmokeFailure(f"CPU reference renders failed ({cpu.returncode})")
    # on success only the timings: the CPU child also logs the GPU
    # plugin's failed start, which is expected with no visible device
    names = tuple(f"{name}: " for name, _o, _a in IMAGE_SCENES)
    for line in cpu_out.splitlines():
        if line.startswith(names) or line.startswith("platform "):
            _log(f"  [images-cpu] {line}")

    sys.path.insert(0, str(REPO))
    from visual_testing.rttest.diff import compare_images

    failed = []
    for name, _over, outputs in IMAGE_SCENES:
        for aov in outputs:
            d = compare_images(gpu_dir / f"{name}_{aov}.exr",
                               cpu_dir / f"{name}_{aov}.exr")
            ok = d.stat_passes()
            _log(f"images: {name}/{aov} [{d.channel_group}] rel_mean="
                 f"{d.rel_mean:.5f} block_rel={d.block_rel:.5f} "
                 f"mse={d.mse:.3e} {'PASS' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{name}/{aov}")
    if failed:
        raise SmokeFailure(f"image gate failed: {failed}")


def main_parent(four: bool) -> int:
    try:
        smi = _nvidia_smi()
        _log(f"gpu: {smi}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            out_dir = Path(tmp)
            if four:
                _child_phase("four", out_dir, timeout=1100)
            else:
                _child_phase("parity", out_dir, timeout=600)
                _phase_render(out_dir)
                _phase_images(out_dir)
            device = json.loads((out_dir / "device.json").read_text())
    except (SmokeFailure, subprocess.TimeoutExpired, OSError,
            ValueError) as e:
        _log(f"FAILED: {e}")
        return 1
    if device["platform"] != "gpu" or device["count"] != (4 if four else 1):
        _log(f"FAILED: unexpected device {device}")
        return 1
    _log(f"gpu: {smi} | device_kind {device['kind']}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


# ---------------------------------------------------------------- children

def _gpu_setup(out_dir: Path, n_devices: int):
    import jax

    from tpu_raytracing import backend

    backend.select_platform("gpu")
    devs = jax.devices()
    if any(d.platform != "gpu" for d in devs):
        raise SmokeFailure(f"not all JAX devices are GPUs: {devs}")
    if len(devs) < n_devices:
        raise SmokeFailure(f"need {n_devices} GPUs, JAX sees {len(devs)}")
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "device.json").write_text(json.dumps(device))
    _log(f"device: {device}")
    return devs


def _rays_primary(ds, n):
    import numpy as np

    import jax.numpy as jnp

    from tpu_raytracing.ops.camera_rays import generate_rays
    from tpu_raytracing.ops.rng import SamplerConfig, make_stream
    from tpu_raytracing.settings import RaytracerSettings

    w, h = ds.meta.width, ds.meta.height
    lane = np.arange(n)
    pix = (lane * 7919) % (w * h)  # 7919 is prime: spreads any n over the image
    px = jnp.asarray(pix % w, jnp.uint32)
    py = jnp.asarray(pix // w, jnp.uint32)
    sample = jnp.asarray(lane // (w * h), jnp.uint32)
    s = RaytracerSettings()
    cfg = SamplerConfig.from_settings(s.sampler, s.seed)
    o, d, _, _ = generate_rays(ds, px, py, cfg, make_stream(px, py, sample),
                               8, jitter=True)
    return (o, d, jnp.full(n, ds.meta.near_clip, jnp.float32),
            jnp.full(n, ds.meta.far_clip, jnp.float32), jnp.ones(n, bool))


def _parity_sets(ds, light_center, closest_xla, rng):
    """Yield (label, any_hit, rays) for primary, bounce and shadow rays;
    the bounce and shadow sets start at the primary rays' first hits."""
    import numpy as np

    import jax.numpy as jnp

    from tpu_raytracing.ops.traverse import hit_details

    prim = _rays_primary(ds, N_RAYS)
    yield "primary", False, prim
    o, d, tmin, tmax, act = prim
    t, p = closest_xla(o, d, tmin, tmax, act)
    hit = hit_details(ds, o, d, t, p)
    ok = np.asarray(hit.hit)
    pts = np.asarray(hit.point)
    nrm = np.asarray(hit.normal)
    # cosine-weighted bounce directions about the (camera-facing) normal
    wo = -np.asarray(d)
    nrm = np.where((np.sum(nrm * wo, axis=1) < 0)[:, None], -nrm, nrm)
    u1, u2 = rng.uniform(size=N_RAYS), rng.uniform(size=N_RAYS)
    r, phi = np.sqrt(u1), 2 * np.pi * u2
    a = np.where(np.abs(nrm[:, :1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
    tx = np.cross(a, nrm)
    tx /= np.maximum(np.linalg.norm(tx, axis=1, keepdims=True), 1e-12)
    ty = np.cross(nrm, tx)
    dirs = (r * np.cos(phi))[:, None] * tx + (r * np.sin(phi))[:, None] * ty \
        + np.sqrt(np.maximum(1 - u1, 0))[:, None] * nrm
    dirs /= np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True), 1e-12)
    f32 = np.float32
    yield "bounce", False, (
        jnp.asarray(pts, f32), jnp.asarray(dirs, f32),
        jnp.full(N_RAYS, 1e-4, f32), jnp.full(N_RAYS, np.inf, f32),
        jnp.asarray(ok),
    )
    # shadow rays toward a 0.5 x 0.5 light patch centred on the light
    target = np.asarray(light_center)[None, :] + np.stack(
        [rng.uniform(-0.25, 0.25, N_RAYS), rng.uniform(-0.25, 0.25, N_RAYS),
         np.zeros(N_RAYS)], axis=1)
    to = target - pts
    dist = np.linalg.norm(to, axis=1)
    yield "shadow", True, (
        jnp.asarray(pts, f32),
        jnp.asarray(to / np.maximum(dist, 1e-12)[:, None], f32),
        jnp.full(N_RAYS, 1e-3, f32), jnp.asarray(dist - 1e-3, f32),
        jnp.asarray(ok & (dist > 2e-3)),
    )


def _time_ms(fn, args, reps=5) -> float:
    import statistics

    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _query_fns(ds):
    """{(route, any_hit): compiled intersect_scene over N_RAYS rays}. The
    'xla' route is traced with the CUDA walk swapped for the XLA walk."""
    import jax
    import jax.numpy as jnp

    from tpu_raytracing.ops import traverse as T

    f32 = jnp.float32
    shapes = (jax.ShapeDtypeStruct((N_RAYS, 3), f32),
              jax.ShapeDtypeStruct((N_RAYS, 3), f32),
              jax.ShapeDtypeStruct((N_RAYS,), f32),
              jax.ShapeDtypeStruct((N_RAYS,), f32),
              jax.ShapeDtypeStruct((N_RAYS,), jnp.bool_))
    fns = {}
    cuda_walk = T._walk_cuda
    for route in ("cuda", "xla"):
        T._walk_cuda = cuda_walk if route == "cuda" else T._walk_xla
        try:
            for any_hit in (False, True):
                def q(o, d, tmin, tmax, act, any_hit=any_hit):
                    return T.intersect_scene(ds, o, d, tmin, tmax,
                                             early_exit=any_hit, active=act)
                fns[route, any_hit] = jax.jit(q).lower(*shapes).compile()
        finally:
            T._walk_cuda = cuda_walk
    return fns


def _compare(any_hit, tk, pk, tx, px):
    """(ok, detail) for one ray set: CUDA (tk, pk) vs XLA (tx, px)."""
    import numpy as np

    if any_hit:
        agree = float(np.mean((pk >= 0) == (px >= 0)))
        return agree >= PRIM_AGREE, (
            f"agree {agree:.6f} occluded {np.mean(px >= 0):.4f}")
    with np.errstate(invalid="ignore"):
        same = pk == px
        agree = float(np.mean(same))
        both = same & (px >= 0)
        dt = np.where(both, np.abs(tk - tx) / np.maximum(1.0, np.abs(tx)), 0.0)
        mism = ~same
        # a mismatch is a tie when both walks hit at the same t (a shared
        # edge both triangles claim, ops/intersect.py BARY_EPS)
        tie = mism & np.isfinite(tk) & np.isfinite(tx) & (
            np.abs(tk - tx) <= T_TOL * np.abs(tx))
    ok = agree >= PRIM_AGREE and float(dt.max()) <= T_TOL
    return ok, (f"agree {agree:.6f} hit {np.mean(px >= 0):.4f}, max|dt| "
                f"{float(dt.max()):.2e}, mismatches {int(mism.sum())} "
                f"(ties {int(tie.sum())})")


def child_parity(out_dir: Path) -> None:
    import numpy as np

    from tpu_raytracing.device import compile_scene
    from tpu_raytracing.ops import bvh_walk_cuda
    from tpu_raytracing.scene.test_scenes import (
        coated_diffuse_bunny_scene, cornell_box, grid_pair_scene,
    )

    _gpu_setup(out_dir, 1)
    t0 = time.perf_counter()
    path = bvh_walk_cuda.register()
    _log(f"build: CUDA walk ready in {time.perf_counter() - t0:.3f}s "
         f"({path.name})")

    scenes = (
        ("bunny", coated_diffuse_bunny_scene(), (0.0, 0.0, 1.4)),
        ("cornell", cornell_box().build(), (0.0, 0.0, 1.4)),
        ("instanced", grid_pair_scene(shared=True), (0.0, 2.0, 0.0)),
    )
    rng = np.random.default_rng(0)
    failures = []
    for sname, scene, light in scenes:
        ds = compile_scene(scene)
        fns = _query_fns(ds)
        for label, any_hit, rays in _parity_sets(
                ds, light, fns["xla", False], rng):
            tk, pk = (np.asarray(x) for x in fns["cuda", any_hit](*rays))
            tx, px = (np.asarray(x) for x in fns["xla", any_hit](*rays))
            ok, detail = _compare(any_hit, tk, pk, tx, px)
            ms_k = _time_ms(fns["cuda", any_hit], rays)
            ms_x = _time_ms(fns["xla", any_hit], rays)
            _log(f"parity: {sname}/{label} rays {N_RAYS} active "
                 f"{int(np.asarray(rays[4]).sum())} {detail} | ms/2^20 rays: "
                 f"cuda {ms_k:.3f} xla {ms_x:.3f} {'PASS' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{sname}/{label}")
    if failures:
        raise SmokeFailure(f"kernel parity failed: {failures}")


def child_images(out_dir: Path) -> None:
    """Render the phase-5 scenes on this process's platform into EXRs."""
    import jax

    from tpu_raytracing import backend
    from tpu_raytracing.cli import save_render_output
    from tpu_raytracing.integrator.render import render
    from tpu_raytracing.scene.test_scenes import get_test_scene
    from tpu_raytracing.settings import AovFlags

    backend.setup_compile_cache()
    out_dir.mkdir(parents=True, exist_ok=True)
    _log(f"platform {jax.devices()[0].platform}")
    flags = {"beauty": AovFlags.BEAUTY, "normals": AovFlags.NORMALS,
             "uv": AovFlags.UV_COORDS}
    for name, over, outputs in IMAGE_SCENES:
        ts = get_test_scene(name)
        settings = ts.settings_func()
        settings.samples_per_pixel = over.get("spp", settings.samples_per_pixel)
        settings.max_ray_depth = over.get("depth", settings.max_ray_depth)
        settings.outputs = AovFlags.NONE
        for aov in outputs:
            settings.outputs |= flags[aov]
        t0 = time.perf_counter()
        out = render(ts.scene_func(), settings)
        for aov in outputs:
            save_render_output(out, flags[aov], "exr",
                               out_dir / f"{name}_{aov}.exr")
        _log(f"{name}: {time.perf_counter() - t0:.3f}s")


def child_four(out_dir: Path) -> None:
    """The (tiles, spp) mesh of parallel/mesh.py (what `cli ... full
    --multichip` runs) on four GPUs, against the one-card path users run
    (integrator.render: the whole frame in one 250,000-lane dispatch).
    Both mesh images must pass the statistical gate against it. The
    (tiles=4, spp=1) image is also compared bit for bit, reported and not
    required: XLA:GPU compiles a quarter-frame shard into other fusions
    than the whole frame, so some pixels differ in their last bits and a
    few Monte-Carlo paths diverge (scripts/gpu_width_probe.py). What
    sharding itself must keep exact is checked at equal width: the same
    sharded step on one card over the four 62,500-pixel shards gives the
    (tiles=4, spp=1) image bit for bit."""
    import statistics

    import numpy as np

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_raytracing.device import compile_scene
    from tpu_raytracing.integrator.render import StaticSettings, render
    from tpu_raytracing.ops.rng import SamplerConfig
    from tpu_raytracing.parallel.mesh import (
        TILE_AXIS, make_render_mesh, make_sharded_step,
    )
    from tpu_raytracing.scene.test_scenes import coated_diffuse_bunny_scene
    from tpu_raytracing.settings import AovFlags, RaytracerSettings
    from visual_testing.rttest.diff import compare_arrays

    devs = _gpu_setup(out_dir, 4)
    settings = RaytracerSettings(samples_per_pixel=8, max_ray_depth=8,
                                 light_sample_count=1,
                                 outputs=AovFlags.BEAUTY)
    ds = compile_scene(coated_diffuse_bunny_scene())
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    w, h = ds.meta.width, ds.meta.height
    gx, gy = np.meshgrid(np.arange(w, dtype=np.uint32),
                         np.arange(h, dtype=np.uint32))
    px, py = gx.reshape(-1), gy.reshape(-1)
    n = px.shape[0]
    if n % 4:
        raise SmokeFailure(f"{n} pixels do not split into 4 equal tiles")

    def timed(label, frame):
        frame()  # compile + warm
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            img, rays = frame()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        _log(f"four: {label}: wall {wall:.4f}s (median of 3) {rays} rays "
             f"{rays / wall / 1e6:.2f} Mrays/s")
        return img, wall

    def production():
        out = render(ds, settings)
        return out.beauty, out.rays_traced

    def mesh(n_tiles, n_spp, devices, parts):
        m = make_render_mesh(n_tiles=n_tiles, n_spp=n_spp, devices=devices)
        step = make_sharded_step(ds, cfg, st, m)
        shard = NamedSharding(m, P(TILE_AXIS))
        args = [tuple(jax.device_put(jnp.asarray(a), shard)
                      for a in (px[k], py[k], np.ones(k.shape[0], bool)))
                for k in np.array_split(np.arange(n), parts)]

        def frame():
            outs = [step(*a) for a in args]
            img = np.concatenate([np.asarray(r) for r, _ in outs])
            return img.reshape(h, w, 3), sum(int(c) for _, c in outs)
        return frame

    one, w1 = timed(f"one card, integrator.render (1 x {n:,} lanes)",
                    production)
    t4, w4 = timed(f"mesh tiles=4 spp=1 ({n // 4:,} lanes per card)",
                   mesh(4, 1, devs[:4], 1))
    t2s2, w22 = timed(f"mesh tiles=2 spp=2 ({n // 2:,} lanes per card)",
                      mesh(2, 2, devs[:4], 1))
    eq, _ = timed(f"one card, sharded step (4 x {n // 4:,} lanes)",
                  mesh(1, 1, devs[:1], 4))
    _log(f"four: speedup over one card: tiles=4 {w1 / w4:.2f}x, tiles=2 x "
         f"spp=2 {w1 / w22:.2f}x")
    failed = []
    for label, img in (("tiles=4 spp=1", t4), ("tiles=2 spp=2", t2s2)):
        d = compare_arrays(img, one)
        ok = d.stat_passes()
        _log(f"four: ({label}) vs one card: bit-identical "
             f"{bool(np.array_equal(img, one))}, pixels differing "
             f"{int(np.any(img != one, axis=-1).sum())} of {n}, max |diff| "
             f"{d.max_diff:.4g}, rel_mean {d.rel_mean:.2e} block_rel "
             f"{d.block_rel:.2e} gate {'PASS' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{label} gate")
    same = bool(np.array_equal(t4, eq))
    _log(f"four: (tiles=4 spp=1) vs one card at equal width: bit-identical "
         f"{same} (max |diff| {float(np.max(np.abs(t4 - eq))):.4g})")
    if not same:
        failed.append("equal-width bit identity")
    if failed:
        raise SmokeFailure(f"four-card mesh check failed: {failed}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    ap.add_argument("--child", choices=("parity", "images", "four"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is None:
        return main_parent(args.four)
    child = {"parity": child_parity, "images": child_images,
             "four": child_four}[args.child]
    try:
        child(args.out)
    except SmokeFailure as e:
        _log(f"FAILED: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
