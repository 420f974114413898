"""Multi-chip sharded rendering over a (tiles, spp) device mesh.

Replacement for the reference's two parallel mechanisms (SURVEY.md §2.7):
the CPU backend's mutex tile work-queue
(raytracing-cpu/src/lib.rs:481-504,705-805) becomes data parallelism over a
``tiles`` mesh axis (deterministic tile -> device assignment instead of work
stealing), and high-spp renders additionally shard the sample loop over an
``spp`` axis whose partial sums are combined with an all-reduce
(``jax.lax.psum``; NCCL between GPUs). The mesh is a plain reshape of the
device list: on a host whose cards are joined all to all (NVLink), any
device order serves equally.

Determinism contract: RNG streams are keyed by (pixel, sample), never by
worker (ops/rng.py), so images are bit-identical for any ``tiles`` sharding
— the same property the reference guarantees across thread counts
(visual-testing/README.md:103). On GPUs it holds at equal per-device
width: XLA:GPU compiles other fusions for other array lengths, so a tile
sharding differs from one card in the last bits of some pixels and in a
few diverged paths, and agrees with it statistically (chip_smoke.py
--four). Sharding ``spp`` changes only the floating-point summation order
of per-sample radiance.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..device import DeviceScene, compile_scene
from ..integrator.render import StaticSettings, trace_radiance
from ..ops.rng import SamplerConfig
from ..settings import AovFlags, RaytracerSettings, RenderOutput

TILE_AXIS = "tiles"
SPP_AXIS = "spp"


def make_render_mesh(
    n_tiles: Optional[int] = None,
    n_spp: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """A (tiles, spp) mesh over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_tiles is None:
        n_tiles = len(devices) // n_spp
    if n_tiles * n_spp != len(devices):
        raise ValueError(
            f"mesh {n_tiles}x{n_spp} != device count {len(devices)}"
        )
    dev_grid = np.asarray(devices).reshape(n_tiles, n_spp)
    return Mesh(dev_grid, (TILE_AXIS, SPP_AXIS))


def make_sharded_step(
    ds: DeviceScene,
    cfg: SamplerConfig,
    st: StaticSettings,
    mesh: Mesh,
):
    """jit-compiled sharded render step: (px, py) -> (radiance, rays).

    px/py are sharded over ``tiles``; each spp-shard accumulates its
    contiguous block of sample indices and the blocks are psum-reduced, so
    chip count only affects fp summation order, not which samples exist.
    """
    n_spp_shards = mesh.shape[SPP_AXIS]
    if st.samples_per_pixel % n_spp_shards != 0:
        raise ValueError(
            f"samples_per_pixel={st.samples_per_pixel} not divisible by "
            f"spp mesh axis {n_spp_shards}"
        )
    spp_per = st.samples_per_pixel // n_spp_shards
    inv_spp = np.float32(1.0 / st.samples_per_pixel)

    # The scene is a runtime ARGUMENT (replicated over the mesh), never a
    # closure: closed-over arrays become XLA constants, which the compiler
    # folds/fuses differently from runtime buffers — a measured ~1-ULP
    # per-pixel divergence vs the single-device drivers (which pass ds as a
    # traced jit argument). Keeping every driver on the argument
    # convention is what makes "bit-identical for any tile sharding" hold.
    def shard_fn(ds_, px, py, active):
        spp_rank = jax.lax.axis_index(SPP_AXIS)

        def body(i, carry):
            acc, rays = carry
            s = (spp_rank * spp_per + i).astype(jnp.uint32)
            r, n = trace_radiance(ds_, cfg, st, px, py, s, active=active)
            return acc + r, rays + n

        total, rays = jax.lax.fori_loop(
            0, spp_per, body,
            (jnp.zeros((px.shape[0], 3), jnp.float32), jnp.zeros((), jnp.int32)),
        )
        total = jax.lax.psum(total, SPP_AXIS)
        rays = jax.lax.psum(rays, (TILE_AXIS, SPP_AXIS))
        return total * inv_spp, rays

    mapped = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS)),
        out_specs=(P(TILE_AXIS), P()),
        check_vma=False,
    )
    jitted = jax.jit(mapped)
    ds_repl = jax.device_put(ds, NamedSharding(mesh, P()))
    return lambda px, py, active: jitted(ds_repl, px, py, active)


def render_distributed(
    scene_or_device,
    settings: RaytracerSettings,
    mesh: Optional[Mesh] = None,
    n_spp_shards: int = 1,
) -> RenderOutput:
    """Full-frame beauty render sharded over a device mesh.

    The pixel grid is padded to a multiple of the tile axis; every device
    renders its contiguous slice (deterministic assignment). AOV passes are
    single-device (cheap) — use integrator.render for them.
    """
    ds = (
        scene_or_device
        if isinstance(scene_or_device, DeviceScene)
        else compile_scene(scene_or_device)
    )
    if mesh is None:
        mesh = make_render_mesh(n_spp=n_spp_shards)
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    step = make_sharded_step(ds, cfg, st, mesh)

    width, height = ds.meta.width, ds.meta.height
    xs = np.arange(width, dtype=np.uint32)
    ys = np.arange(height, dtype=np.uint32)
    gx, gy = np.meshgrid(xs, ys)
    px, py = gx.reshape(-1), gy.reshape(-1)
    n = px.shape[0]
    n_tiles = mesh.shape[TILE_AXIS]
    pad = (-n) % n_tiles
    # padded lanes carry active=False: they trace nothing and are excluded
    # from the psum'd ray count
    active = np.ones(n + pad, bool)
    if pad:
        px = np.concatenate([px, np.zeros(pad, px.dtype)])
        py = np.concatenate([py, np.zeros(pad, py.dtype)])
        active[n:] = False

    sharding = NamedSharding(mesh, P(TILE_AXIS))
    px_d = jax.device_put(jnp.asarray(px), sharding)
    py_d = jax.device_put(jnp.asarray(py), sharding)
    act_d = jax.device_put(jnp.asarray(active), sharding)
    radiance, rays = step(px_d, py_d, act_d)
    beauty = np.asarray(radiance)[:n].reshape(height, width, 3)

    out = RenderOutput(width=width, height=height)
    if settings.outputs & AovFlags.BEAUTY:
        out.beauty = beauty
    out.rays_traced = int(rays)
    return out


def make_sharded_accum_step(
    ds: DeviceScene,
    cfg: SamplerConfig,
    st: StaticSettings,
    mesh: Mesh,
    n_samples: int,
):
    """Sharded accumulation step: (s0, px, py, active) -> (sum, rays).

    Accumulates samples [s0, s0 + n_samples) — the mesh-parallel analogue
    of accumulate.py's chunk_fn. With a 1-wide spp axis the per-pixel fori
    summation order is identical to the single-device path, so chunk
    partials (and therefore checkpointed renders) are bit-exact across any
    tile sharding.
    """
    n_spp_shards = mesh.shape[SPP_AXIS]
    if n_samples % n_spp_shards != 0:
        raise ValueError(
            f"chunk samples {n_samples} not divisible by spp axis "
            f"{n_spp_shards}"
        )
    per = n_samples // n_spp_shards

    # ds is a runtime argument, not a closure — see make_sharded_step.
    def shard_fn(ds_, s0, px, py, active):
        spp_rank = jax.lax.axis_index(SPP_AXIS)

        def body(i, carry):
            acc, rays = carry
            s = s0 + (spp_rank * per + i).astype(jnp.uint32)
            r, n = trace_radiance(ds_, cfg, st, px, py, s, active=active)
            return acc + r, rays + n

        total, rays = jax.lax.fori_loop(
            0, per, body,
            (jnp.zeros((px.shape[0], 3), jnp.float32),
             jnp.zeros((), jnp.int32)),
        )
        total = jax.lax.psum(total, SPP_AXIS)
        rays = jax.lax.psum(rays, (TILE_AXIS, SPP_AXIS))
        return total, rays

    mapped = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS)),
        out_specs=(P(TILE_AXIS), P()),
        check_vma=False,
    )
    jitted = jax.jit(mapped)
    ds_repl = jax.device_put(ds, NamedSharding(mesh, P()))
    step = lambda s0, px, py, active: jitted(ds_repl, s0, px, py, active)  # noqa: E731
    # introspection handles: lower the jitted fn directly to audit the
    # compiled HLO's collectives
    step.jitted = jitted
    step.ds_repl = ds_repl
    return step


def render_accumulated_distributed(
    scene_or_device,
    settings: RaytracerSettings,
    mesh: Optional[Mesh] = None,
    n_spp_shards: int = 1,
    spp_chunk: int = 32,
    checkpoint_path=None,
    on_chunk=None,
) -> RenderOutput:
    """The north-star composition (BASELINE config 5): a high-spp beauty
    render accumulated in checkpointable spp chunks, each chunk sharded
    over a (tiles, spp) device mesh.

    Sample indices are absolute, so the rendered sample set is identical
    to a one-shot or single-device render; with ``n_spp_shards == 1`` the
    image is bit-exact vs ``integrator.accumulate.render_accumulated`` at
    the same ``spp_chunk`` for ANY tile sharding (tests/test_parallel.py).
    Resume works across different tile counts for the same reason.
    """
    import hashlib
    import json
    import logging
    import time
    from pathlib import Path

    log = logging.getLogger("tpu_raytracing")
    ds = (
        scene_or_device
        if isinstance(scene_or_device, DeviceScene)
        else compile_scene(scene_or_device)
    )
    if mesh is None:
        mesh = make_render_mesh(n_spp=n_spp_shards)
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    width, height = ds.meta.width, ds.meta.height
    total_spp = settings.samples_per_pixel
    spp_chunk = min(spp_chunk, total_spp)

    # distinct layout tag: the distributed accumulator is raster-ordered
    # (render_distributed's padded grid), not morton-ordered
    blob = json.dumps(
        {
            "spp": total_spp, "depth": settings.max_ray_depth,
            "lights": settings.light_sample_count, "seed": settings.seed,
            "sampler": repr(settings.sampler),
            "accumulate": settings.accumulate_bounces,
            "wh": [width, height], "tris": ds.meta.n_tris,
            "layout": "raster-dist1",
        },
        sort_keys=True,
    )
    fingerprint = hashlib.sha256(blob.encode()).hexdigest()[:16]

    xs = np.arange(width, dtype=np.uint32)
    ys = np.arange(height, dtype=np.uint32)
    gx, gy = np.meshgrid(xs, ys)
    px, py = gx.reshape(-1), gy.reshape(-1)
    n = px.shape[0]
    n_tiles = mesh.shape[TILE_AXIS]
    pad = (-n) % n_tiles
    active = np.ones(n + pad, bool)
    if pad:
        px = np.concatenate([px, np.zeros(pad, px.dtype)])
        py = np.concatenate([py, np.zeros(pad, py.dtype)])
        active[n:] = False

    accum = np.zeros((n, 3), np.float32)
    rays_total = 0
    spp_done = 0
    if checkpoint_path is not None:
        checkpoint_path = Path(checkpoint_path)
        if checkpoint_path.exists():
            ck = np.load(checkpoint_path, allow_pickle=False)
            if (
                str(ck["fingerprint"]) == fingerprint
                and int(ck["spp_chunk"]) == spp_chunk
            ):
                accum = ck["accum"]
                spp_done = int(ck["spp_done"])
                rays_total = int(ck["rays"])
                log.info(
                    "resuming from checkpoint: %d/%d spp", spp_done,
                    total_spp,
                )
            else:
                log.warning(
                    "checkpoint does not match settings; starting fresh"
                )

    sharding = NamedSharding(mesh, P(TILE_AXIS))
    px_d = jax.device_put(jnp.asarray(px), sharding)
    py_d = jax.device_put(jnp.asarray(py), sharding)
    act_d = jax.device_put(jnp.asarray(active), sharding)

    steps = {}
    while spp_done < total_spp:
        t0 = time.perf_counter()
        this_chunk = min(spp_chunk, total_spp - spp_done)
        if this_chunk not in steps:
            steps[this_chunk] = make_sharded_accum_step(
                ds, cfg, st, mesh, this_chunk
            )
        partial, rays = steps[this_chunk](
            jnp.uint32(spp_done), px_d, py_d, act_d
        )
        accum = accum + np.asarray(partial)[:n]
        rays_total += int(rays)
        spp_done += this_chunk
        log.info(
            "accumulated %d/%d spp over %dx%d mesh (%.2fs)", spp_done,
            total_spp, n_tiles, mesh.shape[SPP_AXIS],
            time.perf_counter() - t0,
        )
        if checkpoint_path is not None:
            tmp = checkpoint_path.with_suffix(".tmp.npz")
            np.savez(
                tmp, accum=accum, spp_done=spp_done, rays=rays_total,
                fingerprint=fingerprint, spp_chunk=spp_chunk,
            )
            tmp.replace(checkpoint_path)
        if on_chunk is not None:
            on_chunk(
                (accum / np.float32(spp_done)).reshape(height, width, 3),
                spp_done,
            )

    out = RenderOutput(width=width, height=height)
    if settings.outputs & AovFlags.BEAUTY:
        out.beauty = (
            (accum / np.float32(total_spp)).reshape(height, width, 3)
        )
    out.rays_traced = rays_total
    return out


def dryrun_step(mesh: Mesh, n_pixels: int = 256, spp: int = 8) -> np.ndarray:
    """Compile + execute one full sharded render step on tiny shapes.

    Used by the driver's multi-chip dry run: builds a builtin scene, jits
    the sharded step over the given mesh, and runs it once.
    """
    from ..scene.test_scenes import get_test_scene

    ts = get_test_scene("checkered_plane")
    scene = ts.scene_func()
    settings = ts.settings_func()
    settings.samples_per_pixel = spp
    settings.light_sample_count = 1
    settings.max_ray_depth = 2

    ds = compile_scene(scene)
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    st = StaticSettings.from_settings(settings)
    step = make_sharded_step(ds, cfg, st, mesh)

    n_tiles = mesh.shape[TILE_AXIS]
    n_pixels = max(n_pixels, n_tiles)
    n_pixels += (-n_pixels) % n_tiles
    rng = np.random.default_rng(0)
    px = rng.integers(0, ds.meta.width, n_pixels, dtype=np.uint32)
    py = rng.integers(0, ds.meta.height, n_pixels, dtype=np.uint32)
    sharding = NamedSharding(mesh, P(TILE_AXIS))
    px_d = jax.device_put(jnp.asarray(px), sharding)
    py_d = jax.device_put(jnp.asarray(py), sharding)
    act_d = jax.device_put(jnp.ones(n_pixels, bool), sharding)
    radiance, rays = step(px_d, py_d, act_d)
    jax.block_until_ready(radiance)
    return np.asarray(radiance)
