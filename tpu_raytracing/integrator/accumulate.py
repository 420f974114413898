"""Checkpointed high-spp accumulation (an extension noted in SURVEY.md §5:
the reference has no checkpoint/resume — renders are one-shot).

For 1024-spp-class renders (BASELINE config 5) the sample loop runs in spp
chunks; after every chunk the accumulator can be dumped to disk, and an
interrupted render resumes from the last chunk. Sample indices are absolute,
so the set of samples is identical to a one-shot render; only the f32
summation association differs (chunk partial sums), deterministically for a
fixed chunk size.
"""
from __future__ import annotations

import hashlib
import json
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np

import jax.numpy as jnp

from ..device import DeviceScene, compile_scene
from ..ops.rng import SamplerConfig
from ..settings import AovFlags, RaytracerSettings, RenderOutput
from .render import StaticSettings, _pixel_grid, _run_chunked, trace_radiance

log = logging.getLogger("tpu_raytracing")


def _settings_fingerprint(settings: RaytracerSettings, ds: DeviceScene) -> str:
    blob = json.dumps(
        {
            "spp": settings.samples_per_pixel,
            "depth": settings.max_ray_depth,
            "lights": settings.light_sample_count,
            "seed": settings.seed,
            "sampler": repr(settings.sampler),
            "accumulate": settings.accumulate_bounces,
            "wh": [ds.meta.width, ds.meta.height],
            "tris": ds.meta.n_tris,
            "layout": "morton1",  # accumulator pixel ordering
        },
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def render_accumulated(
    scene_or_device,
    settings: RaytracerSettings,
    spp_chunk: int = 32,
    checkpoint_path: Optional[Path] = None,
    chunk_pixels: Optional[int] = None,
    on_chunk=None,
) -> RenderOutput:
    """Beauty render accumulated in spp chunks with optional resume.

    on_chunk(image (H, W, 3), spp_done) is called after every chunk with
    the current partial average — the progressive-refinement hook the
    viewer uses (reference viewer re-render loop,
    crates/viewer/src/render_output_view.rs:84-97).
    """
    ds = (
        scene_or_device
        if isinstance(scene_or_device, DeviceScene)
        else compile_scene(scene_or_device)
    )
    cfg = SamplerConfig.from_settings(settings.sampler, settings.seed)
    width, height = ds.meta.width, ds.meta.height
    total_spp = settings.samples_per_pixel
    spp_chunk = min(spp_chunk, total_spp)
    fingerprint = _settings_fingerprint(settings, ds)

    accum = np.zeros((height * width, 3), np.float32)
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
                log.info("resuming from checkpoint: %d/%d spp", spp_done, total_spp)
            else:
                log.warning("checkpoint does not match settings; starting fresh")

    st = StaticSettings.from_settings(settings)
    px, py, unmorton = _pixel_grid(width, height)

    import jax
    from functools import partial

    @partial(jax.jit, static_argnums=(1, 2, 3))
    def chunk_fn(ds_, cfg_, st_, n_samples, s0, px_, py_, act_):
        def body(i, carry):
            acc, rays = carry
            s = s0 + jnp.uint32(i)
            r, n = trace_radiance(ds_, cfg_, st_, px_, py_, s, active=act_)
            return acc + r, rays + n

        return jax.lax.fori_loop(
            0, n_samples, body,
            (jnp.zeros((px_.shape[0], 3), jnp.float32), jnp.zeros((), jnp.int32)),
        )

    while spp_done < total_spp:
        t0 = time.perf_counter()
        s0 = jnp.uint32(spp_done)
        # Final chunk may be short when total_spp % spp_chunk != 0; a second
        # jitted specialization keeps shapes/trip counts static.
        this_chunk = min(spp_chunk, total_spp - spp_done)
        # ray counts stay device scalars until after the pixel-chunk
        # loop: an int() here would block each dispatch and serialize
        # the async chunk pipeline _run_chunked builds
        rays_dev = []

        def run(a, b, act):
            r, n = chunk_fn(ds, cfg, st, this_chunk, s0, a, b, act)
            rays_dev.append(n)
            return r

        (partial_sum,) = _run_chunked(run, px, py, 1, chunk_pixels)
        accum = accum + partial_sum
        rays_total += int(np.asarray(jnp.stack(rays_dev)).sum())
        spp_done += this_chunk
        log.info(
            "accumulated %d/%d spp (%.2fs)", spp_done, total_spp,
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
                (accum[unmorton] / np.float32(spp_done)).reshape(
                    height, width, 3
                ),
                spp_done,
            )

    out = RenderOutput(width=width, height=height)
    out.beauty = (
        (accum[unmorton] / np.float32(total_spp)).reshape(height, width, 3)
    )
    out.rays_traced = rays_total
    return out
