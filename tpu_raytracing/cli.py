"""Command-line frontend (parity: crates/cli/src/main.rs).

Same flag surface and behaviors as the reference CLI so the visual-testing
harness contract holds (SURVEY.md §4): `--scene-path`/`--scene-name`, `-o`,
`--output-format png|exr`, `--backend`, `-t`, `-d`, `-s`, `-l`, `--sampler`,
subcommands `full {--aov n,a,u,m --no-beauty}` / `pixel x y [count]
[offset]` / `list-scenes`, settings precedence builtin-scene <- CLI flags,
EXR channel names R/G/B, Normal.X/Y/Z, Albedo.X/Y/Z, U/V, "Mip Level",
per-AOV suffixed PNGs with beauty exposure 1000, outputs written under
``scenes/output/``.

Backend mapping: the reference's cpu|optix split becomes a JAX platform choice
— ``jax`` (default platform), ``cpu``, ``gpu`` — the renderer itself is
identical (tpu_raytracing/backend.py holds the per-platform policy).
``--num-threads`` is accepted for harness compatibility; on a device renderer
it has no effect beyond host thread pools.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import sys
from pathlib import Path

import numpy as np

from .backend import BACKENDS

log = logging.getLogger("tpu_raytracing")


def _add_common(p: argparse.ArgumentParser, suppress: bool) -> None:
    """Global options, shared by the main parser and every subparser so they
    may appear before or after the subcommand (clap-style interspersal).
    Subparser copies use SUPPRESS defaults so they only override when given."""

    def d(value):
        return argparse.SUPPRESS if suppress else value

    p.add_argument(
        "-i", "--interactive", action="store_true", default=d(False),
        help="Launch interactive TUI for configuration",
    )
    g = p.add_mutually_exclusive_group()
    g.add_argument(
        "--scene-path", type=Path, default=d(None),
        help="Load a scene from disk (GLTF or PBRT)",
    )
    g.add_argument(
        "--scene-name", default=d(None), help="Load a builtin test scene by name"
    )
    p.add_argument(
        "-o", "--output", type=Path, default=d(None),
        help="Output filename (written under scenes/output/)",
    )
    p.add_argument(
        "--output-format", choices=["png", "exr"], default=d(None),
        help="Force output format (otherwise inferred from extension)",
    )
    p.add_argument(
        "--backend", choices=list(BACKENDS), default=d("jax"),
        help="JAX platform to render on (default: what JAX finds; gpu "
        "fails without a GPU)",
    )
    p.add_argument(
        "-t", "--num-threads", type=int, default=d(None),
        help="Host worker threads (compat)",
    )
    p.add_argument(
        "-d", "--ray-depth", type=int, default=d(None),
        help="Maximum ray depth (bounces)",
    )
    p.add_argument("-s", "--spp", type=int, default=d(None), help="Samples per pixel")
    p.add_argument(
        "-l", "--light-samples", type=int, default=d(None), help="Light sample count"
    )
    p.add_argument(
        "--sampler", choices=["independent", "stratified"], default=d(None),
        help="Sampler type",
    )
    p.add_argument(
        "--chunk-pixels", type=int, default=d(None),
        help="Pixels per device dispatch (perf tuning)",
    )
    p.add_argument(
        "--profile", type=Path, default=d(None), metavar="DIR",
        help="Write a jax.profiler trace of the render to DIR",
    )
    p.add_argument(
        "--checkpoint", type=Path, default=d(None), metavar="FILE",
        help="Accumulate spp in chunks, checkpointing to FILE (resumable)",
    )
    p.add_argument(
        "--multichip", action="store_true", default=d(False),
        help="Shard the beauty render over all devices ((tiles, spp) mesh)",
    )
    p.add_argument(
        "--spp-shards", type=int, default=d(1),
        help="spp axis size of the device mesh with --multichip",
    )
    p.add_argument(
        "--spp-chunk", type=int, default=d(32),
        help="Samples per accumulation chunk when --checkpoint is used",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-raytracing",
        description="JAX path tracer (reference-compatible CLI)",
    )
    _add_common(p, suppress=False)

    sub = p.add_subparsers(dest="command")
    full = sub.add_parser("full", help="Full frame render with AOV control")
    _add_common(full, suppress=True)
    full.add_argument(
        "--aov", action="append", default=None,
        help="Comma-separated AOV list (e.g. normal,uv or n,u)",
    )
    full.add_argument(
        "--no-beauty", action="store_true",
        help="Disable beauty output (useful when only AOVs are desired)",
    )
    pixel = sub.add_parser("pixel", help="Render a single pixel and print diagnostics")
    _add_common(pixel, suppress=True)
    pixel.add_argument("x", type=int, help="Pixel x coordinate")
    pixel.add_argument("y", type=int, help="Pixel y coordinate")
    pixel.add_argument("sample_count", type=int, nargs="?", default=1)
    pixel.add_argument("sample_offset", type=int, nargs="?", default=0)
    ls = sub.add_parser("list-scenes", help="List all builtin test scenes as JSON")
    _add_common(ls, suppress=True)
    return p


def _load_scene(args):
    """Return (builtin_settings | None, scene)."""
    from .scene import loaders, test_scenes
    from .settings import RaytracerSettings

    if args.scene_path is not None:
        path = args.scene_path
        ext = path.suffix.lower()
        if ext == ".pbrt":
            return None, loaders.scene_from_pbrt_file(path)
        if ext in (".gltf", ".glb"):
            return None, loaders.scene_from_gltf_file(path)
        log.warning("unrecognized file extension %r, trying to import as gltf", ext)
        return None, loaders.scene_from_gltf_file(path)
    ts = test_scenes.get_test_scene(args.scene_name)
    return ts.settings_func(), ts.scene_func()


def _merge_settings(builtin, args):
    from .sampling import Independent, Stratified
    from .settings import RaytracerSettings

    settings = builtin if builtin is not None else RaytracerSettings()
    if args.ray_depth is not None:
        settings.max_ray_depth = args.ray_depth
    if args.light_samples is not None:
        settings.light_sample_count = args.light_samples
    if args.spp is not None:
        settings.samples_per_pixel = args.spp
    settings.accumulate_bounces = True
    if args.sampler == "independent":
        settings.sampler = Independent()
    elif args.sampler == "stratified":
        strata = int(math.ceil(math.sqrt(settings.samples_per_pixel)))
        settings.sampler = Stratified(jitter=True, x_strata=strata, y_strata=strata)
    return settings


def _apply_aov_flags(settings, args):
    from .settings import AovFlags

    flags = settings.outputs
    for group in args.aov or []:
        for aov in group.split(","):
            aov = aov.strip()
            if aov in ("n", "normal"):
                flags |= AovFlags.NORMALS
            elif aov in ("a", "albedo"):
                flags |= AovFlags.ALBEDO
            elif aov in ("u", "uv"):
                flags |= AovFlags.UV_COORDS
            elif aov in ("m", "mip"):
                flags |= AovFlags.MIP_LEVEL
            elif aov in ("b", "beauty"):
                log.warning("beauty is implicit")
            elif aov:
                log.warning("unknown AOV specified: %s", aov)
    if args.no_beauty:
        flags &= ~AovFlags.BEAUTY
    settings.outputs = flags
    return settings


def _replace_outputs(settings, outputs):
    import copy

    s = copy.copy(settings)
    s.outputs = outputs
    return s


def _add_suffix(path: Path, suffix: str) -> Path:
    return path.parent / f"{path.stem}_{suffix}.png"


def save_render_output(out, flags, output_format, output_path: Path) -> None:
    from .settings import AovFlags

    if output_format is None:
        ext = output_path.suffix.lower().lstrip(".")
        if ext == "png":
            output_format = "png"
        elif ext == "exr":
            output_format = "exr"
        else:
            log.warning("extension not recognized, defaulting to exr")
            output_format = "exr"
    output_path.parent.mkdir(parents=True, exist_ok=True)
    if output_format == "png":
        _save_to_png(out, flags, output_path)
    else:
        _save_to_exr(out, flags, output_path)


def _save_to_png(out, flags, output_path: Path) -> None:
    from .settings import AovFlags
    from .utils.png import normals_to_rgb, save_png, uvs_to_rgb

    if flags & AovFlags.BEAUTY and out.beauty is not None:
        save_png(output_path, out.beauty, exposure=1000.0)
    if flags & AovFlags.NORMALS and out.normals is not None:
        save_png(_add_suffix(output_path, "NORMALS"), normals_to_rgb(out.normals))
    if flags & AovFlags.ALBEDO and out.albedo is not None:
        save_png(_add_suffix(output_path, "ALBEDO"), out.albedo)
    if flags & AovFlags.UV_COORDS and out.uv is not None:
        save_png(_add_suffix(output_path, "UV_COORDS"), uvs_to_rgb(out.uv))
    if flags & AovFlags.MIP_LEVEL:
        log.warning("MIP_LEVEL png output not supported (yet)")


def _save_to_exr(out, flags, output_path: Path) -> None:
    from .settings import AovFlags
    from .utils.exr import write_exr

    channels = {}
    if flags & AovFlags.BEAUTY and out.beauty is not None:
        channels["R"] = out.beauty[..., 0]
        channels["G"] = out.beauty[..., 1]
        channels["B"] = out.beauty[..., 2]
    if flags & AovFlags.NORMALS and out.normals is not None:
        channels["Normal.X"] = out.normals[..., 0]
        channels["Normal.Y"] = out.normals[..., 1]
        channels["Normal.Z"] = out.normals[..., 2]
    if flags & AovFlags.ALBEDO and out.albedo is not None:
        channels["Albedo.X"] = out.albedo[..., 0]
        channels["Albedo.Y"] = out.albedo[..., 1]
        channels["Albedo.Z"] = out.albedo[..., 2]
    if flags & AovFlags.UV_COORDS and out.uv is not None:
        channels["U"] = out.uv[..., 0]
        channels["V"] = out.uv[..., 1]
    if flags & AovFlags.MIP_LEVEL and out.mip_level is not None:
        channels["Mip Level"] = out.mip_level
    write_exr(output_path, channels)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.command == "list-scenes":
        from .scene import test_scenes

        print(json.dumps([s.name for s in test_scenes.all_test_scenes()]))
        return 0

    if args.interactive:
        from . import tui

        new_args = tui.run(args)
        if new_args is None:
            print("Render cancelled.")
            return 0
        args = new_args

    if args.scene_path is None and args.scene_name is None:
        print("error: either --scene-path or --scene-name is required", file=sys.stderr)
        return 1

    from .backend import select_platform

    try:
        select_platform(args.backend)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    from .settings import AovFlags

    builtin_settings, scene = _load_scene(args)
    settings = _merge_settings(builtin_settings, args)

    if args.command == "pixel":
        from .integrator.render import render_single_pixel

        outputs = render_single_pixel(
            scene, settings, args.x, args.y, args.sample_count, args.sample_offset
        )
        for o in outputs:
            print(f"sample {o.sample_index}")
            print(f"hit: {o.hit}")
            print(f"uv: ({o.uv[0]}, {o.uv[1]})")
            print(f"normal: ({o.normal[0]}, {o.normal[1]}, {o.normal[2]})")
            print(f"radiance: ({o.radiance[0]}, {o.radiance[1]}, {o.radiance[2]})")
        return 0

    if args.command == "full":
        settings = _apply_aov_flags(settings, args)

    if settings.outputs == AovFlags.NONE:
        log.warning("no outputs specified (--no-beauty, and no AOVs), quitting...")
        return 0

    from .integrator.render import render

    def do_render():
        if getattr(args, "multichip", False):
            from .parallel import (
                render_accumulated_distributed, render_distributed,
            )

            if args.checkpoint is not None:
                out = render_accumulated_distributed(
                    scene, settings, n_spp_shards=args.spp_shards,
                    spp_chunk=args.spp_chunk,
                    checkpoint_path=args.checkpoint,
                )
            else:
                out = render_distributed(
                    scene, settings, n_spp_shards=args.spp_shards
                )
            if settings.outputs & ~AovFlags.BEAUTY:
                aov_only = render(
                    scene,
                    _replace_outputs(settings, settings.outputs & ~AovFlags.BEAUTY),
                    chunk_pixels=args.chunk_pixels,
                )
                for f in ("normals", "albedo", "uv", "mip_level"):
                    setattr(out, f, getattr(aov_only, f))
            return out
        if args.checkpoint is not None:
            from .integrator.accumulate import render_accumulated
            from .settings import AovFlags as _A

            out = render_accumulated(
                scene, settings, spp_chunk=args.spp_chunk,
                checkpoint_path=args.checkpoint,
                chunk_pixels=args.chunk_pixels,
            )
            if settings.outputs & ~_A.BEAUTY:
                aov_only = render(
                    scene,
                    _replace_outputs(settings, settings.outputs & ~_A.BEAUTY),
                    chunk_pixels=args.chunk_pixels,
                )
                for f in ("normals", "albedo", "uv", "mip_level"):
                    setattr(out, f, getattr(aov_only, f))
            return out
        return render(scene, settings, chunk_pixels=args.chunk_pixels)

    if args.profile is not None:
        import jax

        with jax.profiler.trace(str(args.profile)):
            out = do_render()
        log.info("profiler trace written to %s", args.profile)
    else:
        out = do_render()

    output_folder = Path("scenes/output")
    output_file = output_folder / (args.output or Path("output.exr"))
    save_render_output(out, settings.outputs, args.output_format, output_file)
    log.info("wrote %s", output_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
