"""EXR image comparison (parity: visual-testing/src/rttest/diff.py).

Loads the channel group present in both images — preference order RGB,
Normal.XYZ, Albedo.XYZ, UV — and reports MSE plus max absolute difference.
Pass iff mse <= tolerance; the default tolerance 0.0 demands bit-exact
output, which deterministic seeded rendering guarantees.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from tpu_raytracing.utils.exr import read_exr

CHANNEL_GROUPS = [
    ("RGB", ["R", "G", "B"]),
    ("Normal", ["Normal.X", "Normal.Y", "Normal.Z"]),
    ("Albedo", ["Albedo.X", "Albedo.Y", "Albedo.Z"]),
    ("UV", ["U", "V"]),
]


def load_exr_channels(path: Path) -> Tuple[str, np.ndarray]:
    """(group name, (H, W, C) array) for the first available channel group."""
    channels, width, height = read_exr(path)
    for group_name, names in CHANNEL_GROUPS:
        if all(n in channels for n in names):
            stacked = np.stack([channels[n] for n in names], axis=-1)
            return group_name, stacked
    raise ValueError(
        f"{path}: no known channel group (have {sorted(channels)})"
    )


@dataclass
class DiffResult:
    mse: float
    max_diff: float
    channel_group: str
    rel_mean: float = 0.0  # |mean(t(out)) - mean(t(ref))| / mean(t(ref)),
    # t = Reinhard x/(1+x) on clamped-nonnegative values (bounded stat)
    block_rel: float = 0.0  # max over an 8x8 block grid of
    # |mean(t(out)_blk) - mean(t(ref)_blk)| / mean(t(ref)) — catches
    # spatially-wrong but energy-preserving regressions (shifted/flipped
    # geometry, region channel swaps) that a global mean cannot see

    def passes(self, tolerance: float) -> bool:
        return self.mse <= tolerance

    # Cross-backend (GPU vs CPU-blessed) statistical gate. Per BASELINE.md:
    # per-pixel beauty differences at low spp are chaotic Monte-Carlo path
    # divergence seeded by FMA-contraction ULPs — unbiased, so the image
    # MEAN must still agree tightly — while first-hit AOV groups are
    # deterministic up to silhouette hit/miss flips (sphere normals MSE
    # 1.7e-3 measured), so they get a small absolute MSE bound.
    STAT_AOV_MSE = 5.0e-3
    # Defaults sit a few times above the measured GPU-vs-CPU envelope
    # (H100 vs CPU over the chip_smoke.py image scenes: rel_mean <= 2e-5,
    # block_rel <= 3.7e-4; CHANGES.md), so a ~1% energy regression or a
    # spatially wrong image FAILS instead of hiding under Monte-Carlo
    # noise.
    STAT_REL_MEAN = 0.005
    STAT_BLOCK_REL = 0.002
    # explicit --tolerance overrides keep the old factor-based block
    # bound (per-block MC noise is ~sqrt(n_blocks) larger than the
    # global mean's)
    BLOCK_TOL_FACTOR = 3.0

    def stat_passes(
        self,
        rel_mean_tol: float | None = None,
        block_rel_tol: float | None = None,
    ) -> bool:
        if self.channel_group == "RGB":
            tol = (
                rel_mean_tol if rel_mean_tol is not None
                else self.STAT_REL_MEAN
            )
            if block_rel_tol is not None:
                btol = block_rel_tol
            elif rel_mean_tol is not None:
                btol = self.BLOCK_TOL_FACTOR * rel_mean_tol
            else:
                btol = self.STAT_BLOCK_REL
            return self.rel_mean <= tol and self.block_rel <= btol
        return self.mse <= self.STAT_AOV_MSE


def compare_images(output_path: Path, reference_path: Path) -> DiffResult:
    out_group, out = load_exr_channels(output_path)
    ref_group, ref = load_exr_channels(reference_path)
    if out_group != ref_group:
        raise ValueError(
            f"channel group mismatch: output has {out_group}, "
            f"reference has {ref_group}"
        )
    return compare_arrays(out, ref, out_group)


def compare_arrays(out: np.ndarray, ref: np.ndarray,
                   channel_group: str = "RGB") -> DiffResult:
    """DiffResult of two (H, W, C) images of one channel group."""
    if out.shape != ref.shape:
        raise ValueError(f"shape mismatch: {out.shape} vs {ref.shape}")
    d = out.astype(np.float64) - ref.astype(np.float64)
    # cross-backend HDR means are dominated by rare near-singular paths
    # (1/d^2 light spikes, F/cos grazing reflections) whose backend
    # assignment is ULP-chaotic; compare means through a bounded Reinhard
    # tonemap t(x) = x/(1+x) on non-negative values so the statistic has
    # finite variance and converges at test spp
    a = np.maximum(out.astype(np.float64), 0.0)
    b = np.maximum(ref.astype(np.float64), 0.0)
    ta, tb = a / (1.0 + a), b / (1.0 + b)
    tb_mean = float(np.mean(tb))
    return DiffResult(
        mse=float(np.mean(d * d)),
        max_diff=float(np.max(np.abs(d))) if d.size else 0.0,
        channel_group=channel_group,
        rel_mean=float(
            abs(np.mean(ta) - tb_mean) / max(tb_mean, 1e-9)
        ),
        block_rel=_block_rel(ta, tb, tb_mean),
    )


def _block_rel(ta: np.ndarray, tb: np.ndarray, tb_mean: float,
               grid: int = 8) -> float:
    """Max tonemapped block-mean deviation over a grid x grid tiling,
    normalized by the global reference mean (so dark blocks don't blow
    up the statistic)."""
    denom = max(tb_mean, 1e-9)
    worst = 0.0
    for rows_a, rows_b in zip(
        np.array_split(ta, grid, axis=0), np.array_split(tb, grid, axis=0)
    ):
        for blk_a, blk_b in zip(
            np.array_split(rows_a, grid, axis=1),
            np.array_split(rows_b, grid, axis=1),
        ):
            if blk_a.size == 0:
                continue
            worst = max(
                worst, abs(float(np.mean(blk_a) - np.mean(blk_b))) / denom
            )
    return worst
