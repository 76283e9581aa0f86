"""Synthetic dynamic point-cloud sequences for tests and benchmarks (a
copy of linr_pcgc_tpu/data/synthetic.py, so the port needs nothing of the
JAX package).

Generates voxelized surface-like clouds (noisy deformed spheres) with
frame-to-frame motion, matching the statistics that matter to the codec:
surface sparsity (~2-4 occupied octants per parent), multi-scale structure,
and temporal coherence within a GOP.  Used because the 8iVFB/Owlii/MVUB
datasets are not redistributable inside this repo; the CLI accepts real PLY
directories the same way the reference does.
"""

from __future__ import annotations

import numpy as np


def synthetic_cloud(
    n_points: int = 100_000,
    depth: int = 10,
    seed: int = 0,
    phase: float = 0.0,
) -> np.ndarray:
    """One frame: unique int32 voxel coordinates in [0, 2**depth)."""
    rng = np.random.default_rng(seed)
    side = float(1 << depth)
    v = rng.normal(size=(n_points, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
    # a lumpy, slowly rotating radius field makes the surface non-trivial
    theta = np.arctan2(v[:, 1], v[:, 0]) + phase
    phi = np.arccos(np.clip(v[:, 2], -1, 1))
    bumps = (
        0.12 * np.sin(3 * theta) * np.sin(2 * phi)
        + 0.08 * np.cos(5 * theta + phase)
        + 0.05 * np.sin(7 * phi)
    )
    radius = side * 0.42 * (1.0 + bumps)
    noise = rng.normal(scale=side * 0.002, size=(n_points, 1))
    pts = v * (radius[:, None] + noise) + side / 2
    pts = np.clip(np.round(pts), 0, side - 1).astype(np.int32)
    return np.unique(pts, axis=0)


def smooth_shell(
    n_points: int = 800_000,
    depth: int = 10,
    seed: int = 0,
    phase: float = 0.0,
    bump: float = 0.16,
) -> np.ndarray:
    """A loot-regime frame: a smooth, watertight 2-D shell with ~1 point
    per occupied voxel and NO per-point noise.

    ``synthetic_cloud`` adds voxel-scale radial noise, which puts its
    entropy near ~7 bpp — a regime where child-octant occupancy is barely
    predictable.  Real scans (8iVFB loot: 0.51 bpp converged
    in the upstream LINR-PCGC results) are locally smooth
    surfaces whose occupancy the network CAN predict.  This generator
    reproduces that regime: a low-order bumpy radius field (feature
    wavelength >= ~90 voxels, so locally planar at voxel scale) sampled
    densely enough to seal the shell, then voxelized + deduped.

    The radius is chosen so the shell area lands near ``n_points``
    occupied voxels; ``phase`` drifts the bump field for temporal
    coherence within a GOP (same role as in ``synthetic_cloud``).
    """
    rng = np.random.default_rng(seed)
    side = float(1 << depth)
    # voxelized shell area ~ 4*pi*r^2 * k occupied voxels; k ~= 1.5
    # (empirical: surface diagonality + bump area increase at bump=0.16)
    r0 = np.sqrt(n_points / (4.0 * np.pi * 1.5))
    n_samples = int(n_points * 8)
    # Fibonacci sphere: deterministic, stratified (no sampling holes at 8x)
    i = np.arange(n_samples, dtype=np.float64)
    ga = np.pi * (3.0 - np.sqrt(5.0))
    z = 1.0 - 2.0 * (i + 0.5) / n_samples
    rho = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    th = ga * i
    v = np.stack([rho * np.cos(th), rho * np.sin(th), z], axis=1)
    theta = np.arctan2(v[:, 1], v[:, 0])
    phi = np.arccos(np.clip(v[:, 2], -1, 1))
    # low-order smooth bump field; per-seed random mix keeps sequences
    # distinct, the phase drift keeps frames coherent
    c = rng.normal(scale=1.0, size=6)
    bumps = bump * (
        0.50 * np.sin(3 * theta + phase + c[0])
        + 0.35 * np.cos(5 * theta - 2 * phi + c[1])
        + 0.30 * np.sin(2 * phi * 3 + c[2])
        + 0.25 * np.cos(7 * theta + phi + 0.7 * phase + c[3])
        + 0.20 * np.sin(11 * theta - 3 * phi + c[4] + 0.5 * phase)
        + 0.15 * np.cos(13 * phi + c[5])
    )
    radius = r0 * (1.0 + bumps)
    p = v * radius[:, None] + side / 2
    pts = np.clip(np.floor(p).astype(np.int64), 0, int(side) - 1)
    # dedup via packed keys (row-wise unique on ~6M rows is ~100x slower)
    keys = (pts[:, 0] << (2 * depth)) | (pts[:, 1] << depth) | pts[:, 2]
    keys = np.unique(keys)
    mask_v = (1 << depth) - 1
    out = np.stack(
        [(keys >> (2 * depth)) & mask_v, (keys >> depth) & mask_v,
         keys & mask_v],
        axis=1,
    )
    return out.astype(np.int32)


def smooth_shell_sequence(
    n_frames: int,
    n_points: int = 800_000,
    depth: int = 10,
    seed: int = 0,
):
    """A temporally coherent smooth-shell sequence (loot-like regime)."""
    return [
        smooth_shell(n_points, depth, seed=seed, phase=0.06 * t)
        for t in range(n_frames)
    ]


def synthetic_sequence(
    n_frames: int,
    n_points: int = 100_000,
    depth: int = 10,
    seed: int = 0,
):
    """A temporally coherent sequence of frames (phase drifts per frame)."""
    return [
        synthetic_cloud(n_points, depth, seed=seed, phase=0.08 * t)
        for t in range(n_frames)
    ]
