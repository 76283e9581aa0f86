"""Octree-pyramid preprocessing and the frame dataset.

Port of linr_pcgc_tpu/data/dataset.py.  Per frame: subtract the coordinate
minimum, dedup + canonical sort, then downsample until the parent count
drops below ``min_point_num`` (default 64) or ``scale_num`` levels exist,
recording per level the parent coordinates, 8-bit occupancy and packed
7-neighbor feature code.  The geometry runs in torch on the dataset's
device; the levels are kept as bucket-padded numpy arrays (the codec
uploads what it needs), and the npz cache format is the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os
import zipfile

import numpy as np
import torch

from ..device import resolve_device
from ..ops.coords import coord_key, key_to_coord
from ..ops.octree import neighbor_feature_code, neighbor_map, octree_down
from .ply import read_ply

MIN_POINT_NUM = 64


def bucket_size(n: int) -> int:
    """Padded size for a level of n valid rows (~4 buckets per octave).
    Both codec sides derive shapes from it, so it is part of the format:
    rANS segment lengths follow from these buckets."""
    if n <= 1024:
        return 1024
    p = 1 << (int(n - 1).bit_length() - 1)
    step = max(1024, p // 4)
    return ((n + step - 1) // step) * step


@dataclasses.dataclass
class LevelData:
    """One pyramid level: the parents at scale ``scale_idx`` (all arrays
    padded to a bucket; ``n`` valid rows)."""

    coords: np.ndarray      # (B, 3) int32
    occ: np.ndarray         # (B, 8) uint8
    feat_code: np.ndarray   # (B,) int32 in [0, 128)
    n: int

    @property
    def bucket(self) -> int:
        return self.coords.shape[0]


@dataclasses.dataclass
class FramePyramid:
    levels: list            # [LevelData], index 0 = parents of the original
    point_num: int          # unique points in the original cloud
    coord_min: np.ndarray   # (3,) int32 subtracted from raw coordinates
    low_bits_estimate: int

    @property
    def scale_num(self) -> int:
        return len(self.levels)

    @property
    def low_coords(self) -> np.ndarray:
        """Lowest-scale cloud (the base layer payload)."""
        lev = self.levels[-1]
        return lev.coords[: lev.n]


def level_arrays_from_coords(coords_np: np.ndarray, n: int, kernel_size: int = 3,
                             dilations: tuple = (1,), device=None):
    """Device prep of a level from its (padded, sorted) coords: (coords,
    keys, neighbour feature code, k^3 neighbour map (B, D * kvol) int32),
    the per-dilation maps stacked along the map's K axis, dilation 1 first.
    Runs on the card unless the caller asks for the CPU."""
    coords = torch.as_tensor(np.asarray(coords_np, np.int32), device=resolve_device(device))
    keys = coord_key(coords, torch.arange(coords.shape[0], device=coords.device) < n)
    code = neighbor_feature_code(coords, keys)
    nbr = torch.cat([neighbor_map(coords, keys, kernel_size, d) for d in dilations], dim=1)
    return coords, keys, code, nbr


def build_pyramid(
    points: np.ndarray,
    scale_num: int | None = None,
    min_point_num: int = MIN_POINT_NUM,
    device=None,
) -> FramePyramid:
    """Build the preprocessing pyramid of one frame with the torch octree
    ops on ``device`` (the card unless the caller asks for the CPU);
    integer-equal to the JAX package's pyramid."""
    dev = resolve_device(device)
    pts = np.asarray(points)[:, :3]
    coord_min = pts.min(axis=0).astype(np.int32)
    q = torch.as_tensor((pts - coord_min).astype(np.int64), device=dev)
    keys = torch.unique((q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2])
    cur = key_to_coord(keys)
    point_num = len(cur)

    levels: list[LevelData] = []
    max_levels = scale_num if scale_num is not None else 100000
    for s_idx in range(max_levels):
        pc, pk, occ, n_p = octree_down(cur, coord_key(cur), len(cur))
        parents = pc[:n_p]
        code = neighbor_feature_code(parents, pk[:n_p])
        pb = bucket_size(n_p)
        lev = LevelData(
            coords=np.zeros((pb, 3), np.int32),
            occ=np.zeros((pb, 8), np.uint8),
            feat_code=np.zeros((pb,), np.int32),
            n=n_p,
        )
        lev.coords[:n_p] = parents.cpu().numpy()
        lev.occ[:n_p] = occ[:n_p].cpu().numpy()
        lev.feat_code[:n_p] = code.cpu().numpy()
        levels.append(lev)
        if n_p < min_point_num or s_idx == max_levels - 1:
            low = lev.coords[:n_p]
            break
        cur = parents

    # base-layer size estimate (same bookkeeping as the JAX package)
    bitdepth_q = int(np.ceil(np.log2(low.max() + 1))) if low.size else 1
    max_point_num = (2**bitdepth_q) ** 3
    enc_point_num = min(n_p, max_point_num - n_p)
    low_bits = enc_point_num * bitdepth_q * 3

    return FramePyramid(
        levels=levels,
        point_num=point_num,
        coord_min=coord_min,
        low_bits_estimate=low_bits,
    )


# ------------------------------------------------------------------ cache --


def _cache_path(handle_dir: str, name: str) -> str:
    return os.path.join(handle_dir, os.path.splitext(name)[0] + ".npz")


def save_pyramid(path: str, pyr: FramePyramid) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "point_num": np.int64(pyr.point_num),
        "coord_min": pyr.coord_min,
        "low_bits": np.int64(pyr.low_bits_estimate),
        "scale_num": np.int64(pyr.scale_num),
    }
    for i, lev in enumerate(pyr.levels):
        payload[f"coords_{i}"] = lev.coords[: lev.n]
        payload[f"occ_{i}"] = np.packbits(lev.occ[: lev.n], axis=1)
        payload[f"code_{i}"] = lev.feat_code[: lev.n].astype(np.uint8)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_pyramid(path: str) -> FramePyramid:
    with np.load(path) as z:
        scale_num = int(z["scale_num"])
        levels = []
        for i in range(scale_num):
            c = z[f"coords_{i}"]
            n = len(c)
            b = bucket_size(n)
            coords = np.zeros((b, 3), np.int32)
            coords[:n] = c
            occ = np.zeros((b, 8), np.uint8)
            occ[:n] = np.unpackbits(z[f"occ_{i}"], axis=1, count=8)
            code = np.zeros((b,), np.int32)
            code[:n] = z[f"code_{i}"]
            levels.append(LevelData(coords=coords, occ=occ, feat_code=code, n=n))
        return FramePyramid(
            levels=levels,
            point_num=int(z["point_num"]),
            coord_min=z["coord_min"],
            low_bits_estimate=int(z["low_bits"]),
        )


class PyramidDataset:
    """Directory-of-frames dataset with npz caching.  ``source`` is a
    directory of .ply/.npy files or a list of numpy coordinate arrays.
    Pyramids are built on ``device``: the card unless the caller asks for
    the CPU."""

    def __init__(
        self,
        source,
        handle_dir: str | None = None,
        scale_num: int | None = None,
        ori_type: str = "ply",
        min_point_num: int = MIN_POINT_NUM,
        device=None,
    ):
        self.handle_dir = handle_dir
        self.scale_num = scale_num
        self.min_point_num = min_point_num
        self.ori_type = ori_type
        self.device = resolve_device(device)
        self._arrays = None
        if isinstance(source, (list, tuple)):
            self._arrays = list(source)
            self.names = [f"frame{idx:04d}" for idx in range(len(source))]
        else:
            names = sorted(
                n
                for n in os.listdir(source)
                if n.endswith("." + ori_type)
                and not os.path.isdir(os.path.join(source, n))
            )
            if not names:
                raise ValueError(f"no .{ori_type} files in {source}")
            self.names = names
            self.source_dir = source
        if handle_dir is not None:
            os.makedirs(handle_dir, exist_ok=True)
        self._mem_cache: dict[int, FramePyramid] = {}

    def __len__(self):
        return len(self.names)

    def _raw_points(self, idx: int) -> np.ndarray:
        if self._arrays is not None:
            return self._arrays[idx]
        path = os.path.join(self.source_dir, self.names[idx])
        if self.ori_type == "npy":
            return np.load(path)
        return read_ply(path)

    def raw_sorted_points(self, idx: int) -> np.ndarray:
        """Original coordinates, deduped + canonically sorted, without
        min-subtraction (the decoder's ground truth)."""
        pts = np.unique(self._raw_points(idx)[:, :3].astype(np.int64), axis=0)
        return pts.astype(np.int32)

    def __getitem__(self, idx: int) -> FramePyramid:
        if idx in self._mem_cache:
            return self._mem_cache[idx]
        pyr = None
        if self.handle_dir is not None:
            path = _cache_path(self.handle_dir, self.names[idx])
            if os.path.exists(path):
                try:
                    pyr = load_pyramid(path)
                except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
                    os.remove(path)  # corrupted cache: regenerate
                    pyr = None
        if pyr is None:
            pyr = build_pyramid(
                self._raw_points(idx), self.scale_num, self.min_point_num,
                self.device,
            )
            if self.handle_dir is not None:
                save_pyramid(_cache_path(self.handle_dir, self.names[idx]), pyr)
        if self.scale_num is None:
            self.scale_num = pyr.scale_num
        self._mem_cache[idx] = pyr
        return pyr

    def drop_mem_cache(self):
        self._mem_cache.clear()
