"""One level on the 4^3 brick grid, as the bricks trainer takes it.

Port of linr_pcgc_tpu/ops/bricks.py.  The brick grid is the superbrick
layout's at side 4 (ops/superbricks.build_superbrick_level), so this module
keeps only the JAX level's view of it: the slot mask, and its own copy of
the constants.  Brick order is canonical (lexicographic by brick
coordinate), slot s = (x & 3) << 4 | (y & 3) << 2 | (z & 3), nbr27 in the
lexicographic 27-offset order with -1 where the brick is absent.
Integer-exact numpy on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .superbricks import build_superbrick_level

BRICK = 4
SLOTS = BRICK**3
EMPTY_CODE_SENTINEL = -1  # scale_code of an unoccupied slot


@dataclasses.dataclass
class BrickLevel:
    """One scale's brick grid (numpy, trimmed to n_bricks)."""

    brick_coords: np.ndarray  # (Bb, 3) int32, canonical order
    nbr27: np.ndarray         # (Bb, 27) int32 brick-neighbour map, -1 absent
    slot_mask: np.ndarray     # (Bb, 64) bool, occupied voxel slots
    scale_code: np.ndarray    # (Bb, 64) int32, scale*128+feat_code, -1 empty
    occ: np.ndarray           # (Bb, 8, 64) uint8 ground-truth child occupancy
    voxel_brick: np.ndarray   # (n_vox,) int32 brick index per voxel
    voxel_slot: np.ndarray    # (n_vox,) int32 slot per voxel
    n_vox: int

    @property
    def n_bricks(self) -> int:
        return self.brick_coords.shape[0]


def build_brick_level(coords: np.ndarray, occ: np.ndarray, feat_code: np.ndarray,
                      scale_idx: int) -> BrickLevel:
    """Brickify one level: coords (n, 3), occ (n, 8) and feat_code (n,),
    trimmed and in canonical voxel order."""
    lev = build_superbrick_level(coords, occ, feat_code, scale_idx, side=BRICK)
    return BrickLevel(
        brick_coords=lev.brick_coords,
        nbr27=lev.nbr27,
        slot_mask=lev.scale_code != EMPTY_CODE_SENTINEL,
        scale_code=lev.scale_code,
        occ=lev.occ,
        voxel_brick=lev.voxel_brick,
        voxel_slot=lev.voxel_slot,
        n_vox=lev.n_vox,
    )
