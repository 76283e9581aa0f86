"""Octree level ops in torch: down/up, neighbor feature codes and maps.

Port of linr_pcgc_tpu/ops/octree.py, with the same semantics:

  * parent of child c is floor(c / 2); parents are deduped and kept in
    canonical (lexicographic) order;
  * octant of a child is ``4*(x&1) + 2*(y&1) + (z&1)``;
  * occupancy of a parent is the 8-bit indicator of its occupied octants;
  * upsampling emits each parent's occupied children ``2*p + offset``,
    re-sorted canonically (the lexicographic key is not hierarchical, so
    the sort is load-bearing);
  * the 7-dim neighbor feature of a node is the occupancy of
    [self, -x, +x, -y, +y, -z, +z], packed into a 7-bit code.

The device functions take canonically sorted, pad-tailed coordinates (pad
rows carry ``KEY_PAD``) and keep the JAX package's static output sizes, so
the two packages can be compared array for array.  The ``np_*`` functions
are integer-exact host twins.
"""

from __future__ import annotations

import numpy as np
import torch

from .coords import KEY_PAD, coord_key, key_to_coord, sort_rows_by_key, lookup

OCTANT_OFFSETS = np.array(
    [[i, j, k] for i in range(2) for j in range(2) for k in range(2)],
    dtype=np.int32,
)

NEIGHBOR_OFFSETS_7 = np.array(
    [[0, 0, 0], [-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]],
    dtype=np.int32,
)


def conv_offsets(kernel_size: int = 3) -> np.ndarray:
    """k^3 conv offsets, lexicographic in (dx, dy, dz)."""
    r = kernel_size // 2
    span = range(-r, r + 1)
    return np.array(
        [[dx, dy, dz] for dx in span for dy in span for dz in span],
        dtype=np.int32,
    )


# ---------------------------------------------------------- host (numpy) --


def np_coord_key(coords: np.ndarray) -> np.ndarray:
    c = coords.astype(np.int64)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def np_octree_down(coords: np.ndarray):
    """Sorted unique child coords -> (parents, occupancy (n, 8) uint8)."""
    if len(coords) == 0:
        return np.zeros((0, 3), np.int32), np.zeros((0, 8), np.uint8)
    c = coords.astype(np.int64)
    parent = coords >> 1
    pkey = np_coord_key(parent)
    octant = ((c[:, 0] & 1) << 2) | ((c[:, 1] & 1) << 1) | (c[:, 2] & 1)
    order = np.argsort(pkey, kind="stable")
    pkey = pkey[order]
    octant = octant[order]
    n = len(c)
    is_first = np.empty(n, bool)
    is_first[0] = True
    is_first[1:] = pkey[1:] != pkey[:-1]
    seg = np.cumsum(is_first) - 1
    parents = parent[order][is_first].astype(np.int32)
    occ = np.zeros((len(parents), 8), np.uint8)
    occ[seg, octant] = 1
    return parents, occ


def np_octree_up(coords: np.ndarray, occ: np.ndarray) -> np.ndarray:
    """Occupancy -> canonically sorted child coordinates (host twin of
    octree_up; the decoder's final rebuild)."""
    c = coords.astype(np.int64)
    base = (c[:, 0] << 43) | (c[:, 1] << 22) | (c[:, 2] << 1)
    offs = np.asarray(OCTANT_OFFSETS, np.int64)
    okey = (offs[:, 0] << 42) | (offs[:, 1] << 21) | offs[:, 2]
    idx = np.flatnonzero(occ.reshape(-1))
    keys = base[idx >> 3] + okey[idx & 7]
    keys.sort()
    m = (1 << 21) - 1
    out = np.empty((len(keys), 3), np.int32)
    out[:, 0] = (keys >> 42) & m
    out[:, 1] = (keys >> 21) & m
    out[:, 2] = keys & m
    return out


def np_feat_code(coords: np.ndarray) -> np.ndarray:
    """7-neighbor occupancy code (host twin of neighbor_feature_code)."""
    c = coords.astype(np.int64)
    keys = np_coord_key(coords)
    code = np.zeros(len(coords), np.int32)
    for k, off in enumerate(NEIGHBOR_OFFSETS_7):
        q = c + off[None, :].astype(np.int64)
        valid = np.all(q >= 0, axis=1)
        qkey = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
        pos = np.searchsorted(keys, qkey)
        pos_c = np.minimum(pos, max(len(keys) - 1, 0))
        hit = valid & (keys[pos_c] == qkey)
        code |= hit.astype(np.int32) << k
    return code


# ------------------------------------------------------------ device ops --


def octree_down(coords: torch.Tensor, keys: torch.Tensor, out_size: int):
    """One downsampling step on canonically sorted, pad-tailed coords.

    Returns (parent_coords (out_size, 3) int32, parent_keys (out_size,)
    int64, occupancy (out_size, 8) int32, n_parent int)."""
    dev = coords.device
    parent_of_child = coords >> 1
    octant = (
        ((coords[:, 0] & 1) << 2) | ((coords[:, 1] & 1) << 1) | (coords[:, 2] & 1)
    ).long()
    pkey = coord_key(parent_of_child, keys != KEY_PAD)
    # the lexicographic key is not hierarchical: children re-sort by parent
    pkey, octant = sort_rows_by_key(pkey, octant)
    valid = pkey != KEY_PAD
    prev = torch.cat([pkey.new_full((1,), -1), pkey[:-1]])
    is_first = valid & (pkey != prev)
    n_parent = int(is_first.sum())
    seg = torch.cumsum(is_first.long(), 0) - 1

    occupancy = torch.zeros((out_size, 8), dtype=torch.int32, device=dev)
    keep = valid & (seg < out_size)
    occupancy[seg[keep], octant[keep]] = 1

    parent_keys = torch.full((out_size,), KEY_PAD, dtype=torch.int64, device=dev)
    first = is_first & (seg < out_size)
    parent_keys[seg[first]] = pkey[first]
    parent_coords = torch.where(
        (parent_keys != KEY_PAD)[:, None],
        key_to_coord(parent_keys),
        torch.zeros((), dtype=torch.int32, device=dev),
    )
    return parent_coords, parent_keys, occupancy, n_parent


def octree_up(parent_coords, parent_keys, occupancy):
    """Occupancy -> (children (8P, 3), child_keys, n_child), valid rows
    compacted to the front in canonical order."""
    c, k, n, _ = octree_up_with_parent(parent_coords, parent_keys, occupancy)
    return c, k, n


def octree_up_with_parent(parent_coords, parent_keys, occupancy):
    """octree_up that also returns every child's parent row index
    (``parent_idx`` (8P,), -1 on the pad tail), carried through the
    canonical sort; chaining two gives a voxel's 4^3-brick index."""
    dev = parent_coords.device
    p = parent_coords.shape[0]
    valid = ((parent_keys != KEY_PAD)[:, None] & (occupancy > 0)).reshape(8 * p)
    offsets = torch.as_tensor(OCTANT_OFFSETS, device=dev)
    children = (parent_coords[:, None, :] * 2 + offsets[None]).reshape(8 * p, 3).int()
    ckey = coord_key(children, valid)
    pidx = torch.arange(p, dtype=torch.int32, device=dev).repeat_interleave(8)
    pidx = torch.where(valid, pidx, torch.full_like(pidx, -1))
    child_keys, children, parent_idx = sort_rows_by_key(ckey, children, pidx)
    return children, child_keys, int(valid.sum()), parent_idx


def neighbor_feature_code(coords: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """7-bit neighbor occupancy code per node (bit k = NEIGHBOR_OFFSETS_7[k]);
    pad rows get 0."""
    n = coords.shape[0]
    valid = keys != KEY_PAD
    offsets = torch.as_tensor(NEIGHBOR_OFFSETS_7, device=coords.device)
    q = coords[:, None, :] + offsets[None]
    qkey = coord_key(q.reshape(-1, 3), valid.repeat_interleave(7)).reshape(n, 7)
    found = lookup(keys, qkey) >= 0
    bits = torch.tensor([1 << k for k in range(7)], dtype=torch.int32, device=coords.device)
    return (found.int() * bits[None]).sum(1, dtype=torch.int32)


def neighbor_map(coords, keys, kernel_size: int = 3, dilation: int = 1):
    """(N, k^3) int32 row of ``coords[i] + d*offset[o]``, or -1."""
    n = coords.shape[0]
    kvol = kernel_size**3
    valid = keys != KEY_PAD
    offsets = torch.as_tensor(conv_offsets(kernel_size) * dilation, device=coords.device)
    q = coords[:, None, :] + offsets[None]
    qkey = coord_key(q.reshape(-1, 3), valid.repeat_interleave(kvol)).reshape(n, kvol)
    return lookup(keys, qkey)
