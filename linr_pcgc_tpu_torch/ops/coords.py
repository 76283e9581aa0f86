"""Voxel-coordinate primitives: 63-bit keys, canonical sort, sorted lookup.

Port of linr_pcgc_tpu/ops/coords.py.  The canonical order is lexicographic
by (x, y, z), realized by a bit-packed int64 key (21 bits per axis).  Rows
that are padding or out of range carry ``KEY_PAD`` so they sort to the end
and never match a lookup.  All functions run on whatever device their
tensors are on; sorts are stable.
"""

from __future__ import annotations

import torch

COORD_BITS = 21
COORD_MAX = (1 << COORD_BITS) - 1

# Strictly larger than any valid key; padded rows carry this key.
KEY_PAD = 0x7FFFFFFFFFFFFFFF


def coord_key(coords: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Pack (N, 3) int coordinates into an order-preserving int64 key;
    rows where ``valid`` is False or a coordinate is out of range get
    ``KEY_PAD``."""
    c = coords.long()
    key = (c[:, 0] << (2 * COORD_BITS)) | (c[:, 1] << COORD_BITS) | c[:, 2]
    in_range = ((c >= 0) & (c <= COORD_MAX)).all(dim=1)
    if valid is not None:
        in_range = in_range & valid
    return torch.where(in_range, key, torch.full_like(key, KEY_PAD))


def key_to_coord(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`coord_key` for valid keys; (N, 3) int32."""
    x = (keys >> (2 * COORD_BITS)) & COORD_MAX
    y = (keys >> COORD_BITS) & COORD_MAX
    z = keys & COORD_MAX
    return torch.stack([x, y, z], dim=1).int()


def sort_rows_by_key(keys: torch.Tensor, *row_arrays: torch.Tensor):
    """Stable ascending sort of ``keys``; the same permutation is applied
    to each array.  Returns ``(keys_sorted, *arrays_sorted)``."""
    keys_sorted, perm = torch.sort(keys, stable=True)
    return (keys_sorted,) + tuple(a[perm] for a in row_arrays)


def canonical_sort(coords: torch.Tensor, valid: torch.Tensor | None = None):
    """Canonical-sort coordinates; returns (coords_sorted, keys_sorted)."""
    keys = coord_key(coords, valid)
    keys_sorted, coords_sorted = sort_rows_by_key(keys, coords)
    return coords_sorted, keys_sorted


def lookup(keys_sorted: torch.Tensor, query_keys: torch.Tensor) -> torch.Tensor:
    """Row of each query key in a sorted (pad-tailed) key array, or -1;
    int32 like the JAX twin.  Queries equal to KEY_PAD return -1."""
    flat_q = query_keys.reshape(-1)
    n = keys_sorted.shape[0]
    pos = torch.searchsorted(keys_sorted, flat_q, side="left")
    pos_c = pos.clamp(max=n - 1)
    hit = (keys_sorted[pos_c] == flat_q) & (flat_q != KEY_PAD)
    idx = torch.where(hit, pos_c, torch.full_like(pos_c, -1)).int()
    return idx.reshape(query_keys.shape)


def membership(keys_sorted: torch.Tensor, query_keys: torch.Tensor) -> torch.Tensor:
    """Boolean membership of query keys in a sorted pad-tailed key array."""
    return lookup(keys_sorted, query_keys) >= 0
