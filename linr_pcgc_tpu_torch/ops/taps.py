"""The 3^3 conv's taps on the slot-major 4^3 brick halo: which halo column
each (output slot, tap) pair reads, the conv matrices gathered from the
taps, and the tap selection that turns the dense windowed moment into dw.
Shared by the conv kernels' module (plane_conv: the tap table the CUDA
kernels read, the plain versions' conv matrix and dw) and superbricks (the
conv and its gradient).

Conventions (those of linr_pcgc_tpu/ops/superbricks.py):

  * slot s = x*16 + y*4 + z inside a brick;
  * tap k in _DIRS order, k = (dx+1)*9 + (dy+1)*3 + (dz+1);
  * halo column f = plane*36 + group: plane the x-plane [-x nbr | own 4 |
    +x nbr], group the group-ordered yz columns of a plane (centre 4x4,
    y=0 row, y=5 row, z=0 col, z=5 col, corners).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

B4 = 4
B4_SLOTS = 64
B4_PLANE = 36
B4_HALO_VOL = 216
TAPS = 27

_DIRS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
_DIR_CENTER = _DIRS.index((0, 0, 0))
_FLIP = [_DIRS.index((-dx, -dy, -dz)) for (dx, dy, dz) in _DIRS]


def _b4_group_slot(y: int, z: int) -> int:
    """Spatial (y, z) in [0, 6)^2 -> group-ordered column in [0, 36)."""
    if 1 <= y <= 4 and 1 <= z <= 4:
        return (y - 1) * 4 + (z - 1)
    if y == 0 and 1 <= z <= 4:
        return 16 + (z - 1)
    if y == 5 and 1 <= z <= 4:
        return 20 + (z - 1)
    if z == 0 and 1 <= y <= 4:
        return 24 + (y - 1)
    if z == 5 and 1 <= y <= 4:
        return 28 + (y - 1)
    return 32 + {(0, 0): 0, (0, 5): 1, (5, 0): 2, (5, 5): 3}[(y, z)]


@functools.lru_cache(maxsize=None)
def _tap_table() -> np.ndarray:
    """(64, 216) int: conv tap k read by output slot s at flat-group halo
    column h, or 27 where slot s reads nothing there (structural zero)."""
    tap = np.full((B4_SLOTS, B4_HALO_VOL), TAPS, np.int64)
    for k, (dx, dy, dz) in enumerate(_DIRS):
        for s in range(B4_SLOTS):
            x, y, z = s >> 4, (s >> 2) & 3, s & 3
            f = (x + dx + 1) * B4_PLANE + _b4_group_slot(y + dy + 1, z + dz + 1)
            tap[s, f] = k
    return tap


@functools.lru_cache(maxsize=None)
def tap_columns() -> np.ndarray:
    """(64, 27) uint8: the halo column that tap k of slot u reads, read off
    :func:`_tap_table` (the table the conv matrices are gathered with).
    K1 and K3 take it as their stencil; slot u reads halo columns
    h[T[u, k]*C : (T[u, k] + 1)*C]."""
    tap = _tap_table()
    u, f = np.nonzero(tap < TAPS)
    cols = np.full((B4_SLOTS, TAPS), -1, np.int64)
    cols[u, tap[u, f]] = f
    if (cols < 0).any() or (np.bincount(u, minlength=B4_SLOTS) != TAPS).any():
        raise RuntimeError("the tap table does not give each slot its 27 taps once")
    out = np.ascontiguousarray(cols.astype(np.uint8))
    out.setflags(write=False)  # shared by every caller through the cache
    return out


def _taps(w):
    """(..., 27, Cin, Cout) -> (..., 64, 216, Cin, Cout): the kernel tap
    each (slot, halo column) pair reads, zero off the 3^3 stencil.  A
    gather, so the matrices are exact whatever the matmul precision."""
    zero = torch.zeros_like(w[..., :1, :, :])
    tap = torch.as_tensor(_tap_table(), device=w.device)
    return torch.cat([w, zero], dim=-3)[..., tap, :, :]


def b4_conv_weight_matrix(w):
    """(..., 27, Cin, Cout) -> (..., Cin*216, Cout*64), channel-major rows
    c*216 + h and columns o*64 + s."""
    lead, cin, cout = w.shape[:-3], w.shape[-2], w.shape[-1]
    n = len(lead)
    g = _taps(w).permute(*range(n), n + 2, n + 1, n + 3, n)
    return g.reshape(*lead, cin * B4_HALO_VOL, cout * B4_SLOTS)


def b4_conv_weight_matrix_sm(w):
    """(..., 27, Cin, Cout) -> (..., 216*Cin, 64*Cout) slot-major: rows
    h*Cin + c (the halo's columns), columns s*Cout + o (the next conv's
    slot-major input)."""
    lead, cin, cout = w.shape[:-3], w.shape[-2], w.shape[-1]
    n = len(lead)
    g = _taps(w).permute(*range(n), n + 1, n + 2, n, n + 3)
    return g.reshape(*lead, B4_HALO_VOL * cin, B4_SLOTS * cout)


@functools.lru_cache(maxsize=None)
def _sel_windows() -> np.ndarray:
    """Windowed, pre-flipped tap selection (4, 27, 16, 108) float32: plane
    p's slots u = p*16 + r read only halo window [p*36, p*36 + 108), which
    is what plane_moment_plain stores; SELW[p, k] = SEL[flip(k), p*16:(p+1)*16,
    p*36:(p+3)*36] with SEL[k, s, f] = [tap k of slot s reads column f]."""
    tap = _tap_table()
    sel = (tap[None, :, :] == np.arange(TAPS)[:, None, None]).astype(np.float32)[_FLIP]
    return np.ascontiguousarray(np.stack(
        [sel[:, p * 16:(p + 1) * 16, p * B4_PLANE:(p + 3) * B4_PLANE] for p in range(B4)]))


def moment_taps(mc, c: int, o: int):
    """Compact windowed moment (S, 4, 16*c, 108*o) f32 (plane_moment_plain)
    -> dw (S, 27, c, o) through the static pre-flipped tap selection: tap k
    pairs x at voxel u with dy at u - off_k."""
    s = mc.shape[0]
    mc = mc.reshape(s, B4, 16, c, 3 * B4_PLANE, o)
    return torch.einsum("pkuj,spucjo->skco", torch.as_tensor(_sel_windows(), device=mc.device), mc)
