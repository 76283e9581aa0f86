"""Slot-major 4^3 brick layout: the host brickify of the trainer's GOP
assembly, the layout maps from JAX's channel-major tensors and 8^3
superbricks onto it, the halo gather (K2), the conv with and without its
fused epilogue and their gradients, and the codec's device brickify (the
taps and conv matrices are in ops.taps).

Port of the slot-major pieces of linr_pcgc_tpu/ops/superbricks.py that the
codec and the trainer run.  Conventions kept exactly:

  * slot s = x*16 + y*4 + z inside a brick; bricks in canonical order;
  * activations (Bb, S, 64*C): slot-major, channels contiguous per slot;
  * halo (Bb, S, 216*C) in column order (plane*36 + group)*C + c, where
    plane is the x-plane [-x nbr | own 4 | +x nbr] and group the
    group-ordered yz columns of a plane (centre 4x4, y=0 row, y=5 row,
    z=0 col, z=5 col, corners);
  * nbr27 (Bb, 27) int32 in _DIRS order, -1 where the brick is absent.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .coords import KEY_PAD, coord_key, lookup
from .octree import NEIGHBOR_OFFSETS_7
from . import cuda_build
from .plane_conv import plane_matmul, plane_matmul_bm, plane_moment_dw
from .taps import (  # noqa: F401  (the conv matrices are re-exported)
    B4, B4_HALO_VOL, B4_PLANE, B4_SLOTS, _DIR_CENTER, _DIRS, _FLIP, _tap_table,
    b4_conv_weight_matrix, b4_conv_weight_matrix_sm, moment_taps,
)

# destination yz column groups of one halo plane, in concatenation order
_YZ_ORDER = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)]

B4_HALO = 6
_B4_X_SRC = {-1: (B4 - 1, B4), 0: (0, B4), 1: (0, 1)}


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., n/8) uint8 -> (..., n) {0,1} uint8, numpy packbits 'big' order."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


# ------------------------------------------------------ host brickify ----


def _np_key(coords: np.ndarray) -> np.ndarray:
    c = coords.astype(np.int64)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def _np_unkey(keys: np.ndarray) -> np.ndarray:
    m = (1 << 21) - 1
    return np.stack([(keys >> 42) & m, (keys >> 21) & m, keys & m], axis=1).astype(np.int32)


@dataclasses.dataclass
class SuperBrickLevel:
    """One scale's brick grid (numpy, trimmed to n_bricks)."""

    brick_coords: np.ndarray  # (Bb, 3) int32, canonical order
    nbr27: np.ndarray         # (Bb, 27) int32 brick-neighbour map, -1 absent
    scale_code: np.ndarray    # (Bb, slots) int32, scale*128+feat_code, -1 empty
    occ: np.ndarray           # (Bb, 8, slots) uint8 ground-truth child occupancy
    voxel_brick: np.ndarray   # (n_vox,) int32 brick index per voxel
    voxel_slot: np.ndarray    # (n_vox,) int32 slot per voxel
    n_vox: int

    @property
    def n_bricks(self) -> int:
        return self.brick_coords.shape[0]


def build_superbrick_level(coords: np.ndarray, occ: np.ndarray, feat_code: np.ndarray,
                           scale_idx: int, side: int = 8) -> SuperBrickLevel:
    """Brickify one level at side^3 (the trainer uses side 4).  Inputs are
    the trimmed per-level arrays in canonical voxel order: coords (n, 3),
    occ (n, 8), feat_code (n,).  Integer-exact numpy on the host."""
    n = len(coords)
    c = coords.astype(np.int64)
    shift = side.bit_length() - 1
    m = side - 1
    slots = side**3
    brick_keys, inv = np.unique(_np_key(coords >> shift), return_inverse=True)
    bb = len(brick_keys)
    slot = (((c[:, 0] & m) << (2 * shift)) | ((c[:, 1] & m) << shift) | (c[:, 2] & m)).astype(np.int32)

    scale_code = np.full((bb, slots), -1, np.int32)
    scale_code[inv, slot] = scale_idx * 128 + feat_code.astype(np.int32)
    occ_b = np.zeros((bb, 8, slots), np.uint8)
    occ_b[inv, :, slot] = occ.astype(np.uint8)

    # neighbour keys by key arithmetic: a border underflow borrows into the
    # next field and names a brick that does not exist -> -1
    doff = np.asarray([(dx << 42) + (dy << 21) + dz for (dx, dy, dz) in _DIRS], np.int64)
    qkey = brick_keys[:, None] + doff[None, :]
    pos = np.searchsorted(brick_keys, qkey).astype(np.int32)
    np.minimum(pos, np.int32(bb - 1), out=pos)
    nbr = np.where(np.take(brick_keys, pos) == qkey, pos, np.int32(-1))
    return SuperBrickLevel(
        brick_coords=_np_unkey(brick_keys),
        nbr27=nbr,
        scale_code=scale_code,
        occ=occ_b,
        voxel_brick=inv.astype(np.int32).reshape(-1),
        voxel_slot=slot,
        n_vox=n,
    )


# ------------------------------------------------------------- layouts ----
#
# JAX's channel-major tensors (..., C, slots) against the port's slot-major
# (..., slots*C), and JAX's 8^3 superbricks against the port's 4^3 conv.
# Superbrick b splits into 8 sub-bricks p = (px, py, pz) in {0, 1}^3, row
# 8b + px*4 + py*2 + pz of the sub-brick grid; its slot x*64 + y*8 + z is
# slot (x&3)*16 + (y&3)*4 + (z&3) of sub-brick (x>>2, y>>2, z>>2).  The
# neighbour of sub-brick (b, p) in direction d is q = p + d: superbrick
# direction floor(q / 2), sub-brick q mod 2.  A sub-brick without voxels
# keeps code -1 and mask 0, so the submanifold conv is unchanged.

SB_SLOTS = 8**3
SUBS = SB_SLOTS // B4_SLOTS  # sub-bricks of a superbrick


def to_slot_major(x: torch.Tensor) -> torch.Tensor:
    """Channel-major (..., C, 64) -> slot-major (..., 64*C)."""
    return x.transpose(-1, -2).reshape(*x.shape[:-2], -1)


def to_channel_major(x: torch.Tensor) -> torch.Tensor:
    """Slot-major (..., 64*C) -> channel-major (..., C, 64)."""
    return x.reshape(*x.shape[:-1], B4_SLOTS, -1).transpose(-1, -2)


def to_sub_bricks(t: torch.Tensor) -> torch.Tensor:
    """(Bb, ..., 512) on 8^3 superbrick slots -> (8Bb, ..., 64) on 4^3
    sub-brick slots."""
    bb, rest = t.shape[0], t.shape[1:-1]
    n = len(rest)
    v = t.reshape(bb, *rest, 2, B4, 2, B4, 2, B4)
    return v.permute(0, n + 1, n + 3, n + 5, *range(1, n + 1), n + 2, n + 4, n + 6).reshape(
        bb * SUBS, *rest, B4_SLOTS)


def from_sub_bricks(t: torch.Tensor) -> torch.Tensor:
    """(8Bb, ..., 64) on sub-brick slots -> (Bb, ..., 512), the inverse of
    :func:`to_sub_bricks`."""
    rest = t.shape[1:-1]
    n = len(rest)
    v = t.reshape(t.shape[0] // SUBS, 2, 2, 2, *rest, B4, B4, B4)
    return v.permute(0, *range(4, 4 + n), 1, 4 + n, 2, 5 + n, 3, 6 + n).reshape(
        t.shape[0] // SUBS, *rest, SB_SLOTS)


@functools.lru_cache(maxsize=None)
def _sub_brick_dirs():
    """(8, 27) pair of tables: for sub-brick p and direction k of _DIRS,
    the _DIRS index of the superbrick that holds the neighbour, and the
    neighbour's sub-brick index in it."""
    sdir = np.zeros((SUBS, 27), np.int64)
    sub = np.zeros((SUBS, 27), np.int64)
    for p in range(SUBS):
        pv = (p >> 2, (p >> 1) & 1, p & 1)
        for k, d in enumerate(_DIRS):
            q = [a + b for a, b in zip(pv, d)]
            sdir[p, k] = _DIRS.index(tuple(v // 2 for v in q))
            sub[p, k] = (q[0] % 2) * 4 + (q[1] % 2) * 2 + q[2] % 2
    return sdir, sub


def sub_brick_map(nbr27: torch.Tensor, code: torch.Tensor, occ: torch.Tensor | None = None):
    """JAX's 8^3 level (nbr27 (Bb, 27), code (Bb, 512)[, occ (Bb, 8,
    512)]) -> the 4^3 sub-brick level (nbr27 (8Bb, 27) int32, code (8Bb,
    64)[, occ (8Bb, 8, 64)]): integer ops on the tensors' own device."""
    sdir, sub = (torch.as_tensor(t, device=nbr27.device) for t in _sub_brick_dirs())
    nb = nbr27.long()[:, sdir]  # (Bb, 8, 27)
    nbr = torch.where(nb >= 0, nb * SUBS + sub, -1).reshape(-1, 27).int().contiguous()
    out = (nbr, to_sub_bricks(code))
    return out if occ is None else out + (to_sub_bricks(occ),)


def sub_brick_slices(level_slices):
    """Level slices over superbricks -> the same levels over sub-bricks."""
    return tuple((a * SUBS, b * SUBS, s) for (a, b, s) in level_slices)


def sub_brick_geom(geom: dict) -> dict:
    """A network geom on 512 slots (nbr27, mask (Bb, 1, 1, 512), code,
    dtype) -> the same geometry on 4^3 sub-bricks."""
    nbr, code = sub_brick_map(geom["nbr27"], geom["code"])
    return dict(geom, nbr27=nbr, code=code, mask=to_sub_bricks(geom["mask"]))


def _b4_yz_cols_sm(slab, dy, dz):
    """Source yz columns (axis -2, 16 = y*4 + z) that a (dy, dz) neighbour
    ships; slab (Bb, S, px, 16, C)."""
    if (dy, dz) == (0, 0):
        return slab
    if (dy, dz) == (-1, 0):
        return slab[..., 12:16, :]
    if (dy, dz) == (1, 0):
        return slab[..., 0:4, :]
    if (dy, dz) == (0, -1):
        return slab[..., 3::4, :]
    if (dy, dz) == (0, 1):
        return slab[..., 0::4, :]
    if (dy, dz) == (-1, -1):
        return slab[..., 15:16, :]
    if (dy, dz) == (-1, 1):
        return slab[..., 12:13, :]
    if (dy, dz) == (1, -1):
        return slab[..., 3:4, :]
    return slab[..., 0:1, :]


def _gather_rows(frag, nbr_col):
    """Brick rows of ``frag`` by neighbour index; -1 (absent) -> zeros."""
    idx = nbr_col.long()
    got = frag[idx.clamp(min=0)]
    return torch.where((idx >= 0)[:, None], got, torch.zeros((), dtype=frag.dtype, device=frag.device))


# ------------------------------------------------------------- K2: halo --


def b4_halo_sm_plain(x: torch.Tensor, nbr27: torch.Tensor) -> torch.Tensor:
    """x (Bb, S, 64*C) -> (Bb, S, 216*C): 26 neighbour fragments gathered
    through nbr27 (zeros where absent) and the own brick, concatenated in
    the flat group order (the plain twin of K2)."""
    bb, s, vc = x.shape
    c = vc // B4_SLOTS
    xv = x.reshape(bb, s, B4, 16, c)
    frags = {}
    for d in _DIRS:
        dx, dy, dz = d
        sx = _B4_X_SRC[dx]
        pc = _b4_yz_cols_sm(xv[:, :, sx[0]: sx[1]], dy, dz)
        px, wd = pc.shape[2], pc.shape[3]
        if d == (0, 0, 0):
            frags[d] = pc.reshape(bb, s, px, wd * c)
        else:
            g = _gather_rows(pc.reshape(bb, s * px * wd * c), nbr27[:, _DIRS.index(d)])
            frags[d] = g.reshape(bb, s, px, wd * c)
    planes = []
    for hp in range(B4_HALO):
        dx = -1 if hp == 0 else (1 if hp == B4_HALO - 1 else 0)
        sp = 0 if dx != 0 else hp - 1
        planes.append(torch.cat([frags[(dx, dy, dz)][:, :, sp, :] for (dy, dz) in _YZ_ORDER], dim=2))
    return torch.cat(planes, dim=2)


@functools.lru_cache(maxsize=None)
def halo_source_table() -> np.ndarray:
    """(216,) uint16: halo column f -> d*64 + v (direction d, source slot
    v), derived by pushing an index tensor through the plain version:
    slot v of brick b holds b*64 + v, and brick 0's neighbour in direction
    d is brick d + 1."""
    x = torch.arange(28 * B4_SLOTS, dtype=torch.float64).reshape(28, 1, B4_SLOTS)
    nbr = torch.full((28, 27), -1, dtype=torch.int32)
    nbr[0] = torch.arange(1, 28, dtype=torch.int32)
    h = b4_halo_sm_plain(x, nbr)[0, 0].long()
    brick, v = h // B4_SLOTS, h % B4_SLOTS
    d = torch.where(brick == 0, torch.full_like(brick, _DIR_CENTER), brick - 1)
    return np.ascontiguousarray((d * 64 + v).numpy().astype(np.uint16))


# csrc/halo.cu's plan constants
HALO_UNITS = (16, 8, 4, 2)   # copy units, widest first (bytes)
HALO_MAX_THREADS = 768     # csrc/halo.cu MAX_THREADS
HALO_MAX_BRICKS = 64         # bricks a block takes (MAX_BRICKS)
HALO_ROWS_PER_BLOCK = 64     # (brick, stage) rows a block aims at
HALO_MIN_BLOCKS = 2 * 132    # blocks a small call still spreads over (two per SM)


class HaloPlan(NamedTuple):
    unit_bytes: int   # bytes one load and one store move
    unit_cols: int    # units per halo column: C * esz / unit_bytes (an output row: 216 x that)
    threads: int      # per block, a multiple of 32; thread t copies units t, t + threads, ...
    bricks: int       # bricks per block (its rows: bricks x S)
    blocks: int


def halo_plan(bb: int, s: int, c: int, esz: int, align: int = 16) -> HaloPlan:
    """K2's launch plan, from the shapes alone: the widest unit of
    HALO_UNITS that divides a halo column's c * esz bytes and ``align``
    (the alignment of x's address); as few passes of at most 768 threads
    as cover an output row; ceil(64 / s) bricks a block, fewer if that
    leaves under 264 blocks."""
    if min(bb, s, c) < 1 or esz not in (2, 4):
        raise ValueError(f"b4_halo_sm needs bricks, stages, channels and 2- or 4-byte values, "
                         f"got bb={bb} s={s} c={c} esz={esz}")
    unit = next(u for u in HALO_UNITS if (c * esz) % u == 0 and align % u == 0)
    upc = c * esz // unit
    ru = B4_HALO_VOL * upc
    passes = -(-ru // HALO_MAX_THREADS)
    threads = 32 * -(-ru // (32 * passes))
    bricks = max(1, min(-(-HALO_ROWS_PER_BLOCK // s), HALO_MAX_BRICKS, -(-bb // HALO_MIN_BLOCKS)))
    return HaloPlan(unit, upc, threads, bricks, -(-bb // bricks))


def b4_halo_sm(x: torch.Tensor, nbr27: torch.Tensor) -> torch.Tensor:
    """(Bb, S, 64*C), (Bb, 27) int32 -> (Bb, S, 216*C) slot-major halo:
    the CUDA kernel K2 on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return b4_halo_sm_plain(x, nbr27)
    if x.device.type != "cuda":
        raise ValueError(f"b4_halo_sm runs on CUDA or CPU tensors, not {x.device}")
    bb, s, vc = x.shape
    if vc % B4_SLOTS or x.element_size() not in (2, 4):
        raise ValueError(f"b4_halo_sm takes (Bb, S, 64*C) of 2- or 4-byte values, got {x.shape} {x.dtype}")
    if nbr27.dtype != torch.int32 or tuple(nbr27.shape) != (bb, 27) or nbr27.device != x.device:
        raise ValueError("nbr27 must be a (Bb, 27) int32 tensor on x's device")
    if not (x.is_contiguous() and nbr27.is_contiguous()):
        raise ValueError("b4_halo_sm takes contiguous tensors")
    c = vc // B4_SLOTS
    h = torch.empty((bb, s, B4_HALO_VOL * c), dtype=x.dtype, device=x.device)
    if h.numel() == 0:
        return h
    plan = halo_plan(bb, s, c, x.element_size(), min(16, x.data_ptr() & -x.data_ptr()))
    tab = halo_source_table()
    lib = cuda_build.load("halo")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.b4_halo_sm(x.data_ptr(), nbr27.data_ptr(), h.data_ptr(), bb, s, plan.unit_cols,
                             plan.unit_bytes, plan.bricks, plan.threads, plan.blocks,
                             tab.ctypes.data, stream)
    if err:
        raise RuntimeError(f"b4_halo_sm kernel launch failed (CUDA error {err})")
    b4_halo_sm.launches += 1
    return h


b4_halo_sm.launches = 0


# ------------------------------------------------------- conv and gradient --


def _conv_grads(need_dx: bool, x, w, nbr27, dym):
    """The conv's dx and dw from the cotangent ``dym`` of its product (dy
    times the mask, for the fused conv), whose halo the backward rebuilds:
    g = K2(dym); dx = K3(g, w's taps flipped, C and O swapped) when
    ``need_dx``, else None; dw = K4(x, g), the 27-tap stencil reduced over
    the bricks, in w's dtype."""
    dt = x.dtype
    c, o = w.shape[-2], w.shape[-1]
    g = b4_halo_sm(dym, nbr27)
    dx = None
    if need_dx:
        wt = w[:, _FLIP].transpose(-1, -2).to(dt).contiguous()  # (S, 27, O, C)
        dx = plane_matmul(g, wt, o, c)
    return dx, plane_moment_dw(x, g, c, o).to(w.dtype)


class _ConvSmBm(torch.autograd.Function):
    """The fused conv and its gradient (the port of the custom VJP of
    superbricks.b4_convsm_bm).  Forward: K2 then K1.  It saves x, w, b,
    mask and nbr27, never the halo, which the backward rebuilds from dy
    (the JAX trainer's checkpoint policy, for free).  Backward, with dym =
    dy * mask: dx and dw by ``_conv_grads`` (K2, K3, K4); db = the sum of
    dym over bricks and slots.  K1, K3 and K4 work on the taps; no conv
    matrix and no dense moment is built."""

    @staticmethod
    def forward(ctx, x, w, b, mask, nbr27):
        ctx.save_for_backward(x, w, b, mask, nbr27)
        dt = x.dtype
        c, o = w.shape[-2], w.shape[-1]
        h = b4_halo_sm(x, nbr27)
        bias = b.repeat(1, B4_SLOTS).to(dt).contiguous()
        return plane_matmul_bm(h, w.to(dt).contiguous(), c, o, bias, mask.to(dt).contiguous())

    @staticmethod
    def backward(ctx, dy):
        x, w, b, mask, nbr27 = ctx.saved_tensors
        dt = x.dtype
        bb, s, _ = x.shape
        o = w.shape[-1]
        dym = (dy.to(dt) * mask.to(dt).repeat_interleave(o, dim=-1)[:, None, :]).contiguous()
        dx, dw = _conv_grads(ctx.needs_input_grad[0], x, w, nbr27, dym)
        db = dym.float().reshape(bb, s, B4_SLOTS, o).sum(dim=(0, 2)).to(b.dtype)
        return dx, dw, db, None, None


def b4_convsm_bm(x, w, b, mask, nbr27):
    """Slot-major 3^3 brick conv with the epilogue fused, differentiable
    in x, w and b: K2 then K1 forward; K2, K3 and K4 backward.

    x (Bb, S, 64*C) contiguous, w (S, 27, C, O), b (S, O), mask (Bb, 64),
    nbr27 (Bb, 27) int32 -> (Bb, S, 64*O) = (conv(x) + b) * mask, in
    x.dtype."""
    return _ConvSmBm.apply(x, w, b, mask, nbr27)


class _ConvSm(torch.autograd.Function):
    """The conv without bias and mask and its gradient (the port of the
    custom VJP of superbricks.b4_convsm).  Forward: K2 then K3.  Backward:
    ``_conv_grads`` on dy itself."""

    @staticmethod
    def forward(ctx, x, w, nbr27):
        ctx.save_for_backward(x, w, nbr27)
        c, o = w.shape[-2], w.shape[-1]
        return plane_matmul(b4_halo_sm(x, nbr27), w.to(x.dtype).contiguous(), c, o)

    @staticmethod
    def backward(ctx, dy):
        x, w, nbr27 = ctx.saved_tensors
        dx, dw = _conv_grads(ctx.needs_input_grad[0], x, w, nbr27, dy.to(x.dtype).contiguous())
        return dx, dw, None


def b4_convsm(x, w, nbr27):
    """Slot-major 3^3 brick conv, differentiable in x and w: x (Bb, S,
    64*C) contiguous, w (S, 27, C, O), nbr27 (Bb, 27) int32 -> conv(x)
    (Bb, S, 64*O) in x.dtype.  K2 then K3 forward; K2, K3 and K4 backward.
    Bias and mask stay with the caller, as in JAX."""
    return _ConvSm.apply(x, w, nbr27)


# --------------------------------------------------------- device brickify --


@functools.lru_cache(maxsize=None)
def _slot_dir_tables(side: int, off: tuple):
    """For slot s and any 27-offset ``off``: the _DIRS index of the
    componentwise brick carry (``tdir``) and the neighbour cell's slot
    (``perm``, wrapped mod side)."""
    shift = side.bit_length() - 1
    m = side - 1
    slots = side**3
    tdir = np.zeros((slots,), np.int64)
    perm = np.zeros((slots,), np.int64)
    dx, dy, dz = off
    for s in range(slots):
        x, y, z = s >> (2 * shift), (s >> shift) & m, s & m
        nx, ny, nz = x + dx, y + dy, z + dz
        tdir[s] = _DIRS.index((nx // side, ny // side, nz // side))
        perm[s] = ((nx & m) << (2 * shift)) | ((ny & m) << shift) | (nz & m)
    return tdir, perm


@functools.lru_cache(maxsize=None)
def _slot_shift_tables(side: int, off: tuple):
    """For a face offset: each slot's neighbour-cell slot (``perm``) and
    whether that cell lies in the adjacent brick (``crosses``)."""
    shift = side.bit_length() - 1
    m = side - 1
    slots = side**3
    perm = np.zeros((slots,), np.int64)
    crosses = np.zeros((slots,), bool)
    dx, dy, dz = off
    for s in range(slots):
        x, y, z = s >> (2 * shift), (s >> shift) & m, s & m
        nx, ny, nz = x + dx, y + dy, z + dz
        crosses[s] = not (0 <= nx < side and 0 <= ny < side and 0 <= nz < side)
        perm[s] = ((nx & m) << (2 * shift)) | ((ny & m) << shift) | (nz & m)
    return perm, crosses


def dev_nbr27_from_parent(vb2, sl2, nbr27_pf2, idx_grid2, cap: int, side: int = 4):
    """Level-s brick neighbour map without a key search: level-s bricks
    are level-(s+2) voxels, so brick i's neighbour at offset d is read
    from level-(s+2)'s own brickify geometry by gathers.

    vb2/sl2 (Bv2,): level-(s+2) voxel -> its brick row / slot;
    nbr27_pf2 (cap2, 27); idx_grid2 (cap2 * slots,) voxel rows, -1 empty.
    Returns (cap, 27) int32, -1 absent."""
    slots = side**3
    dev = vb2.device
    bv2 = vb2.shape[0]
    cap2 = nbr27_pf2.shape[0]
    valid = vb2 >= 0
    vb2c = torch.where(valid, vb2, torch.zeros_like(vb2)).long()
    brow = nbr27_pf2[vb2c].long()  # (Bv2, 27)
    grid = torch.cat([idx_grid2, idx_grid2.new_full((1,), -1)])
    sl2l = sl2.long()
    cols = []
    for d in _DIRS:
        tdir_t, perm_t = _slot_dir_tables(side, d)
        td = torch.as_tensor(tdir_t, device=dev)[sl2l]
        pm = torch.as_tensor(perm_t, device=dev)[sl2l]
        tb = torch.where(td == _DIR_CENTER, vb2c, brow.gather(1, td[:, None])[:, 0])
        flat = torch.where(tb >= 0, tb * slots + pm, torch.full_like(tb, cap2 * slots))
        cols.append(torch.where(valid, grid[flat], torch.full_like(flat, -1, dtype=grid.dtype)))
    out = torch.stack(cols, dim=1).int()
    if bv2 >= cap:
        return out[:cap]
    return torch.cat([out, out.new_full((cap - bv2, 27), -1)])


def dev_brickify(coords, keys, scale_idx: int, brick_cap: int, side: int = 4):
    """Brickify one frame's level on device.

    coords (Nv, 3) int32 canonically sorted, pad-tailed; keys (Nv,) int64.
    Returns dict(bkeys (cap,), n_bricks, vox_brick (Nv,) int32 (-1 on pads),
    vox_slot (Nv,) int32, code (cap, slots) int32 (scale*128 + feat, -1
    empty), nbr27 (cap, 27) int32).  One stable sort of the brick keys
    carries the voxel index; the voxel->brick map is the inverse scatter
    of the running rank."""
    shift = side.bit_length() - 1
    dev = coords.device
    nv = coords.shape[0]
    valid = keys != KEY_PAD
    bkey_all = coord_key(coords >> shift, valid)
    sbk, order = torch.sort(bkey_all, stable=True)
    prev = torch.cat([sbk.new_full((1,), -1), sbk[:-1]])
    is_first = (sbk != KEY_PAD) & (sbk != prev)
    n_bricks = int(is_first.sum())
    rank = torch.cumsum(is_first.long(), 0) - 1
    bkeys = torch.full((brick_cap,), KEY_PAD, dtype=torch.int64, device=dev)
    put = is_first & (rank < brick_cap)
    bkeys[rank[put]] = sbk[put]
    vox_brick = torch.zeros((nv,), dtype=torch.int32, device=dev)
    vox_brick[order] = torch.where(sbk != KEY_PAD, rank, torch.full_like(rank, -1)).int()
    return dev_brickify_geom(coords, keys, scale_idx, brick_cap, side, bkeys, n_bricks, vox_brick)


def dev_brickify_geom(coords, keys, scale_idx: int, brick_cap: int, side: int,
                      bkeys, n_bricks, vox_brick, nbr27=None):
    """The grid / feature / neighbour half of :func:`dev_brickify`, given
    the brick identity (sorted ``bkeys`` + per-voxel ``vox_brick``).  The
    7-neighbour feature code is read off the brick occupancy grid through 6
    neighbour-brick row gathers + static slot permutations."""
    shift = side.bit_length() - 1
    m = side - 1
    slots = side**3
    dev = coords.device
    valid = keys != KEY_PAD
    slot = (((coords[:, 0] & m) << (2 * shift)) | ((coords[:, 1] & m) << shift)
            | (coords[:, 2] & m)).int()
    slot = torch.where(valid, slot, torch.zeros_like(slot))

    if nbr27 is None:
        # neighbour keys by key arithmetic: a border underflow borrows into
        # the next field and names a brick that does not exist -> -1
        doff = torch.tensor([(dx << 42) + (dy << 21) + dz for (dx, dy, dz) in _DIRS],
                            dtype=torch.int64, device=dev)
        qk = torch.where((bkeys != KEY_PAD)[:, None], bkeys[:, None] + doff[None],
                         torch.full((1, 1), KEY_PAD, dtype=torch.int64, device=dev))
        nbr27 = lookup(bkeys, qk)

    # a brick beyond brick_cap is dropped, as the JAX scatter's mode="drop"
    flat = torch.where(valid & (vox_brick < brick_cap), vox_brick.long() * slots + slot,
                       torch.full_like(slot, brick_cap * slots, dtype=torch.int64))
    occ_flat = torch.zeros((brick_cap * slots + 1,), dtype=torch.int32, device=dev)
    occ_flat[flat] = 1
    occ_g = occ_flat[:-1].reshape(brick_cap, slots)
    occ_pad = torch.cat([occ_g, occ_g.new_zeros((1, slots))])
    feat_grid = occ_g.clone()  # bit 0 = self
    for k in range(1, 7):
        off = tuple(int(v) for v in NEIGHBOR_OFFSETS_7[k])
        nb = nbr27[:, _DIRS.index(off)].long()
        nbg = occ_pad[torch.where(nb >= 0, nb, torch.full_like(nb, brick_cap))]
        perm, crosses = _slot_shift_tables(side, off)
        perm_t = torch.as_tensor(perm, device=dev)
        src = torch.where(torch.as_tensor(crosses, device=dev)[None], nbg[:, perm_t], occ_g[:, perm_t])
        feat_grid = feat_grid + (src << k)
    code = torch.where(occ_g > 0, int(scale_idx) * 128 + feat_grid, torch.full_like(feat_grid, -1))
    return dict(
        bkeys=bkeys,
        n_bricks=n_bricks,
        vox_brick=vox_brick,
        vox_slot=slot,
        code=code,
        nbr27=nbr27,
    )
