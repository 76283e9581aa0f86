"""The weight gradient of the skinny convs: K11.

The 1^3 convs of both trainers, and the gather backend's k^3 conv, reduce
their weight gradient over ~1 M rows into an output of a few hundred
values: on the TPU XLA work (linr_pcgc_tpu/models/sb_network.py:205
``sbconv1``, models/network.py:375 ``_conv1``, models/network.py:412
``_conv3_op_bwd``'s ``dot_general`` :431), here one CUDA source,
csrc/wgrad.cu, with two kernels:

* the ring form, for contiguous rows: ``wgrad_sb`` (x (Bb, S, 64*C), dy
  (Bb, S, 64*O) slot-major -> dw (S, C, O) in x's dtype, ``sum_{b, v}
  x[b, s, v*C + c] * dy[b, s, v*O + o]``) and the 1^3 conv of
  ``wgrad_gather`` (x (N, Cin), dy (N, Cout) f32, no map: S = 1, bricks of
  64 rows, the last one ragged);
* the gather form: ``wgrad_gather`` with idx (K, N) int32 -> dw (K, Cin,
  Cout) f32, ``sum_n x[idx[k, n], c] * dy[n, o]`` (a negative idx adds
  nothing).

Each launches its kernel on CUDA tensors and runs its plain version (the
einsum, or the matmul, or the gather + matmul that autograd ran before) on
CPU tensors; there is no other path.  The kernels sum in f32 in a fixed
order under plans from the shapes alone (``ring_plan``, ``gather_plan``),
so two launches give the same bits; bf16 is rounded once at the end.  Ring
form: a persistent block (one an SM) owns a contiguous brick range, which
comes through a ring of shared-memory slots by bulk copies; a warp owns one
stage and every ``wps``-th brick of each tile and holds the stage's whole
(C, O) (bf16 on the tensor cores; f32 a lane an 8 x 8 tile and every
``32 / nob2``-th row); a stage's warps are summed in warp order into the
block's partial, the blocks in block order.  Gather form: a persistent block
owns a node range in tiles of 64 nodes; a warp owns taps w, w + 8, w + 16,
w + 24 of the tap group and, per tile and tap, the present rows in node
order, a lane a 4 x 4 tile and every ``32 / nob2``-th of those rows; the
lanes of a row class are summed by a shuffle butterfly, the blocks in block
order.  ``tests/test_torch_wgrad.py`` emulates both orders.

``sb_conv1_product`` and ``gather_conv1_product`` are the 1^3 convs'
products with their gradient: the forward product and its dx are autograd's
own (the same einsum or matmul on the weight detached, so the same bits as
before), and ``_WGrad``, the identity on the product's output, adds dw by
K11.  ``ops/gather_conv.py``'s autograd Function takes its dw from
``wgrad_gather`` with the conv's neighbour map.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build
from .plane_conv import DTYPES

SLOTS = 64                # slots of a 4^3 brick: the ring form's rows per brick
SMS = 132                 # SMs of an H100 SXM
SMEM_MAX = 232448         # a block's most shared memory, after opting in
SMEM_SM = 233472          # an SM's shared memory; each block also holds 1 KB
# csrc/wgrad.cu's ring form
RING_HDR = 256            # barriers and a zero row before the ring
RING_TILE = 32 * 1024     # bytes of a ring slot the plan aims at
RING_BYTES = 200 * 1024   # the ring's bytes at most
RING_MAX_NST = 8
RING_MAX_WARPS = 16
RING_GROUP = 32           # widest output group, both ways
# csrc/wgrad.cu's gather form
G_TILE = 64               # nodes of a tile
G_WARPS = 8
G_TPW = 4                 # taps a warp owns
G_TAPS = G_WARPS * G_TPW  # taps of a tap group (grid.y)
G_GROUP = 16              # widest output group, both ways
G_NS = 3                  # tile slots of index and dy rows
G_OFF_X = G_NS * G_TAPS * G_TILE * 4 + G_NS * G_TILE * G_GROUP * 4 + G_WARPS * G_TPW * G_TILE


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _groups(n: int, widest: int, step: int) -> tuple[int, int]:
    """Output groups along a channel axis of n: (width, count), the width a
    multiple of ``step`` unless one group covers all n."""
    count = _cdiv(n, widest)
    if count == 1:
        return n, 1
    width = _cdiv(_cdiv(n, count), step) * step
    return width, _cdiv(n, width)


def _lane_tiles(cw: int, ow: int, tile: int) -> tuple[int, int]:
    """A warp's lane tiles over a (cw, ow) group: (tiles, tiles rounded up
    to a power of two); lane = row class * nob2 + tile."""
    nob = _cdiv(cw, tile) * _cdiv(ow, tile)
    return nob, 1 << (nob - 1).bit_length()


class RingPlan(NamedTuple):
    sg: int          # stages a block (stage groups on grid.y)
    wps: int         # warps a stage
    tb: int          # bricks a ring slot
    nst: int         # ring slots
    per_block: int   # bricks of each block's contiguous range
    blocks: int
    cgrp: int        # output group widths: x's channels
    ogrp: int        # and dy's
    smem: int        # dynamic shared memory a block, bytes
    groups: int      # grid.y: stage groups x output groups

    def ints(self):
        return (ctypes.c_longlong * 9)(self.sg, self.wps, self.tb, self.nst, self.per_block,
                                       self.blocks, self.cgrp, self.ogrp, self.smem)


def ring_plan(rows: int, s: int, c: int, o: int, esz: int) -> RingPlan:
    """K11's ring-form plan from the shapes alone (so are dw's bits): rows
    of a stage in bricks of 64 (the last one ragged), stage groups of at
    most 16 (fewer where a brick's rows would pass half the ring), warps a
    stage so that a block has at least 8, tiles of whole bricks near
    RING_TILE bytes, a ring of up to 8 slots in RING_BYTES, one block an SM
    over contiguous brick ranges, output groups of at most 32 x 32.  Raises
    ValueError where a brick's rows of one stage pass half the ring."""
    if min(rows, s, c, o) < 1:
        raise ValueError(f"wgrad needs a row, a stage and channels, got rows={rows} S={s} "
                         f"C={c} O={o}")
    row_bytes = SLOTS * (c + o) * esz  # one (brick, stage)
    if row_bytes > RING_BYTES // 2:
        raise ValueError(f"wgrad's ring form takes C + O <= {RING_BYTES // 2 // (SLOTS * esz)} "
                         f"at {esz}-byte elements, got C={c} O={o}")
    sg = min(s, RING_MAX_WARPS, RING_BYTES // 2 // row_bytes)
    wps = max(1, 8 // sg)
    bricks = _cdiv(rows, SLOTS)
    brick = sg * row_bytes
    tb = max(1, min(32, RING_TILE // brick, bricks))
    slot = tb * brick
    nst = max(2, min(RING_MAX_NST, RING_BYTES // slot))
    cgrp, n_cg = _groups(c, RING_GROUP, 8)
    ogrp, n_og = _groups(o, RING_GROUP, 8)
    groups = _cdiv(s, sg) * n_cg * n_og
    blocks = max(1, SMS // groups)
    per = _cdiv(bricks, blocks)
    smem = RING_HDR + max(nst * slot, sg * wps * cgrp * ogrp * 4)
    return RingPlan(sg, wps, tb, nst, per, _cdiv(bricks, per), cgrp, ogrp, smem, groups)


class GatherPlan(NamedTuple):
    cgrp: int        # output group widths: x's channels
    ogrp: int        # and dy's
    per_block: int   # nodes of each block's range, whole tiles
    blocks: int
    smem: int        # dynamic shared memory a block, bytes
    groups: int      # grid.y: tap groups x output groups

    def ints(self):
        return (ctypes.c_longlong * 5)(self.cgrp, self.ogrp, self.per_block, self.blocks,
                                       self.smem)


def gather_plan(n: int, k: int, c: int, o: int) -> GatherPlan:
    """K11's gather-form plan from the shapes alone (so are dw's bits): tap
    groups of 32 and output groups of at most 16 x 16 on grid.y, two blocks
    an SM where their shared memory allows it (Cin <= 8), else one, over
    contiguous node ranges of whole 64-node tiles."""
    if min(n, k, c, o) < 1:
        raise ValueError(f"wgrad needs a node, a tap and channels, got N={n} K={k} C={c} O={o}")
    cgrp, n_cg = _groups(c, G_GROUP, 4)
    ogrp, n_og = _groups(o, G_GROUP, 4)
    smem = G_OFF_X + G_WARPS * G_TPW * G_TILE * _cdiv(cgrp, 4) * 4 * 4
    per_sm = max(1, min(2, SMEM_SM // (smem + 1024)))
    groups = _cdiv(k, G_TAPS) * n_cg * n_og
    blocks = max(1, per_sm * SMS // groups)
    per = _cdiv(_cdiv(n, blocks), G_TILE) * G_TILE
    return GatherPlan(cgrp, ogrp, per, _cdiv(n, per), smem, groups)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself if its data is 16-byte aligned (bulk and 16-byte copies need
    it; a fresh allocation is), else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stage_major(t: torch.Tensor) -> bool:
    """t (Bb, S, ...) is laid out (S, Bb, ...) in memory: a permuted view,
    as torch.einsum leaves its output."""
    return t.dim() >= 2 and t.shape[1] > 1 and t.transpose(0, 1).is_contiguous()


def _ring_layout(t: torch.Tensor):
    """(t or a contiguous copy, stage-major?): the ring form reads
    brick-major (contiguous) and stage-major rows."""
    if t.is_contiguous():
        return _aligned(t), False
    if _stage_major(t):
        return (t, True) if t.data_ptr() % 16 == 0 else (t.contiguous(), False)
    return t.contiguous(), False


def _ring(x, dy, rows: int, s: int, c: int, o: int, dw):
    """K11's ring form into dw: x (rows / 64, S, 64*C), dy of one dtype on
    one card, each brick-major or stage-major."""
    plan = ring_plan(rows, s, c, o, x.element_size())
    part = torch.empty((plan.blocks, s, c, o), dtype=torch.float32, device=x.device)
    (x, xsm), (dy, dsm) = _ring_layout(x), _ring_layout(dy)
    with torch.cuda.device(x.device):
        err = cuda_build.load("wgrad").wgrad_ring(
            x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
            int(x.dtype == torch.bfloat16), rows, s, c, o, int(xsm), int(dsm), plan.ints(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"wgrad ring kernel launch failed (CUDA error {err})")


# ------------------------------------------------------- superbrick form --


def _check_sb(x, dy, c: int, o: int):
    if x.dim() != 3 or x.shape[2] != SLOTS * c:
        raise ValueError(f"wgrad_sb takes x (Bb, S, 64*{c}), got {tuple(x.shape)}")
    if tuple(dy.shape) != (x.shape[0], x.shape[1], SLOTS * o):
        raise ValueError(f"wgrad_sb: dy has shape {tuple(dy.shape)}, expected "
                         f"{(x.shape[0], x.shape[1], SLOTS * o)}")
    if dy.device != x.device or dy.dtype != x.dtype:
        raise ValueError("wgrad_sb: dy must match x's device and dtype")
    if x.dtype not in DTYPES:
        raise TypeError(f"wgrad_sb takes {DTYPES}, got {x.dtype}")


def wgrad_sb_plain(x, dy, c: int, o: int):
    """The plain version of K11's superbrick form: the einsum's weight
    gradient summed in f32 and rounded once to x's dtype (on the CPU the
    bits of the bf16 einsum's own backward; cuBLAS's bf16 product of the
    same sums is off by more than an ulp)."""
    bb, s, _ = x.shape
    return torch.einsum("bsvc,bsvo->sco", x.reshape(bb, s, SLOTS, c).float(),
                        dy.reshape(bb, s, SLOTS, o).float()).to(x.dtype)


def wgrad_sb(x, dy, c: int, o: int):
    """dw (S, c, o) in x's dtype = sum over the bricks and slots of x[b, s,
    v*c + c'] dy[b, s, v*o + o']: K11 on CUDA tensors (each contiguous, or
    a stage-major view as an einsum leaves it), the plain version on CPU
    ones."""
    _check_sb(x, dy, c, o)
    if x.device.type == "cpu":
        return wgrad_sb_plain(x, dy, c, o)
    if x.device.type != "cuda":
        raise ValueError(f"wgrad_sb runs on CUDA or CPU tensors, not {x.device}")
    if not all(t.is_contiguous() or _stage_major(t) for t in (x, dy)):
        raise ValueError("wgrad_sb takes contiguous or stage-major tensors")
    bb, s, _ = x.shape
    dw = torch.empty((s, c, o), dtype=x.dtype, device=x.device)
    if bb == 0:
        return dw.zero_()
    _ring(x, dy, bb * SLOTS, s, c, o, dw)
    wgrad_sb.launches += 1
    return dw


wgrad_sb.launches = 0


# ----------------------------------------------------------- gather form --


def _check_gather(x, dy, idx):
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"wgrad_gather takes x (N, Cin), dy (N, Cout), got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}")
    if idx is not None and (idx.dim() != 2 or idx.shape[1] != x.shape[0]):
        raise ValueError(f"wgrad_gather: idx has shape {tuple(idx.shape)}, expected (K, "
                         f"{x.shape[0]})")
    if any(t.device != x.device for t in (dy, idx) if t is not None):
        raise ValueError("wgrad_gather takes tensors on one device")


def wgrad_gather_plain(x, dy, idx=None):
    """The plain version of K11's gather form: the 1^3 conv's matmul, or
    the k^3 conv's gather + batched matmul (ops/gather_conv.py)."""
    if idx is None:
        return (x.t() @ dy)[None]
    from .gather_conv import gather_conv_dw

    return gather_conv_dw(x, idx, dy)


def wgrad_gather(x, dy, idx=None):
    """dw (K, Cin, Cout) f32 = sum_n x[idx[k, n]] (x) dy[n] (K = 1 and x's
    own rows where idx is None): K11 on CUDA tensors (f32, an int32 map,
    contiguous), the plain version on CPU ones."""
    _check_gather(x, dy, idx)
    if x.device.type == "cpu":
        return wgrad_gather_plain(x, dy, idx)
    if x.device.type != "cuda":
        raise ValueError(f"wgrad_gather runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError(f"wgrad_gather takes float32 x and dy, got {x.dtype}, {dy.dtype}")
    if idx is not None and idx.dtype != torch.int32:
        raise TypeError(f"wgrad_gather takes an int32 idx, got {idx.dtype}")
    if not all(t.is_contiguous() for t in (x, dy, idx) if t is not None):
        raise ValueError("wgrad_gather takes contiguous tensors")
    (n, c), o = x.shape, dy.shape[1]
    k = 1 if idx is None else idx.shape[0]
    dw = torch.empty((k, c, o), dtype=torch.float32, device=x.device)
    if n == 0 or min(k, c, o) == 0:
        return dw.zero_()
    if idx is None:  # the 1^3 conv: contiguous rows, the ring form at S = 1
        _ring(x, dy, n, 1, c, o, dw)
    else:
        plan = gather_plan(n, k, c, o)
        part = torch.empty((plan.blocks, k, c, o), dtype=torch.float32, device=x.device)
        x, dy, idx = _aligned(x), _aligned(dy), _aligned(idx)
        with torch.cuda.device(x.device):
            err = cuda_build.load("wgrad").wgrad_gather_f32(
                x.data_ptr(), dy.data_ptr(), idx.data_ptr(), part.data_ptr(), dw.data_ptr(), n, k,
                c, o, plan.ints(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wgrad gather kernel launch failed (CUDA error {err})")
    wgrad_gather.launches += 1
    return dw


wgrad_gather.launches = 0


# --------------------------------------------------- the 1^3 conv products --


class _WGrad(torch.autograd.Function):
    """The identity on a 1^3 conv's product y = x w, computed on w
    detached, that gives w its gradient: the backward passes dy on to y's
    own graph (dx as autograd computed it before) and returns dw by K11."""

    @staticmethod
    def forward(ctx, y, x, w, form):
        ctx.save_for_backward(x)
        ctx.form = form
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dw = None
        if ctx.needs_input_grad[2]:
            if ctx.form == "sb":  # x4 and dy as they come, brick- or stage-major
                bb, s, _, c = x.shape
                o = dy.shape[-1]
                dw = wgrad_sb(_slot_rows(x), _slot_rows(dy), c, o)
            else:
                dw = wgrad_gather(x, dy.contiguous())[0]
        return dy if ctx.needs_input_grad[0] else None, None, dw, None


def _slot_rows(t4):
    """(Bb, S, 64, C) -> (Bb, S, 64*C) without a copy where t4 is
    brick-major or stage-major (the layouts K11's ring form reads)."""
    bb, s, v, c = t4.shape
    if t4.is_contiguous() or t4.transpose(0, 1).is_contiguous():
        return t4.view(bb, s, v * c)
    return t4.reshape(bb, s, v * c)


def sb_conv1_product(x4, w):
    """The superbrick 1^3 conv's product: x4 (Bb, S, 64, C), w (S, C, O) of
    one dtype -> (Bb, S, 64, O), sbconv1's einsum; dw by K11, which reads
    x4 as it is saved (the einsum leaves its output stage-major, so the
    next 1^3 conv's input is a permuted view: no copy of it is kept)."""
    y = torch.einsum("bsvc,sco->bsvo", x4, w.detach())
    if not (torch.is_grad_enabled() and w.requires_grad):
        return y
    return _WGrad.apply(y, x4.detach(), w, "sb")


def gather_conv1_product(x, w):
    """The gather backend's 1^3 conv product: x (N, Cin) @ w (Cin, Cout);
    dw by K11."""
    y = x @ w.detach()
    if not (torch.is_grad_enabled() and w.requires_grad):
        return y
    return _WGrad.apply(y, x.detach().contiguous(), w, "gather")
