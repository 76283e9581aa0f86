"""The slot-major conv products, the ports of the three kernels of
linr_pcgc_tpu/ops/pallas_conv.py:

  * K1 ``plane_matmul_bm`` (``_fwd_bm_kernel``): the conv forward with its
    bias + mask epilogue;
  * K3 ``plane_matmul`` (``_fwd_kernel``): the same product without the
    epilogue, for the backward's dx = halo(dy * mask) @ Wt;
  * K4 ``plane_moment_dw`` (``_moment_kernel``): the conv's weight
    gradient dw.  The TPU kernel builds the compact windowed moment x^T
    halo(dy * mask) (``plane_moment_plain`` here), which moment_taps
    reduces to dw through a 0/1 tap selection; K4 computes the 27-tap
    stencil's dw directly, and its plain version is that two-step path.

The TPU kernels multiply the halo by the conv matrix w2
(taps.b4_conv_weight_matrix_sm): the 16 slots of output x-plane p in 0..3
read the window [p*36*C, (p+3)*36*C) of the slot-major halo, four products
of depth 108*C.  Each slot reads 27 of those 108 halo columns, so K1 and K3
take the taps w (S, 27, C, O) instead and compute the stencil alone: slot u
reads halo column T[u, k] (taps.tap_columns) for tap k.  Their plain
versions build w2 from the same taps and keep the window products, i.e.
they compute what the TPU kernels compute.  K4 likewise reduces only the
27 taps of each slot, from the same table.

Each wrapper launches its CUDA kernel (csrc/plane_conv.cu,
csrc/plane_moment.cu) on a CUDA tensor and runs its ``*_plain`` twin on a
CPU tensor; there is no other path.  Inputs may be float32 or bfloat16
(all one dtype); every version accumulates in float32.  K1 and K3 round
once to the input dtype; K4 returns float32.  ``plane_moment``, JAX's
entry to the dense moment, has no kernel: nothing on the card needs the
moment, so it runs on the CPU and raises elsewhere.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build
from .taps import (B4, B4_HALO_VOL, B4_PLANE, B4_SLOTS, TAPS, b4_conv_weight_matrix_sm, moment_taps,
                   tap_columns)

DTYPES = (torch.float32, torch.bfloat16)

# csrc/plane_conv.cu keeps a ring of at least three tiles (a halo row and,
# for K1, two mask rows each) and two output rows in one block's shared
# memory, beside its barriers and tap table
_SMEM_BLOCK = 232448 - 1024 - 128 - B4_SLOTS * TAPS * 2


def _check(h, w, kc, no, bias=None, mask=None):
    bb, s, hk = h.shape
    nn = B4_SLOTS * no
    if hk != B4_HALO_VOL * kc:
        raise ValueError(f"h has {hk} columns, expected 216*{kc}")
    operands = [("w", w, (s, TAPS, kc, no))]
    if bias is not None:
        operands += [("bias", bias, (s, nn)), ("mask", mask, (bb, B4_SLOTS))]
    for name, t, shape in operands:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != h.device or t.dtype != h.dtype:
            raise ValueError(f"{name} must match h's device and dtype")
    if h.dtype not in DTYPES:
        raise TypeError(f"the plane products take {DTYPES}, got {h.dtype}")


def _window_products(h, w, kc: int, no: int):
    """The TPU kernels' arithmetic: per output plane, the f32 product of
    the halo window with w2's window (w2 gathered from the taps w)."""
    w2 = b4_conv_weight_matrix_sm(w)
    n = 16 * no
    for p in range(B4):
        k0, k1 = p * B4_PLANE * kc, (p + 3) * B4_PLANE * kc
        yield p, torch.einsum(
            "bsk,skn->bsn", h[:, :, k0:k1].float(), w2[:, k0:k1, p * n:(p + 1) * n].float()
        )


def _launch(name, h, w, kc, no, *epilogue):
    """Check what the CUDA kernel needs beyond the shapes, launch it on
    the current stream and return y."""
    tensors = (h, w, *epilogue)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    bulk = (h, *epilogue[1:])  # h and K1's mask are fetched by bulk copies
    if any(t.data_ptr() % 16 for t in bulk):
        raise ValueError(f"{name}: h and mask must be 16-byte aligned")
    esz = h.element_size()
    mask_row = B4_SLOTS * esz if epilogue else 0
    if 3 * (B4_HALO_VOL * kc * esz + 2 * mask_row) + 2 * B4_SLOTS * no * esz > _SMEM_BLOCK:
        raise ValueError(f"{name}: a halo row of {kc} channels does not fit the kernel's ring")
    bb, s, _ = h.shape
    y = torch.empty((bb, s, B4_SLOTS * no), dtype=h.dtype, device=h.device)
    lib = cuda_build.load("plane_conv")
    fn = getattr(lib, f"{name}_{'f32' if h.dtype == torch.float32 else 'bf16'}")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), y.data_ptr(), bb, s, kc, no,
                 tap_columns().ctypes.data, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {err})")
    return y


def plane_matmul_bm_plain(h, w, kc: int, no: int, bias, mask):
    """The plain PyTorch version: per plane, f32 window product + bias,
    times the slot mask repeated over the O channels, rounded to h.dtype."""
    _check(h, w, kc, no, bias, mask)
    bb, s, _ = h.shape
    n = 16 * no
    mrep = mask.float().repeat_interleave(no, dim=-1)  # (bb, 64*no)
    out = torch.empty((bb, s, B4_SLOTS * no), dtype=h.dtype, device=h.device)
    for p, acc in _window_products(h, w, kc, no):
        acc = acc + bias[None, :, p * n:(p + 1) * n].float()
        out[:, :, p * n:(p + 1) * n] = (acc * mrep[:, None, p * n:(p + 1) * n]).to(h.dtype)
    return out


def plane_matmul_bm(h, w, kc: int, no: int, bias, mask):
    """y (Bb, S, 64*no) = conv(h; w) + bias, * mask (K1).

    h (Bb, S, 216*kc) the slot-major halo; w (S, 27, kc, no) the conv's
    taps; bias (S, 64*no) slot-tiled; mask (Bb, 64)."""
    if h.device.type == "cpu":
        return plane_matmul_bm_plain(h, w, kc, no, bias, mask)
    if h.device.type != "cuda":
        raise ValueError(f"plane_matmul_bm runs on CUDA or CPU tensors, not {h.device}")
    _check(h, w, kc, no, bias, mask)
    y = _launch("plane_matmul_bm", h, w, kc, no, bias, mask)
    plane_matmul_bm.launches += 1
    return y


plane_matmul_bm.launches = 0


# --------------------------------------------------------- K3: no epilogue --


def plane_matmul_plain(h, w, kc: int, no: int):
    """The plain PyTorch version of K3: per plane, the f32 window product,
    rounded to h.dtype."""
    _check(h, w, kc, no)
    bb, s, _ = h.shape
    n = 16 * no
    out = torch.empty((bb, s, B4_SLOTS * no), dtype=h.dtype, device=h.device)
    for p, acc in _window_products(h, w, kc, no):
        out[:, :, p * n:(p + 1) * n] = acc.to(h.dtype)
    return out


def plane_matmul(h, w, kc: int, no: int):
    """y (Bb, S, 64*no) = conv(h; w) (K3).  h (Bb, S, 216*kc); w (S, 27,
    kc, no).  In the conv's backward h is the halo of dy * mask and w the
    flipped taps with C and O swapped, so kc = O and no = C there."""
    if h.device.type == "cpu":
        return plane_matmul_plain(h, w, kc, no)
    if h.device.type != "cuda":
        raise ValueError(f"plane_matmul runs on CUDA or CPU tensors, not {h.device}")
    _check(h, w, kc, no)
    y = _launch("plane_matmul", h, w, kc, no)
    plane_matmul.launches += 1
    return y


plane_matmul.launches = 0


# ------------------------------------------------------------- K4: dw --

# csrc/plane_moment.cu's plan constants
MOMENT_SMS = 132            # persistent blocks: at most one per SM of an H100 SXM
MOMENT_MAX_WARPS = 10       # a block's warps: stages x warps per stage
MOMENT_MAX_TILE = 32        # bricks per staged tile
MOMENT_CHUNK = 512          # outputs per chunk of the runtime-shaped form
_MOMENT_SMEM = 232448 - 1024  # one block per SM, less the runtime's reserve
_MOMENT_OFF_RING = 3584     # barriers and tap table before the ring
MOMENT_PATHS = {"tensor_cores": 0, "cuda_cores": 1, "any_shape": 2}
MOMENT_SHAPES = ((8, 8), (12, 8), (4, 4), (7, 8))  # (C, O) with a form of their own: the trainer's


class MomentPlan(NamedTuple):
    path: str
    tile_bricks: int      # bricks per staged tile (one bulk copy of x, one of g)
    nst: int              # ring depth
    per_block: int        # bricks of each block's contiguous range (a whole number of tiles)
    blocks: int
    warps_per_stage: int
    stages_per_launch: int
    slot_bytes: int       # one ring slot: a tile's x and g rows, rounded up to 128
    smem: int             # dynamic shared memory per block, bytes


def moment_plan(bb: int, s: int, kc: int, no: int, dtype) -> MomentPlan:
    """K4's launch plan, from the shapes alone (so are dw's bits): the
    largest tile whose ring of 4 (else 3, 2) fits one block's shared
    memory, at most ceil(bb / 132) bricks; then contiguous brick ranges of
    a whole number of tiles, one per block, at most 132 blocks.  A warp
    owns one stage; stages beyond 10 go in further launches.  Raises
    ValueError if one brick's rows do not fit."""
    if dtype not in DTYPES:
        raise TypeError(f"plane_moment_dw takes {DTYPES}, got {dtype}")
    if min(bb, s, kc, no) < 1:
        raise ValueError("plane_moment_dw needs at least one brick, stage and channel")
    esz = 4 if dtype == torch.float32 else 2
    own = (kc, no) in MOMENT_SHAPES
    path = ("cuda_cores" if esz == 4 else "tensor_cores") if own else "any_shape"
    sg = min(s, MOMENT_MAX_WARPS)
    wps = max(1, MOMENT_MAX_WARPS // sg)
    nout = MOMENT_CHUNK if path == "any_shape" else TAPS * kc * no
    red = sg * wps * nout * 4
    brick = s * (B4_SLOTS * kc + B4_HALO_VOL * no) * esz
    avail = _MOMENT_SMEM - _MOMENT_OFF_RING
    for nst in (4, 3, 2):
        tile = (avail // nst // 128 * 128) // brick
        if tile >= 1:
            break
    if tile < 1 or red > avail:
        raise ValueError(f"plane_moment_dw: the rows of one brick ({brick} bytes) or the "
                         f"reduction ({red} bytes) do not fit a block's shared memory")
    tile = min(tile, MOMENT_MAX_TILE, -(-bb // MOMENT_SMS))
    per = -(-(-(-bb // MOMENT_SMS)) // tile) * tile
    slot = -(-tile * brick // 128) * 128
    return MomentPlan(path, tile, nst, per, -(-bb // per), wps, sg, slot,
                      _MOMENT_OFF_RING + max(nst * slot, red))


def _check_moment(x, g, kc, no):
    bb, s, uk = x.shape
    if uk != B4_SLOTS * kc:
        raise ValueError(f"x has {uk} columns, expected 64*{kc}")
    if tuple(g.shape) != (bb, s, B4_HALO_VOL * no):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {(bb, s, B4_HALO_VOL * no)}")
    if g.device != x.device or g.dtype != x.dtype:
        raise ValueError("g must match x's device and dtype")
    if x.dtype not in DTYPES:
        raise TypeError(f"plane_moment_dw takes {DTYPES}, got {x.dtype}")


def plane_moment_plain(x, g, kc: int, no: int):
    """The TPU kernel's arithmetic (the counterpart of JAX plane_moment):
    the compact windowed moment m (S, 4, 16*kc, 108*no) f32, m[s, p] =
    x[:, s, plane p]^T @ g[:, s, window p] summed over the bricks."""
    _check_moment(x, g, kc, no)
    return torch.stack([
        torch.einsum(
            "bsu,bsj->suj",
            x[:, :, p * 16 * kc:(p + 1) * 16 * kc].float(),
            g[:, :, p * B4_PLANE * no:(p + 3) * B4_PLANE * no].float(),
        )
        for p in range(B4)
    ], dim=1)


def plane_moment(x, g, kc: int, no: int):
    """The compact windowed moment (S, 4, 16*kc, 108*no) f32 of JAX's
    plane_moment, on the CPU.  The card computes the conv's weight gradient
    as K4's 27-tap stencil (plane_moment_dw) and never the dense moment, so
    any other device raises."""
    if x.device.type != "cpu":
        raise ValueError(f"plane_moment runs on CPU tensors only, not {x.device}: on a card "
                         "K4 computes dw directly (plane_moment_dw)")
    return plane_moment_plain(x, g, kc, no)


def plane_moment_dw_plain(x, g, kc: int, no: int):
    """The plain PyTorch version of K4: the dense windowed moment, then
    the tap selection, as the TPU path computes dw."""
    return moment_taps(plane_moment_plain(x, g, kc, no), kc, no)


def plane_moment_dw(x, g, kc: int, no: int):
    """dw (S, 27, kc, no) f32 = sum_b sum_u x[b, s, u*kc + c] *
    g[b, s, T[u, flip(k)]*no + o] (K4): the conv's weight gradient.  x
    (Bb, S, 64*kc) the conv's input; g (Bb, S, 216*no) the halo of its
    masked output cotangent."""
    if x.device.type == "cpu":
        return plane_moment_dw_plain(x, g, kc, no)
    if x.device.type != "cuda":
        raise ValueError(f"plane_moment_dw runs on CUDA or CPU tensors, not {x.device}")
    _check_moment(x, g, kc, no)
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("plane_moment_dw takes contiguous tensors")
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("plane_moment_dw: x and g must be 16-byte aligned (bulk copies)")
    bb, s, _ = x.shape
    dw = torch.empty((s, TAPS, kc, no), dtype=torch.float32, device=x.device)
    if bb == 0:
        return dw.zero_()
    plan = moment_plan(bb, s, kc, no, x.dtype)
    part = torch.empty((plan.blocks, s, TAPS * kc * no), dtype=torch.float32, device=x.device)
    ints = (ctypes.c_int * 8)(plan.tile_bricks, plan.nst, plan.per_block, plan.blocks,
                              plan.warps_per_stage, plan.stages_per_launch, plan.slot_bytes,
                              plan.smem)
    lib = cuda_build.load("plane_moment")
    fn = lib.plane_moment_dw_f32 if x.dtype == torch.float32 else lib.plane_moment_dw_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), bb, s, kc, no,
                 MOMENT_PATHS[plan.path], ints, tap_columns().ctypes.data, stream)
    if err:
        raise RuntimeError(f"plane_moment_dw kernel launch failed (CUDA error {err})")
    plane_moment_dw.launches += 1
    return dw


plane_moment_dw.launches = 0
