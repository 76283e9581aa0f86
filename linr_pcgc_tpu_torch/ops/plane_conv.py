"""The slot-major conv products, the ports of the three kernels of
linr_pcgc_tpu/ops/pallas_conv.py:

  * K1 ``plane_matmul_bm`` (``_fwd_bm_kernel``): the conv forward with its
    bias + mask epilogue;
  * K3 ``plane_matmul`` (``_fwd_kernel``): the same product without the
    epilogue, for the backward's dx = halo(dy * mask) @ Wt;
  * K4 ``plane_moment`` (``_moment_kernel``): the compact windowed moment
    x^T halo(dy * mask) that superbricks.moment_taps turns into dw.

The TPU kernels multiply the halo by the conv matrix w2
(taps.b4_conv_weight_matrix_sm): the 16 slots of output x-plane p in 0..3
read the window [p*36*C, (p+3)*36*C) of the slot-major halo, four products
of depth 108*C.  Each slot reads 27 of those 108 halo columns, so K1 and K3
take the taps w (S, 27, C, O) instead and compute the stencil alone: slot u
reads halo column T[u, k] (taps.tap_columns) for tap k.  Their plain
versions build w2 from the same taps and keep the window products, i.e.
they compute what the TPU kernels compute.

Each wrapper launches its CUDA kernel (csrc/plane_conv.cu,
csrc/plane_moment.cu) on a CUDA tensor and runs its ``*_plain`` twin on a
CPU tensor; there is no other path.  Inputs may be float32 or bfloat16
(all one dtype); every version accumulates in float32.  K1 and K3 round
once to the input dtype; K4 returns float32.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .taps import B4, B4_HALO_VOL, B4_PLANE, B4_SLOTS, TAPS, b4_conv_weight_matrix_sm, tap_columns

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


# ------------------------------------------------------------- K4: moment --

MOMENT_BK = 32           # bricks per staged chunk in csrc/plane_moment.cu
MOMENT_TILE = 64         # its M and N tile
MOMENT_TARGET_BLOCKS = 132 * 16  # two waves of 8 blocks on each of the 132 SMs


def _check_moment(x, g, kc, no):
    bb, s, uk = x.shape
    if uk != B4_SLOTS * kc:
        raise ValueError(f"x has {uk} columns, expected 64*{kc}")
    if tuple(g.shape) != (bb, s, B4_HALO_VOL * no):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {(bb, s, B4_HALO_VOL * no)}")
    if g.device != x.device or g.dtype != x.dtype:
        raise ValueError("g must match x's device and dtype")
    if x.dtype not in DTYPES:
        raise TypeError(f"plane_moment takes {DTYPES}, got {x.dtype}")


def moment_splits(bb: int, s: int, kc: int, no: int) -> int:
    """How many brick ranges K4 sums separately: enough blocks for about
    two waves, never a range under one staged chunk.  A function of the
    shapes alone, so the moment's bits are too."""
    tiles = -(-16 * kc // MOMENT_TILE) * -(-108 * no // MOMENT_TILE) * s * B4
    return max(1, min(-(-bb // MOMENT_BK), -(-MOMENT_TARGET_BLOCKS // tiles)))


def plane_moment_plain(x, g, kc: int, no: int):
    """The plain PyTorch version of K4: four f32 window moments."""
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
    """m (S, 4, 16*kc, 108*no) f32: m[s, p] = x[:, s, plane p]^T @
    g[:, s, window p], summed over the bricks (K4).  x (Bb, S, 64*kc) the
    conv's input; g (Bb, S, 216*no) the halo of its masked output
    cotangent."""
    if x.device.type == "cpu":
        return plane_moment_plain(x, g, kc, no)
    if x.device.type != "cuda":
        raise ValueError(f"plane_moment runs on CUDA or CPU tensors, not {x.device}")
    _check_moment(x, g, kc, no)
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("plane_moment takes contiguous tensors")
    bb, s, _ = x.shape
    splits = moment_splits(bb, s, kc, no)
    m = torch.empty((s, B4, 16 * kc, 108 * no), dtype=torch.float32, device=x.device)
    ws = torch.empty((splits,) + tuple(m.shape), dtype=torch.float32, device=x.device)
    lib = cuda_build.load("plane_moment")
    fn = lib.plane_moment_f32 if x.dtype == torch.float32 else lib.plane_moment_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), ws.data_ptr(), m.data_ptr(), bb, s, kc, no,
                 splits, stream)
    if err:
        raise RuntimeError(f"plane_moment kernel launch failed (CUDA error {err})")
    plane_moment.launches += 1
    return m


plane_moment.launches = 0
