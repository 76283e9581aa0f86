"""The weight gradient of the skinny convs: K11.

The 1^3 convs of both trainers, and the gather backend's k^3 conv, reduce
their weight gradient over ~1 M rows into an output of a few hundred
values: on the TPU XLA work (linr_pcgc_tpu/models/sb_network.py:205
``sbconv1``, models/network.py:375 ``_conv1``, models/network.py:412
``_conv3_op_bwd``'s ``dot_general`` :431), here one CUDA kernel,
csrc/wgrad.cu, with two entries:

* ``wgrad_sb``: x (Bb, S, 64*C), dy (Bb, S, 64*O) slot-major -> dw (S, C,
  O) in x's dtype, ``sum_{b, v} x[b, s, v*C + c] * dy[b, s, v*O + o]``;
* ``wgrad_gather``: x (N, Cin), dy (N, Cout) f32 node-major, idx (K, N)
  int32 or None -> dw (K, Cin, Cout) f32, ``sum_n x[idx[k, n], c] *
  dy[n, o]`` (a negative idx adds nothing; None is K = 1 and x's own row).

Each launches the kernel on CUDA tensors and runs its plain version (the
einsum, or the matmul, or the gather + matmul that autograd ran before) on
CPU tensors; there is no other path.  The kernel sums in f32 in a fixed
order: per thread its rows in order, per warp a shuffle butterfly, per
block its warps in order, then the blocks' partials in range order, under
a plan from the shapes alone (``wgrad_plan``), so two launches give the same
bits; bf16 is rounded once at the end.

``sb_conv1_product`` and ``gather_conv1_product`` are the 1^3 convs'
products with their gradient: the forward product and its dx are autograd's
own (the same einsum or matmul on the weight detached, so the same bits as
before), and ``_WGrad``, the identity on the product's output, adds dw by
K11.  ``ops/gather_conv.py``'s autograd Function takes its dw from
``wgrad_gather`` with the conv's neighbour map.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_build
from .plane_conv import DTYPES

SLOTS = 64                # slots of a 4^3 brick: the superbrick form's rows per brick
WGRAD_THREADS = 256       # csrc/wgrad.cu's block
WGRAD_BLOCKS = 2 * 132    # two resident blocks on each SM of an H100 SXM
WGRAD_TILES = ((8, 8), (8, 4), (4, 4), (32, 2))  # csrc/wgrad.cu's (CT, OT) register tiles
_ROW_STEP = 2 * WGRAD_THREADS  # a range is whole steps of the kernel's row loop


class WgradPlan(NamedTuple):
    ct: int          # the register tile: x's channels
    ot: int          # and dy's
    tiles: int       # tiles over C x O, the last ones masked
    ranges: int      # contiguous row ranges of each group, one block each per tile
    per_range: int   # rows of a range (the last one ragged)


def _tile_cost(c: int, o: int, tile) -> int:
    """A row's FMAs and loads of a thread, over every tile of C x O."""
    ct, ot = tile
    return -(-c // ct) * -(-o // ot) * (ct * ot + ct + ot)


def wgrad_plan(rows: int, groups: int, c: int, o: int) -> WgradPlan:
    """K11's launch plan from the shapes alone (so are dw's bits): the
    register tile with the fewest FMAs and loads a row (the first of
    equals), then each group's rows cut into contiguous ranges, a whole
    number of 512-row steps each, so that groups x tiles x ranges is about
    WGRAD_BLOCKS blocks."""
    if min(rows, groups, c, o) < 1:
        raise ValueError(f"wgrad needs a row, a group and channels, got rows={rows} "
                         f"groups={groups} C={c} O={o}")
    ct, ot = min(WGRAD_TILES, key=lambda t: _tile_cost(c, o, t))
    tiles = -(-c // ct) * -(-o // ot)
    want = max(1, WGRAD_BLOCKS // (groups * tiles))
    per = -(-(-(-rows // want)) // _ROW_STEP) * _ROW_STEP
    return WgradPlan(ct, ot, tiles, -(-rows // per), per)


def _launch(fn, ptrs, rows: int, groups: int, c: int, o: int, out):
    """Plan, partials and launch of one entry into ``out``."""
    plan = wgrad_plan(rows, groups, c, o)
    part = torch.empty((plan.ranges, groups, c, o), dtype=torch.float32, device=out.device)
    with torch.cuda.device(out.device):
        err = fn(*ptrs, part.data_ptr(), out.data_ptr(), rows, groups, c, o, plan.ct, plan.ot,
                 plan.ranges, plan.per_range, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"wgrad kernel launch failed (CUDA error {err})")


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
    v*c + c'] dy[b, s, v*o + o']: K11 on CUDA tensors (contiguous), the
    plain version on CPU ones."""
    _check_sb(x, dy, c, o)
    if x.device.type == "cpu":
        return wgrad_sb_plain(x, dy, c, o)
    if x.device.type != "cuda":
        raise ValueError(f"wgrad_sb runs on CUDA or CPU tensors, not {x.device}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("wgrad_sb takes contiguous tensors")
    bb, s, _ = x.shape
    dw = torch.empty((s, c, o), dtype=x.dtype, device=x.device)
    if bb == 0:
        return dw.zero_()
    lib = cuda_build.load("wgrad")
    fn = lib.wgrad_sb_f32 if x.dtype == torch.float32 else lib.wgrad_sb_bf16
    _launch(fn, (x.data_ptr(), dy.data_ptr()), bb * SLOTS, s, c, o, dw)
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
    _launch(cuda_build.load("wgrad").wgrad_gather_f32,
            (x.data_ptr(), dy.data_ptr(), 0 if idx is None else idx.data_ptr()), n, k, c, o, dw)
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
            g = dy.contiguous()  # y's own graph gets dy as it came
            if ctx.form == "sb":
                bb, s, _, c = x.shape
                o = g.shape[-1]
                dw = wgrad_sb(x.reshape(bb, s, SLOTS * c), g.reshape(bb, s, SLOTS * o), c, o)
            else:
                dw = wgrad_gather(x, g)[0]
        return dy if ctx.needs_input_grad[0] else None, None, dw, None


def sb_conv1_product(x4, w):
    """The superbrick 1^3 conv's product: x4 (Bb, S, 64, C), w (S, C, O) of
    one dtype -> (Bb, S, 64, O), sbconv1's einsum; dw by K11."""
    y = torch.einsum("bsvc,sco->bsvo", x4, w.detach())
    if not (torch.is_grad_enabled() and w.requires_grad):
        return y
    return _WGrad.apply(y, x4.detach().contiguous(), w, "sb")


def gather_conv1_product(x, w):
    """The gather backend's 1^3 conv product: x (N, Cin) @ w (Cin, Cout);
    dw by K11."""
    y = x @ w.detach()
    if not (torch.is_grad_enabled() and w.requires_grad):
        return y
    return _WGrad.apply(y, x.detach().contiguous(), w, "gather")
