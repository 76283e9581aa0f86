"""The brick network on JAX's layout: the bricks trainer's convs
(runtime/brick_overfit.py) and JAX's public brick-network functions.

Port of linr_pcgc_tpu/models/brick_network.py.  JAX keeps the activations
channel-major, (Bb, C, 64), and runs each 3^3 conv as a 6^3 halo exchange
and one dense product with the conv matrix, each 1^3 conv as an einsum.
That is the superbrick network's math at a stage batch of one, so the port
runs the network itself through models/sb_network.py on the slot-major
layout (Bb, 1, 64*C) at S = 1: every 3^3 conv is
ops.superbricks.b4_convsm_bm (K2 then K1 forward; K2, K3 and K4 backward),
every 1^3 conv ops.wgrad.sb_conv1_product (its weight gradient K11's ring
form).  This module is where JAX's brick tensors come in: ``brick_geom``,
the conv counterparts ``bconv3`` and ``bconv1`` and the network functions
(``brick_input_features``, ``brick_stage_context``, ``brick_stage_head``,
``brick_forward_all_stages``, ``brick_training_bits``) take and give JAX's
channel-major tensors, through the layout maps of ops/superbricks.py
(``to_slot_major``, ``to_channel_major``), and JAX's level slices
((start, end), one per scale).  ``halo_exchange`` and
``conv_weight_matrix`` give JAX's flat halo and dense conv matrix (the
halo by K2, its columns reordered); the port's convs use neither.

``geom`` is the superbrick network's: dict(nbr27 (Bb, 27) int32, mask (Bb,
1, 1, 64), code (Bb, 64), dtype).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.superbricks import (
    B4,
    B4_SLOTS,
    b4_halo_sm,
    halo_source_table,
    to_channel_major,
    to_slot_major,
)
from ..ops.taps import _DIRS
from .network import ModelConfig, stack_outer_blocks
from .sb_network import (
    _sb_block,
    _sb_mlp2,
    sb_forward_all_stages,
    sb_input_features,
    sb_training_bits,
    sbconv1,
    sbconv3,
)

HALO_SLOTS = 216


def brick_geom(nbr27, mask, code, dtype):
    """The network's geom from JAX's arrays: nbr27 (Bb, 27), the slot mask
    (Bb, 64) (any dtype, nonzero = occupied) and code (Bb, 64)."""
    return dict(nbr27=nbr27.int().contiguous(), mask=(mask != 0).to(dtype)[:, None, None, :],
                code=code, dtype=dtype)


def sb_level_slices(level_slices):
    """JAX's brick level slices ((start, end), ...) as the superbrick
    functions take them, ((start, end, scale), ...)."""
    return tuple((a, b, s) for s, (a, b) in enumerate(level_slices))


# -------------------------------------------------- JAX's halo and matrix --


def _src_span(a: int) -> range:
    """The slab of the neighbour in direction ``a`` (one axis) that borders
    the brick."""
    return {-1: range(B4 - 1, B4), 0: range(B4), 1: range(1)}[a]


@functools.lru_cache(maxsize=None)
def _halo_lanes():
    """JAX's flat halo: its 27 groups (one per direction, in _DIRS order),
    each the bordering slab's slots in (x, y, z) order.  Returns, per lane
    of the 216, the port's halo column of the same (direction, source slot)
    and the lane's 6^3 halo coordinate, and the group sizes."""
    column = {int(dv): f for f, dv in enumerate(halo_source_table())}
    cols, coords, sizes = [], [], []
    for k, d in enumerate(_DIRS):
        spans = [_src_span(a) for a in d]
        for sx in spans[0]:
            for sy in spans[1]:
                for sz in spans[2]:
                    cols.append(column[k * B4_SLOTS + sx * 16 + sy * 4 + sz])
                    coords.append((B4 * d[0] + sx + 1, B4 * d[1] + sy + 1, B4 * d[2] + sz + 1))
        sizes.append(len(spans[0]) * len(spans[1]) * len(spans[2]))
    return np.array(cols), coords, tuple(sizes)


@functools.lru_cache(maxsize=None)
def _lane_order(c: int):
    """JAX's (group, channel, slot) lane order over C channels: per lane,
    its group-ordered halo slot p and channel."""
    sizes = _halo_lanes()[2]
    starts = np.cumsum((0,) + sizes)
    p = np.concatenate([np.tile(np.arange(a, a + n), c) for a, n in zip(starts, sizes)])
    ch = np.concatenate([np.repeat(np.arange(c), n) for n in sizes])
    return p, ch


def halo_exchange(x, nbr27):
    """JAX's halo_exchange: x (Bb, C, 64), nbr27 (Bb, 27) -> the flat halo
    (Bb, C*216) in JAX's (group, channel, slot) lane order: K2 on the
    slot-major x (its plain version on the CPU), its columns reordered.
    Forward only: the port's convs take their gradients through
    ops.superbricks.b4_convsm_bm."""
    bb, c = x.shape[0], x.shape[1]
    h = b4_halo_sm(to_slot_major(x)[:, None].contiguous(), nbr27.int().contiguous())
    p, ch = _lane_order(c)
    idx = torch.as_tensor(_halo_lanes()[0][p] * c + ch, device=x.device)
    return h.reshape(bb, -1)[:, idx]


@functools.lru_cache(maxsize=None)
def _selection() -> np.ndarray:
    """(27, 64, 216): 1 where output slot s reads JAX's halo slot p
    through tap k."""
    lane = {hc: p for p, hc in enumerate(_halo_lanes()[1])}
    sel = np.zeros((27, B4_SLOTS, HALO_SLOTS), np.float32)
    for k, (dx, dy, dz) in enumerate(_DIRS):
        for s in range(B4_SLOTS):
            sel[k, s, lane[((s >> 4) + dx + 1, ((s >> 2) & 3) + dy + 1, (s & 3) + dz + 1)]] = 1
    return sel


def conv_weight_matrix(w):
    """JAX's dense brick-conv matrix: w (27, Cin, Cout) -> (Cin*216,
    Cout*64), rows in halo_exchange's lane order and columns (o, slot),
    so that halo_exchange(x) @ it is the conv.  Every entry is one tap's
    weight or zero."""
    cin, cout = w.shape[1], w.shape[2]
    sel = torch.as_tensor(_selection(), dtype=w.dtype, device=w.device)
    w2 = torch.einsum("ksh,kco->chos", sel, w).reshape(cin * HALO_SLOTS, cout * B4_SLOTS)
    p, ch = _lane_order(cin)
    return w2[torch.as_tensor(ch * HALO_SLOTS + p, device=w.device)]


# ------------------------------------------------------------ the network --


def bconv3(x, geom, p):
    """JAX's _bconv3 on its layout: x (Bb, Cin, 64), p {"w": (27, Cin,
    Cout), "b": (Cout,)} -> (conv(x) + b) * mask, (Bb, Cout, 64)."""
    return sbconv3(x[:, None], geom, p["w"][None], p["b"][None])[:, 0]


def bconv1(x, geom, p):
    """JAX's _bconv1 on its layout: x (Bb, Cin, 64), p {"w": (Cin, Cout),
    "b": (Cout,)} -> (x w + b) * mask, (Bb, Cout, 64)."""
    return sbconv1(x[:, None], geom, p["w"][None], p["b"][None])[:, 0]


def brick_input_features(params, cfg: ModelConfig, geom, level_slices):
    """The per-slot input embedding, (Bb, ch, 64): sb_input_features."""
    x = sb_input_features(params, cfg, geom, sb_level_slices(level_slices))
    return to_channel_major(x)[:, 0]


def brick_stage_context(params, cfg: ModelConfig, stage, x_glob, occ7, geom):
    """Stage ``stage``'s context (Bb, ch, 64): x_glob plus, past stage 0,
    the context block outer[stage - 1] on occ7 (Bb, 7, 64) with the rows
    from ``stage`` on zeroed (what the decoder does not know yet)."""
    stage = int(stage)
    k = cfg.outstage - 1
    dt = geom["dtype"]
    occ = occ7.to(dt) * (torch.arange(k, device=occ7.device) < stage).to(dt)[None, :, None]
    st = stack_outer_blocks(params, cfg, [max(stage - 1, 0)])
    blk = {"conv_in": {"w": st["conv_in_w"], "b": st["conv_in_b"]}, "irn": st["irn"],
           "conv_out": st["conv_out"]}
    ctx = to_channel_major(_sb_block(to_slot_major(occ)[:, None], geom, blk))[:, 0]
    return x_glob + (1.0 if stage > 0 else 0.0) * ctx


def _stage_layer(p, s: int):
    """Stage s's weights of a per-stage layer, as a stage batch of one."""
    return {"w": p["w"][s][None], "b": p["b"][s][None]}


def brick_stage_head(params, stage, ctx, geom):
    """Stage ``stage``'s logits (Bb, 64) from its context (Bb, ch, 64):
    the prune conv, then the inner MLP."""
    s = int(stage)
    pr = _stage_layer(params["prune"], s)
    h = sbconv3(to_slot_major(ctx)[:, None], geom, pr["w"], pr["b"])
    im = params["inner_mlp"]
    return _sb_mlp2(h, geom, _stage_layer(im["l0"], s), _stage_layer(im["l1"], s))[:, 0]


def brick_forward_all_stages(params, cfg: ModelConfig, geom, occ_t, level_slices):
    """Logits (outstage, Bb, 64) from occ_t (Bb, 8, 64), the ground truth
    (zero on empty slots, as the GOP batch holds it): sb_forward_all_stages
    with the stage axis first."""
    return sb_forward_all_stages(params, cfg, geom, occ_t,
                                 sb_level_slices(level_slices)).transpose(0, 1)


def brick_training_bits(params, cfg: ModelConfig, geom, occ_t, level_slices):
    """Masked sum-BCE over the occupied slots in bits (f32, whatever the
    compute dtype): sb_training_bits."""
    return sb_training_bits(params, cfg, geom, occ_t, sb_level_slices(level_slices))
