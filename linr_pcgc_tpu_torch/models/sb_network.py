"""Stage-batched slot-major forward of the occupancy network: the codec's
probability producer and the trainer's fused pass.

Port of the slot-major forward of linr_pcgc_tpu/models/sb_network.py.
Activations are (Bb, S, 64*C): bricks, a static stage batch S, and the 64
slots with channels contiguous per slot.  Unoccupied slots are kept exactly
zero after every conv (bias, then the slot mask), which makes the dense
brick convolution equal to the submanifold convolution of the reference.

``geom`` is dict(nbr27 (Bb, 27) int32, mask (Bb, 1, 1, 64), code (Bb, 64),
dtype).  Every 3^3 conv goes through ops.superbricks.b4_convsm_bm, i.e.
the halo gather K2 then the plane matmul K1, and its gradient through K2,
K3 and K4; every 1^3 conv's weight gradient through K11.  Parameters come
as the nested view of models.network.param_tree.

JAX's other layouts are taken at the boundary and mapped onto this pass,
never given a pass of their own: the convs take channel-major (Bb, S, C,
64) and (Bb, S, C, 512) tensors, and the public functions take a geom on
JAX's 8^3 superbricks (code (Bb, 512)).  Such a geom is mapped once at
entry onto its 4^3 sub-bricks (ops.superbricks.sub_brick_geom), the
slot-major pass runs unchanged, and the result comes back in JAX's order:
logits (Bb, S, 512), x_glob and features channel-major (Bb, 1, ch, 512).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .network import ModelConfig, stack_outer_blocks
from ..ops.superbricks import (
    B4_SLOTS,
    SB_SLOTS,
    b4_convsm_bm,
    from_sub_bricks,
    sub_brick_geom,
    sub_brick_slices,
    to_channel_major,
    to_slot_major,
    to_sub_bricks,
)
from ..ops.wgrad import sb_conv1_product


def _relu(x):
    return torch.clamp_min(x, 0.0)


def _mask_flat(geom, o: int):
    """Slot mask repeated over ``o`` channel-minor lanes: (Bb, 1, 64*o)."""
    return geom["mask"][:, 0, 0, :].repeat_interleave(o, dim=-1)[:, None, :]


def b4conv3_sm(x, geom, w, b):
    """Stage-batched 3^3 conv: x (Bb, S, 64*C), w (S, 27, C, O), b (S, O)
    -> (Bb, S, 64*O) through K2 -> K1 with the bias + mask epilogue."""
    dt = geom["dtype"]
    return b4_convsm_bm(x.to(dt).contiguous(), w, b, geom["mask"][:, 0, 0, :], geom["nbr27"])


def _side8(geom) -> bool:
    """Whether ``geom`` lies on JAX's 8^3 superbricks (512 slots)."""
    return geom["code"].shape[-1] == SB_SLOTS


def _sub_in(x):
    """Channel-major (Bb, S, C, 512) -> slot-major sub-bricks (8Bb, S, 64*C)."""
    return to_slot_major(to_sub_bricks(x))


def _sub_out(y):
    """Slot-major sub-bricks (8Bb, S, 64*C) -> channel-major (Bb, S, C, 512)."""
    return from_sub_bricks(to_channel_major(y))


def sbconv1(x, geom, w, b):
    """Stage-batched 1^3 conv: x (Bb, S, 64*C), w (S, C, O), b (S, O): one
    per-stage product over the (Bb*64, C) slot rows, + bias, * mask; its
    weight gradient is K11 (ops/wgrad.py).  A channel-major x (Bb, S, C,
    64 or 512) is relaid onto that product and its output (Bb, S, O,
    slots) given back channel-major."""
    if x.ndim == 4:
        if x.shape[-1] == B4_SLOTS:
            return to_channel_major(sbconv1(to_slot_major(x), geom, w, b))
        return _sub_out(sbconv1(_sub_in(x), sub_brick_geom(geom), w, b))
    dt = geom["dtype"]
    bb, s, vc = x.shape
    c, o = w.shape[-2], w.shape[-1]
    y = sb_conv1_product(x.to(dt).reshape(bb, s, B4_SLOTS, c), w.to(dt))
    y = y.reshape(bb, s, B4_SLOTS * o) + b.repeat(1, B4_SLOTS)[None].to(dt)
    return (y * _mask_flat(geom, o)).to(dt)


def b4conv3(x, geom, w, b):
    """JAX's channel-major 4^3 conv: x (Bb, S, C, 64) -> (Bb, S, O, 64),
    as b4conv3_sm on the relaid tensor."""
    return to_channel_major(b4conv3_sm(to_slot_major(x), geom, w, b))


def sbconv3(x, geom, w, b):
    """Stage-batched 3^3 conv on any of JAX's layouts: slot-major (Bb, S,
    64*C) (the codec's and the trainers'), channel-major (Bb, S, C, 64)
    (b4conv3), or channel-major on 8^3 superbricks (Bb, S, C, 512), which
    runs on the sub-brick map of x and ``geom`` (a 512-slot geom) and comes
    back as (Bb, S, O, 512)."""
    if x.ndim == 3:
        return b4conv3_sm(x, geom, w, b)
    if x.shape[-1] == B4_SLOTS:
        return b4conv3(x, geom, w, b)
    return _sub_out(b4conv3_sm(_sub_in(x), sub_brick_geom(geom), w, b))


def _sb_irn(x, geom, p):
    """InceptionResNet, stage-batched: the two branches' leading 3^3 convs
    (c00 on x, c11 on relu(c10(x))) run as ONE conv over the per-slot
    channel concatenation with block weights (block-zero positions add
    exact 0.0 terms)."""
    bb, s, _ = x.shape
    c = p["c00"]["w"].shape[-2]
    h = c // 2
    t = _relu(sbconv1(x, geom, p["c10"]["w"], p["c10"]["b"]))
    xc = torch.cat(
        [x.reshape(bb, s, B4_SLOTS, c), t.reshape(bb, s, B4_SLOTS, h)], dim=-1
    ).reshape(bb, s, -1)
    w00, w11 = p["c00"]["w"], p["c11"]["w"]  # (S, 27, c, h), (S, 27, h, h)
    w_cat = w00.new_zeros((w00.shape[0], w00.shape[1], c + h, c))
    w_cat[:, :, :c, :h] = w00
    w_cat[:, :, c:, h:] = w11
    b_cat = torch.cat([p["c00"]["b"], p["c11"]["b"]], dim=-1)
    y = b4conv3_sm(xc, geom, w_cat, b_cat).reshape(bb, s, B4_SLOTS, c)
    out0 = sbconv3(_relu(y[..., :h]).reshape(bb, s, -1), geom, p["c01"]["w"], p["c01"]["b"])
    out1 = sbconv1(_relu(y[..., h:]).reshape(bb, s, -1), geom, p["c12"]["w"], p["c12"]["b"])
    h0 = out0.reshape(bb, s, B4_SLOTS, -1)
    h1 = out1.reshape(bb, s, B4_SLOTS, -1)
    return torch.cat([h0, h1], dim=-1).reshape(bb, s, -1) + x


def _sb_resnet(x, geom, p):
    h = _relu(sbconv3(x, geom, p["r0"]["w"], p["r0"]["b"]))
    return x + sbconv3(h, geom, p["r1"]["w"], p["r1"]["b"])


def _sb_block_core(y, geom, p):
    """ResNetBlock: stacked cores + outer skip when more than one."""
    if "irn" in p:
        return _sb_irn(y, geom, p["irn"])
    out = y
    for lp in p["core"]:
        if "dc0" in lp:
            raise NotImplementedError(
                "DilatedResNet needs a second neighbour map the brick layout "
                "does not carry; it runs on the gather backend (ROADMAP A.4.1)"
            )
        out = _sb_irn(out, geom, lp) if "c00" in lp else _sb_resnet(out, geom, lp)
    if len(p["core"]) > 1:
        out = out + y
    return out


def _sb_block(x, geom, p):
    """make_block: conv -> relu -> ResNetBlock -> conv."""
    y = _relu(sbconv3(x, geom, p["conv_in"]["w"], p["conv_in"]["b"]))
    y = _sb_block_core(y, geom, p)
    return sbconv3(y, geom, p["conv_out"]["w"], p["conv_out"]["b"])


def _sb_mlp2(x, geom, l0, l1):
    return sbconv1(_relu(sbconv1(x, geom, l0["w"], l0["b"])), geom, l1["w"], l1["b"])


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _stack1(tree):
    """Add a leading S=1 stage axis to every leaf."""
    return _map_tree(lambda a: a[None], tree)


def sb_input_features(params, cfg: ModelConfig, geom, level_slices):
    """Per-slot input embedding: the per-level scale MLP over [scale
    embedding ++ 7 neighbour-occupancy bits]; ``level_slices`` entries are
    (start, end, scale_idx) over the brick axis.  Returns (Bb, 1, 64*ch),
    or (Bb, 1, ch, 512) on a 512-slot geom."""
    if _side8(geom):
        return _sub_out(sb_input_features(params, cfg, sub_brick_geom(geom),
                                          sub_brick_slices(level_slices)))
    dt = geom["dtype"]
    code = geom["code"]
    slots = code.shape[-1]
    feat = code & 127
    mask_v = geom["mask"][:, 0, 0, :, None]
    bits = torch.stack([((feat >> k) & 1).to(dt) for k in range(cfg.in_channel)], dim=-1)
    bits = bits * mask_v
    parts = []
    for (a, b, s) in level_slices:
        seg_geom = dict(geom, mask=geom["mask"][a:b])
        emb = params["scale_emb"][s].to(dt)
        seg = torch.cat(
            [emb[None, None, :].expand(b - a, slots, emb.shape[0]) * mask_v[a:b], bits[a:b]],
            dim=-1,
        ).reshape(b - a, 1, slots * (emb.shape[0] + cfg.in_channel))
        l0 = _stack1(_map_tree(lambda x: x[s], params["scale_mlp"]["l0"]))
        l1 = _stack1(_map_tree(lambda x: x[s], params["scale_mlp"]["l1"]))
        parts.append(_sb_mlp2(seg, seg_geom, l0, l1))
    return torch.cat(parts, dim=0)


def _occ_context_input(occ7, tri, geom):
    """The context blocks' input: 7 known-occupancy channels, channel c
    visible to stage row r iff tri[r, c].  occ7 (Bb, 7, 64), tri (S, 7)
    -> (Bb, S, 64*7) slot-major."""
    occ_v = occ7.transpose(1, 2) * geom["mask"][:, 0, 0, :, None]  # (Bb, 64, 7)
    occ_b = occ_v[:, None, :, :] * tri[None, :, None, :]
    return occ_b.reshape(occ_b.shape[0], occ_b.shape[1], -1)


def sb_x_glob(params, cfg: ModelConfig, geom, level_slices):
    """The stage-independent context: input embedding -> block_in;
    (Bb, 1, 64*ch), or (Bb, 1, ch, 512) on a 512-slot geom."""
    if _side8(geom):
        return _sub_out(sb_x_glob(params, cfg, sub_brick_geom(geom), sub_brick_slices(level_slices)))
    intensor = sb_input_features(params, cfg, geom, level_slices)
    return _sb_block(intensor, geom, _stack1(params["block_in"]))


def _context_blocks(base: int, cs: int, first: bool) -> list:
    """The context block of each context row of the ``cs`` stages from
    ``base``: outer[clip(j - 1, 0)] for stage j, stage 0's row left out when
    ``first``.  Host indices, so that the blocks are stacked as they are
    used rather than gathered from the stack of all of them."""
    return [max(j - 1, 0) for j in range(base + 1 if first else base, base + cs)]


def sb_chunk_logits(params, cfg: ModelConfig, geom, occ_t, base: int, cs: int,
                    x_glob, first: bool = False):
    """Logits (Bb, cs, 64) for the ``cs`` stages from ``base``, given
    ``x_glob``.  Stage j's context block is outer[clip(j-1, 0)] gated by
    [j > 0]; occupancy channel c is visible to stage j iff c < j, so the
    encoder's ground truth and the decoder's partial buffer produce
    identical values.  ``first`` drops the gated-off stage-0 row, and only
    at cs >= 3 (at cs <= 2 it is normalised to off, as in the JAX codec).
    On a 512-slot geom, occ_t is (Bb, 8, 512), x_glob (Bb, 1, ch, 512) and
    the logits (Bb, cs, 512)."""
    if _side8(geom):
        return from_sub_bricks(sb_chunk_logits(params, cfg, sub_brick_geom(geom),
                                               to_sub_bricks(occ_t), base, cs, _sub_in(x_glob),
                                               first))
    dt = geom["dtype"]
    dev = occ_t.device
    k = cfg.outstage - 1
    occ_f = occ_t.to(dt)
    rows = torch.arange(base, base + cs, device=dev)
    first = first and cs >= 3
    crows = rows[1:] if first else rows
    tri = (crows[:, None] > torch.arange(k, device=dev)[None, :]).to(dt)
    occ_b = _occ_context_input(occ_f[:, :k, :], tri, geom)

    st = stack_outer_blocks(params, cfg, _context_blocks(base, cs, first))
    outer = {"conv_in": {"w": st["conv_in_w"], "b": st["conv_in_b"]}, "irn": st["irn"],
             "conv_out": st["conv_out"]}
    if first and cs == 1:
        ctx_full = x_glob
    elif first:
        ctx = _sb_block(occ_b, geom, outer)
        ctx_full = torch.cat([x_glob, x_glob + ctx], dim=1)
    else:
        ctx = _sb_block(occ_b, geom, outer)
        gate = (rows > 0).to(dt)[None, :, None]
        ctx_full = x_glob + gate * ctx

    tr = lambda a: a[base:base + cs]
    im = params["inner_mlp"]
    h = sbconv3(ctx_full, geom, tr(params["prune"]["w"]), tr(params["prune"]["b"]))
    return _sb_mlp2(
        h, geom,
        {"w": tr(im["l0"]["w"]), "b": tr(im["l0"]["b"])},
        {"w": tr(im["l1"]["w"]), "b": tr(im["l1"]["b"])},
    )


def sb_fused_chunk_logits(params, cfg: ModelConfig, geom, occ_t, base: int, cs: int,
                          level_slices, first: bool = False):
    """Logits (Bb, cs, 64) for the ``cs`` stages from ``base`` with block_in
    fused into the stage-batched context pass (the trainer's pass).

    block_in and the context blocks share one architecture, so row 0 of a
    stage batch of S' = 1 + cs rows computes block_in on the input features
    (x_glob) and rows 1.. the stage contexts, over the same halo gathers.
    The occupancy input and the context blocks' conv_in weights are
    zero-padded from 7 to ``ch`` channels to match block_in's conv_in
    (zero weights add exact zeros).  ``first`` drops stage 0's gated-off
    context row, and only at cs >= 3, as in sb_chunk_logits.  On a 512-slot
    geom, occ_t is (Bb, 8, 512) and the logits (Bb, cs, 512)."""
    if _side8(geom):
        return from_sub_bricks(sb_fused_chunk_logits(params, cfg, sub_brick_geom(geom),
                                                     to_sub_bricks(occ_t), base, cs,
                                                     sub_brick_slices(level_slices), first))
    dt = geom["dtype"]
    dev = occ_t.device
    k = cfg.outstage - 1
    ch = cfg.ch
    rows = torch.arange(base, base + cs, device=dev)
    first = first and cs >= 3
    crows = rows[1:] if first else rows
    ncr = len(crows)
    tri = (crows[:, None] > torch.arange(k, device=dev)[None, :]).to(dt)
    occ_b = _occ_context_input(occ_t.to(dt)[:, :k, :], tri, geom)
    bb = occ_b.shape[0]
    occ_b = F.pad(occ_b.reshape(bb, ncr, B4_SLOTS, k), (0, ch - k)).reshape(bb, ncr, -1)
    feat = sb_input_features(params, cfg, geom, level_slices)
    xin = torch.cat([feat, occ_b], dim=1)  # (Bb, 1 + ncr, 64*ch)

    st = stack_outer_blocks(params, cfg, _context_blocks(base, cs, first))
    cat = lambda b_leaf, o_rows: torch.cat([b_leaf[None], o_rows], dim=0)
    bi = params["block_in"]
    cw = F.pad(st["conv_in_w"], (0, 0, 0, ch - k))
    blk = {
        "conv_in": {"w": cat(bi["conv_in"]["w"], cw), "b": cat(bi["conv_in"]["b"], st["conv_in_b"])},
        "irn": {name: {leaf: cat(bi["irn"][name][leaf], st["irn"][name][leaf])
                       for leaf in st["irn"][name]} for name in st["irn"]},
        "conv_out": {leaf: cat(bi["conv_out"][leaf], st["conv_out"][leaf])
                     for leaf in st["conv_out"]},
    }
    out = _sb_block(xin, geom, blk)  # (Bb, 1 + ncr, 64*ch)
    x_glob, ctx = out[:, :1], out[:, 1:]
    if first:
        ctx_full = torch.cat([x_glob, x_glob + ctx], dim=1)
    else:
        gate = (rows > 0).to(dt)[None, :, None]
        ctx_full = x_glob + gate * ctx

    tr = lambda a: a[base:base + cs]
    im = params["inner_mlp"]
    h = sbconv3(ctx_full, geom, tr(params["prune"]["w"]), tr(params["prune"]["b"]))
    return _sb_mlp2(
        h, geom,
        {"w": tr(im["l0"]["w"]), "b": tr(im["l0"]["b"])},
        {"w": tr(im["l1"]["w"]), "b": tr(im["l1"]["b"])},
    )


def _masked_bits(logits, geom, occ_t, base: int, cs: int):
    """Masked sum-BCE over the chunk's stages, in bits (f32)."""
    logits = logits.float()
    occ = occ_t[:, base:base + cs, :].float()
    bce = logits.clamp_min(0.0) - logits * occ + torch.log1p(torch.exp(-logits.abs()))
    bce = bce * geom["mask"][:, 0].float()
    return bce.sum() / math.log(2.0)


def sb_fused_chunk_bits(params, cfg: ModelConfig, geom, occ_t, base: int, cs: int,
                        level_slices, first: bool = False):
    """Masked sum-BCE bits (f32) of the ``cs`` stages from ``base`` through
    the fused pass; occ_t (Bb, 8, 64) ground truth."""
    logits = sb_fused_chunk_logits(params, cfg, geom, occ_t, base, cs, level_slices, first)
    return _masked_bits(logits, geom, occ_t, base, cs)


def sb_chunk_bits(params, cfg: ModelConfig, geom, occ_t, base: int, cs: int, x_glob):
    """Masked sum-BCE bits (f32) of the ``cs`` stages from ``base`` given
    ``x_glob`` (the unfused trainer's pass, ``first`` off as in the JAX
    trainer: stage 0's gated-off context row is computed)."""
    logits = sb_chunk_logits(params, cfg, geom, occ_t, base, cs, x_glob)
    return _masked_bits(logits, geom, occ_t, base, cs)


def sb_forward_all_stages(params, cfg: ModelConfig, geom, occ_t, level_slices,
                          stage_range=None):
    """Whole-frame logits (Bb, b - a, 64) of the stages [a, b) of
    ``stage_range`` (all of them by default): x_glob, then the stages as
    one batch given it.  Stage j's context block sees occupancy channels c
    < j, and stage 0's context is x_glob alone; occ_t (Bb, 8, 64) ground
    truth (or (Bb, 8, 512) on a 512-slot geom, the logits then (Bb, b - a,
    512))."""
    if _side8(geom):
        return from_sub_bricks(sb_forward_all_stages(params, cfg, sub_brick_geom(geom),
                                                     to_sub_bricks(occ_t),
                                                     sub_brick_slices(level_slices), stage_range))
    a, b = (0, cfg.outstage) if stage_range is None else stage_range
    x_glob = sb_x_glob(params, cfg, geom, level_slices)
    return sb_chunk_logits(params, cfg, geom, occ_t, a, b - a, x_glob, first=a == 0)


def sb_training_bits(params, cfg: ModelConfig, geom, occ_t, level_slices, stage_range=None):
    """Masked sum-BCE over the occupied slots in bits (f32, whatever the
    compute dtype) of the stages in ``stage_range``: the voxel loss."""
    a, b = (0, cfg.outstage) if stage_range is None else stage_range
    logits = sb_forward_all_stages(params, cfg, geom, occ_t, level_slices, (a, b))
    return _masked_bits(logits, geom, occ_t, a, b - a)
