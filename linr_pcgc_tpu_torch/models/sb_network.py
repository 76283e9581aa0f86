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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .network import ModelConfig, stack_outer_blocks
from ..ops.superbricks import B4_SLOTS, b4_convsm_bm
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


def sbconv1(x, geom, w, b):
    """Stage-batched 1^3 conv: x (Bb, S, 64*C), w (S, C, O), b (S, O): one
    per-stage product over the (Bb*64, C) slot rows, + bias, * mask; its
    weight gradient is K11 (ops/wgrad.py)."""
    dt = geom["dtype"]
    bb, s, vc = x.shape
    c, o = w.shape[-2], w.shape[-1]
    y = sb_conv1_product(x.to(dt).reshape(bb, s, B4_SLOTS, c), w.to(dt))
    y = y.reshape(bb, s, B4_SLOTS * o) + b.repeat(1, B4_SLOTS)[None].to(dt)
    return (y * _mask_flat(geom, o)).to(dt)


def sbconv3(x, geom, w, b):
    """The slot-major 3^3 conv (the only layout the codec uses)."""
    return b4conv3_sm(x, geom, w, b)


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
    (start, end, scale_idx) over the brick axis.  Returns (Bb, 1, 64*ch)."""
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
    (Bb, 1, 64*ch)."""
    intensor = sb_input_features(params, cfg, geom, level_slices)
    return _sb_block(intensor, geom, _stack1(params["block_in"]))


def sb_chunk_logits(params, cfg: ModelConfig, geom, occ_t, base: int, cs: int,
                    x_glob, first: bool = False):
    """Logits (Bb, cs, 64) for the ``cs`` stages from ``base``, given
    ``x_glob``.  Stage j's context block is outer[clip(j-1, 0)] gated by
    [j > 0]; occupancy channel c is visible to stage j iff c < j, so the
    encoder's ground truth and the decoder's partial buffer produce
    identical values.  ``first`` drops the gated-off stage-0 row, and only
    at cs >= 3 (at cs <= 2 it is normalised to off, as in the JAX codec)."""
    dt = geom["dtype"]
    dev = occ_t.device
    k = cfg.outstage - 1
    occ_f = occ_t.to(dt)
    rows = torch.arange(base, base + cs, device=dev)
    first = first and cs >= 3
    crows = rows[1:] if first else rows
    tri = (crows[:, None] > torch.arange(k, device=dev)[None, :]).to(dt)
    occ_b = _occ_context_input(occ_f[:, :k, :], tri, geom)

    st = stack_outer_blocks(params, cfg)
    idx = (crows - 1).clamp(min=0)
    tk = lambda a: a[idx]
    outer = {
        "conv_in": {"w": tk(st["conv_in_w"]), "b": tk(st["conv_in_b"])},
        "irn": _map_tree(tk, st["irn"]),
        "conv_out": _map_tree(tk, st["conv_out"]),
    }
    if first and cs == 1:
        ctx_full = x_glob
    elif first:
        ctx = _sb_block(occ_b, geom, outer)
        ctx_full = torch.cat([x_glob, x_glob + ctx], dim=1)
    else:
        ctx = _sb_block(occ_b, geom, outer)
        gate = (rows > 0).to(dt)[None, :, None]
        ctx_full = x_glob + gate * ctx

    tr = lambda a: a[rows]
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
    context row, and only at cs >= 3, as in sb_chunk_logits."""
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

    st = stack_outer_blocks(params, cfg)
    idx = (crows - 1).clamp(min=0)
    cat = lambda b_leaf, o_rows: torch.cat([b_leaf[None], o_rows[idx]], dim=0)
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

    tr = lambda a: a[rows]
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
