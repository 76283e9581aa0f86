"""Device-resident codec: geometry, probabilities and rANS on the device.

Port of linr_pcgc_tpu/runtime/dev_codec.py, with both of its probability
producers (fused, the default, and stage, ``LINR_CODEC_PROBS=stage``) on
both of its wires: rANS (the default) and the host arithmetic coder
(``LINR_CODEC_ENTROPY=ac``, and the mid-training test).  Both codec sides
upload only the base layer; per level the brick structure, neighbour maps
and feature codes are derived on the device from coordinates it already
holds, the probability producer runs there, and on the rANS wire the
entropy coder consumes its f16 output there:

  * level shapes come from counts both sides share (voxel buckets from
    decoded counts, brick counts from the octree identity bricks(s) =
    voxels(s+2)), with the JAX package's buckets and CODEC_FRAME_CHUNK, so
    segment lengths — and with them the rANS bytes for given
    probabilities — match the JAX codec's;
  * bit-exactness: both sides call ``_fused_probs`` with the same static
    stage width cs (derived from shared shapes, ``_fused_cs``).  The
    encoder fills every ground-truth column up front and calls it
    outstage/cs times per level; the decoder calls it once per stage on
    its partial occupancy and keeps row stage - base.  The in-network
    triangular mask multiplies channel c by exactly 0.0 for c >= stage,
    every kernel on the path is deterministic, and each stage row of a
    product is computed independently of the others, so that row equals
    the encoder's bit for bit.  The stage producer is the same pass at
    cs = 1, one stage a call on both sides (``_stage_step``).

On the AC wire the probabilities leave the card: the encoder downloads
every stage's f16 probabilities and codes them on the host
(``binary_encode_batch``); the decoder downloads one stage's at a time,
decodes its bits on the host and uploads them as the next stage's context,
a host round trip per (level, stage), as the JAX package does.  Both sides
widen the same f16 values to float32 (``_split_probs``), so the host coder
sees the same probabilities.

Buffers the JAX package donates are updated in place here.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..coding import binary_decode_batch, binary_encode_batch, pack_bitstream, unpack_bitstream
from ..data.dataset import bucket_size
from ..models.network import ModelConfig
from ..models.sb_network import sb_chunk_logits, sb_x_glob
from ..ops.coords import KEY_PAD, coord_key
from ..ops.octree import np_octree_up, octree_up_with_parent
from ..ops.rans import (
    LANES,
    pack_bit_rows,
    pack_rans_blob_flat,
    rans_compact_emissions,
    rans_decode_segment_plain,
    rans_decode_stage,
    rans_encode_segment,
    rans_initial_states,
    unpack_rans_blob,
)
from ..ops.superbricks import (
    dev_brickify,
    dev_brickify_geom,
    dev_nbr27_from_parent,
    unpack_bits,
)

B4 = 4
B4_SLOTS = 64

# Frames per device pass (deterministic on both sides).
CODEC_FRAME_CHUNK = 8


def codec_dtype() -> torch.dtype:
    """Compute dtype of the probability producer: bf16 by default,
    ``LINR_CODEC_DTYPE=f32`` for float32.  Both sides must agree; it
    travels in side_info["numerics"]["dtype"]."""
    return torch.float32 if os.environ.get("LINR_CODEC_DTYPE") == "f32" else torch.bfloat16


def _frame_chunks(f: int):
    return [list(range(a, min(a + CODEC_FRAME_CHUNK, f))) for a in range(0, f, CODEC_FRAME_CHUNK)]


def _brick_bucket(n: int) -> int:
    """Brick-count bucket (~4 per octave, 64 granularity)."""
    if n <= 64:
        return 64
    p = 1 << (int(n - 1).bit_length() - 1)
    step = max(64, p // 4)
    return ((n + step - 1) // step) * step


def _lane_bucket(n: int) -> int:
    """Per-lane byte capacity bucket for the emission compaction."""
    if n <= 32:
        return 32
    p = 1 << (int(n - 1).bit_length() - 1)
    step = max(32, p // 4)
    return -(-n // step) * step


# ------------------------------------------------------------- geometry --


def _init_level(coords: torch.Tensor, counts, bucket: int):
    """(F, B, 3) base coords -> (F, bucket, 3) coords + (F, bucket) keys."""
    c = coords[:, :bucket]
    keys = torch.stack([
        coord_key(c[i], torch.arange(bucket, device=c.device) < int(n))
        for i, n in enumerate(counts)
    ])
    return c, keys


def _brickify_level(coords, keys, counts, scale: int, brick_cap: int, tv_bucket: int):
    """Per-frame brickify (one sort per frame) + GOP-flat geometry."""
    outs = [dev_brickify(coords[i], keys[i], scale, brick_cap, B4) for i in range(keys.shape[0])]
    return _package_geo(outs, counts, brick_cap, tv_bucket)


def _brickify_level_gp2(coords, keys, counts, scale: int, parent1, parent2, keys_s2,
                        vb2, sl2, nbr27_pf2, idx_grid2, brick_cap: int, tv_bucket: int):
    """Search-free brickify: level-s bricks are level-(s+2) voxels, so the
    brick keys are ``keys_s2``, a voxel's brick is its grandparent
    ``parent2[parent1[v]]``, and the neighbour map comes from level-(s+2)'s
    geometry by gathers (dev_nbr27_from_parent)."""
    outs = []
    for i in range(keys.shape[0]):
        k2 = keys_s2[i]
        if k2.shape[0] >= brick_cap:
            k2r = k2[:brick_cap]
        else:
            k2r = torch.cat([k2, k2.new_full((brick_cap - k2.shape[0],), KEY_PAD)])
        n_bricks = int((k2r != KEY_PAD).sum())
        p1, p2 = parent1[i].long(), parent2[i]
        g1 = torch.where(p1 >= 0, p1, torch.full_like(p1, p2.shape[0] - 1))
        vb = torch.where(p1 >= 0, p2[g1], torch.full_like(p2[g1], -1)).int()
        nbr27 = dev_nbr27_from_parent(vb2[i], sl2[i], nbr27_pf2[i], idx_grid2[i], brick_cap, B4)
        outs.append(dev_brickify_geom(coords[i], keys[i], scale, brick_cap, B4, k2r,
                                      n_bricks, vb, nbr27))
    return _package_geo(outs, counts, brick_cap, tv_bucket)


def _package_geo(outs, counts, brick_cap: int, tv_bucket: int):
    """Stack per-frame geometry into the GOP-flat layout: code (F*cap, 64),
    nbr27 (F*cap, 27) with frame offsets, vox_brick/vox_slot (F, Bv), and
    the compacted per-voxel flat slot index ``sel`` (tv,) in (frame,
    canonical voxel) order, plus the maps the rANS coder and the
    search-free brickify two levels later need."""
    dev = outs[0]["code"].device
    f = len(outs)
    nbr = torch.stack([o["nbr27"] for o in outs]).int()  # (F, cap, 27)
    off = (torch.arange(f, device=dev, dtype=torch.int32) * brick_cap)[:, None, None]
    nbr_flat = torch.where(nbr >= 0, nbr + off, torch.full_like(nbr, -1)).reshape(f * brick_cap, 27)
    code_flat = torch.stack([o["code"] for o in outs]).reshape(f * brick_cap, -1)
    vox_brick = torch.stack([o["vox_brick"] for o in outs])  # (F, Bv)
    vox_slot = torch.stack([o["vox_slot"] for o in outs])
    bv = vox_brick.shape[1]

    offs = torch.tensor([0] + list(np.cumsum([int(c) for c in counts])), device=dev)
    p = torch.arange(tv_bucket, device=dev)
    fr = (torch.searchsorted(offs, p, right=True) - 1).clamp(0, f - 1)
    j = (p - offs[fr]).clamp(0, bv - 1)
    vb = vox_brick[fr, j].long()
    vs = vox_slot[fr, j].long()
    valid = p < offs[f]
    sel = torch.where(valid & (vb >= 0), (fr * brick_cap + vb) * B4_SLOTS + vs, torch.zeros_like(vb))

    # per-frame voxel-index grid: the scatter inverse of (vox_brick, vox_slot);
    # a brick past the cap is dropped, as the reference's mode="drop"
    flat_pos = torch.where((vox_brick >= 0) & (vox_brick < brick_cap),
                           vox_brick.long() * B4_SLOTS + vox_slot,
                           torch.full_like(vox_brick, brick_cap * B4_SLOTS, dtype=torch.int64))
    idx_grid = torch.full((f, brick_cap * B4_SLOTS + 1), -1, dtype=torch.int32, device=dev)
    frow = torch.arange(f, device=dev)[:, None].expand(f, bv)
    jrow = torch.arange(bv, device=dev, dtype=torch.int32)[None].expand(f, bv)
    idx_grid[frow, flat_pos] = jrow
    return dict(
        code=code_flat,
        nbr27=nbr_flat.contiguous(),
        vox_brick=vox_brick,
        vox_slot=vox_slot,
        sel=sel,
        vox_fr=fr,
        vox_j=j,
        nbr27_pf=nbr,
        idx_grid=idx_grid[:, :-1],
    )


def _geom(code, nbr27, dt):
    mask = (code >= 0).to(dt)[:, None, None, :]
    return dict(nbr27=nbr27, mask=mask, code=code, dtype=dt)


def _dev_ctx(params, cfg: ModelConfig, code, nbr27, scale: int, dt):
    """x_glob of one level: input embedding at ``scale`` -> block_in."""
    return sb_x_glob(params, cfg, _geom(code, nbr27, dt), [(0, code.shape[0], scale)])


# ------------------------------------------------ probability producer ----

# Bytes of temporaries per (brick, stage) of the fused producer, used to cap
# the stage-batch width cs by a memory budget.  The figure was measured on a
# TPU (ch=8, bf16) and is kept so that cs is derived by the same formula on
# both codec sides; it is still to be measured on the H100.
_FUSED_TEMP_BYTES_PER_BRICK_STAGE = 11_000


def _fused_budget_gb() -> float:
    return float(os.environ.get("LINR_FUSED_BUDGET_GB", "8"))


def _fused_cs_cap() -> int:
    """Latency cap on cs: the decoder re-runs the cs-wide producer at every
    stage and keeps one row, the encoder runs it outstage/cs times."""
    return int(os.environ.get("LINR_FUSED_CS_CAP", "2"))


def _fused_cs(bb: int, cfg: ModelConfig, budget_gb: float, cs_cap: int | None = None) -> int:
    """Largest divisor cs of outstage within the cap whose temporaries fit
    the budget at ``bb`` bricks."""
    per = _FUSED_TEMP_BYTES_PER_BRICK_STAGE * max(cfg.ch, 8) / 8.0
    for cs in sorted((d for d in range(1, cfg.outstage + 1) if cfg.outstage % d == 0), reverse=True):
        if cs_cap is not None and cs > cs_cap:
            continue
        if bb * cs * per <= budget_gb * 1e9:
            return cs
    return 1


def _probs_mode() -> str:
    """The probability producer, from ``LINR_CODEC_PROBS``: "fused" (the
    default: ``_fused_probs``, cs stages a pass) or "stage" (one stage a
    pass, ``_stage_step``, the JAX package's earlier wire).  It travels in
    side_info["numerics"]["probs"] and the decoder adopts the encoder's."""
    mode = os.environ.get("LINR_CODEC_PROBS", "fused")
    if mode not in ("fused", "stage"):
        raise ValueError(f"LINR_CODEC_PROBS={mode!r}: the producers are 'fused' and 'stage'")
    return mode


def _fused_probs(params, cfg: ModelConfig, occ_buf, code, nbr27, x_glob, sel,
                 base: int, cs: int, first: bool, dt):
    """The shared stage-batched producer: (cs, tv) f16 probabilities of the
    ``cs`` stages from ``base``, in compacted voxel order."""
    geom = _geom(code, nbr27, dt)
    logits = sb_chunk_logits(params, cfg, geom, occ_buf.to(dt), base, cs, x_glob, first)
    pr = torch.sigmoid(logits.float())  # (Bb, cs, 64)
    return pr.permute(1, 0, 2).reshape(cs, -1)[:, sel].half()


def _stage_probs(params, cfg: ModelConfig, occ_buf, code, nbr27, x_glob, sel, stage: int, dt):
    """The stage producer's prediction: (tv,) f16 probabilities of
    ``stage`` alone, the chunk-logit pass at cs = 1 (stage 0's gated-off
    context row computed, as in JAX's ``_stage_step``), on the buffer's
    columns below ``stage``."""
    return _fused_probs(params, cfg, occ_buf, code, nbr27, x_glob, sel, stage, 1, False, dt)[0]


def _stage_step(params, cfg: ModelConfig, occ_buf, vox_occ, code, nbr27, x_glob, stage: int,
                bits_packed, vox_brick, vox_slot, sel, dt):
    """The per-stage producer both sides of the JAX "stage" wire run: write
    stage - 1's bits (``bits_packed`` (F, Bv/8); zeros at stage 0, a no-op
    on the zeroed column 0) into the brick buffer and the per-voxel
    occupancy, in place, then predict ``stage``.  Returns (occ_buf,
    vox_occ, (tv,) f16 probabilities).  The encoder runs it; the decoder
    runs its prediction alone (``_stage_probs``), since its entropy decode
    (K6's stage tail, or the AC wire's scatter) already wrote the bits."""
    bv = vox_brick.shape[1]
    col = max(stage - 1, 0)
    bits = unpack_bits(bits_packed)[:, :bv]
    _scatter_col(occ_buf, bits, col, vox_brick, vox_slot)
    vox_occ[:, :, col] = bits
    return occ_buf, vox_occ, _stage_probs(params, cfg, occ_buf, code, nbr27, x_glob, sel, stage, dt)


# --------------------------------------------------- occupancy buffers ----


def _scatter_col(occ_buf, col, stage: int, vox_brick, vox_slot):
    """Write one stage's per-voxel bits col (F, Bv) into occupancy column
    ``stage`` of the brick buffer (F*cap, 8, 64), in place."""
    f, bv = vox_brick.shape
    cap = occ_buf.shape[0] // f
    fr = torch.arange(f, device=col.device)[:, None].expand(f, bv)
    flat_b = fr * cap + vox_brick
    ok = (vox_brick >= 0) & (flat_b < f * cap)  # the reference's mode="drop"
    occ_buf[flat_b[ok].long(), stage, vox_slot[ok].long()] = col[ok]
    return occ_buf


def _enc_occ_buffers(cols7, vox_brick, vox_slot, occ_buf, vox_occ):
    """Encoder only: scatter stage 0..6's ground-truth columns (7, F, Bv/8)
    packed into the brick buffer and the per-voxel occupancy, in place
    (stage 7's bits reach the level transition through their own column)."""
    bv = vox_brick.shape[1]
    for stage in range(cols7.shape[0]):
        col = unpack_bits(cols7[stage])[:, :bv]
        _scatter_col(occ_buf, col, stage, vox_brick, vox_slot)
        vox_occ[:, :, stage] = col
    return occ_buf, vox_occ


_pack_cols = pack_bit_rows  # (F, Bv) {0,1} uint8 -> (F, Bv/8), numpy packbits order


def _transition(coords, keys, vox_occ, bits7_packed, out_bucket: int):
    """Apply the last stage's bits, then octree-up every frame to the next
    level's bucket: (coords', keys', parent_idx)."""
    f, bv = keys.shape
    vox_occ[:, :, 7] = unpack_bits(bits7_packed)[:, :bv]
    chs, cks, pids = [], [], []
    for i in range(f):
        ch, ck, _, pidx = octree_up_with_parent(coords[i], keys[i], vox_occ[i].int())
        cur = ch.shape[0]
        if cur >= out_bucket:
            ch, ck, pidx = ch[:out_bucket], ck[:out_bucket], pidx[:out_bucket]
        else:
            pad = out_bucket - cur
            ch = torch.cat([ch, ch.new_zeros((pad, 3))])
            ck = torch.cat([ck, ck.new_full((pad,), KEY_PAD)])
            pidx = torch.cat([pidx, pidx.new_full((pad,), -1)])
        chs.append(ch)
        cks.append(ck)
        pids.append(pidx)
    return torch.stack(chs), torch.stack(cks), torch.stack(pids)


# -------------------------------------------------------------- entropy ----


def _rans_enc_seg(states, pr, packed_col, vox_fr, vox_j, total: int):
    """Encode one (level, stage) segment from the f16 probabilities the
    decoder will see and the ground-truth packed column (the first
    ``total`` symbols valid; K5 masks the rest)."""
    bits = unpack_bits(packed_col)[vox_fr, vox_j]
    return rans_encode_segment(states, pr, bits, total)


def _stage_plan(vox_fr, vox_j, total: int, vox_brick, vox_slot, cap: int):
    """The operands K6's stage tail takes for one level, built on the device
    without a host sync: ``dst`` (tv,) int32, symbol i's byte in an
    occupancy column of the (F*cap, 8, 64) buffer, (fr*cap + vb)*512 + vs
    where the reference's scatter writes its voxel (-1 for pad symbols,
    pad voxels and bricks dropped past the buffer), and ``offs`` (F+1,)
    int32, each frame's first symbol."""
    f = vox_brick.shape[0]
    dev = vox_fr.device
    valid = torch.arange(vox_fr.shape[0], device=dev) < total
    vb = vox_brick[vox_fr, vox_j].long()
    flat_b = vox_fr * cap + vb
    hit = valid & (vb >= 0) & (flat_b < f * cap)
    dst = torch.where(hit, flat_b * 512 + vox_slot[vox_fr, vox_j], -1).int()
    counts = ((vox_fr[None] == torch.arange(f, device=dev)[:, None]) & valid[None]).sum(1)
    offs = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).int()
    return dst, offs


def _rans_dec_stage_scatter_plain(states, cursors, stream, pr, vox_fr, vox_j, total: int,
                                  bits_acc, occ_buf, stage: int, vox_brick, vox_slot):
    """The plain version of the stage tail, the reference's computation in
    torch ops (boolean-mask indexing: host syncs on a card)."""
    f, bv = vox_brick.shape
    tv = pr.shape[0]
    valid = torch.arange(tv, device=pr.device) < total
    states, cursors, bits = rans_decode_segment_plain(states, cursors, stream, pr, total)
    col = torch.zeros((f, bv), dtype=torch.uint8, device=pr.device)
    col[vox_fr[valid], vox_j[valid]] = bits[valid]
    bits_acc[stage] = bits
    _scatter_col(occ_buf, col, stage, vox_brick, vox_slot)
    return states, cursors, occ_buf, _pack_cols(col), bits_acc


def _rans_dec_stage_scatter(states, cursors, stream, pr, vox_fr, vox_j, total: int,
                            bits_acc, occ_buf, stage: int, vox_brick, vox_slot, plan=None):
    """Decode stage ``stage``'s bits into ``bits_acc[stage]`` and write them
    into occupancy column ``stage`` (the next producer call's context), in
    place.  Returns (states, cursors, occ_buf, packed column, bits_acc).

    On the card this is K6's stage-tail entry, one launch and a packing
    pass with no host sync; ``plan`` is the level's ``_stage_plan`` (built
    here if not given).  Storing only the voxels a symbol covers equals the
    reference's scatter of the whole column because the column is zero
    until its stage is decoded (the buffer is zeroed per level).  On the
    CPU it is the plain version."""
    if pr.device.type == "cpu":
        return _rans_dec_stage_scatter_plain(states, cursors, stream, pr, vox_fr, vox_j, total,
                                             bits_acc, occ_buf, stage, vox_brick, vox_slot)
    f, bv = vox_brick.shape
    if plan is None:
        plan = _stage_plan(vox_fr, vox_j, total, vox_brick, vox_slot, occ_buf.shape[0] // f)
    packed = torch.empty((f, bv // 8), dtype=torch.uint8, device=pr.device)
    states, cursors = rans_decode_stage(states, cursors, stream, pr, total, bits_acc[stage],
                                        occ_buf, stage, *plan, packed)
    return states, cursors, occ_buf, packed, bits_acc


def _vox_occ_from_bits(bits_acc, vox_fr, vox_j, total: int, f: int, bv: int):
    """(outstage, tv) decoded bits -> (F, Bv, 8) per-voxel occupancy."""
    tv = bits_acc.shape[1]
    valid = torch.arange(tv, device=bits_acc.device) < total
    out = torch.zeros((f, bv, 8), dtype=torch.uint8, device=bits_acc.device)
    out[vox_fr[valid], vox_j[valid]] = bits_acc.t()[valid]
    return out


def _lane_lens_stack(masks):
    """(K, LANES, 2) bool -> per-lane emitted byte counts (LANES,)."""
    return masks.permute(1, 0, 2).reshape(LANES, -1).sum(1)


def _pack_bits_frames(bit_arrays, bv: int, device):
    """Per-frame bit vectors -> (F, Bv/8) packed, on the device."""
    out = np.zeros((len(bit_arrays), bv), np.uint8)
    for i, b in enumerate(bit_arrays):
        out[i, : len(b)] = b
    return torch.as_tensor(np.packbits(out, axis=-1), device=device)


def _split_probs(pr_f16: np.ndarray, counts):
    """(tv,) f16 in compacted voxel order -> one float32 array per frame."""
    out, pos = [], 0
    for n in counts:
        out.append(pr_f16[pos: pos + n].astype(np.float32))
        pos += n
    return out


def _probs_down(pr, counts):
    """Download f16 probabilities ((tv,) or (stages, tv)) and split them per
    frame: [frame] or [stage][frame] float32 arrays."""
    pr_h = pr.cpu().numpy()
    if pr_h.ndim == 1:
        return _split_probs(pr_h, counts)
    return [_split_probs(row, counts) for row in pr_h]


class _LevelShapes:
    """Per-level static shapes shared by both codec sides.  n_vox[s][i] is
    frame i's voxel count at level s; brick counts come from the octree
    identity bricks(s) = n_vox(s+2), the top two levels' from host coords."""

    def __init__(self, s_num: int, base_coords: list):
        self.s_num = s_num
        self.n_vox = [None] * s_num
        self.n_vox[s_num - 1] = [len(c) for c in base_coords]
        self._top_bricks = {s_num - 1: [self._n_bricks(c) for c in base_coords]}

    @staticmethod
    def _n_bricks(c) -> int:
        c = c.astype(np.int64)
        return len(np.unique(((c[:, 0] >> 2) << 42) | ((c[:, 1] >> 2) << 21) | (c[:, 2] >> 2)))

    def set_counts(self, s: int, counts: list):
        self.n_vox[s] = counts

    def bricks(self, s: int) -> list:
        if s + 2 < self.s_num:
            return self.n_vox[s + 2]
        return self._top_bricks[s]

    def set_top_coords(self, s: int, coords_list: list):
        """Record host coords for level s (only needed for s_num - 2)."""
        self._top_bricks[s] = [self._n_bricks(c) for c in coords_list]

    def buckets(self, s: int):
        bv = bucket_size(max(self.n_vox[s]))
        cap = _brick_bucket(max(self.bricks(s)))
        # tv is also the rANS segment length: a LANES multiple
        tv = -(-bucket_size(sum(self.n_vox[s])) // LANES) * LANES
        return bv, cap, tv


def _zero_buffers(f: int, cap: int, bv: int, device):
    occ_buf = torch.zeros((f * cap, 8, B4_SLOTS), dtype=torch.uint8, device=device)
    vox_occ = torch.zeros((f, bv, 8), dtype=torch.uint8, device=device)
    return occ_buf, vox_occ


def _resize_coords(coords, keys, bv: int):
    cur = coords.shape[1]
    if cur == bv:
        return coords, keys
    if cur > bv:
        return coords[:, :bv], keys[:, :bv]
    f = coords.shape[0]
    return (
        torch.cat([coords, coords.new_zeros((f, bv - cur, 3))], 1),
        torch.cat([keys, keys.new_full((f, bv - cur), KEY_PAD)], 1),
    )


def _level_geometry(s, coords, keys, counts, cap, tv, hist_keys, hist_parent, hist_geo):
    """This level's brick geometry: search-free when the two levels above
    it were coded in this pass, else by one sort per frame."""
    if s + 2 in hist_keys and s in hist_parent and s + 1 in hist_parent:
        geo = _brickify_level_gp2(coords, keys, counts, s, hist_parent[s], hist_parent[s + 1],
                                  hist_keys[s + 2], *hist_geo[s + 2], cap, tv)
    else:
        geo = _brickify_level(coords, keys, counts, s, cap, tv)
    hist_geo[s] = (geo["vox_brick"], geo["vox_slot"], geo["nbr27_pf"], geo["idx_grid"])
    hist_keys.pop(s + 3, None)
    hist_parent.pop(s + 2, None)
    hist_geo.pop(s + 3, None)
    return geo


# ---------------------------------------------------------------- encode --


def encode_chunk_probs_dev(params, cfg: ModelConfig, pyrs, device,
                           fused_budget_gb=None, fused_cs_cap=None, keep_device: bool = True):
    """Device-chain encode of one frame chunk, coarse to fine: per level
    the f16 probabilities of every stage and the ground-truth bits, from
    the producer ``_probs_mode()`` names: the fused producer on buffers
    holding every ground-truth column, or the stage producer fed each
    stage's column as the decoder will be.

    With ``keep_device`` (the rANS sweep's form) returns [(s, probs[stage]
    (tv,) f16, cols[stage] (F, Bv/8) uint8, (vox_fr, vox_j), total,
    counts, tv), ...] on the device; without it (the AC wire's form)
    [(s, probs[stage][frame] float32, bits[stage][frame] uint8), ...] on
    the host.  Both in coarse-to-fine order."""
    dt = codec_dtype()
    mode = _probs_mode()
    f = len(pyrs)
    budget = _fused_budget_gb() if fused_budget_gb is None else fused_budget_gb
    cs_cap = _fused_cs_cap() if fused_cs_cap is None else fused_cs_cap
    s_num = pyrs[0].scale_num
    shapes = _LevelShapes(s_num, [p.low_coords.astype(np.int32) for p in pyrs])
    for s in range(s_num - 1, -1, -1):
        shapes.set_counts(s, [p.levels[s].n for p in pyrs])
    shapes.set_top_coords(s_num - 2, [p.levels[s_num - 2].coords[: p.levels[s_num - 2].n] for p in pyrs])

    bv0 = bucket_size(max(shapes.n_vox[s_num - 1]))
    base = np.zeros((f, bv0, 3), np.int32)
    for i, p in enumerate(pyrs):
        base[i, : len(p.low_coords)] = p.low_coords
    coords, keys = _init_level(torch.as_tensor(base, device=device), shapes.n_vox[s_num - 1], bv0)

    pending = []
    hist_keys, hist_parent, hist_geo = {}, {}, {}
    for s in range(s_num - 1, -1, -1):
        bv, cap, tv = shapes.buckets(s)
        coords, keys = _resize_coords(coords, keys, bv)
        counts = shapes.n_vox[s]
        hist_keys[s] = keys
        geo = _level_geometry(s, coords, keys, counts, cap, tv, hist_keys, hist_parent, hist_geo)
        xg = _dev_ctx(params, cfg, geo["code"], geo["nbr27"], s, dt)
        occ_buf, vox_occ = _zero_buffers(f, cap, bv, device)
        cols = [
            _pack_bits_frames([p.levels[s].occ[: p.levels[s].n, stage] for p in pyrs], bv, device)
            for stage in range(cfg.outstage)
        ]
        probs = []
        if mode == "stage":
            prev = torch.zeros((f, bv // 8), dtype=torch.uint8, device=device)
            for stage in range(cfg.outstage):
                occ_buf, vox_occ, pr = _stage_step(
                    params, cfg, occ_buf, vox_occ, geo["code"], geo["nbr27"], xg, stage, prev,
                    geo["vox_brick"], geo["vox_slot"], geo["sel"], dt)
                probs.append(pr)
                prev = cols[stage]  # this stage's bits are the next one's context
        else:
            cs = _fused_cs(geo["code"].shape[0], cfg, budget, cs_cap)
            occ_buf, vox_occ = _enc_occ_buffers(
                torch.stack(cols[: cfg.outstage - 1]), geo["vox_brick"], geo["vox_slot"], occ_buf,
                vox_occ)
            for b0 in range(0, cfg.outstage, cs):
                prs = _fused_probs(params, cfg, occ_buf, geo["code"], geo["nbr27"], xg,
                                   geo["sel"], b0, cs, b0 == 0, dt)
                probs.extend(prs[i] for i in range(cs))
        if s > 0:
            coords, keys, pidx = _transition(coords, keys, vox_occ, cols[cfg.outstage - 1],
                                             bucket_size(max(shapes.n_vox[s - 1])))
            hist_parent[s - 1] = pidx
        pending.append((s, probs, cols, (geo["vox_fr"], geo["vox_j"]), sum(counts), counts, tv))
    if keep_device:
        return pending
    return [
        (s, _probs_down(torch.stack(probs), counts),
         [[np.ascontiguousarray(p.levels[s].occ[: p.levels[s].n, stage]) for p in pyrs]
          for stage in range(cfg.outstage)])
        for (s, probs, *_, counts, _tv) in pending
    ]


def encode_gop_streams_dev(params, cfg: ModelConfig, pyramids, device):
    """The AC wire: blobs[frame][scale], each the packed per-stage streams
    of the host arithmetic coder (one batch per level), and the total
    bits."""
    f_total = len(pyramids)
    s_num = pyramids[0].scale_num
    blobs = [[None] * s_num for _ in range(f_total)]
    total_bits = 0
    for chunk in _frame_chunks(f_total):
        f = len(chunk)
        levels = encode_chunk_probs_dev(params, cfg, [pyramids[i] for i in chunk], device,
                                        keep_device=False)
        for s, probs, stage_bits in levels:
            streams = binary_encode_batch([probs[st][i] for st in range(cfg.outstage) for i in range(f)],
                                         [stage_bits[st][i] for st in range(cfg.outstage)
                                          for i in range(f)])
            for i in range(f):
                blob = pack_bitstream([streams[st * f + i] for st in range(cfg.outstage)])
                blobs[chunk[i]][s] = blob
                total_bits += len(blob) * 8
    return blobs, total_bits


def encode_gop_streams_rans(params, cfg: ModelConfig, pyramids, device):
    """Occupancy streams with the device entropy coder: per frame chunk one
    rans-v2 blob.  Segments are encoded in reverse decode order (levels
    fine to coarse, stages 7..0); per level the emissions are compacted on
    the device into lane streams and stitched on the host in decode order."""
    s_num = pyramids[0].scale_num
    chunk_blobs = []
    total_bits = 0
    for chunk in _frame_chunks(len(pyramids)):
        pending = encode_chunk_probs_dev(params, cfg, [pyramids[i] for i in chunk], device)
        states = rans_initial_states(device)
        emis = {}
        for (s, probs, cols, (vox_fr, vox_j), total, counts, tv) in reversed(pending):
            seg_b, seg_m = [], []
            for stage in reversed(range(cfg.outstage)):
                states, byts, mask = _rans_enc_seg(states, probs[stage], cols[stage], vox_fr, vox_j, total)
                seg_b.append(byts)
                seg_m.append(mask)
            emis[s] = (torch.cat(seg_b[::-1]), torch.cat(seg_m[::-1]))  # stage ascending
        level_order = [p[0] for p in pending]  # decode order
        lens_h = torch.stack([_lane_lens_stack(emis[s][1]) for s in level_order]).cpu().numpy()
        outs = []
        for k, s in enumerate(level_order):
            _, out = rans_compact_emissions(emis[s][0], emis[s][1], _lane_bucket(int(lens_h[k].max())))
            outs.append(out.cpu().numpy())
        # lane-major ragged assembly: level k, lane l, byte j lands at
        # lane_start[l] + sum(lens[:k, l]) + j
        lens_np = lens_h.astype(np.int64)
        lane_tot = lens_np.sum(axis=0)
        lane_start = np.concatenate([[0], np.cumsum(lane_tot)[:-1]])
        payload = np.empty(int(lane_tot.sum()), np.uint8)
        pos = lane_start.copy()
        for k, out in enumerate(outs):
            ln = lens_np[k]
            tot = int(ln.sum())
            if tot:
                seg0 = np.repeat(pos, ln)
                within = np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(ln) - ln, ln)
                cidx = np.arange(out.shape[1], dtype=np.int64)
                payload[seg0 + within] = out[cidx[None, :] < ln[:, None]]
            pos += ln
        blob = pack_rans_blob_flat(states.cpu().numpy().astype(np.uint32), payload, lane_tot)
        chunk_blobs.append(blob)
        total_bits += len(blob) * 8
    return {"rans": chunk_blobs, "s_num": s_num}, total_bits


# ---------------------------------------------------------------- decode --


class _RansLevels:
    """The rANS wire's entropy decode of one frame chunk, on the device:
    K6's stage tail decodes each stage's bits into ``bits_acc`` and the
    occupancy column, with no host sync."""

    def __init__(self, blob: bytes, device):
        states, flat, offs = unpack_rans_blob(blob)
        self.st = torch.as_tensor(states.astype(np.int64), device=device)
        self.cur = torch.as_tensor(offs, device=device)
        self.stream = torch.as_tensor(flat, device=device)

    def level(self, s, probs, geo, occ_buf, counts, tv, cap, bv, outstage):
        """-> (per-frame (n, outstage) bits on the host, a function giving
        the level transition's (per-voxel occupancy, packed last column))."""
        f, total = len(counts), sum(counts)
        bits_acc = torch.zeros((outstage, tv), dtype=torch.uint8, device=occ_buf.device)
        plan = _stage_plan(geo["vox_fr"], geo["vox_j"], total, geo["vox_brick"],
                           geo["vox_slot"], cap)
        for stage in range(outstage):
            self.st, self.cur, _, last, bits_acc = _rans_dec_stage_scatter(
                self.st, self.cur, self.stream, probs(stage), geo["vox_fr"], geo["vox_j"], total,
                bits_acc, occ_buf, stage, geo["vox_brick"], geo["vox_slot"], plan,
            )
        bits8 = bits_acc.cpu().numpy()  # (8, tv)
        offs = np.concatenate([[0], np.cumsum(counts)])
        occ_host = [np.ascontiguousarray(bits8[:, offs[i]: offs[i + 1]].T) for i in range(f)]
        return occ_host, lambda: (
            _vox_occ_from_bits(bits_acc, geo["vox_fr"], geo["vox_j"], total, f, bv), last)


class _AcLevels:
    """The AC wire's entropy decode of one frame chunk (``blobs[frame]
    [scale]``), on the host: per stage the probabilities go down, the host
    decoder gives the bits, and they go back up as the next stage's
    context."""

    def __init__(self, blobs):
        self.blobs = blobs

    def level(self, s, probs, geo, occ_buf, counts, tv, cap, bv, outstage):
        """As _RansLevels.level."""
        f, device = len(counts), occ_buf.device
        streams = [unpack_bitstream(b[s]) for b in self.blobs]
        occ_host = [np.zeros((n, outstage), np.uint8) for n in counts]
        for stage in range(outstage):
            decs = binary_decode_batch(_probs_down(probs(stage), counts),
                                       [streams[i][stage] for i in range(f)])
            for i in range(f):
                occ_host[i][:, stage] = decs[i]
            if stage < outstage - 1:
                # this stage's bits are the next stage's context
                col = unpack_bits(_pack_bits_frames(decs, bv, device))[:, :bv]
                _scatter_col(occ_buf, col, stage, geo["vox_brick"], geo["vox_slot"])

        def transition():
            host = np.zeros((f, bv, outstage), np.uint8)
            for i in range(f):
                host[i, : counts[i]] = occ_host[i]
            last = _pack_bits_frames([o[:, outstage - 1] for o in occ_host], bv, device)
            return torch.as_tensor(host, device=device), last

        return occ_host, transition


def decode_gop_streams_rans(params, cfg: ModelConfig, wire, lows, device, probs_mode=None,
                            fused_budget_gb=None, fused_cs_cap=None):
    """Decode from per-chunk rans blobs; the entropy decode runs on the
    device inside the stage loop."""
    return _decode_chain(params, cfg, lows, device, wire.get("s_num") or cfg.scale_num,
                         lambda ci, chunk: _RansLevels(wire["rans"][ci], device),
                         probs_mode, fused_budget_gb, fused_cs_cap)


def decode_gop_streams_dev(params, cfg: ModelConfig, frame_blobs, lows, device, probs_mode=None,
                           fused_budget_gb=None, fused_cs_cap=None):
    """Decode the AC wire's ``frame_blobs[frame][scale]``; each stage's
    probabilities go down to the host decoder and its bits come back up."""
    return _decode_chain(params, cfg, lows, device, len(frame_blobs[0]),
                         lambda ci, chunk: _AcLevels([frame_blobs[i] for i in chunk]),
                         probs_mode, fused_budget_gb, fused_cs_cap)


def _decode_chain(params, cfg: ModelConfig, lows, device, s_num, chunk_levels, probs_mode,
                  fused_budget_gb, fused_cs_cap):
    """Decode all frames coarse to fine with the device-resident chain: per
    level the shared producer, stage by stage, feeds the wire's entropy
    decode (``chunk_levels(ci, chunk)``, a _RansLevels or _AcLevels); the
    final coordinates are rebuilt on the host from the decoded bits.
    Returns the min-subtracted coords per frame.  ``probs_mode`` is the
    encoder's producer (``_probs_mode()`` if not given): "stage" predicts
    each stage alone after the entropy decode wrote the stage before it."""
    mode = probs_mode or _probs_mode()
    if mode not in ("fused", "stage"):
        raise ValueError(f"probs mode {mode!r}: the producers are 'fused' and 'stage'")
    dt = codec_dtype()
    budget = _fused_budget_gb() if fused_budget_gb is None else fused_budget_gb
    cs_cap = _fused_cs_cap() if fused_cs_cap is None else fused_cs_cap
    f_total = len(lows)
    out_coords = [None] * f_total
    for ci, chunk in enumerate(_frame_chunks(f_total)):
        f = len(chunk)
        levels = chunk_levels(ci, chunk)
        base = [np.ascontiguousarray(lows[i], np.int32) for i in chunk]
        shapes = _LevelShapes(s_num, base)
        bv0 = bucket_size(max(len(c) for c in base))
        base_pad = np.zeros((f, bv0, 3), np.int32)
        for i, c in enumerate(base):
            base_pad[i, : len(c)] = c
        coords, keys = _init_level(torch.as_tensor(base_pad, device=device), [len(c) for c in base], bv0)

        cur_coords = list(base)
        hist_keys, hist_parent, hist_geo = {}, {}, {}
        for s in range(s_num - 1, -1, -1):
            bv, cap, tv = shapes.buckets(s)
            coords, keys = _resize_coords(coords, keys, bv)
            counts = shapes.n_vox[s]
            hist_keys[s] = keys
            geo = _level_geometry(s, coords, keys, counts, cap, tv, hist_keys, hist_parent, hist_geo)
            xg = _dev_ctx(params, cfg, geo["code"], geo["nbr27"], s, dt)
            occ_buf, _ = _zero_buffers(f, cap, bv, device)
            cs = _fused_cs(geo["code"].shape[0], cfg, budget, cs_cap)

            def probs(stage):
                if mode == "stage":
                    return _stage_probs(params, cfg, occ_buf, geo["code"], geo["nbr27"], xg,
                                        geo["sel"], stage, dt)
                b0 = (stage // cs) * cs
                return _fused_probs(params, cfg, occ_buf, geo["code"], geo["nbr27"], xg,
                                    geo["sel"], b0, cs, b0 == 0, dt)[stage - b0]

            occ_host, transition = levels.level(s, probs, geo, occ_buf, counts, tv, cap, bv,
                                                cfg.outstage)
            cur_coords = [np_octree_up(cur_coords[i], occ_host[i]) for i in range(f)]
            if s > 0:
                shapes.set_counts(s - 1, [int(occ_host[i].sum()) for i in range(f)])
                if s - 1 == s_num - 2:
                    shapes.set_top_coords(s - 1, cur_coords)
                vox_occ, last = transition()
                coords, keys, pidx = _transition(coords, keys, vox_occ, last,
                                                 bucket_size(max(shapes.n_vox[s - 1])))
                hist_parent[s - 1] = pidx
        for i in range(f):
            out_coords[chunk[i]] = cur_coords[i]
    return out_coords
