"""Interleaved binary rANS over 4096 lanes, on the codec's device.

Port of linr_pcgc_tpu/ops/rans.py with the same wire format (rans-v2):
symbol i of a segment belongs to lane i % LANES and step i // LANES;
RANS_L = 2^23, byte renormalisation (at most 2 bytes per symbol), 16-bit
frequencies f1 = clip(round(p * 2^16), 1, 2^16 - 1) from the f16
probabilities, bit 0 on [0, f0).  Invalid (bucket-pad) symbols are coded
as bit 0 with f1 = 1.  Encoding runs in reverse symbol order (rANS is
LIFO); each lane's bytes are stored in decode-read order.

The JAX twin's encode and decode are ``lax.scan``s over the steps of a
segment.  Here each is a hand kernel on a CUDA tensor (csrc/rans.cu), one
launch per segment with one chain thread per lane: K5 ``rans_encode_segment``,
K6 ``rans_decode_segment`` and K6's stage-tail entry ``rans_decode_stage``
(the codec's decode fused with its scatter into the occupancy buffer).  On
a CPU tensor each runs its plain version, a Python loop over the steps,
each step vectorised over the lanes.  States are int64 at the interface:
every intermediate stays below 2^31 (state < 2^31, renormalised), so the
kernels run in uint32 and the plain versions in int64 with the same bits;
the JAX decoder's only u32 wrap is in its windowed word reads, which these
byte-level decoders do not need.

``valid`` is a bool tensor or an int n (the first n symbols are valid, the
codec's form: the kernels then load no valid tensor).  A decoder read at
or past the stream's last byte returns that byte.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ..device import resolve_device
from . import cuda_build

LANES = 4096
RANS_L = 1 << 23
PROB_BITS = 16
PROB_SCALE = 1 << PROB_BITS


# ------------------------------------------------------------ frequencies --


def freq1_from_prob(p: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """P(bit=1) -> 16-bit frequency (int64): f32 round-half-even of
    p * 2^16 (torch.round rounds half to even), clipped to [1, 2^16-1];
    invalid symbols get 1."""
    f1 = torch.round(p.float() * PROB_SCALE).long().clamp(1, PROB_SCALE - 1)
    return torch.where(valid, f1, torch.ones_like(f1))


def np_freq1_from_prob(p, valid):
    f1 = np.clip(np.round(p.astype(np.float32) * PROB_SCALE).astype(np.int64), 1, PROB_SCALE - 1)
    return np.where(valid, f1, 1).astype(np.uint32)


def rans_initial_states(device=None) -> torch.Tensor:
    """Every lane's initial state RANS_L, on ``device`` (the card unless
    the caller asks for the CPU)."""
    return torch.full((LANES,), RANS_L, dtype=torch.int64, device=resolve_device(device))


# ----------------------------------------------------------------- encode --


def _check_segment(states, probs, valid, bits=None):
    if probs.dim() != 1 or probs.shape[0] % LANES:
        raise ValueError(f"probs must be 1-d with a multiple of {LANES} symbols, got "
                         f"{tuple(probs.shape)}")
    n = probs.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"a segment holds fewer than 2^31 symbols, got {n}")
    if tuple(states.shape) != (LANES,) or states.dtype != torch.int64:
        raise ValueError(f"states must be ({LANES},) int64")
    if isinstance(valid, int):
        if not 0 <= valid <= n:
            raise ValueError(f"valid count {valid} is outside [0, {n}]")
    elif tuple(valid.shape) != (n,) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be ({n},) bool or an int")
    if bits is not None and tuple(bits.shape) != (n,):
        raise ValueError(f"bits must have shape ({n},)")


def _valid_mask(valid, n, device):
    if isinstance(valid, int):
        return torch.arange(n, device=device) < valid
    return valid


def _check_stream(stream, cursors):
    if tuple(cursors.shape) != (LANES,) or cursors.dtype != torch.int64:
        raise ValueError(f"cursors must be ({LANES},) int64")
    if stream.dim() != 1 or stream.dtype != torch.uint8 or not 0 < stream.shape[0] < 1 << 31:
        raise ValueError("stream must be a 1-d uint8 tensor of 1 to 2^31 - 1 bytes")


def _check_kernel_operands(name, probs, tensors):
    """What K5 and K6 take beyond the plain versions: float16
    probabilities (the codec's), contiguous tensors on one device."""
    if probs.dtype != torch.float16:
        raise TypeError(f"{name} takes float16 probabilities, got {probs.dtype}")
    for t in (probs, *tensors):
        if t.device != probs.device or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors on one device")


def rans_encode_segment_plain(states, probs, bits, valid):
    """The plain PyTorch version of K5: a loop over the steps, each
    vectorised over the lanes."""
    _check_segment(states, probs, valid, bits)
    n = probs.shape[0]
    steps = n // LANES
    vd = _valid_mask(valid, n, probs.device).reshape(steps, LANES)
    f1 = freq1_from_prob(probs.reshape(steps, LANES), vd)
    f0 = PROB_SCALE - f1
    bit = vd & (bits.reshape(steps, LANES) != 0)
    f = torch.where(bit, f1, f0)
    c = torch.where(bit, f0, torch.zeros_like(f0))
    lim = f << 15
    byts = torch.empty((steps, LANES, 2), dtype=torch.uint8, device=probs.device)
    mask = torch.empty((steps, LANES, 2), dtype=torch.bool, device=probs.device)
    x = states
    for t in range(steps - 1, -1, -1):
        e0 = x >= lim[t]
        byts[t, :, 1] = (x & 0xFF).to(torch.uint8)
        x = torch.where(e0, x >> 8, x)
        e1 = x >= lim[t]
        byts[t, :, 0] = (x & 0xFF).to(torch.uint8)
        x = torch.where(e1, x >> 8, x)
        q = torch.div(x, f[t], rounding_mode="floor")
        x = (q << 16) + (x - q * f[t]) + c[t]
        mask[t, :, 1] = e0
        mask[t, :, 0] = e1
    return x, byts, mask


def rans_encode_segment(states, probs, bits, valid):
    """Encode one segment (N % LANES == 0) in reverse symbol order (K5).

    states (LANES,) int64; probs (N,) P(bit=1), float16 on the card; bits
    (N,) uint8 or bool; valid (N,) bool or an int.  Returns (states',
    slot_bytes (steps, LANES, 2) uint8, slot_mask (steps, LANES, 2) bool):
    slot [..., 0] is the first-read byte, so the decode-order byte stream
    of a lane is the masked slots read at t = 0..steps-1, slot 0 then 1.
    Segments are fed last-decoded first."""
    if probs.device.type == "cpu":
        return rans_encode_segment_plain(states, probs, bits, valid)
    if probs.device.type != "cuda":
        raise ValueError(f"rans_encode_segment runs on CUDA or CPU tensors, not {probs.device}")
    _check_segment(states, probs, valid, bits)
    if bits.dtype not in (torch.uint8, torch.bool):
        raise TypeError(f"rans_encode_segment takes uint8 or bool bits, got {bits.dtype}")
    counted = isinstance(valid, int)
    _check_kernel_operands("rans_encode_segment", probs,
                           (bits, states) if counted else (bits, valid, states))
    lib = cuda_build.load("rans")
    steps = probs.shape[0] // LANES
    x = torch.empty_like(states)
    byts = torch.empty((steps, LANES, 2), dtype=torch.uint8, device=probs.device)
    mask = torch.empty((steps, LANES, 2), dtype=torch.bool, device=probs.device)
    with torch.cuda.device(probs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rans_encode(probs.data_ptr(), bits.data_ptr(),
                              None if counted else valid.data_ptr(), valid if counted else 0,
                              states.data_ptr(), x.data_ptr(), byts.data_ptr(), mask.data_ptr(),
                              steps, stream)
    if err:
        raise RuntimeError(f"rans_encode kernel launch failed (CUDA error {err})")
    rans_encode_segment.launches += 1
    return x, byts, mask


rans_encode_segment.launches = 0


def rans_compact_emissions(byts, mask, out_bucket: int):
    """Per-lane compaction of stacked segments' emissions (K, LANES, 2) in
    decode order -> (lane_len (LANES,) int64, out (LANES, out_bucket) uint8)
    with lane l's stream in out[l, :lane_len[l]]."""
    k = byts.shape[0]
    b2 = byts.permute(1, 0, 2).reshape(LANES, k * 2)
    m2 = mask.permute(1, 0, 2).reshape(LANES, k * 2)
    mi = m2.long()
    pos = torch.cumsum(mi, dim=1) - mi
    lane_len = mi.sum(dim=1)
    out = torch.zeros((LANES, out_bucket), dtype=torch.uint8, device=byts.device)
    lane_idx = torch.arange(LANES, device=byts.device)[:, None].expand_as(pos)
    out[lane_idx[m2], pos[m2]] = b2[m2]
    return lane_len, out


# ----------------------------------------------------------------- decode --


def rans_decode_segment_plain(states, cursors, stream, probs, valid):
    """The plain PyTorch version of K6: a loop over the steps, each
    vectorised over the lanes."""
    _check_segment(states, probs, valid)
    _check_stream(stream, cursors)
    last = stream.shape[0] - 1
    n = probs.shape[0]
    steps = n // LANES
    vd = _valid_mask(valid, n, probs.device).reshape(steps, LANES)
    f1 = freq1_from_prob(probs.reshape(steps, LANES), vd)
    f0 = PROB_SCALE - f1
    bits = torch.empty((steps, LANES), dtype=torch.uint8, device=probs.device)
    x, cur = states, cursors
    for t in range(steps):
        slot = x & (PROB_SCALE - 1)
        bit = slot >= f0[t]
        f = torch.where(bit, f1[t], f0[t])
        c = torch.where(bit, f0[t], torch.zeros_like(x))
        x = f * (x >> 16) + slot - c
        for _ in range(2):
            need = x < RANS_L
            byte = stream[cur.clamp(max=last)].long()
            x = torch.where(need, (x << 8) | byte, x)
            cur = cur + need.long()
        bits[t] = (bit & vd[t]).to(torch.uint8)
    return x, cur, bits.reshape(n)


def _launch_checks(name, states, cursors, stream, probs, valid, tensors=()):
    if probs.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {probs.device}")
    _check_segment(states, probs, valid)
    _check_stream(stream, cursors)
    extra = () if isinstance(valid, int) else (valid,)
    _check_kernel_operands(name, probs, (*extra, stream, states, cursors, *tensors))


def rans_decode_segment(states, cursors, stream, probs, valid):
    """Decode one segment's bits (K6).

    states (LANES,) int64; cursors (LANES,) int64 absolute byte positions
    into ``stream`` (uint8); probs (N,) P(bit=1), float16 on the card;
    valid (N,) bool or an int.  Returns (states', cursors', bits (N,)
    uint8); pad symbols decode to 0.  Reads are clamped to the stream's
    last byte, like the JAX twin's clip-mode reads over its zero-tailed
    stream (a valid stream never reads past its lane)."""
    if probs.device.type == "cpu":
        return rans_decode_segment_plain(states, cursors, stream, probs, valid)
    _launch_checks("rans_decode_segment", states, cursors, stream, probs, valid)
    lib = cuda_build.load("rans")
    n = probs.shape[0]
    counted = isinstance(valid, int)
    x, cur = torch.empty_like(states), torch.empty_like(cursors)
    bits = torch.empty((n,), dtype=torch.uint8, device=probs.device)
    with torch.cuda.device(probs.device):
        cstream = torch.cuda.current_stream().cuda_stream
        err = lib.rans_decode(probs.data_ptr(), None if counted else valid.data_ptr(),
                              valid if counted else 0, stream.data_ptr(), stream.shape[0] - 1,
                              states.data_ptr(), cursors.data_ptr(), x.data_ptr(), cur.data_ptr(),
                              bits.data_ptr(), n // LANES, cstream)
    if err:
        raise RuntimeError(f"rans_decode kernel launch failed (CUDA error {err})")
    rans_decode_segment.launches += 1
    return x, cur, bits


rans_decode_segment.launches = 0


# ------------------------------------------------------ decode, stage tail --


def pack_bit_rows(col):
    """(F, Bv) {0,1} uint8 -> (F, Bv/8) uint8, numpy packbits big order."""
    f, bv = col.shape
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=col.device)
    return (col.reshape(f, bv // 8, 8).int() * w).sum(-1).to(torch.uint8)


def _check_stage(probs, total, bits_out, occ_buf, stage, dst, offs, packed):
    n = probs.shape[0]
    if not isinstance(total, int):
        raise TypeError("the stage tail takes its valid symbols as an int count")
    if tuple(bits_out.shape) != (n,) or bits_out.dtype != torch.uint8:
        raise ValueError(f"bits_out must be ({n},) uint8")
    if tuple(dst.shape) != (n,) or dst.dtype != torch.int32:
        raise ValueError(f"dst must be ({n},) int32")
    if occ_buf.dim() != 3 or tuple(occ_buf.shape[1:]) != (8, 64) or occ_buf.dtype != torch.uint8:
        raise ValueError("occ_buf must be (F * cap, 8, 64) uint8")
    if occ_buf.numel() >= 1 << 31:
        raise ValueError("occ_buf must hold fewer than 2^31 bytes")
    if not 0 <= stage < 8:
        raise ValueError(f"stage must be in [0, 8), got {stage}")
    if offs.dim() != 1 or offs.dtype != torch.int32 or packed.dim() != 2 \
            or packed.dtype != torch.uint8 or packed.shape[0] != offs.shape[0] - 1:
        raise ValueError("offs must be (F + 1,) int32 and packed (F, Bv/8) uint8")


def rans_decode_stage_plain(states, cursors, stream, probs, total, bits_out, occ_buf, stage,
                            dst, offs, packed):
    """The plain PyTorch version of K6's stage tail (``rans_decode_stage``)."""
    _check_stage(probs, total, bits_out, occ_buf, stage, dst, offs, packed)
    x, cur, bits = rans_decode_segment_plain(states, cursors, stream, probs, total)
    bits_out.copy_(bits)
    hit = dst >= 0
    occ_buf.view(-1)[dst[hit].long() + stage * 64] = bits[hit]
    f, bv8 = packed.shape
    col = torch.zeros((f, bv8 * 8), dtype=torch.uint8, device=bits.device)
    o = offs.tolist()
    for k in range(f):
        col[k, : o[k + 1] - o[k]] = bits[o[k]: o[k + 1]]
    packed.copy_(pack_bit_rows(col))
    return x, cur


def rans_decode_stage(states, cursors, stream, probs, total, bits_out, occ_buf, stage,
                      dst, offs, packed):
    """K6's stage-tail entry: decode one (level, stage) segment of the codec
    (the first ``total`` symbols valid) into ``bits_out`` (N,) uint8, store
    each bit at slot ``dst[i]`` (int32, -1: none) of occupancy column
    ``stage`` of ``occ_buf`` (F * cap, 8, 64) uint8, i.e. at flat byte
    dst[i] + 64 * stage, and write the stage's per-voxel column packed
    (numpy packbits) into ``packed`` (F, Bv/8): frame k's voxel j < count
    is symbol offs[k] + j, from ``offs`` (F + 1,) int32.  Returns
    (states', cursors'); the outputs are written in place, in one kernel
    launch plus one small packing pass, with no host synchronisation."""
    if probs.device.type == "cpu":
        return rans_decode_stage_plain(states, cursors, stream, probs, total, bits_out, occ_buf,
                                       stage, dst, offs, packed)
    _check_stage(probs, total, bits_out, occ_buf, stage, dst, offs, packed)
    _launch_checks("rans_decode_stage", states, cursors, stream, probs, total,
                   (bits_out, occ_buf, dst, offs, packed))
    lib = cuda_build.load("rans")
    x, cur = torch.empty_like(states), torch.empty_like(cursors)
    f, bv8 = packed.shape
    with torch.cuda.device(probs.device):
        cstream = torch.cuda.current_stream().cuda_stream
        err = lib.rans_decode_stage(probs.data_ptr(), total, dst.data_ptr(), occ_buf.data_ptr(),
                                    stage, stream.data_ptr(), stream.shape[0] - 1,
                                    states.data_ptr(), cursors.data_ptr(), x.data_ptr(),
                                    cur.data_ptr(), bits_out.data_ptr(), offs.data_ptr(),
                                    packed.data_ptr(), f, bv8, probs.shape[0] // LANES, cstream)
    if err:
        raise RuntimeError(f"rans_decode_stage kernel launch failed (CUDA error {err})")
    rans_decode_stage.launches += 1
    return x, cur


rans_decode_stage.launches = 0


# --------------------------------------------------------- host twin (np) --


def np_rans_encode(seg_probs, seg_bits, seg_valid):
    """Host-reference encoder over a list of segments in DECODE order;
    returns (states (LANES,) uint32, LANES bytes objects in read order)."""
    x = np.full(LANES, RANS_L, np.uint64)
    enc_bytes = [[] for _ in range(LANES)]
    for probs, bits, valid in reversed(list(zip(seg_probs, seg_bits, seg_valid))):
        n = len(probs)
        assert n % LANES == 0
        steps = n // LANES
        pr = np.asarray(probs, np.float32).reshape(steps, LANES)
        bt = np.asarray(bits).reshape(steps, LANES)
        vd = np.asarray(valid).reshape(steps, LANES)
        for t in reversed(range(steps)):
            f1 = np_freq1_from_prob(pr[t], vd[t]).astype(np.uint64)
            f0 = PROB_SCALE - f1
            bit = np.where(vd[t], bt[t].astype(bool), False)
            f = np.where(bit, f1, f0)
            c = np.where(bit, f0, 0)
            for _ in range(2):
                emit = x >= (f << 15)
                for lane in np.nonzero(emit)[0]:
                    enc_bytes[lane].append(int(x[lane] & 0xFF))
                x = np.where(emit, x >> 8, x)
            x = ((x // f) << 16) + (x % f) + c
    return x.astype(np.uint32), [bytes(reversed(eb)) for eb in enc_bytes]


def np_rans_decode(states, lane_streams, seg_probs, seg_valid):
    """Host-reference decoder; returns (bits per segment, final states,
    lane cursors)."""
    x = states.astype(np.uint64).copy()
    cur = np.zeros(LANES, np.int64)
    buf = [np.frombuffer(s, np.uint8) for s in lane_streams]
    out = []
    for probs, valid in zip(seg_probs, seg_valid):
        n = len(probs)
        steps = n // LANES
        pr = np.asarray(probs, np.float32).reshape(steps, LANES)
        vd = np.asarray(valid).reshape(steps, LANES)
        bits = np.zeros((steps, LANES), np.uint8)
        for t in range(steps):
            f1 = np_freq1_from_prob(pr[t], vd[t]).astype(np.uint64)
            f0 = PROB_SCALE - f1
            slot = x & (PROB_SCALE - 1)
            bit = slot >= f0
            f = np.where(bit, f1, f0)
            c = np.where(bit, f0, 0)
            x = f * (x >> 16) + slot - c
            for _ in range(2):
                need = x < RANS_L
                for lane in np.nonzero(need)[0]:
                    b = buf[lane][cur[lane]] if cur[lane] < len(buf[lane]) else 0
                    x[lane] = (x[lane] << 8) | b
                    cur[lane] += 1
            bits[t] = np.where(vd[t], bit, False)
        out.append(bits.reshape(n))
    return out, x.astype(np.uint32), cur


# ------------------------------------------------------------ blob format --

_V2_FLAG = 0x80000000  # high bit of the LANES word = has CRC32


def pack_rans_blob_flat(states: np.ndarray, payload: np.ndarray, lane_lens: np.ndarray) -> bytes:
    """rans-v2 blob from a lane-major concatenated payload (lane l's stream
    = payload[sum(lane_lens[:l]):][:lane_lens[l]])."""
    head = [
        np.asarray([LANES | _V2_FLAG], np.uint32).tobytes(),
        np.asarray([zlib.crc32(payload.tobytes()) & 0xFFFFFFFF], np.uint32).tobytes(),
        np.asarray(states, np.uint32).tobytes(),
        np.asarray(lane_lens, np.uint32).tobytes(),
    ]
    return b"".join(head) + payload.tobytes()


def pack_rans_blob(states: np.ndarray, lane_streams: list) -> bytes:
    """rans-v2 blob: u32 (LANES | 0x80000000) | u32 crc32(streams) | LANES
    x u32 state | LANES x u32 length | concatenated lane streams."""
    payload = np.frombuffer(b"".join(lane_streams), np.uint8)
    return pack_rans_blob_flat(states, payload, np.asarray([len(s) for s in lane_streams]))


def unpack_rans_blob(blob: bytes):
    """-> (states (LANES,) uint32, flat stream (B+1,) uint8 with a zero
    sentinel, lane byte offsets (LANES,) int64).  Verifies the v2 CRC."""
    word0 = int(np.frombuffer(blob[:4], np.uint32)[0])
    has_crc = bool(word0 & _V2_FLAG)
    lanes = word0 & ~_V2_FLAG
    if lanes != LANES:
        raise ValueError(
            f"rans blob was written with {lanes} lanes; this build decodes {LANES} "
            "(the lane count is a wire-format constant)"
        )
    off = 4
    crc_stored = None
    if has_crc:
        crc_stored = int(np.frombuffer(blob[off: off + 4], np.uint32)[0])
        off += 4
    states = np.frombuffer(blob[off: off + 4 * LANES], np.uint32).copy()
    off += 4 * LANES
    lens = np.frombuffer(blob[off: off + 4 * LANES], np.uint32).astype(np.int64)
    off += 4 * LANES
    flat = np.frombuffer(blob[off:], np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    if len(flat) != int(lens.sum()):
        raise ValueError(f"rans blob holds {len(flat)} stream bytes, header says {int(lens.sum())}")
    if crc_stored is not None:
        crc = zlib.crc32(flat.tobytes()) & 0xFFFFFFFF
        if crc != crc_stored:
            raise ValueError(
                f"rans blob CRC mismatch: stored {crc_stored:#010x}, computed {crc:#010x}"
            )
    flat = np.concatenate([flat, np.zeros(1, np.uint8)])
    return states, flat, offs
