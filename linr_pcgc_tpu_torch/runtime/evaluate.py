"""Mid-training evaluation: the real rate of a GOP checkpoint.

Port of linr_pcgc_tpu/runtime/evaluate.py (itself the reference's
``Test_one_gop``): load the checkpoint, round-trip the weight codec with an
equality assert, code every (frame, scale, stage) with the host arithmetic
coder under the production encoder's probabilities, decode those streams
with the production decoder (the AC wire of runtime/dev_codec.py) with a
losslessness assert over every frame, and report

    bpp_all = point_bpp + model_bpp + xyzlow_bpp

with per-frame encode and decode times, written to ``result.json``.  The
same keys, ``side_info.json`` and ``bins/`` layout as the JAX package.
Runs on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ..coding import binary_encode_batch, binary_estimate_bits, pack_bitstream
from ..coding.weights import compress_params, decompress_params
from ..device import codec_numerics, resolve_device
from ..models.network import ModelConfig, param_tree, params_to_flat, unflatten_params
from ..ops.octree import OCTANT_OFFSETS


def _gop_probs_and_bits(params, cfg: ModelConfig, pyramids, device):
    """Per frame, [(scale, stage, probabilities float32, ground-truth bits
    float32)] in (scale, stage) order, computed exactly as the production
    encoder computes them (the same frame chunks and producer), so that the
    decoder reproduces them bit for bit."""
    from .codec import _use_sb
    from .dev_codec import _frame_chunks, encode_chunk_probs_dev

    if not _use_sb(cfg):
        raise NotImplementedError(
            f"{cfg}: only kernel_size 3, outstage 8, non-dilation models are ported; the "
            "others run on the gather backend (ROADMAP A.4.1)")
    f = len(pyramids)
    per_frame = [[] for _ in range(f)]
    with codec_numerics():
        for chunk in _frame_chunks(f):
            levels = encode_chunk_probs_dev(params, cfg, [pyramids[i] for i in chunk], device,
                                            keep_device=False)
            for s, probs, bits in sorted(levels, key=lambda e: e[0]):
                for stage in range(cfg.outstage):
                    for j, i in enumerate(chunk):
                        per_frame[i].append((s, stage, probs[stage][j],
                                             bits[stage][j].astype(np.float32)))
    return per_frame


def frame_bit_heatmap(params, cfg: ModelConfig, pyr, device=None) -> list:
    """Per-point bit heatmap data (the reference's ``codec_with_point``):
    per scale, the parent coordinates, the ground-truth occupancy, each
    stage's prediction quality 1 - |p - gt| and its -log2 coding cost."""
    per_frame = _gop_probs_and_bits(params, cfg, [pyr], resolve_device(device))[0]
    out = []
    for s_idx, lev in enumerate(pyr.levels):
        entries = [e for e in per_frame if e[0] == s_idx]
        p = np.stack([e[2] for e in entries], axis=1)   # (n, 8)
        gt = np.stack([e[3] for e in entries], axis=1)  # (n, 8)
        quality = 1.0 - np.abs(p - gt)
        out.append({
            "coords": lev.coords[: lev.n].copy(),
            "gt": gt,
            "quality": quality,
            "bits": -np.log2(np.maximum(quality, 1e-12)),
        })
    return out


def _original_coords(pyr) -> np.ndarray:
    """The frame's original (min-subtracted) sorted coordinates, rebuilt
    from the finest level's occupancy: the decode's target."""
    lev = pyr.levels[0]
    c = lev.coords[: lev.n].astype(np.int64)
    occ = lev.occ[: lev.n].astype(bool)
    offs = np.asarray(OCTANT_OFFSETS, np.int64)
    children = (c[:, None, :] * 2 + offs[None]).reshape(-1, 3)[occ.reshape(-1)]
    key = (children[:, 0] << 42) | (children[:, 1] << 21) | children[:, 2]
    return children[np.argsort(key, kind="stable")].astype(np.int32)


def test_one_gop(model_path: str, cfg: ModelConfig, pyramids: list, result_dir: str,
                 low_bytes: bytes, write_flag: bool = False, device=None) -> dict:
    """The real rate of the checkpoint at ``model_path`` over the GOP; with
    ``write_flag`` the bitstream goes to ``<result_dir>/bins``.  Raises if
    the weight codec or the decode is not lossless."""
    from .codec import CFG_SIDE_BITS, cfg_side_info, decode_gop_streams
    from .overfit import load_checkpoint

    dev = resolve_device(device)
    os.makedirs(result_dir, exist_ok=True)
    bins_dir = os.path.join(result_dir, "bins")
    if write_flag:
        os.makedirs(bins_dir, exist_ok=True)
        with open(os.path.join(bins_dir, "low_enc_bytes.bin"), "wb") as f:
            f.write(low_bytes)

    params, _, meta = load_checkpoint(model_path, cfg)
    bitdepth = meta.get("bitdepth", 8)

    # the weight codec's round trip, with an equality assert
    enc_time = dec_time = 0.0
    st = time.time()
    flat = params_to_flat(params)
    comp = compress_params(flat, bitdepth)
    enc_time += time.time() - st
    st = time.time()
    recon = decompress_params(len(flat), comp["side_info"], comp["final_bytes"])
    dec_time += time.time() - st
    if not np.array_equal(recon, comp["recon"]):
        raise AssertionError("weight codec roundtrip failed")
    params_used = param_tree(unflatten_params(cfg, recon, dev))

    if write_flag:
        with open(os.path.join(bins_dir, "model.bin"), "wb") as f:
            f.write(comp["final_bytes"])
    with open(os.path.join(result_dir, "side_info.json"), "w") as f:
        json.dump(dict(comp["side_info"], model_cfg=cfg_side_info(cfg)), f, indent=4)

    # encode: the network over the whole GOP, then one batch of the coder
    st = time.time()
    per_frame = _gop_probs_and_bits(params_used, cfg, pyramids, dev)
    t_net = time.time() - st
    probs = [e[2] for frame in per_frame for e in frame]
    bits = [e[3] for frame in per_frame for e in frame]
    st = time.time()
    streams = binary_encode_batch(probs, bits)
    t_enc = time.time() - st

    bits_est = sum(binary_estimate_bits(p, b) for p, b in zip(probs, bits))
    points = sum(p.point_num for p in pyramids)
    # the real point bits: packed per (frame, scale) as the encoder packs them
    bits_real = 0
    s_num = pyramids[0].scale_num
    frame_blobs = []
    for i, frame in enumerate(per_frame):
        blobs = []
        for s in range(s_num):
            idxs = [j for j, e in enumerate(frame) if e[0] == s]
            base = i * s_num * cfg.outstage  # outstage streams per (frame, scale)
            blob = pack_bitstream([streams[base + j] for j in idxs])
            bits_real += len(blob) * 8
            blobs.append(blob)
            if write_flag:
                with open(os.path.join(bins_dir, f"frame{i:04d}_scale{s}.bin"), "wb") as f:
                    f.write(blob)
        frame_blobs.append(blobs)

    # decode: the production decoder, timed apart from the encode, with
    # the losslessness assert
    lows = [p.low_coords for p in pyramids]
    st = time.time()
    with codec_numerics():
        decoded = decode_gop_streams(params_used, cfg, frame_blobs, lows, dev, "ac")
    t_dec = time.time() - st
    for i, (got, pyr) in enumerate(zip(decoded, pyramids)):
        gt = _original_coords(pyr)
        if got.shape != gt.shape or not np.array_equal(got, gt):
            raise AssertionError(f"frame {i} mid-test decode mismatch")

    enc_time += t_net + t_enc
    dec_time += t_dec
    model_bits = comp["bit_real"] + CFG_SIDE_BITS
    low_bits = len(low_bytes) * 8
    n_frames = len(pyramids)
    result = {
        "bpp_all": (bits_real + model_bits + low_bits) / points,
        "point_bpp": bits_real / points,
        "point_bpp_val": bits_est / points,
        "model_bpp": model_bits / points,
        "xyzlow_bpp": low_bits / points,
        "enc_mode": comp["enc_mode"],
        "enc_time": enc_time / n_frames,
        "dec_time": dec_time / n_frames,
    }
    with open(os.path.join(result_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=4)
    return result
