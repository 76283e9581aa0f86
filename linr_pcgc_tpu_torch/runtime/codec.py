"""GOP encode / decode to the on-disk artifact layout.

Port of the superbrick paths of linr_pcgc_tpu/runtime/codec.py, with the
same artifact layout and side-info keys:

    <dir>/side_info.json          {mu, b, min_param, max_param, enc_mode,
                                   bitdepth, model_cfg, frame_points,
                                   numerics[, entropy]}
    <dir>/bins/model.bin          entropy-coded quantized weights
    <dir>/bins/low_enc_bytes.bin  base layer: per-frame uint8 xyz triples +
                                  all frames' int32 coordinate minima
    <dir>/bins/chunk{NNNN}.rans   rANS wire (the default; entropy
                                  "rans-v2"): one occupancy blob per frame
                                  chunk
    <dir>/bins/frame{NNNN}_scale{s}.bin
                                  AC wire (LINR_CODEC_ENTROPY=ac; no entropy
                                  key): the host arithmetic coder's streams
                                  of one (frame, scale), one per stage

Both sides predict with the dequantized weights, on the same device, with
the same functions and shapes (runtime/dev_codec.py).  The probabilities
depend on the backend that computed them, so ``side_info["numerics"]``
carries a ``backend`` tag and a stream decodes only on the backend that
encoded it: the port refuses the JAX package's streams (no tag), and the
JAX package refuses the port's (an extra key in its numerics check).
"""

from __future__ import annotations

import glob as globmod
import json
import os

import numpy as np
import torch

from ..coding import pack_bitstream, unpack_bitstream
from ..coding.weights import compress_params, decompress_params
from ..data.dataset import FramePyramid
from ..data.ply import write_ply_ascii
from ..device import backend_tag, codec_numerics, resolve_device
from ..models.network import ModelConfig, init_params, param_tree, params_to_flat, unflatten_params
from .dev_codec import (
    _fused_budget_gb,
    _fused_cs_cap,
    codec_dtype,
    decode_gop_streams_dev,
    decode_gop_streams_rans,
    encode_gop_streams_dev,
    encode_gop_streams_rans,
)

# ------------------------------------------------------------ base layer --


def encode_low_all_frames(pyramids: list[FramePyramid]) -> bytes:
    """Base-layer codec: lowest-scale coords as raw uint8 triples per frame
    plus all frames' coordinate minima (int32), length-prefixed."""
    blobs = []
    mins = []
    for pyr in pyramids:
        low = pyr.low_coords
        if low.size and low.max() > 255:
            raise ValueError("lowest scale exceeds 8 bits; increase scale_num")
        blobs.append(low.astype(np.uint8).tobytes())
        mins.append(np.asarray(pyr.coord_min, np.int32))
    blobs.append(np.concatenate(mins).astype(np.int32).tobytes())
    return pack_bitstream(blobs)


def decode_low_all_frames(blob: bytes):
    parts = unpack_bitstream(blob)
    mins = np.frombuffer(parts.pop(), np.int32).reshape(-1, 3)
    lows = [np.frombuffer(p, np.uint8).reshape(-1, 3).astype(np.int32) for p in parts]
    return lows, mins


# ---------------------------------------------------------- occupancy wire --


def _use_sb(cfg: ModelConfig) -> bool:
    """The configurations the superbrick codec covers: the only ones the
    port runs (the JAX package codes the others with a gather backend)."""
    return cfg.kernel_size == 3 and cfg.outstage == 8 and cfg.block_type != "dilation"


def _require_sb(cfg: ModelConfig) -> None:
    if not _use_sb(cfg):
        raise NotImplementedError(
            f"{cfg}: only kernel_size 3, outstage 8, non-dilation models are "
            "ported; the others run on the gather backend (ROADMAP A.4.1)"
        )


def _wire() -> str:
    """The encoder's wire: "rans" unless ``LINR_CODEC_ENTROPY=ac`` asks for
    the host arithmetic coder ("ac"), as in the JAX package.  A decoder
    takes the wire from side_info's ``entropy`` key (_wire_of)."""
    return "ac" if os.environ.get("LINR_CODEC_ENTROPY", "rans") == "ac" else "rans"


def _wire_of(side_info: dict) -> str:
    entropy = side_info.get("entropy")
    if entropy not in ("rans-v2", None):
        raise ValueError(f"entropy {entropy!r}: the port decodes rans-v2 and the AC wire")
    return "rans" if entropy == "rans-v2" else "ac"


def encode_gop_streams(params, cfg: ModelConfig, pyramids: list[FramePyramid], device,
                       wire=None):
    """Occupancy streams of a GOP and their total bits on ``wire`` (by
    default the environment's): {"rans": [chunk blobs], "s_num"} on the
    rANS wire, blobs[frame][scale] on the AC wire."""
    _require_sb(cfg)
    encode = {"rans": encode_gop_streams_rans, "ac": encode_gop_streams_dev}[wire or _wire()]
    return encode(params, cfg, pyramids, device)


def decode_gop_streams(params, cfg: ModelConfig, frame_blobs, lows, device, wire=None,
                       probs_mode=None, fused_budget_gb=None, fused_cs_cap=None):
    """Decoded (min-subtracted) coordinates, one array per frame, from the
    streams of ``wire`` (by default the environment's) as
    encode_gop_streams gives them."""
    _require_sb(cfg)
    decode = {"rans": decode_gop_streams_rans, "ac": decode_gop_streams_dev}[wire or _wire()]
    return decode(params, cfg, frame_blobs, lows, device, probs_mode=probs_mode,
                  fused_budget_gb=fused_budget_gb, fused_cs_cap=fused_cs_cap)


def encode_frame(params, cfg: ModelConfig, pyr: FramePyramid, device=None) -> dict:
    """Single-frame encode (a GOP of one) on the environment's wire:
    {"blobs", "bits"}; the streams decode only with the same frame
    grouping.  Runs on the card unless ``device`` says otherwise."""
    wire = _wire()
    blobs, bits = encode_gop_streams(params, cfg, [pyr], resolve_device(device), wire)
    return {"blobs": blobs if wire == "rans" else blobs[0], "bits": bits}


def decode_frame(params, cfg: ModelConfig, scale_blobs, low_coords: np.ndarray, device=None):
    """Single-frame decode (a GOP of one; see encode_frame) on the
    environment's wire."""
    wire = _wire()
    return decode_gop_streams(params, cfg, scale_blobs if wire == "rans" else [scale_blobs],
                              [low_coords], resolve_device(device), wire)[0]


def _write_streams(bins_dir: str, wire: str, streams) -> None:
    """The wire's files: chunk{k:04d}.rans, or frame{i:04d}_scale{s}.bin."""
    if wire == "rans":
        files = {f"chunk{k:04d}.rans": blob for k, blob in enumerate(streams["rans"])}
    else:
        files = {f"frame{i:04d}_scale{s}.bin": blob
                 for i, per_scale in enumerate(streams) for s, blob in enumerate(per_scale)}
    for name, blob in files.items():
        with open(os.path.join(bins_dir, name), "wb") as f:
            f.write(blob)


def _read_streams(bins_dir: str, wire: str, cfg: ModelConfig, n_frames: int):
    """The streams _write_streams wrote.  On the AC wire a frame's scale
    count comes from its files, as in the reference decoder."""
    if wire == "rans":
        return {"rans": [_read(fn) for fn in sorted(globmod.glob(
            os.path.join(bins_dir, "chunk*.rans")))], "s_num": cfg.scale_num}
    frames = []
    for idx in range(n_frames):
        files = globmod.glob(os.path.join(bins_dir, f"frame{idx:04d}_scale*.bin"))
        if not files:
            raise FileNotFoundError(f"no frame{idx:04d}_scale*.bin under {bins_dir}")
        scale_num = 1 + max(int(fn.rsplit("scale", 1)[1].split(".bin")[0]) for fn in files)
        frames.append([_read(os.path.join(bins_dir, f"frame{idx:04d}_scale{s}.bin"))
                       for s in range(scale_num)])
    return frames


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------ side info --


def params_template(cfg: ModelConfig) -> dict:
    """Shape template for deserializing weight vectors."""
    return init_params(0, cfg)


_CFG_FIELDS = (
    "scale_num",
    "in_channel",
    "hidden_channel_conv",
    "hidden_channel_mlp",
    "embed_dim",
    "scale_mlp_hidden",
    "block_layers",
    "outstage",
    "kernel_size",
)
_BLOCK_TYPES = ("inception", "resnet", "dilation")
CFG_SIDE_BITS = 8 * (len(_CFG_FIELDS) + 1)


def cfg_side_info(cfg: ModelConfig) -> dict:
    info = {k: int(getattr(cfg, k)) for k in _CFG_FIELDS}
    info["block_type"] = _BLOCK_TYPES.index(cfg.block_type)
    return info


def cfg_from_side_info(side_info: dict) -> ModelConfig:
    info = side_info["model_cfg"]
    kw = {k: int(info[k]) for k in _CFG_FIELDS}
    kw["block_type"] = _BLOCK_TYPES[int(info.get("block_type", 0))]
    return ModelConfig(**kw)


def _numerics_info(device) -> dict:
    """What selects the probability producer: the JAX package's keys (the
    compute dtype, the conv with its flat-group halo, the fused producer
    with its cs budget and cap) plus the backend tag.  The decoder adopts
    probs / budget / cap and must match the rest.  On a card the conv is
    K1's 27-tap form ("taps"), whose f32 sums round otherwise than the
    plane-window product ("plane") that the CPU and earlier card builds
    ran, so their streams are refused there."""
    return {
        "dtype": "f32" if codec_dtype() == torch.float32 else "bf16",
        "conv_kernel": "taps" if device.type == "cuda" else "plane",
        "halo": "flat",
        "probs": "fused",
        "fused_budget_gb": _fused_budget_gb(),
        "fused_cs_cap": _fused_cs_cap(),
        "backend": backend_tag(device),
    }


def _check_numerics(enc_num, device):
    """-> (probs_mode, fused_budget_gb, fused_cs_cap) adopted from the
    encoder; raises ValueError when the stream needs another backend or
    other numerics."""
    dec_num = _numerics_info(device)
    if enc_num is None or enc_num.get("backend") != dec_num["backend"]:
        got = None if enc_num is None else enc_num.get("backend")
        raise ValueError(
            f"this stream was encoded by backend {got!r}; this decoder is "
            f"{dec_num['backend']!r}: probabilities are backend-specific, so "
            "decode it with the package and device that encoded it"
        )
    enc_num = dict(enc_num)
    adopted = (
        enc_num.pop("probs", None),
        enc_num.pop("fused_budget_gb", None),
        enc_num.pop("fused_cs_cap", None),
    )
    for k in ("probs", "fused_budget_gb", "fused_cs_cap"):
        dec_num.pop(k)
    if dec_num != enc_num:
        raise ValueError(
            f"decoder numerics {dec_num} do not match the encoder's {enc_num}: "
            "set LINR_CODEC_DTYPE to the encoder's value"
        )
    return adopted


# -------------------------------------------------------------- GOP on disk --


def encode_gop(model_path: str, pyramids: list[FramePyramid], result_dir: str,
               cfg: ModelConfig, logger=None, device=None) -> dict:
    """Encode one GOP with the checkpoint at ``model_path`` (the JAX npz
    layout) to the artifact layout; runs on the card unless ``device``
    says otherwise."""
    from .overfit import load_checkpoint

    dev = resolve_device(device)
    log = logger.info if logger is not None else print
    _require_sb(cfg)
    bins_dir = os.path.join(result_dir, "bins")
    os.makedirs(bins_dir, exist_ok=True)

    params, _, meta = load_checkpoint(model_path, cfg)
    bitdepth = meta.get("bitdepth", 8)

    low_bytes = encode_low_all_frames(pyramids)
    with open(os.path.join(bins_dir, "low_enc_bytes.bin"), "wb") as f:
        f.write(low_bytes)

    comp = compress_params(params_to_flat(params), bitdepth)
    with open(os.path.join(bins_dir, "model.bin"), "wb") as f:
        f.write(comp["final_bytes"])
    side_info = dict(
        comp["side_info"],
        model_cfg=cfg_side_info(cfg),
        frame_points=[int(p.point_num) for p in pyramids],
        numerics=_numerics_info(dev),
    )
    wire = _wire()
    if wire == "rans":
        side_info["entropy"] = "rans-v2"
    with open(os.path.join(result_dir, "side_info.json"), "w") as f:
        json.dump(side_info, f, indent=4)

    # the decoder only has the dequantized weights: predict with them
    params_used = param_tree(unflatten_params(cfg, comp["recon"], dev))
    log(f"encode GOP: {len(pyramids)} frames on {dev}")
    with codec_numerics():
        streams, total_bits = encode_gop_streams(params_used, cfg, pyramids, dev, wire)
    _write_streams(bins_dir, wire, streams)
    return {
        "point_bits": total_bits,
        "model_bits": comp["bit_real"] + CFG_SIDE_BITS + 32 * len(pyramids),
        "low_bits": len(low_bytes) * 8,
        "points": sum(p.point_num for p in pyramids),
        "enc_mode": comp["enc_mode"],
    }


def decode_gop(enc_dir: str, dec_dir: str | None, cfg: ModelConfig | None = None,
               gop_start_idx: int = 0, ground_truth=None, write_flag: bool = False,
               logger=None, device=None) -> list:
    """Decode one GOP from its artifact directory; with ``cfg=None`` the
    model comes from side_info.json alone.  ``ground_truth(i)`` (optional)
    returns frame i's original sorted coordinates, and a mismatch raises."""
    dev = resolve_device(device)
    log = logger.info if logger is not None else print
    bins_dir = os.path.join(enc_dir, "bins")
    with open(os.path.join(bins_dir, "low_enc_bytes.bin"), "rb") as f:
        lows, mins = decode_low_all_frames(f.read())
    with open(os.path.join(enc_dir, "side_info.json")) as f:
        side_info = json.load(f)
    with open(os.path.join(bins_dir, "model.bin"), "rb") as f:
        model_blob = f.read()
    if cfg is None:
        cfg = cfg_from_side_info(side_info)
    _require_sb(cfg)
    probs_mode, fused_budget_gb, fused_cs_cap = _check_numerics(side_info.get("numerics"), dev)
    wire = _wire_of(side_info)

    n_params = sum(int(t.numel()) for t in params_template(cfg).values())
    flat = decompress_params(n_params, side_info, model_blob)
    params = param_tree(unflatten_params(cfg, flat, dev))

    streams = _read_streams(bins_dir, wire, cfg, len(lows))
    if dec_dir is not None:
        os.makedirs(dec_dir, exist_ok=True)

    with codec_numerics():
        coords_list = decode_gop_streams(
            params, cfg, streams, lows, dev, wire, probs_mode=probs_mode,
            fused_budget_gb=fused_budget_gb, fused_cs_cap=fused_cs_cap,
        )
    expect = side_info.get("frame_points")
    got = [len(c) for c in coords_list]
    if expect is not None and got != list(expect):
        raise ValueError(
            f"decoded point counts {got} do not match the encoder's {expect}: "
            "the bitstream was decoded with another GOP grouping or is corrupt"
        )
    decoded = []
    for idx, coords in enumerate(coords_list):
        final = coords + mins[idx]
        if ground_truth is not None:
            gt = ground_truth(idx)
            if final.shape != gt.shape or not np.array_equal(final, gt):
                raise ValueError(f"frame {idx} decode mismatch")
            log(f"frame {idx} is correct")
        decoded.append(final)
        if write_flag and dec_dir is not None:
            write_ply_ascii(os.path.join(dec_dir, f"frame{gop_start_idx + idx:04d}.ply"), final)
    return decoded
