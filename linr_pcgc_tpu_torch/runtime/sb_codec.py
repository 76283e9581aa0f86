"""The host-AC superbrick codec: per level, the brick geometry built on the
host, one x_glob call and one probability call a stage on the device, and
the host arithmetic coder for every stream of the level in one batch.

Port of linr_pcgc_tpu/runtime/sb_codec.py, with its names.  Its entry points
are runtime/codec.py's ``encode_gop_streams_sb`` and ``decode_gop_streams_sb``
(API only: the CLI's codec is runtime/dev_codec.py).  The geometry is
``build_codec_level`` at side 4 (4^3 bricks, the default) or side 8 (JAX's
8^3 superbricks, which the network maps onto its 4^3 sub-bricks at entry,
models/sb_network.py); both codec sides must use the same side.

Encoder/decoder bit identity.  Both sides run the same float32 calls under
``device.codec_numerics()``: ``sb_codec_ctx`` once a level, then
``sb_codec_stage_probs`` once a stage, the encoder on the ground truth and
the decoder on its partial buffer, whose channels at or above the stage are
zero.  The network multiplies occupancy channel c by exactly 0.0 for c >=
stage before anything reads it, so the channels a stage's call reads are
the same on both sides, and so are its f16 probabilities.  The geometry
is integer numpy from coordinates both sides hold, and the bucket (the
shapes) follows from brick counts both sides compute.

Frames of a level are appended along the brick axis (frame f's bricks from
f * bucket): frames never neighbour each other, so one call covers up to
CODEC_FRAME_CHUNK frames of a level.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..coding import binary_decode_batch
from ..data.dataset import bucket_size
from ..models.network import ModelConfig
from ..models.sb_network import sb_chunk_logits, sb_x_glob
from ..ops.octree import np_feat_code
from ..ops.superbricks import build_superbrick_level, unpack_bits
from .dev_codec import CODEC_FRAME_CHUNK, _frame_chunks, _split_probs  # noqa: F401  (JAX's names)
from .sb_overfit import _sb_bucket


@dataclasses.dataclass
class CodecLevel:
    """One level's GOP-batched brick geometry (frames appended along the
    brick axis with a shared per-frame bucket), host numpy."""

    nbr27: np.ndarray          # (F*B, 27) int32, -1 absent
    code: np.ndarray           # (F*B, slots) int32 scale*128+feat, -1 empty
    occ: np.ndarray            # (F*B, 8, slots) uint8 (zeros when unknown)
    voxel_maps: list           # per frame (voxel_brick + f*B, voxel_slot, n)
    bucket: int
    scale_idx: int

    @property
    def slices(self):
        return ((0, self.nbr27.shape[0], self.scale_idx),)


def build_codec_level(frame_coords: list, scale_idx: int, frame_occs: list | None = None,
                      side: int = 4) -> CodecLevel:
    """Brickify one level of every frame at side^3.  ``frame_coords`` are
    trimmed, canonically sorted coordinate arrays; ``frame_occs`` the
    ground-truth occupancies (encoder) or None (decoder: zeros until
    decoded).  Both codec sides must pass the same ``side``."""
    f = len(frame_coords)
    slots = side**3
    levs = []
    for i, c in enumerate(frame_coords):
        occ = frame_occs[i] if frame_occs is not None else np.zeros((len(c), 8), np.uint8)
        levs.append(build_superbrick_level(c, occ, np_feat_code(c), scale_idx, side=side))
    b = _sb_bucket(max(lev.n_bricks for lev in levs))
    nbr = np.full((f * b, 27), -1, np.int32)
    code = np.full((f * b, slots), -1, np.int32)
    occ_b = np.zeros((f * b, 8, slots), np.uint8)
    maps = []
    for i, lev in enumerate(levs):
        a = i * b
        nb = lev.n_bricks
        nbr[a: a + nb] = np.where(lev.nbr27 >= 0, lev.nbr27 + np.int32(a), -1)
        code[a: a + nb] = lev.scale_code
        occ_b[a: a + nb] = lev.occ
        maps.append((lev.voxel_brick.astype(np.int64) + a, lev.voxel_slot, lev.n_vox))
    return CodecLevel(nbr27=nbr, code=code, occ=occ_b, voxel_maps=maps, bucket=b,
                      scale_idx=scale_idx)


# ------------------------------------------------------- device calls ----


def _geom(code, nbr27):
    return dict(nbr27=nbr27, mask=(code >= 0).float()[:, None, None, :], code=code,
                dtype=torch.float32)


def sb_codec_ctx(params, cfg: ModelConfig, code, nbr27, slices):
    """A level's stage-independent context x_glob, float32, computed once a
    level on both codec sides."""
    return sb_x_glob(params, cfg, _geom(code, nbr27), slices)


def sb_codec_stage_probs(params, cfg: ModelConfig, code, nbr27, occ_packed, x_glob,
                         stage: int, vox_idx):
    """ONE stage's occupancy probabilities at the voxels, (Nv,) f16: the
    call both codec sides run.  The occupancy comes bit-packed (unpacked
    here), the network runs in float32, and the probabilities go back per
    voxel (``vox_idx`` = brick * slots + slot, pad-tailed) as f16, which
    both sides round alike."""
    occ = unpack_bits(occ_packed).float()
    logits = sb_chunk_logits(params, cfg, _geom(code, nbr27), occ, stage, 1, x_glob)
    pr = torch.sigmoid(logits.float())[:, 0, :].reshape(-1)
    return pr[vox_idx].half()


def occ_set_stage(occ_packed, col_packed, stage: int):
    """Decoder buffer update, in place: write the newly decoded stage's
    packed column."""
    occ_packed[:, stage, :] = col_packed
    return occ_packed


# ------------------------------------------------------- level codecs ----
#
# A level is coded for all frames of a GOP stage by stage, in sub-batches of
# at most CODEC_FRAME_CHUNK frames (_frame_chunks, the device codec's own);
# the grouping follows from the frame count alone, so encoder and decoder
# make the same calls.


def _vox_idx_bucketed(level: CodecLevel, device):
    """The frames' per-voxel flat slot indices, concatenated and pad-tailed
    to a bucket (the decoder derives the same counts, so the same shapes),
    on ``device``; and the per-frame counts."""
    slots = level.code.shape[-1]
    idx = np.concatenate([vb * slots + vs for (vb, vs, n) in level.voxel_maps]).astype(np.int64)
    out = np.zeros(bucket_size(len(idx)), np.int64)
    out[: len(idx)] = idx
    return torch.as_tensor(out, device=device), [n for (_, _, n) in level.voxel_maps]


def _level_tensors(level: CodecLevel, device):
    return (torch.as_tensor(level.code, device=device),
            torch.as_tensor(level.nbr27, device=device),
            torch.as_tensor(np.packbits(level.occ, axis=-1), device=device))


def encode_level_probs(params, cfg: ModelConfig, level: CodecLevel, device):
    """Per-(stage, frame) probability and bit arrays of one level: one
    x_glob call and one call a stage, the decoder's own.  Returns
    (probs[stage][frame], bits[stage][frame]), float32 on the host."""
    code, nbr, occ_packed = _level_tensors(level, device)
    vox_idx, counts = _vox_idx_bucketed(level, device)
    xg = sb_codec_ctx(params, cfg, code, nbr, level.slices)
    probs = [[] for _ in range(cfg.outstage)]
    bits = [[] for _ in range(cfg.outstage)]
    for stage in range(cfg.outstage):
        pr = sb_codec_stage_probs(params, cfg, code, nbr, occ_packed, xg, stage, vox_idx)
        probs[stage] = _split_probs(pr.cpu().numpy(), counts)
        for (vb, vs, n) in level.voxel_maps:
            bits[stage].append(level.occ[vb, stage, vs].astype(np.float32))
    return probs, bits


def decode_level(params, cfg: ModelConfig, level: CodecLevel, stage_streams, device):
    """Decode one level's stage streams for every frame:
    ``stage_streams[frame][stage]`` are the AC byte streams.  Returns the
    per-frame (n, 8) occupancy arrays."""
    f = len(level.voxel_maps)
    slots = level.code.shape[-1]
    code, nbr, occ_dev = _level_tensors(level, device)  # the occupancy: zeros
    vox_idx, counts = _vox_idx_bucketed(level, device)
    xg = sb_codec_ctx(params, cfg, code, nbr, level.slices)
    out = [np.zeros((n, 8), np.uint8) for (_, _, n) in level.voxel_maps]
    for stage in range(cfg.outstage):
        pr = sb_codec_stage_probs(params, cfg, code, nbr, occ_dev, xg, stage, vox_idx)
        probs = _split_probs(pr.cpu().numpy(), counts)
        decs = binary_decode_batch(probs, [stage_streams[i][stage] for i in range(f)])
        col = np.zeros((level.nbr27.shape[0], slots), np.uint8)
        for i, (vb, vs, n) in enumerate(level.voxel_maps):
            out[i][:, stage] = decs[i]
            col[vb, vs] = decs[i]
        if stage < cfg.outstage - 1:
            # channels above the stage stay zero; the network masks them
            occ_set_stage(occ_dev, torch.as_tensor(np.packbits(col, axis=-1), device=device), stage)
    return out
