"""GOP assembly and training on the 4^3 superbrick layout.

Port of the single-device paths of linr_pcgc_tpu/runtime/sb_overfit.py.
The loss over occupied slots equals the flat voxel loss, and the optimizer
semantics (Adam with coupled weight decay, StepLR per frame step, the
min_lr clamp after each epoch) are the JAX trainer's.

Memory discipline.  The frame loss is a sum over (level group x stage
chunk) units: levels share no activation, and stages are independent given
the inputs.  Each unit runs its forward and then ``backward`` into the
gradient of one flat float32 parameter vector, so the unit gradients sum to
the exact frame gradient and the peak is one unit's working set.  Inside a
unit every 3^3 conv saves only its input, never its halo
(ops/superbricks.b4_convsm_bm), which is the JAX trainer's checkpoint
policy without recomputation.

Two passes, chosen as JAX chooses them.  The default config (one inception
layer per block) takes the fused pass: block_in rides each stage chunk's
halo exchanges as its row 0 (models/sb_network.sb_fused_chunk_bits).
Every other config (``block_layers`` > 1, resnet blocks) takes the unfused
pass: x_glob (input embedding -> block_in) once per level group, then each
stage chunk given x_glob as a detached leaf, whose gradient accumulates in
x_glob's dtype over the chunks and is folded back through block_in once at
the end.  x_glob's graph stays alive across the chunks; at S = 1 it is a
fraction of a chunk's working set, so it is not recomputed.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..data.dataset import FramePyramid
from ..device import resolve_device
from ..models.network import ModelConfig, param_tree, unflatten_params
from ..models.sb_network import sb_chunk_bits, sb_fused_chunk_bits, sb_x_glob
from ..ops.superbricks import build_superbrick_level, unpack_bits
from .overfit import TrainConfig, epoch_steps

SIDE = 4
SLOTS = SIDE**3

# Bytes of device memory per brick-row of a stage chunk at the default
# config (hidden_channel_conv 8), measured on a TPU (v5e, round 4: 81,920
# bricks x (8 + 1) rows compiled to 18.87 GB).  Kept so that the stage
# chunk is derived by the JAX trainer's formula; its H100 value is not
# measured yet.
BYTES_PER_BRICK_ROW = {torch.bfloat16: 26 * 1024, torch.float32: 52 * 1024}


def _sb_bucket(n: int) -> int:
    """Brick-count bucket of a level (~4 per octave, at least 64)."""
    if n <= 64:
        return 64
    p = 1 << (int(n - 1).bit_length() - 1)
    step = max(64, p // 4)
    return ((n + step - 1) // step) * step


@dataclasses.dataclass
class SbGopBatch:
    """A GOP on the brick layout, stacked over frames.  ``code`` is int16
    and ``occ`` bit-packed along the slot axis, as in the JAX batch."""

    nbr27: torch.Tensor      # (F, Bb, 27) int32 flat-global brick map, -1 absent
    code: torch.Tensor       # (F, Bb, 64) int16 scale*128 + feat, -1 empty
    occ: torch.Tensor        # (F, Bb, 8, 8) uint8 bit-packed occupancy
    point_num: torch.Tensor  # (F,) float32
    level_slices: tuple      # ((start, end, scale_idx), ...) per scale

    @property
    def n_frames(self) -> int:
        return self.nbr27.shape[0]

    def occ_dense(self, f: int) -> torch.Tensor:
        """Unpacked (Bb, 8, 64) uint8 occupancy of frame ``f``."""
        return unpack_bits(self.occ[f])


def assemble_gop_superbricks(pyramids: list[FramePyramid], device=None) -> SbGopBatch:
    """Brickify every level of every frame on the host and pad each level
    to a bucket shared by the frames; the batch is uploaded to ``device``
    (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    s_num = pyramids[0].scale_num
    if any(p.scale_num != s_num for p in pyramids):
        raise ValueError("frames disagree on scale_num")
    levels = [
        [
            build_superbrick_level(
                p.levels[s].coords[: p.levels[s].n], p.levels[s].occ[: p.levels[s].n],
                p.levels[s].feat_code[: p.levels[s].n], s, side=SIDE,
            )
            for s in range(s_num)
        ]
        for p in pyramids
    ]
    buckets = [_sb_bucket(max(fl[s].n_bricks for fl in levels)) for s in range(s_num)]
    offsets = np.cumsum([0] + buckets[:-1]).astype(np.int64)
    total = int(sum(buckets))
    level_slices = tuple((int(offsets[s]), int(offsets[s] + buckets[s]), s) for s in range(s_num))

    f_nbr, f_code, f_occ = [], [], []
    for fl in levels:
        nbr = np.full((total, 27), -1, np.int32)
        code = np.full((total, SLOTS), -1, np.int16)
        occ = np.zeros((total, 8, SLOTS), np.uint8)
        for s in range(s_num):
            lev = fl[s]
            a = int(offsets[s])
            nb = lev.n_bricks
            nbr[a: a + nb] = np.where(lev.nbr27 >= 0, lev.nbr27 + np.int32(a), -1)
            code[a: a + nb] = lev.scale_code.astype(np.int16)
            occ[a: a + nb] = lev.occ
        f_nbr.append(nbr)
        f_code.append(code)
        f_occ.append(np.packbits(occ, axis=-1))
    return SbGopBatch(
        nbr27=torch.as_tensor(np.stack(f_nbr), device=dev),
        code=torch.as_tensor(np.stack(f_code), device=dev),
        occ=torch.as_tensor(np.stack(f_occ), device=dev),
        point_num=torch.as_tensor(np.array([p.point_num for p in pyramids], np.float32),
                                  device=dev),
        level_slices=level_slices,
    )


def level_groups(level_slices, max_group_bricks: int | None = None):
    """Partition the contiguous, ordered level slices into groups whose
    gradients are accumulated one after another.  The finest level, about
    half of all bricks, is never split (halo exchanges cross its bricks).

    Returns [(start, end, rebased_slices), ...], the slices rebased to the
    group's start."""
    total = level_slices[-1][1]
    if max_group_bricks is None:
        # group only at production scale; small batches in one piece
        max_group_bricks = total if total <= 4096 else max(total // 3, 1)
    groups, cur = [], []
    for sl in level_slices:
        if cur and (sl[1] - cur[0][0]) > max_group_bricks:
            groups.append(cur)
            cur = []
        cur.append(sl)
    if cur:
        groups.append(cur)
    return [
        (g[0][0], g[-1][1], tuple((a - g[0][0], b - g[0][0], s) for (a, b, s) in g))
        for g in groups
    ]


def is_fused(cfg: ModelConfig) -> bool:
    """Whether the trainer takes the fused pass (block_in riding the stage
    chunks): only the default one-layer inception block_in shares the
    context blocks' architecture."""
    return cfg.block_layers == 1 and cfg.block_type == "inception"


def stage_chunk_picker(cfg: ModelConfig, total: int, compute_dtype, stage_chunk=None):
    """group bricks -> stage-chunk width cs, by the JAX trainer's formula:
    the largest divisor of outstage, at most 8 (bf16) or 4 (f32) on the
    fused pass and 4 or 2 on the unfused one, whose (cs + 1) rows of every
    brick fit the memory budget at BYTES_PER_BRICK_ROW (budget
    LINR_SB_HBM_GB, 14 GiB by default).  Small batches (total * 64 <= 4096
    * 512) take the whole outstage."""
    if stage_chunk is not None:
        if cfg.outstage % stage_chunk:
            raise ValueError(f"stage_chunk {stage_chunk} does not divide outstage {cfg.outstage}")
        return lambda group_bricks: stage_chunk
    small = total * SLOTS <= 4096 * 512
    bf16 = compute_dtype == torch.bfloat16
    if small:
        base_cs = cfg.outstage
    elif is_fused(cfg):
        base_cs = 8 if bf16 else 4
    else:
        base_cs = 4 if bf16 else 2
    bpr = BYTES_PER_BRICK_ROW[torch.bfloat16 if bf16 else torch.float32]
    budget = float(os.environ.get("LINR_SB_HBM_GB", "14")) * 2**30
    divisors = [d for d in range(cfg.outstage, 0, -1) if cfg.outstage % d == 0]

    def pick_cs(group_bricks: int) -> int:
        for d in divisors:
            if d > base_cs:
                continue
            if small or (d + 1) * group_bricks * bpr <= budget:
                return d
        return 1

    return pick_cs


def make_frame_grads_sb(cfg: ModelConfig, level_slices, compute_dtype=torch.bfloat16,
                        max_group_bricks: int | None = None, stage_chunk: int | None = None,
                        stages: tuple | None = None, reduce=None):
    """(flat params, frame data) -> (loss, flat gradient) of one frame:
    bits per point and its gradient, accumulated unit by unit.

    ``flat`` is the float32 parameter vector in the flatten order; frame
    data is dict(nbr27 (Bb, 27), code (Bb, 64), occ (Bb, 8, 8) packed,
    point_num ()) on the parameters' device.

    The stage-parallel trainer (parallel/train.py) gives each rank
    ``stages`` = (first, end), the stage chunks of every level group it
    runs, and ``reduce``, which sums a tensor over the ranks in place:
    then the rank's (gradient, bits) are summed once per frame, 54,713
    float32 values at the default config, and on the unfused pass each
    group's x_glob cotangent is summed before it folds back through
    block_in (x_glob is recomputed on every rank), so that the fold, done
    alike on every rank, is added after the sum."""
    fused = is_fused(cfg)
    total = level_slices[-1][1]
    if max_group_bricks is None and total * SLOTS <= 4096 * 512:
        max_group_bricks = total
    pick_cs = stage_chunk_picker(cfg, total, compute_dtype, stage_chunk)
    units = [(ga, gb, sub, pick_cs(gb - ga))
             for (ga, gb, sub) in level_groups(level_slices, max_group_bricks)]
    lo, hi = (0, cfg.outstage) if stages is None else stages

    def frame_grads(flat: torch.Tensor, fd: dict):
        leaf = flat.detach().requires_grad_()
        bits_total = torch.zeros((), dtype=torch.float32, device=flat.device)
        fold = None
        for ga, gb, sub_slices, cs in units:
            nbr = fd["nbr27"][ga:gb]
            code = fd["code"][ga:gb]
            geom = dict(
                # neighbour indices are flat-global: rebase to the group
                nbr27=torch.where(nbr >= 0, nbr - ga, -1).int().contiguous(),
                mask=(code >= 0).to(compute_dtype)[:, None, None, :],
                code=code,
                dtype=compute_dtype,
            )
            occ = unpack_bits(fd["occ"][ga:gb])
            if not fused:
                x_glob = sb_x_glob(param_tree(unflatten_params(cfg, leaf, flat.device)), cfg,
                                   geom, sub_slices)
                xg = x_glob.detach().requires_grad_()
            for base in range(lo, hi, cs):
                params = param_tree(unflatten_params(cfg, leaf, flat.device))
                if fused:
                    bits = sb_fused_chunk_bits(params, cfg, geom, occ, base, cs, sub_slices,
                                               first=base == 0)
                else:
                    bits = sb_chunk_bits(params, cfg, geom, occ, base, cs, xg)
                bits.backward()
                bits_total = bits_total + bits.detach()
            if not fused:
                # d(x_glob), summed over the chunks in x_glob's dtype, back
                # through block_in and the input embedding
                if reduce is None:
                    x_glob.backward(xg.grad)
                else:
                    g = torch.autograd.grad(x_glob, leaf, reduce(xg.grad))[0]
                    fold = g if fold is None else fold + g
        if reduce is None:
            return bits_total / fd["point_num"], leaf.grad / fd["point_num"]
        summed = reduce(torch.cat([leaf.grad, bits_total[None]]))
        grad = summed[:-1] if fold is None else summed[:-1] + fold
        return summed[-1] / fd["point_num"], grad / fd["point_num"]

    frame_grads.units = [(ga, gb, cs) for ga, gb, _, cs in units]
    return frame_grads


def make_epoch_fn_sb(cfg: ModelConfig, tc: TrainConfig, level_slices,
                     compute_dtype=torch.bfloat16, max_group_bricks: int | None = None,
                     stage_chunk: int | None = None, stages: tuple | None = None, reduce=None):
    """Sequential epoch trainer on the brick layout: epoch_fn(flat, opt,
    lr, sched_count, batch), as overfit.epoch_steps runs it; ``stages``
    and ``reduce`` make it a rank of the stage-parallel trainer
    (make_frame_grads_sb)."""
    frame_grads = make_frame_grads_sb(cfg, level_slices, compute_dtype, max_group_bricks,
                                      stage_chunk, stages, reduce)

    def epoch_fn(flat, opt, lr, sched_count, batch: SbGopBatch):
        return epoch_steps(frame_grads, tc, flat, opt, lr, sched_count, sb_frames(batch))

    epoch_fn.units = frame_grads.units
    return epoch_fn


def sb_frames(batch: SbGopBatch):
    """The batch's frames one by one, as the frame gradient takes them."""
    return (dict(nbr27=batch.nbr27[i], code=batch.code[i], occ=batch.occ[i],
                 point_num=batch.point_num[i]) for i in range(batch.n_frames))
