"""GOP assembly and training on the 4^3 brick grid: the bricks trainer.

Port of linr_pcgc_tpu/runtime/brick_overfit.py, one of JAX's cross-check
backends (``overfit_gop(backend="bricks")``).  The loss over the occupied
slots equals the flat voxel loss, and the optimizer is the other trainers'
(overfit.epoch_steps: Adam with coupled weight decay, StepLR per frame
step, the min_lr clamp after each epoch).

The brick network is the superbrick network at a stage batch of one
(models/brick_network.py), so the frame gradient is the superbrick
trainer's (sb_overfit.make_frame_grads_sb) on its unfused pass with the
whole frame as one unit and stage chunks of one: x_glob (input embedding
-> block_in) once as a detached leaf, each stage's forward and then its
``backward``, so one stage's activations are alive at a time (JAX
recomputes them under jax.checkpoint instead), and d(x_glob), summed over
the stages in x_glob's dtype, folds back through block_in once at the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.dataset import FramePyramid
from ..device import resolve_device
from ..models.brick_network import sb_level_slices
from ..models.network import ModelConfig
from ..ops.bricks import SLOTS, build_brick_level
from .overfit import TrainConfig, epoch_steps
from .sb_overfit import make_frame_grads_sb, sb_frame_loss


def _brick_bucket(n: int) -> int:
    """Brick-count bucket of a level (~4 per octave, at least 256)."""
    if n <= 256:
        return 256
    p = 1 << (int(n - 1).bit_length() - 1)
    step = max(256, p // 4)
    return ((n + step - 1) // step) * step


@dataclasses.dataclass
class BrickGopBatch:
    """A GOP on the brick grid, stacked over frames, as the JAX batch."""

    nbr27: torch.Tensor      # (F, Bb, 27) int32 flat-global brick map, -1 absent
    mask: torch.Tensor       # (F, Bb, 64) uint8 occupied-slot mask
    code: torch.Tensor       # (F, Bb, 64) int32 scale*128 + feat, -1 empty
    occ: torch.Tensor        # (F, Bb, 8, 64) uint8
    point_num: torch.Tensor  # (F,) float32
    level_slices: tuple      # ((start, end), ...) per scale

    @property
    def n_frames(self) -> int:
        return self.nbr27.shape[0]


def assemble_gop_bricks(pyramids: list[FramePyramid], device=None) -> BrickGopBatch:
    """Brickify every level of every frame on the host and pad each level
    to a bucket shared by the frames; the batch is uploaded to ``device``
    (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    s_num = pyramids[0].scale_num
    if any(p.scale_num != s_num for p in pyramids):
        raise ValueError("frames disagree on scale_num")
    levels = [
        [
            build_brick_level(p.levels[s].coords[: p.levels[s].n], p.levels[s].occ[: p.levels[s].n],
                              p.levels[s].feat_code[: p.levels[s].n], s)
            for s in range(s_num)
        ]
        for p in pyramids
    ]
    buckets = [_brick_bucket(max(fl[s].n_bricks for fl in levels)) for s in range(s_num)]
    offsets = np.cumsum([0] + buckets[:-1]).astype(np.int64)
    total = int(sum(buckets))
    level_slices = tuple((int(offsets[s]), int(offsets[s] + buckets[s])) for s in range(s_num))

    f_nbr, f_mask, f_code, f_occ = [], [], [], []
    for fl in levels:
        nbr = np.full((total, 27), -1, np.int32)
        mask = np.zeros((total, SLOTS), np.uint8)
        code = np.full((total, SLOTS), -1, np.int32)
        occ = np.zeros((total, 8, SLOTS), np.uint8)
        for s in range(s_num):
            lev = fl[s]
            a, nb = int(offsets[s]), lev.n_bricks
            nbr[a: a + nb] = np.where(lev.nbr27 >= 0, lev.nbr27 + np.int32(a), -1)
            mask[a: a + nb] = lev.slot_mask
            code[a: a + nb] = lev.scale_code
            occ[a: a + nb] = lev.occ
        f_nbr.append(nbr)
        f_mask.append(mask)
        f_code.append(code)
        f_occ.append(occ)
    as_t = lambda a: torch.as_tensor(np.stack(a), device=dev)  # noqa: E731
    return BrickGopBatch(
        nbr27=as_t(f_nbr), mask=as_t(f_mask), code=as_t(f_code), occ=as_t(f_occ),
        point_num=torch.as_tensor(np.array([p.point_num for p in pyramids], np.float32),
                                  device=dev),
        level_slices=level_slices,
    )


def brick_frames(batch: BrickGopBatch):
    """The batch's frames one by one, as the frame gradient takes them
    (the slot mask from the code, as in the superbrick trainer)."""
    return (dict(nbr27=batch.nbr27[i], code=batch.code[i], occ=batch.occ[i],
                 point_num=batch.point_num[i]) for i in range(batch.n_frames))


def brick_frame_loss(params, cfg: ModelConfig, fd: dict, level_slices,
                     compute_dtype=torch.float32):
    """Bits per point of one frame, in one pass over all 8 stages;
    ``params`` the nested view (models.network.param_tree), ``fd`` as
    brick_frames gives it."""
    return sb_frame_loss(params, cfg, fd, sb_level_slices(level_slices), compute_dtype)


def make_frame_grads_bricks(cfg: ModelConfig, level_slices, compute_dtype=torch.bfloat16):
    """(flat params, frame data) -> (bits per point, flat gradient) of one
    frame, stage by stage (the module's docstring); ``flat`` the float32
    parameter vector in the flatten order."""
    return make_frame_grads_sb(cfg, sb_level_slices(level_slices), compute_dtype,
                               max_group_bricks=level_slices[-1][1], stage_chunk=1, fused=False)


def make_epoch_fn_bricks(cfg: ModelConfig, tc: TrainConfig, level_slices,
                         compute_dtype=torch.bfloat16):
    """Sequential epoch trainer on the brick grid: epoch_fn(flat, opt, lr,
    sched_count, batch) -> (flat, opt, lr, sched_count, per-frame losses),
    as overfit.epoch_steps runs it.  bf16 activations by default (the
    parameters and Adam state stay f32); float32 on request."""
    frame_grads = make_frame_grads_bricks(cfg, level_slices, compute_dtype)

    def epoch_fn(flat, opt, lr, sched_count, batch: BrickGopBatch):
        return epoch_steps(frame_grads, tc, flat, opt, lr, sched_count, brick_frames(batch))

    return epoch_fn
