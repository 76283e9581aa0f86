"""Multi-device GOP training on torch.distributed: the trainers a rank runs.

Port of linr_pcgc_tpu/parallel/train.py.  JAX runs them as one program over
a mesh; here every rank runs its share in its own process
(parallel/launch.py) and the ranks meet in collectives of the rank's
``Group`` (parallel/mesh.py):

  * stage-parallel on the superbrick layout (``make_epoch_fn_sb_sp``, the
    ``devices > 1`` default): the frame gradient is an exact sum over
    (level group x stage chunk) units; rank r runs stages [r cs, (r+1) cs)
    of every level group (cs = outstage / D) through the sequential
    trainer's own unit machinery (runtime/sb_overfit.make_frame_grads_sb
    with a stage range), then one all_reduce of (gradient, bits) and the
    same Adam step on every rank: the sequential trainer's semantics and
    schedule, every rank holding the same parameters bit for bit;
  * frame data-parallel (``make_epoch_fn_sb_dp`` on the layout when D does
    not divide outstage, ``make_epoch_fn_dp`` on the gather backend): D
    frames a step, one all_reduce of the weighted gradient sum, the
    weighted-mean gradient's Adam step, with ``step_size`` / D
    (overfit.dp_train_config, applied by ``make_epoch_fn_parallel`` as JAX's
    overfit_gop applies it); frames padding the last step carry weight 0.

Parameters are the flat float32 vector of the single-device trainers, and
every epoch function has their signature epoch_fn(flat, opt, lr,
sched_count, arrays) -> (flat, opt, lr, sched_count, losses).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.network import ModelConfig
from ..runtime.overfit import (
    TrainConfig,
    adam_init,
    assemble_gop,
    batch_arrays,
    dp_train_config,
    epoch_steps,
    gather_frames,
    make_frame_grads,
    train_gop,
)
from ..runtime.sb_overfit import (
    assemble_gop_superbricks,
    make_epoch_fn_sb,
    make_frame_grads_sb,
    sb_frames,
)


def make_epoch_fn_sb_sp(cfg: ModelConfig, tc: TrainConfig, level_slices, group,
                        compute_dtype=torch.bfloat16):
    """Stage-parallel epoch trainer of one rank of ``group``: its cs =
    outstage / D stages of every level group, the unit gradients and bits
    summed over the group once per frame (and on the unfused pass x_glob's
    cotangent per level group), then the sequential trainer's Adam and
    StepLR step.  ``step_size`` is not converted: one step per frame, as on
    one device.  Requires D | outstage."""
    if cfg.outstage % group.size:
        raise ValueError(f"{group.size} ranks do not divide outstage {cfg.outstage}: "
                         "train frame-parallel (sb_dp)")
    cs = cfg.outstage // group.size
    return make_epoch_fn_sb(cfg, tc, level_slices, compute_dtype, stage_chunk=cs,
                            stages=(group.rank * cs, (group.rank + 1) * cs),
                            reduce=group.all_reduce_)


def shard_frames(frames: list, group) -> list:
    """This rank's frames, one a data-parallel step: the GOP's frames laid
    out (T, D) as JAX's ``shard_gop`` lays them, step t holding frames t*D
    .. t*D + D-1; this rank takes column ``group.rank``.  Where F % D != 0
    the last step is padded with copies of frame 0 of weight 0, so the
    update is the mean over the real frames only.  Returns [(frame,
    weight), ...]."""
    d, f = group.size, len(frames)
    steps = -(-f // d)
    out = []
    for t in range(steps):
        i = t * d + group.rank
        out.append((frames[i], 1.0) if i < f else (frames[0], 0.0))
    return out


def shard_sb_gop(batch, group) -> list:
    """shard_frames over the frames of a superbrick GOP batch."""
    return shard_frames(list(sb_frames(batch)), group)


def shard_gop(arrays: dict, group) -> list:
    """shard_frames over the frames of the gather trainer's batch_arrays."""
    return shard_frames(list(gather_frames(arrays)), group)


def dp_frame_grads(frame_grads, group):
    """The data-parallel step's gradient from a frame gradient: (flat,
    (frame, weight)) -> (the step's D frame losses, the weighted-mean
    gradient), by one all_reduce of [w g, w, the losses by rank]."""

    def step_grads(flat, shard):
        fd, w = shard
        loss, g = frame_grads(flat, fd)
        p, d = g.numel(), group.size
        buf = torch.zeros(p + 1 + d, dtype=torch.float32, device=g.device)
        buf[:p] = w * g
        buf[p] = w
        buf[p + 1 + group.rank] = loss
        group.all_reduce_(buf)
        return buf[p + 1:], buf[:p] / buf[p]

    return step_grads


def make_epoch_fn_sb_dp(cfg: ModelConfig, tc: TrainConfig, level_slices, group,
                        compute_dtype=torch.bfloat16):
    """Frame-parallel epoch on the superbrick layout: each rank computes
    its frame's gradient with the sequential trainer's units
    (make_frame_grads_sb, the same per-rank peak memory as on one device),
    one Adam step a super-step on the weighted-mean gradient; the caller
    converts the schedule (overfit.dp_train_config: ``step_size`` / D), as
    in JAX.  epoch_fn(flat, opt, lr, k, shard_sb_gop(batch, group)); its
    losses are (T, D), the padding frames' included."""
    frame_grads = dp_frame_grads(make_frame_grads_sb(cfg, level_slices, compute_dtype), group)

    def epoch_fn(flat, opt, lr, sched_count, shard):
        return epoch_steps(frame_grads, tc, flat, opt, lr, sched_count, shard)

    return epoch_fn


def make_epoch_fn_dp(cfg: ModelConfig, tc: TrainConfig, group):
    """Frame-parallel epoch on the gather backend (float32, K10 in every
    rank): as make_epoch_fn_sb_dp with the gather trainer's frame gradient
    (the caller converts the schedule);
    epoch_fn(flat, opt, lr, k, shard_gop(batch_arrays(batch), group))."""
    frame_grads = dp_frame_grads(make_frame_grads(cfg), group)

    def epoch_fn(flat, opt, lr, sched_count, shard):
        return epoch_steps(frame_grads, tc, flat, opt, lr, sched_count, shard)

    return epoch_fn


def make_epoch_fn_parallel(backend: str, cfg: ModelConfig, tc: TrainConfig, pyramids: list,
                           group, dev, compute_dtype=None):
    """(epoch_fn, this rank's arrays) of a parallel backend on this rank's
    device: "sb_sp" and "sb_dp" in bf16 unless ``compute_dtype`` says
    otherwise, "dp" in float32; the frame-parallel ones with ``step_size``
    / D, as JAX's overfit_gop gives them."""
    if backend == "dp":
        arrays = batch_arrays(assemble_gop(pyramids, cfg.kernel_size, cfg.dilations, dev))
        return (make_epoch_fn_dp(cfg, dp_train_config(tc, group.size), group),
                shard_gop(arrays, group))
    dtype = compute_dtype or torch.bfloat16
    batch = assemble_gop_superbricks(pyramids, dev)
    if backend == "sb_sp":
        return make_epoch_fn_sb_sp(cfg, tc, batch.level_slices, group, dtype), batch
    if backend == "sb_dp":
        return (make_epoch_fn_sb_dp(cfg, dp_train_config(tc, group.size), batch.level_slices,
                                    group, dtype), shard_sb_gop(batch, group))
    raise ValueError(f"backend {backend!r} is not a parallel trainer")


# ------------------------------------------------------------ rank targets --


def train_gop_in_rank(world, job, log_file=None) -> str:
    """A rank of overfit_gop's parallel backends: the GOP's epoch loop
    (runtime/overfit.train_gop) with the whole world as its group; rank 0
    logs (stdout and the run's log file) and writes the artifacts."""
    from .launch import rank_logger

    log = rank_logger(log_file).info if world.rank == 0 else (lambda msg: None)
    return train_gop(job, world.device, world, log)


def train_in_rank(world, runs: list) -> list:
    """A rank of ``train_parallel``: the runs one after another."""
    from ..ops.counters import launches

    out = []
    for run in runs:
        cfg, tc = run["cfg"], run["tc"]
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[run.get("dtype", "bf16")]
        epoch_fn, arrays = make_epoch_fn_parallel(run["backend"], cfg, tc, run["pyramids"],
                                                  world, world.device, dtype)
        flat = torch.as_tensor(np.asarray(run["flat"], np.float32), device=world.device)
        opt, lr, k = adam_init(flat), np.float32(tc.learning_rate), 0
        before = launches()
        losses = []
        for _ in range(run["epochs"]):
            flat, opt, lr, k, ls = epoch_fn(flat, opt, lr, k, arrays)
            losses.append(ls.numpy())
        now = launches()
        counts = world.gather_rows(torch.tensor([float(now[key] - before[key]) for key in now]))
        out.append(dict(
            losses=losses, flat=flat.cpu().numpy(), m=opt["m"].cpu().numpy(),
            v=opt["v"].cpu().numpy(), t=opt["t"], lr=float(lr), k=k,
            identical=world.identical(flat), transport=world.transport,
            launches=[dict(zip(now, map(int, row.tolist()))) for row in counts],
        ))
    return out


def train_parallel(runs: list, devices: int, device=None, device_ids=None) -> list:
    """Train each run in one world of ``devices`` ranks (one spawn for all
    of them), each from its own start.  A run is dict(backend ("sb_sp",
    "sb_dp" or "dp"), cfg, tc, pyramids, flat (the initial parameters,
    numpy), epochs, dtype ("bf16" or "f32"; "dp" is float32)), Adam from
    zero moments at ``tc.learning_rate``.  Returns per run rank 0's
    dict(losses (per epoch), flat, m, v, t, lr, k, identical (every rank
    ended with the same parameter bits), transport, launches (per rank,
    the run's kernel launches)).  Ranks are placed as overfit_gop places
    them (parallel/mesh.rank_devices)."""
    from .launch import launch
    from .mesh import rank_devices

    return launch(train_in_rank, rank_devices(devices, device, device_ids), (runs,))
