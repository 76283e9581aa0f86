"""GOP-parallel training: lanes of ranks each overfit a different GOP.

Port of linr_pcgc_tpu/parallel/gop_parallel.py.  The reference's warm
start (its main.py:98-104) makes every GOP after the first independent:
each loads GOP 0's checkpoint (model, Adam state, lr) and trains on its
own frames, so the warm GOPs train side by side with no collective between
them.  The world of ``lanes x sp`` ranks splits into lanes of ``sp``
consecutive ranks (parallel/mesh.Group.split, sp the minor axis as in
JAX); lane l trains GOP l with the sequential superbrick trainer (sp = 1)
or stage-parallel inside the lane (sp > 1, parallel/train's sb_sp over the
lane's group), through overfit_gop's own epoch loop, and the lane's rank 0
writes what overfit_gop writes: ``gop_*/model.npz``, ``result.json`` and
the base-layer cache.

JAX stacks the GOPs into one program and so assembles them with common
buckets (runtime/sb_overfit.assemble_gops_superbricks); a lane here is a
process of its own and assembles its GOP alone, with the buckets a single
GOP's training has, so a lane's run is the per-GOP sequential run.
"""

from __future__ import annotations

import os

from ..runtime.codec import _use_sb
from ..runtime.overfit import GopJob, gop_low_bytes, train_gop


def overfit_gops_parallel(dataset, group_ranges: list, epoch_num: int, cfg, tc,
                          result_dir: str, warm_start_path: str, bitdepth: int = 8,
                          handle_dir: str | None = None, sp_devices: int = 1, device=None,
                          device_ids=None, logger=None) -> list:
    """Overfit ``len(group_ranges)`` GOPs of equal size at once, each on a
    lane of ``sp_devices`` ranks, all warm-started from
    ``warm_start_path``; returns their checkpoint paths.  Ranks are placed
    as overfit_gop places them (parallel/mesh.rank_devices over
    ``len(group_ranges) * sp_devices`` ranks)."""
    from .launch import launch, log_file_of
    from .mesh import rank_devices

    log = logger.info if logger is not None else print
    if not _use_sb(cfg):
        raise ValueError("GOP-parallel training runs the superbrick trainer only")
    sizes = {len(g) for g in group_ranges}
    if len(sizes) != 1:
        raise ValueError(f"GOP-parallel training needs equal GOP sizes, got {sizes}: train the "
                         "ragged tail sequentially")
    jobs = []
    for gr in group_ranges:
        pyramids = [dataset[i] for i in gr]
        gop_dir = os.path.join(result_dir, f"gop_{gr[0]}_{gr[-1]}")
        os.makedirs(gop_dir, exist_ok=True)
        jobs.append(GopJob(pyramids=pyramids, group_range=list(gr), epoch_num=epoch_num, cfg=cfg,
                           tc=tc, result_dir=result_dir,
                           backend="sb_sp" if sp_devices > 1 else "sb",
                           low_bytes=gop_low_bytes(pyramids, gop_dir, handle_dir),
                           warm_start_path=warm_start_path, bitdepth=bitdepth))
    d = len(jobs) * sp_devices
    log(f"gop-parallel: {len(jobs)} GOPs x {len(group_ranges[0])} frames"
        + (f" x {sp_devices}-way sp" if sp_devices > 1 else "")
        + f" on {d} ranks, warm from {warm_start_path}")
    launch(train_lanes_in_rank, rank_devices(d, device, device_ids),
           (jobs, sp_devices, log_file_of(logger)))
    return [job.model_path for job in jobs]


def train_lanes_in_rank(world, jobs: list, sp: int, log_file=None) -> None:
    """A rank of overfit_gops_parallel: train its lane's GOP; the lane's
    rank 0 logs (prefixed with the GOP) and writes the artifacts."""
    from .launch import rank_logger

    lane, group = world.split(sp)
    job = jobs[lane]
    name = os.path.basename(job.gop_dir)
    log = rank_logger(log_file, f"{name}: ").info if group.rank == 0 else (lambda msg: None)
    train_gop(job, world.device, group, log)
