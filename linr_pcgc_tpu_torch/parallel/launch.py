"""One process per rank: spawn, rendezvous, run, collect.

The JAX package is one process that drives D devices; the port runs one
process per device.  ``launch`` spawns the ranks (``torch.multiprocessing``
with the spawn method), lets them meet through a file rendezvous in a
fresh temporary directory, runs ``target(group, *args)`` in each, and
returns rank 0's result.  If any rank fails the launch fails: the parent
stops the other ranks and raises with the failing rank's traceback, and the
process group's timeout ends a collective that waits on a dead rank.

A spawned rank imports the module that defines its target, so every target
lives in this package (a target defined in a test module would import JAX
into every rank).  Arguments and results travel pickled.
"""

from __future__ import annotations

import datetime
import logging
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import Group, transport

# Seconds a collective may wait for the other ranks before it fails.
COLLECTIVE_TIMEOUT_S = 1800.0


def launch(target, devs: list, args: tuple = ()):
    """Run ``target(group, *args)`` on one spawned rank per entry of
    ``devs`` (parallel/mesh.rank_devices) and return rank 0's result.
    Ranks on the CPU share the parent's torch threads evenly; ranks on
    cards keep torch's default."""
    n = len(devs)
    threads = max(1, torch.get_num_threads() // n) if devs[0].type == "cpu" else None
    tport = transport(devs)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="linr_rdzv_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, devs, tport, init, threads, target, args, results))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        return _collect(procs, results)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


def _collect(procs, results):
    """Rank 0's result once every rank has reported; raises on the first
    failure (a rank's traceback, or a rank that died without one)."""
    n = len(procs)
    out, done = None, set()
    died_at = None
    while len(done) < n:
        try:
            rank, ok, payload = results.get(timeout=1.0)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in done]
            if dead:
                # give its traceback, if it wrote one, a moment to arrive
                died_at = died_at or time.monotonic()
                if time.monotonic() - died_at > 5.0:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{payload}")
        done.add(rank)
        if rank == 0:
            out = payload
    return out


def _rank_main(rank, devs, tport, init, threads, target, args, results):
    """A rank's process: join the group, run the target, report."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = devs[rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(tport, init_method=init, rank=rank, world_size=len(devs),
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        world = Group(rank, len(devs), dev, tport, tuple(range(len(devs))))
        out = target(world, *args)
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def rank_logger(log_file: str | None, prefix: str = ""):
    """A message logger for a rank: stdout (inherited from the parent) and,
    where given, the run's log file (appended)."""
    logger = logging.getLogger(f"linr_pcgc_tpu_torch.rank{prefix}")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    logger.propagate = False
    fmt = logging.Formatter(f"{prefix}%(message)s")
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file:
        handlers.append(logging.FileHandler(log_file, mode="a", encoding="utf-8"))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def log_file_of(logger) -> str | None:
    """The file a caller's logger writes to, for the ranks to append to."""
    for h in getattr(logger, "handlers", ()):
        if isinstance(h, logging.FileHandler):
            return h.baseFilename
    return None
