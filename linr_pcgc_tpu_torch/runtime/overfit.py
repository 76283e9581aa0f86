"""Per-GOP overfitting and checkpoints.

Port of linr_pcgc_tpu/runtime/overfit.py for one device: the superbrick
trainer (runtime/sb_overfit.py) for the configurations its layout covers,
and the flat gather trainer here (``GopBatch``, ``assemble_gop``,
``make_epoch_fn``) for the others (``outstage`` other than 8, dilated
blocks, ``kernel_size`` other than 3), dispatched as JAX dispatches them.
Optimization semantics are the JAX package's, themselves the reference's:

  * Adam(lr, betas (0.9, 0.999), eps 1e-8) with coupled weight decay
    (gradient += wd * param) and torch's bias correction;
  * loss per frame = sum BCE bits / point_num; one optimizer step per
    frame; StepLR: lr *= gamma every ``step_size`` frame steps; the min_lr
    clamp once per epoch, after the frame loop;
  * warm start: a later GOP loads GOP 0's params, Adam state (m, v, step
    count) and final lr; the schedule counter restarts per GOP.

Checkpoints are the JAX package's npz layout (flat params, Adam moments,
step, lr and metadata): a checkpoint written by either package loads into
the other.  Training is not bit-deterministic and does not run under
``device.codec_numerics``; the codec stays deterministic because encoder
and decoder share the checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..data.dataset import FramePyramid, bucket_size, level_arrays_from_coords
from ..device import resolve_device
from ..models.network import (
    ModelConfig,
    flatten_params,
    init_params,
    param_tree,
    params_to_flat,
    training_bits,
    unflatten_params,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyper-parameters; defaults mirror the reference CLI."""

    learning_rate: float = 0.01
    gamma: float = 0.992
    min_lr: float = 4e-4
    weight_decay: float = 1e-4
    step_size: int = 32
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


# ------------------------------------------------------------ optimizer --


def adam_init(flat: torch.Tensor) -> dict:
    return {"m": torch.zeros_like(flat), "v": torch.zeros_like(flat), "t": 0}


def adam_frame_update(flat: torch.Tensor, opt: dict, lr, grads: torch.Tensor, tc: TrainConfig):
    """One torch-semantics Adam step on the flat float32 parameter vector:
    coupled weight decay, bias-corrected moments, eps outside the square
    root, every factor in float32 as in the JAX update.  Returns new
    tensors (the inputs are left as they are)."""
    g = grads + tc.weight_decay * flat
    t = int(opt["t"]) + 1
    m = tc.beta1 * opt["m"] + (1 - tc.beta1) * g
    v = tc.beta2 * opt["v"] + (1 - tc.beta2) * g * g
    tf = torch.tensor(float(t), dtype=torch.float32)
    bc1 = (1.0 - torch.tensor(tc.beta1, dtype=torch.float32) ** tf).to(flat.device)
    bc2 = (1.0 - torch.tensor(tc.beta2, dtype=torch.float32) ** tf).to(flat.device)
    lr_t = torch.tensor(np.float32(lr), dtype=torch.float32, device=flat.device)
    new = flat - lr_t * (m / bc1) / (torch.sqrt(v / bc2) + tc.eps)
    return new, {"m": m, "v": v, "t": t}


def epoch_steps(frame_grads, tc: TrainConfig, flat, opt, lr, sched_count, frames):
    """One epoch of the sequential trainer: per frame (``frames`` yields
    each frame's data) ``frame_grads(flat, fd) -> (loss, flat gradient)``,
    one Adam step and one StepLR step (lr *= gamma every ``step_size``
    frame steps); the min_lr clamp after the epoch.  Returns (flat, opt,
    lr, sched_count, per-frame losses (F,) float32 on the CPU); ``lr`` is a
    numpy float32, ``opt`` {"m", "v": flat tensors, "t": int}."""
    losses = []
    k = sched_count
    lr = np.float32(lr)
    for fd in frames:
        loss, grads = frame_grads(flat, fd)
        flat, opt = adam_frame_update(flat, opt, lr, grads, tc)
        k += 1
        if k % tc.step_size == 0:
            lr = np.float32(lr * np.float32(tc.gamma))
        losses.append(loss)
    lr = max(lr, np.float32(tc.min_lr))
    return flat, opt, lr, k, torch.stack(losses).cpu()


# ------------------------------------------------------ the gather trainer --


@dataclasses.dataclass
class GopBatch:
    """Flat node arrays of a GOP stacked over frames (leading axis), as in
    JAX: every frame's levels padded to buckets shared by the frames."""

    scale_id: torch.Tensor   # (F, N) int32
    feat_code: torch.Tensor  # (F, N) int32
    nbr27: torch.Tensor      # (F, K, N) int32 flat-global map, -1 absent
    occ: torch.Tensor        # (F, 8, N) uint8 feature-major
    mask: torch.Tensor       # (F, N) bool
    point_num: torch.Tensor  # (F,) float32
    level_buckets: list      # per-level bucket sizes
    level_offsets: list      # start of each level on the flat axis


def assemble_gop(pyramids: list[FramePyramid], kernel_size: int = 3,
                 dilations: tuple = (1,), device=None) -> GopBatch:
    """Pad every frame's levels to shared buckets and build the flat,
    stacked training batch on ``device`` (the card unless the caller asks
    for the CPU); the neighbour maps are built there, per-dilation maps
    stacked along K."""
    dev = resolve_device(device)
    s_num = pyramids[0].scale_num
    if any(p.scale_num != s_num for p in pyramids):
        raise ValueError("frames disagree on scale_num")
    level_buckets = [bucket_size(max(p.levels[s].n for p in pyramids)) for s in range(s_num)]
    level_offsets = [int(v) for v in np.cumsum([0] + level_buckets[:-1])]
    n_flat = int(sum(level_buckets))

    f_scale, f_code, f_nbr, f_occ, f_mask = [], [], [], [], []
    for pyr in pyramids:
        parts_nbr = []
        scale_id = np.zeros(n_flat, np.int32)
        code = np.zeros(n_flat, np.int32)
        occ = np.zeros((n_flat, 8), np.uint8)
        mask = np.zeros(n_flat, bool)
        for s, lev in enumerate(pyr.levels):
            b, off = level_buckets[s], level_offsets[s]
            coords = np.zeros((b, 3), np.int32)
            coords[: lev.n] = lev.coords[: lev.n]
            nbr = level_arrays_from_coords(coords, lev.n, kernel_size, dilations, dev)[3]
            parts_nbr.append(torch.where(nbr >= 0, nbr + off, -1).T.int())
            scale_id[off: off + b] = s
            code[off: off + lev.n] = lev.feat_code[: lev.n]
            occ[off: off + lev.n] = lev.occ[: lev.n]
            mask[off: off + lev.n] = True
        f_nbr.append(torch.cat(parts_nbr, dim=1))
        f_scale.append(scale_id)
        f_code.append(code)
        f_occ.append(occ)
        f_mask.append(mask)

    return GopBatch(
        scale_id=torch.as_tensor(np.stack(f_scale), device=dev),
        feat_code=torch.as_tensor(np.stack(f_code), device=dev),
        nbr27=torch.stack(f_nbr),
        occ=torch.as_tensor(np.ascontiguousarray(np.stack(f_occ).transpose(0, 2, 1)), device=dev),
        mask=torch.as_tensor(np.stack(f_mask), device=dev),
        point_num=torch.as_tensor(np.array([p.point_num for p in pyramids], np.float32),
                                  device=dev),
        level_buckets=level_buckets,
        level_offsets=level_offsets,
    )


def batch_arrays(batch: GopBatch) -> dict:
    return dict(scale_id=batch.scale_id, feat_code=batch.feat_code, nbr27=batch.nbr27,
                occ=batch.occ, mask=batch.mask, point_num=batch.point_num)


def frame_loss(params, cfg: ModelConfig, fd: dict):
    """Bits per point of one frame (float32 on the frame's device)."""
    bits = training_bits(params, cfg, fd["scale_id"], fd["feat_code"], fd["nbr27"],
                         fd["occ"].float(), fd["mask"])
    return bits / fd["point_num"]


def make_frame_grads(cfg: ModelConfig):
    """The gather trainer's (flat params, frame data) -> (loss, flat
    gradient) of one frame, float32: one backward of the whole frame.  The
    frame's graph lives until its backward; K10's autograd Function keeps
    no gathered tensor, so nothing is recomputed."""

    def frame_grads(flat, fd):
        leaf = flat.detach().requires_grad_()
        loss = frame_loss(param_tree(unflatten_params(cfg, leaf, flat.device)), cfg, fd)
        loss.backward()
        return loss.detach(), leaf.grad

    return frame_grads


def make_epoch_fn(cfg: ModelConfig, tc: TrainConfig):
    """The gather trainer in float32: epoch_fn(flat, opt, lr, sched_count,
    batch_arrays(batch)), one gradient of the whole frame and one Adam step
    per frame (epoch_steps)."""
    frame_grads = make_frame_grads(cfg)

    def epoch_fn(flat, opt, lr, sched_count, arrays: dict):
        return epoch_steps(frame_grads, tc, flat, opt, lr, sched_count, gather_frames(arrays))

    return epoch_fn


def gather_frames(arrays: dict):
    """The frames of batch_arrays(batch) one by one."""
    return ({k: a[i] for k, a in arrays.items()} for i in range(arrays["point_num"].shape[0]))


# ----------------------------------------------------------- checkpoints --


def save_checkpoint(path: str, params: dict, opt: dict | None, lr: float,
                    epoch: int, loss: float, bitdepth: int) -> None:
    """``opt`` is {"m": params-like, "v": params-like, "t": int}; None
    stores zero moments (a fresh optimizer)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = params_to_flat(params)
    if opt is None:
        m = v = np.zeros_like(flat)
        t = 0
    else:
        m, v, t = params_to_flat(opt["m"]), params_to_flat(opt["v"]), int(opt["t"])
    payload = {
        "params": flat,
        "m": m,
        "v": v,
        "t": np.int64(t),
        "lr": np.float64(lr),
        "epoch": np.int64(epoch),
        "loss": np.float64(loss),
        "bitdepth": np.int64(bitdepth),
    }
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, cfg: ModelConfig, device="cpu"):
    """-> (params, opt, meta) with tensors on ``device``.

    Unlike the entry points, this defaults to the host on purpose: the
    encoder hands the loaded parameters to the weight codec, which
    quantizes and entropy-codes them on the host, and puts only the
    dequantized weights on the card."""
    with np.load(path) as z:
        params = unflatten_params(cfg, z["params"], device)
        opt = {
            "m": unflatten_params(cfg, z["m"], device),
            "v": unflatten_params(cfg, z["v"], device),
            "t": int(z["t"]),
        }
        meta = {
            "lr": float(z["lr"]),
            "epoch": int(z["epoch"]),
            "loss": float(z["loss"]),
            "bitdepth": int(z["bitdepth"]),
        }
    return params, opt, meta


def _save_flat(path, cfg, flat, opt, lr, epoch, loss, bitdepth):
    save_checkpoint(path, unflatten_params(cfg, flat.detach()),
                    {"m": unflatten_params(cfg, opt["m"]), "v": unflatten_params(cfg, opt["v"]),
                     "t": opt["t"]}, float(lr), epoch, loss, bitdepth)


def _load_flat(path, cfg, device):
    params, opt, meta = load_checkpoint(path, cfg, device)
    return (flatten_params(params),
            {"m": flatten_params(opt["m"]), "v": flatten_params(opt["v"]), "t": opt["t"]}, meta)


# ---------------------------------------------------------- GOP overfit --

# The trainers that run in a world of ranks (parallel/train.py): stage-
# parallel on the brick layout, and frame data-parallel on the brick layout
# and on the gather backend.
PARALLEL_BACKENDS = ("sb_sp", "sb_dp", "dp")


def select_backend(cfg: ModelConfig, backend: str = "auto", devices: int = 1) -> str:
    """The trainer of a GOP, as the JAX ``overfit_gop`` chooses it.  On one
    device "auto" is "sb" where the superbrick layout covers the
    configuration (``codec._use_sb``), else "gather".  On ``devices`` > 1
    the layout's configurations train stage-parallel ("sb_sp", the exact
    sequential semantics) when ``devices`` divides ``outstage``, else
    frame-DP on the layout ("sb_dp"); every other configuration, and any
    other backend asked for but "sb_dp", trains frame-DP on the gather
    backend ("dp")."""
    from .codec import _use_sb

    known = ("auto", "sb", "gather") + PARALLEL_BACKENDS
    if backend not in known:
        raise ValueError(f"backend {backend!r}: the port trains with one of {known}")
    if devices > 1:
        if _use_sb(cfg) and backend in ("auto", "sb", "sb_sp"):
            return "sb_sp" if cfg.outstage % devices == 0 else "sb_dp"
        return "sb_dp" if backend == "sb_dp" else "dp"
    if backend == "auto":
        return "sb" if _use_sb(cfg) else "gather"
    return backend


def dp_train_config(tc: TrainConfig, n_devices: int) -> TrainConfig:
    """Schedule conversion for frame-parallel training: one optimizer step
    covers D frames, so ``step_size`` shrinks by D to keep the reference's
    decay-per-frames-seen cadence."""
    return dataclasses.replace(tc, step_size=max(1, round(tc.step_size / n_devices)))


@dataclasses.dataclass
class GopJob:
    """What the training of one GOP needs, picklable for the ranks of a
    parallel backend: the frames' pyramids, the flags of overfit_gop, the
    trainer (``select_backend``) and the base layer's bytes."""

    pyramids: list
    group_range: list
    epoch_num: int
    cfg: ModelConfig
    tc: TrainConfig
    result_dir: str
    backend: str
    low_bytes: bytes
    warm_start_path: str | None = None
    seed: int = 8807
    bitdepth: int = 8
    mid_test: bool = False
    check_freq: int = 5
    write_pth: bool = True
    write_real_bitstream: bool = False
    resume: bool = False

    @property
    def gop_dir(self) -> str:
        return os.path.join(self.result_dir, f"gop_{self.group_range[0]}_{self.group_range[-1]}")

    @property
    def model_path(self) -> str:
        return os.path.join(self.gop_dir, "model.npz")


def gop_low_bytes(pyramids, gop_dir: str, handle_dir: str | None) -> bytes:
    """The GOP's base layer, read from ``<handle_dir or gop dir>/<gop
    dir's name>_xyzlow.bin`` when it is there, else coded and written
    there."""
    from .codec import encode_low_all_frames

    buffer_dir = handle_dir or gop_dir
    os.makedirs(buffer_dir, exist_ok=True)
    path = os.path.join(buffer_dir, f"{os.path.basename(gop_dir)}_xyzlow.bin")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    low_bytes = encode_low_all_frames(pyramids)
    with open(path, "wb") as f:
        f.write(low_bytes)
    return low_bytes


def overfit_gop(
    dataset,
    group_range,
    epoch_num: int,
    cfg: ModelConfig,
    tc: TrainConfig,
    result_dir: str,
    warm_start_path: str | None = None,
    seed: int = 8807,
    bitdepth: int = 8,
    mid_test: bool = False,
    check_freq: int = 5,
    write_pth: bool = True,
    write_real_bitstream: bool = False,
    handle_dir: str | None = None,
    resume: bool = False,
    device=None,
    logger=None,
    backend: str = "auto",
    devices: int = 1,
    device_ids=None,
) -> str:
    """Overfit one GOP; returns the checkpoint path
    ``<result_dir>/gop_<a>_<b>/model.npz``.

    On one device: with the superbrick trainer in bf16 where its layout
    covers the configuration (``codec._use_sb``), else with the gather
    trainer in f32.  On ``devices`` > 1, or with a parallel ``backend``,
    in a world of that many ranks (parallel/), the trainer chosen as JAX
    chooses it (``select_backend``): rank r on ``cuda:r`` (or
    ``cuda:device_ids[r]``; more ranks than cards raises), or every rank
    on the CPU where ``device`` says so.

    Writes what the JAX version writes: the checkpoint of the best epoch
    (whenever the epoch's mean loss improves and ``write_pth``; the last
    epoch's if none was written), ``result.json`` with one entry per epoch
    (on a card also the epoch's peak device memory, ``peak_mem_bytes``; in
    a world of ranks also the trainer, the rank count, the transport and
    each rank's kernel launches so far) and the base layer ``<handle_dir
    or gop dir>/gop_<a>_<b>_xyzlow.bin`` (read back when it is there).
    Rank 0 writes them.

    ``mid_test`` runs runtime/evaluate.test_one_gop (a real encode and
    lossless decode on the AC wire) at every epoch below 10 and every
    ``check_freq``-th, into ``<gop
    dir>/<epoch>/``, after saving that epoch's checkpoint, and adds its
    rates and times to the epoch's entry (in a world of ranks on rank 0,
    while the others wait); with ``write_real_bitstream`` every 50th
    epoch's test also writes its bitstream.

    ``resume`` continues from the GOP's own checkpoint (params, Adam state,
    lr, epoch); otherwise ``warm_start_path`` loads params, Adam state and
    lr.  Fresh weights come from the port's ``init_params(seed)``, whose
    torch generator draws other numbers than the JAX package's from the
    same seed.  Runs on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    log = logger.info if logger is not None else print
    pyramids = [dataset[i] for i in group_range]
    gop_dir = os.path.join(result_dir, f"gop_{group_range[0]}_{group_range[-1]}")
    os.makedirs(gop_dir, exist_ok=True)
    job = GopJob(
        pyramids=pyramids, group_range=list(group_range), epoch_num=epoch_num, cfg=cfg, tc=tc,
        result_dir=result_dir, backend=select_backend(cfg, backend, devices),
        low_bytes=gop_low_bytes(pyramids, gop_dir, handle_dir),
        warm_start_path=warm_start_path, seed=seed, bitdepth=bitdepth, mid_test=mid_test,
        check_freq=check_freq, write_pth=write_pth, write_real_bitstream=write_real_bitstream,
        resume=resume,
    )
    if job.backend not in PARALLEL_BACKENDS:
        return train_gop(job, dev, log=log)
    from ..parallel.launch import launch, log_file_of
    from ..parallel.mesh import rank_devices
    from ..parallel.train import train_gop_in_rank

    return launch(train_gop_in_rank, rank_devices(devices, dev, device_ids),
                  (job, log_file_of(logger)))


def train_gop(job: GopJob, dev, group=None, log=print) -> str:
    """The epoch loop of overfit_gop, on this process's device ``dev``:
    alone (``group`` None), or as one rank of ``group``
    (parallel/mesh.Group), which trains with the job's parallel backend;
    its rank 0 writes the artifacts and runs the mid-test while the others
    wait.  Returns the checkpoint path."""
    from .evaluate import test_one_gop
    from .sb_overfit import assemble_gop_superbricks, make_epoch_fn_sb

    cfg, tc = job.cfg, job.tc
    writer = group is None or group.rank == 0
    gop_size = len(job.pyramids)
    point_total = sum(p.point_num for p in job.pyramids)
    xyzlow_bpp = len(job.low_bytes) / point_total
    model_path = job.model_path

    if job.backend == "sb":
        arrays = assemble_gop_superbricks(job.pyramids, dev)
        epoch_fn = make_epoch_fn_sb(cfg, tc, arrays.level_slices, compute_dtype=torch.bfloat16)
    elif job.backend == "gather":
        arrays = batch_arrays(assemble_gop(job.pyramids, cfg.kernel_size, cfg.dilations, dev))
        epoch_fn = make_epoch_fn(cfg, tc)
    else:
        from ..parallel.train import make_epoch_fn_parallel

        epoch_fn, arrays = make_epoch_fn_parallel(job.backend, cfg, tc, job.pyramids, group, dev)

    flat = flatten_params(init_params(job.seed, cfg, dev))
    opt = adam_init(flat)
    lr = tc.learning_rate
    start_epoch = 0
    if job.resume and os.path.isfile(model_path):
        flat, opt, meta = _load_flat(model_path, cfg, dev)
        lr = meta["lr"]
        start_epoch = meta["epoch"] + 1
        log(f"resume {model_path} at epoch {start_epoch} (lr={lr:.6f})")
    elif job.warm_start_path is not None and os.path.isfile(job.warm_start_path):
        flat, opt, meta = _load_flat(job.warm_start_path, cfg, dev)
        lr = meta["lr"]
        log(f"warm start from {job.warm_start_path} (lr={lr:.6f})")
    lr = np.float32(lr)
    sched_count = 0

    best_loss = float("inf")
    results = []
    train_time = 0.0
    loss_mean = float("nan")
    if start_epoch >= job.epoch_num:
        return model_path
    for epoch in range(start_epoch, job.epoch_num):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        st = time.perf_counter()
        flat, opt, lr, sched_count, losses = epoch_fn(flat, opt, lr, sched_count, arrays)
        train_time += time.perf_counter() - st
        loss_mean = float(losses.reshape(-1)[:gop_size].mean())  # frame-DP pads the last step
        log(f"epoch: {epoch}")
        log(f"loss: {loss_mean}")
        log(f"train_time: {train_time}")
        log(f"train_time_avg: {train_time / gop_size}")
        entry = {
            "epoch": epoch,
            "loss": loss_mean,
            "train_time": train_time,
            "train_time_avg": train_time / gop_size,
        }
        if dev.type == "cuda":
            entry["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        if group is not None:
            from ..ops.counters import launches

            counts = launches()
            rows = group.gather_rows(torch.tensor([float(v) for v in counts.values()]))
            entry.update(backend=job.backend, devices=group.size, transport=group.transport,
                         rank_launches=[dict(zip(counts, map(int, r.tolist()))) for r in rows])
        # the reference mid-tests every epoch below 10 and every check_freq-th
        if job.mid_test and (epoch < 10 or epoch % job.check_freq == 0):
            if writer:
                _save_flat(model_path, cfg, flat, opt, lr, epoch, best_loss, job.bitdepth)
                test_out = test_one_gop(
                    model_path=model_path, cfg=cfg, pyramids=job.pyramids,
                    result_dir=os.path.join(job.gop_dir, str(epoch)),
                    write_flag=job.write_real_bitstream and epoch % 50 == 0,
                    low_bytes=job.low_bytes, device=dev,
                )
                entry.update(
                    real_bpp_all=test_out["bpp_all"],
                    real_point_bpp=test_out["point_bpp"],
                    point_bpp_val=test_out["point_bpp_val"],
                    model_bpp=test_out["model_bpp"],
                    xyzlow_bpp=xyzlow_bpp,
                    enc_time=test_out["enc_time"],
                    dec_time=test_out["dec_time"],
                    enc_mode=test_out["enc_mode"],
                    model_bitdepth_final=job.bitdepth,
                )
                for k in ("real_bpp_all", "real_point_bpp", "model_bpp", "enc_time", "dec_time"):
                    log(f"{k}: {entry[k]}")
            if group is not None:
                group.barrier()
        elif loss_mean < best_loss and job.write_pth:
            best_loss = loss_mean
            if writer:
                _save_flat(model_path, cfg, flat, opt, lr, epoch, best_loss, job.bitdepth)
        results.append(entry)
        if writer:
            with open(os.path.join(job.gop_dir, "result.json"), "w") as f:
                json.dump(results, f, indent=4)

    if writer:
        if loss_mean < best_loss and job.write_pth:
            best_loss = loss_mean
            _save_flat(model_path, cfg, flat, opt, lr, job.epoch_num - 1, best_loss, job.bitdepth)
        if not os.path.exists(model_path):
            _save_flat(model_path, cfg, flat, opt, lr, job.epoch_num - 1, loss_mean, job.bitdepth)
    if group is not None:
        group.barrier()  # the checkpoint is on disk before any rank returns
    return model_path
