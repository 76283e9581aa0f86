"""Per-GOP overfitting and checkpoints.

Port of linr_pcgc_tpu/runtime/overfit.py for one device and the superbrick
trainer (runtime/sb_overfit.py).  Optimization semantics are the JAX
package's, themselves the reference's:

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

from ..device import resolve_device
from ..models.network import (
    ModelConfig,
    flatten_params,
    init_params,
    params_to_flat,
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
    write_pth: bool = True,
    handle_dir: str | None = None,
    resume: bool = False,
    device=None,
    logger=None,
) -> str:
    """Overfit one GOP on one device with the superbrick trainer in bf16;
    returns the checkpoint path ``<result_dir>/gop_<a>_<b>/model.npz``.

    Writes what the JAX version writes: the checkpoint of the best epoch
    (whenever the epoch's mean loss improves and ``write_pth``; the last
    epoch's if none was written), ``result.json`` with one entry per epoch
    (on a card also the epoch's peak device memory, ``peak_mem_bytes``) and
    the base layer ``<handle_dir or gop dir>/gop_<a>_<b>_xyzlow.bin``.

    ``resume`` continues from the GOP's own checkpoint (params, Adam state,
    lr, epoch); otherwise ``warm_start_path`` loads params, Adam state and
    lr.  Fresh weights come from the port's ``init_params(seed)``, whose
    torch generator draws other numbers than the JAX package's from the
    same seed.  Runs on the card unless ``device`` says otherwise."""
    from .codec import encode_low_all_frames
    from .sb_overfit import assemble_gop_superbricks, make_epoch_fn_sb

    if not (cfg.kernel_size == 3 and cfg.outstage == 8 and cfg.block_type != "dilation"):
        raise NotImplementedError(
            f"{cfg}: only kernel_size 3, outstage 8, non-dilation models train on the "
            "superbrick layout (the gather backend is not ported: ROADMAP A)")
    dev = resolve_device(device)
    log = logger.info if logger is not None else print
    gop_flag = f"gop_{group_range[0]}_{group_range[-1]}"
    gop_dir = os.path.join(result_dir, gop_flag)
    os.makedirs(gop_dir, exist_ok=True)
    model_path = os.path.join(gop_dir, "model.npz")

    pyramids = [dataset[i] for i in group_range]
    gop_size = len(pyramids)

    # base layer, reused from disk when present
    buffer_dir = handle_dir or gop_dir
    os.makedirs(buffer_dir, exist_ok=True)
    xyzlow_path = os.path.join(buffer_dir, f"{gop_flag}_xyzlow.bin")
    if not os.path.exists(xyzlow_path):
        with open(xyzlow_path, "wb") as f:
            f.write(encode_low_all_frames(pyramids))

    batch = assemble_gop_superbricks(pyramids, dev)
    epoch_fn = make_epoch_fn_sb(cfg, tc, batch.level_slices, compute_dtype=torch.bfloat16)

    flat = flatten_params(init_params(seed, cfg, dev))
    opt = adam_init(flat)
    lr = tc.learning_rate
    start_epoch = 0
    if resume and os.path.isfile(model_path):
        flat, opt, meta = _load_flat(model_path, cfg, dev)
        lr = meta["lr"]
        start_epoch = meta["epoch"] + 1
        log(f"resume {model_path} at epoch {start_epoch} (lr={lr:.6f})")
    elif warm_start_path is not None and os.path.isfile(warm_start_path):
        flat, opt, meta = _load_flat(warm_start_path, cfg, dev)
        lr = meta["lr"]
        log(f"warm start from {warm_start_path} (lr={lr:.6f})")
    lr = np.float32(lr)
    sched_count = 0

    best_loss = float("inf")
    results = []
    train_time = 0.0
    loss_mean = float("nan")
    if start_epoch >= epoch_num:
        return model_path
    for epoch in range(start_epoch, epoch_num):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        st = time.perf_counter()
        flat, opt, lr, sched_count, losses = epoch_fn(flat, opt, lr, sched_count, batch)
        train_time += time.perf_counter() - st
        loss_mean = float(losses.mean())
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
        if loss_mean < best_loss and write_pth:
            best_loss = loss_mean
            _save_flat(model_path, cfg, flat, opt, lr, epoch, best_loss, bitdepth)
        results.append(entry)
        with open(os.path.join(gop_dir, "result.json"), "w") as f:
            json.dump(results, f, indent=4)

    if not os.path.exists(model_path):
        _save_flat(model_path, cfg, flat, opt, lr, epoch_num - 1, loss_mean, bitdepth)
    return model_path
