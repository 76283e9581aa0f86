"""Checkpoints in the JAX package's npz layout (linr_pcgc_tpu/runtime/
overfit.py save_checkpoint/load_checkpoint): flat params, Adam moments,
step, lr and metadata.  A checkpoint written by either package loads into
the other.  Training itself is ported in a later slice."""

from __future__ import annotations

import os

import numpy as np

from ..models.network import ModelConfig, params_to_flat, unflatten_params


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
    """-> (params, opt, meta) with tensors on ``device``."""
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

