"""One profiled training epoch on the card: device time by kernel, and the
matrix products by input shape.

    python -m linr_pcgc_tpu_torch.tools.prof_train [--backend sb|gather]
        [--frames 2] [--hidden_channel_conv 8]

Builds the smoke's training frames (``synthetic_cloud(800_000, depth=10,
seed=7, phase=0.08 t)``, as ``chip_smoke.py`` phase 5), trains one untimed
epoch from ``init_params(8807)`` (the superbrick trainer in bf16 at the
default config, or the gather trainer, f32, at ``--outstage 4``), then
times one epoch (host clock, synchronised, no profiler; its peak device
memory too), profiles the next
with ``torch.profiler`` (device busy time, top kernels by device time) and
the one after with ``record_shapes=True`` (the products, ``aten::bmm``,
``mm``, ``addmm``, ``einsum``, by input shape with the device time of the
kernels they launched; shapes cost host time, so that epoch is not
timed).  The idle share is 1 - busy / the unprofiled epoch's wall time.
The last line is one JSON object of these.  Without a card it
raises.  To profile another checkout of the package (the parent of a
change) with this tool: ``PYTHONPATH=<checkout> python
linr_pcgc_tpu_torch/tools/prof_train.py``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

PRODUCTS = ("aten::bmm", "aten::mm", "aten::addmm", "aten::einsum")


def _is_device(e) -> bool:
    return getattr(e, "device_type", None) is not None and str(e.device_type).endswith("CUDA")


def profile_epoch(pyrs, dev, cfg=None, top: int = 14, log=print) -> dict:
    """After an untimed epoch of ``pyrs``, one timed, one profiled and one
    traced with shapes: the superbrick trainer in bf16 at the default config
    (``cfg`` None), the gather trainer for ``cfg``.  Logs and returns wall,
    busy, idle share, the top kernels and the products by input shape."""
    from linr_pcgc_tpu_torch.models import ModelConfig, flatten_params, init_params
    from linr_pcgc_tpu_torch.runtime import TrainConfig, adam_init, overfit, sb_overfit

    scale_num = pyrs[0].scale_num
    if cfg is None:
        cfg = ModelConfig(scale_num=scale_num)
        batch = sb_overfit.assemble_gop_superbricks(pyrs, dev)
        epoch_fn = sb_overfit.make_epoch_fn_sb(cfg, TrainConfig(), batch.level_slices)
        units = str(epoch_fn.units)
    else:
        batch = overfit.batch_arrays(overfit.assemble_gop(pyrs, cfg.kernel_size, cfg.dilations, dev))
        epoch_fn = overfit.make_epoch_fn(cfg, TrainConfig())
        units = f"gather, outstage {cfg.outstage}, hidden_channel_conv {cfg.ch}"
    flat = flatten_params(init_params(8807, cfg, dev))
    state = (flat, adam_init(flat), np.float32(0.01), 0)
    state = epoch_fn(*state, batch)[:4]  # untimed: first calls, allocations
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev).add_(1)  # the profiler's own set-up, untimed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = epoch_fn(*state, batch)[:4]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state = epoch_fn(*state, batch)[:4]
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if _is_device(e)]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    log(f"profiled training epoch ({len(pyrs)} frames, units {units}): wall {wall:.3f} s (an "
        f"epoch without the profiler, peak device memory {peak / 2**30:.3f} GiB), device busy "
        f"{busy:.3f} s (idle share {max(0.0, 1 - busy / wall):.3f})")
    kernels = []
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  {e.count:7d} x  {e.key[:90]}")
        kernels.append({"name": e.key, "ms": e.self_device_time_total / 1e3, "count": e.count})
    k2 = [e for e in rows if "b4_halo_sm_kernel" in e.key]
    log(f"  K2 in the profiled epoch: {sum(e.self_device_time_total for e in k2) / 1e3:.3f} ms "
        f"over {sum(e.count for e in k2)} launches ({len(k2)} instances)")
    # the products by input shape, from one more epoch traced with shapes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        epoch_fn(*state, batch)
        torch.cuda.synchronize()
    products = []
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in PRODUCTS and e.device_time_total > 0:
            products.append({"op": e.key, "shapes": str(e.input_shapes), "count": e.count,
                             "ms": e.device_time_total / 1e3})
    products.sort(key=lambda p: -p["ms"])
    log("  products by input shape (device time of the kernels each launched):")
    for p in products[:top]:
        log(f"  {p['ms']:10.3f} ms  {p['count']:7d} x  {p['op']} {p['shapes'][:120]}")
    return {"wall_s": wall, "peak_bytes": peak, "busy_s": busy,
            "idle_share": max(0.0, 1 - busy / wall),
            "kernels": kernels, "products": products[:top], "units": units}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--backend", choices=["sb", "gather"], default="sb")
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--hidden_channel_conv", type=int, default=8)
    args = p.parse_args(argv)
    if args.backend == "sb" and args.hidden_channel_conv != 8:
        p.error("the superbrick profile runs the default config (hidden_channel_conv 8)")
    if not torch.cuda.is_available():
        raise RuntimeError("prof_train measures the card: torch.cuda.is_available() is False")
    from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud
    from linr_pcgc_tpu_torch.models import ModelConfig

    dev = torch.device("cuda")
    pyrs = [build_pyramid(synthetic_cloud(800_000, depth=10, seed=7, phase=0.08 * t), 7,
                          device=dev) for t in range(args.frames)]
    cfg = None if args.backend == "sb" else ModelConfig(
        scale_num=7, outstage=4, hidden_channel_conv=args.hidden_channel_conv)
    out = profile_epoch(pyrs, dev, cfg)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
