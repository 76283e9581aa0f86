"""Where a training epoch's peak device memory goes, for one checkout.

    python linr_pcgc_tpu_torch/tools/trace_memory.py [--tree DIR] [--backend sb|gather]

Imports ``linr_pcgc_tpu_torch`` from ``--tree`` (default: this checkout),
builds the smoke's first two training frames (``synthetic_cloud(800_000,
depth=10, seed=7, phase=0.08 t)``), trains one untimed epoch from
``init_params(8807)`` (the superbrick trainer in bf16 at the default
config, or the gather trainer at ``--outstage 4``), then records the
allocator's history (``torch.cuda.memory._record_memory_history``, Python
stacks) over one more epoch.  Replaying the trace finds the moment the
epoch's own allocations peak; the blocks live then are grouped by the
innermost frame of the package that allocated them (file, line,
function), the largest groups printed with their bytes.  The last line is
one JSON object: the epoch's ``max_memory_allocated``, the traced peak
above the epoch's start, and the groups.  Two checkouts (a change and its
parent) compare group by group.  Without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict


def _site(frames, pkg_root: str) -> str:
    """The innermost frame in the package, as 'file:line function'."""
    for f in frames:
        name = f.get("filename", "")
        if name.startswith(pkg_root) and "tools" not in os.path.relpath(name, pkg_root).split(os.sep):
            return f"{os.path.relpath(name, pkg_root)}:{f.get('line')} {f.get('name')}"
    return "(outside the package)"


def peak_groups(trace, pkg_root: str, top: int = 15):
    """Replays an allocator trace: the peak of the bytes allocated within
    it, and the blocks live then grouped by allocation site."""
    cur = peak = 0
    peak_at = -1
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            cur += ev["size"]
            if cur > peak:
                peak, peak_at = cur, i
        elif ev["action"] == "free_completed":
            cur -= ev["size"]
    live = {}
    for ev in trace[: peak_at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
    groups = defaultdict(lambda: [0, 0])
    for ev in live.values():
        g = groups[_site(ev.get("frames", []), pkg_root)]
        g[0] += ev["size"]
        g[1] += 1
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][0])[:top]
    return peak, [{"site": k, "bytes": v[0], "blocks": v[1]} for k, v in ranked]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None, help="checkout whose package is traced")
    ap.add_argument("--backend", choices=["sb", "gather"], default="sb")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.tree or here))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("trace_memory traces the card: torch.cuda.is_available() is False")
    import linr_pcgc_tpu_torch as pkg
    from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud
    from linr_pcgc_tpu_torch.models import ModelConfig, flatten_params, init_params
    from linr_pcgc_tpu_torch.runtime import TrainConfig, adam_init, overfit, sb_overfit

    dev = torch.device("cuda")
    pkg_root = os.path.dirname(os.path.abspath(pkg.__file__))
    pyrs = [build_pyramid(synthetic_cloud(800_000, depth=10, seed=7, phase=0.08 * t), 7,
                          device=dev) for t in range(2)]
    if args.backend == "sb":
        cfg = ModelConfig(scale_num=7)
        batch = sb_overfit.assemble_gop_superbricks(pyrs, dev)
        epoch_fn = sb_overfit.make_epoch_fn_sb(cfg, TrainConfig(), batch.level_slices)
    else:
        cfg = ModelConfig(scale_num=7, outstage=4)
        batch = overfit.batch_arrays(overfit.assemble_gop(pyrs, cfg.kernel_size, cfg.dilations, dev))
        epoch_fn = overfit.make_epoch_fn(cfg, TrainConfig())
    flat = flatten_params(init_params(8807, cfg, dev))
    state = (flat, adam_init(flat), np.float32(0.01), 0)
    state = epoch_fn(*state, batch)[:4]  # untimed: first calls, allocations
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
    epoch_fn(*state, batch)
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    max_alloc = torch.cuda.max_memory_allocated(dev)
    trace = snap["device_traces"][dev.index or 0]
    peak, groups = peak_groups(trace, pkg_root)
    print(f"{args.backend} epoch of 2 frames ({pkg_root}): max_memory_allocated "
          f"{max_alloc / 2**30:.3f} GiB, {base / 2**30:.3f} GiB live at its start, traced peak "
          f"{peak / 2**30:.3f} GiB above it; live then, by allocation site:", flush=True)
    for g in groups:
        print(f"  {g['bytes'] / 2**30:8.3f} GiB {g['blocks']:6d} blocks  {g['site']}", flush=True)
    out = {"tree": os.path.dirname(pkg_root), "backend": args.backend,
           "device": torch.cuda.get_device_name(0), "max_allocated": max_alloc, "base": base,
           "traced_peak": peak, "groups": groups}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
