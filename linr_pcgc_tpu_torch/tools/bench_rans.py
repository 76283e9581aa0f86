"""The rANS coder's kernels and the decoder's stage tail, timed on the card,
and the codec's blob for one seeded GOP.

    PYTHONPATH=<root of a checkout> python <this file> [--reps N]

Measures the ``linr_pcgc_tpu_torch`` package that Python imports, so the
same file measures two checkouts of the repository in turn: run it by path
with PYTHONPATH set to each checkout's root (alternate them on one card,
as in A, B, B, A).  It prints one JSON line:

* ``k5_ms``, ``k6_ms``: K5 (``rans_encode_segment``) and K6
  (``rans_decode_segment``) on the smoke's level-0 segment, 1,572,864
  symbols (384 steps of 4096 lanes, the first 1,344,182 valid), seeded
  f16 probabilities skewed as the codec's: torch.profiler device time per
  call (every activity of ``--reps`` calls after a traced warm-up, over
  ``--reps``, the host idle for 20 ms around each step's calls);
  ``k5_call_ms``, ``k6_call_ms``: CUDA-event time per call over ``--reps``
  back-to-back calls, the median of five windows (the host's time when it
  is the slower side);
* ``tail_ms``, ``tail_dev_ms``: ``dev_codec._rans_dec_stage_scatter`` (the
  decoder's stage tail, called as the reference's signature has it) at the
  level-0 shapes of two 800k-point frames: host clock per call between
  synchronisations, the median over 3 x 8 stages, and the device time of
  the activities of those calls, per call;
* ``blob_sha256`` and ``bits``: the rANS blob of that GOP encoded with
  seeded weights (``init_params(8807)``, the default config, bf16): equal
  hashes mean byte-identical streams;
* the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule

TV, TOTAL = 384 * 4096, 1_344_182
N_POINTS, DEPTH, N_FRAMES, SCALE_NUM = 800_000, 10, 2, 7


def _segment(dev):
    """The smoke's seeded level-0 segment: (probs f16, bits, valid)."""
    rng = np.random.default_rng(5)
    p = rng.uniform(0.0, 1.0, TV)
    p = np.where(rng.uniform(size=TV) < 0.7, 0.02, p).astype(np.float16)
    v = np.arange(TV) < TOTAL
    b = np.where(v, rng.uniform(size=TV) < p.astype(np.float32), 0).astype(np.uint8)
    return tuple(torch.as_tensor(a).to(dev) for a in (p, b, v))


def _event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return float(np.median(out))


def _device_us(fn, reps: int, edge_s: float = 0.02, traces: int = 3) -> float:
    """Device microseconds of every activity ``reps`` calls of ``fn`` run,
    traced after a warm-up step of ``reps`` calls, with the host idle for
    ``edge_s`` around each step's calls (launches near a step's edges can
    go unrecorded, as in prof_probes); a trace that records no device
    activity is taken again, up to ``traces`` times in all."""
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                time.sleep(edge_s)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(edge_s)
                prof.step()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")
                 and not e.key.startswith("ProfilerStep"))
        if us > 0:
            return us
    raise RuntimeError("torch.profiler recorded no device time")


def time_kernels(dev, reps: int) -> dict:
    from linr_pcgc_tpu_torch.ops import rans

    p, b, v = _segment(dev)
    st0 = rans.rans_initial_states(dev)
    x, byts, mask = rans.rans_encode_segment(st0, p, b, v)
    lens, out = rans.rans_compact_emissions(byts, mask, 2 * byts.shape[0])
    payload = out[torch.arange(out.shape[1], device=dev)[None] < lens[:, None]]
    stream = torch.cat([payload, payload.new_zeros(1)])
    offs = torch.cumsum(lens, 0) - lens
    _, _, bits = rans.rans_decode_segment(x, offs, stream, p, v)
    if not torch.equal(bits, b):
        raise AssertionError("K6 does not decode K5's segment")
    k5 = lambda: rans.rans_encode_segment(st0, p, b, v)  # noqa: E731
    k6 = lambda: rans.rans_decode_segment(x, offs, stream, p, v)  # noqa: E731
    return dict(k5_ms=_device_us(k5, reps) / reps / 1e3, k6_ms=_device_us(k6, reps) / reps / 1e3,
                k5_call_ms=_event_ms(k5, reps), k6_call_ms=_event_ms(k6, reps),
                stream_bytes=int(stream.numel() - 1))


def gop(dev):
    """The serving GOP of the smoke: two seeded 800k-point frames."""
    from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud

    frames = [synthetic_cloud(N_POINTS, depth=DEPTH, seed=7, phase=0.08 * t)
              for t in range(N_FRAMES)]
    return [build_pyramid(p, SCALE_NUM, device=dev) for p in frames]


def time_tail(pyrs, dev) -> tuple[float, float]:
    """Host ms per stage-tail call at the GOP's level 0 (synchronised) and
    device ms per call."""
    from linr_pcgc_tpu_torch.ops import rans
    from linr_pcgc_tpu_torch.runtime import dev_codec as dc

    s_num = pyrs[0].scale_num
    shapes = dc._LevelShapes(s_num, [p.low_coords for p in pyrs])
    for s in range(s_num):
        shapes.set_counts(s, [p.levels[s].n for p in pyrs])
    shapes.set_top_coords(s_num - 2, [p.levels[s_num - 2].coords[: p.levels[s_num - 2].n]
                                      for p in pyrs])
    bv, cap, tv = shapes.buckets(0)
    counts = shapes.n_vox[0]
    base = np.zeros((len(pyrs), bv, 3), np.int32)
    for i, p in enumerate(pyrs):
        base[i, : p.levels[0].n] = p.levels[0].coords[: p.levels[0].n]
    coords, keys = dc._init_level(torch.as_tensor(base, device=dev), counts, bv)
    geo = dc._brickify_level(coords, keys, counts, 0, cap, tv)
    total = sum(counts)
    if tv != TV:
        raise AssertionError(f"the GOP's level-0 segment has {tv} symbols, not {TV}")
    p, b, _ = _segment(dev)
    x, byts, mask = rans.rans_encode_segment(rans.rans_initial_states(dev), p, b,
                                             torch.arange(tv, device=dev) < total)
    lens, out = rans.rans_compact_emissions(byts, mask, 2 * byts.shape[0])
    stream = torch.cat([out[torch.arange(out.shape[1], device=dev)[None] < lens[:, None]],
                        out.new_zeros(1)])
    offs = torch.cumsum(lens, 0) - lens
    f = len(pyrs)
    acc = torch.zeros((8, tv), dtype=torch.uint8, device=dev)
    occ = torch.zeros((f * cap, 8, 64), dtype=torch.uint8, device=dev)

    def tail(stage):
        dc._rans_dec_stage_scatter(x, offs, stream, p, geo["vox_fr"], geo["vox_j"], total,
                                   acc, occ, stage, geo["vox_brick"], geo["vox_slot"])

    times = []
    for rep in range(4):
        for stage in range(8):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tail(stage)
            torch.cuda.synchronize()
            if rep:  # the first pass warms up
                times.append((time.perf_counter() - t) * 1e3)
    if not torch.equal(acc[0], b):
        raise AssertionError("the stage tail does not decode the segment")
    return float(np.median(times)), _device_us(lambda: tail(0), 8) / 8 / 1e3


def encode_blob(pyrs, dev) -> tuple[str, int]:
    """sha256 and bits of the GOP's rANS blobs, seeded weights."""
    from linr_pcgc_tpu_torch.models import ModelConfig, init_params
    from linr_pcgc_tpu_torch.models.network import param_tree, params_to_flat, unflatten_params
    from linr_pcgc_tpu_torch.runtime import dev_codec as dc
    from linr_pcgc_tpu_torch.runtime.codec import codec_numerics

    cfg = ModelConfig(scale_num=SCALE_NUM)
    params = param_tree(unflatten_params(cfg, params_to_flat(init_params(8807, cfg)), dev))
    with codec_numerics():
        wire, bits = dc.encode_gop_streams_rans(params, cfg, pyrs, dev)
    h = hashlib.sha256()
    for blob in wire["rans"]:
        h.update(blob)
    return h.hexdigest(), int(bits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_rans: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import linr_pcgc_tpu_torch

    dev = torch.device("cuda")
    rec = dict(tree=os.path.dirname(os.path.dirname(os.path.abspath(
        linr_pcgc_tpu_torch.__file__))))
    rec.update(time_kernels(dev, args.reps))
    pyrs = gop(dev)
    rec["tail_ms"], rec["tail_dev_ms"] = time_tail(pyrs, dev)
    rec["blob_sha256"], rec["bits"] = encode_blob(pyrs, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    rec["card"] = smi.stdout.strip()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
