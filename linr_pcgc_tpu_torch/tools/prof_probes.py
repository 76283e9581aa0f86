"""The card's probes, the port of scripts/prof_pallas.py.

    python -m linr_pcgc_tpu_torch.tools.prof_probes

Runs the three probe kernels of ops/probes.py on the card, at the shapes of
the JAX script, and holds each against its plain PyTorch version: K7
(x * 2 + 1 on an (8, 128) block) and K9 (a (512, 256) row gather by
seeded indices) bit for bit, K8 (a 512^3 float32 product) to the JAX
probe's tolerance (rtol 2e-5, atol 2e-4) and bit-identical across two
runs.  Float32 products run in full float32 here (TF32 off), so the plain
version's ``torch.matmul`` tiles are a float32 reference.

K7 is traced beside an empty kernel (csrc/probes.cu ``probe_empty``, one
block, no work), launched in the same calls: its device time is K7's launch
floor, printed and kept as ``launch_ms``.

Prints the device, then one ``OK`` line per probe with the kernel's time,
its plain version's, the library call's (where one PyTorch call computes
the same function) and the bound (the larger of the bytes over the HBM
rate and the operations over the peak of the kernel's route: the float32
CUDA-core peak, or for K8's 3xTF32 its three products over the TF32
tensor-core peak, printed beside the float32 bound of one product).  At
the probes' sizes a call's wall time is the host's launch cost, so the times are device
times from torch.profiler (the device time of every kernel, copy and fill
of 50 calls, summed, over 50); the wall time of a call is printed beside
them, and under each line the kernel's device activity by name, with the
launches the profiler recorded.  K9's call must run one kernel and nothing
else (its index check is inside the kernel).  Then K9 once more at 65,536
rows of 256 float32, where its bytes rate can show.  Any failure raises,
so the module exits nonzero; without a card it raises too.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from ..device import resolve_device
from ..ops import probes

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s,
# float32 FLOP/s outside the tensor cores, TF32 tensor-core FLOP/s.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
MATMUL_RTOL, MATMUL_ATOL = 2e-5, 2e-4
REPS = 50
# Host idle time around each traced step's calls, and the traces taken
# before giving up on a whole one.  Without the idle time a short trace can
# lose some or all of its step's launches; tools/trace_edges.py counts how
# often, with and without it.
EDGE_S = 0.02
TRACES = 3


def cuda_ms(fn, reps: int = REPS) -> float:
    """Time per call of ``fn`` between two CUDA events around ``reps``
    back-to-back calls: the wall time of a call when the host, not the
    device, is the slower side."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _trace(fn, reps: int, edge_s: float = EDGE_S) -> list:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            time.sleep(edge_s)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(edge_s)
            prof.step()
    return [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA") and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]


def device_activity(fn, reps: int = REPS) -> list:
    """[(device activity name, launches recorded, us in all)] over ``reps``
    calls of ``fn``, from torch.profiler: every kernel, copy and fill the
    calls run on the card.  The calls are traced after a warm-up step of
    ``reps`` calls, in which the profiler already traces the card but keeps
    nothing, and each step holds the host idle for ``EDGE_S`` before and
    after its calls: launches near the edges of a step can go unrecorded.
    A call runs the same device work each time, so a whole trace records
    each activity a multiple of ``reps`` times; a trace that records none,
    or another count, is taken again, up to ``TRACES`` times in all.  The
    step's own span on the card's timeline is not an activity."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACES + 1):
        acts = _trace(fn, reps)
        if acts and all(n % reps == 0 for _, n, _ in acts):
            break
        print(f"  torch.profiler trace {attempt} of {TRACES} is not whole ("
              f"{activity_line(acts, reps) or 'no device activity'})", flush=True)
    return acts


def device_ms(fn, reps: int = REPS, acts=None) -> float:
    """Device time per call of ``fn``: the summed time of every activity
    its ``reps`` calls run on the card (``acts``, traced here if not
    given), over ``reps``."""
    acts = device_activity(fn, reps) if acts is None else acts
    busy_us = sum(us for _, _, us in acts)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return busy_us / reps / 1e3


def activity_line(acts, reps: int = REPS) -> str:
    return "; ".join(f"{name[:60]}: {n} launches in {reps} calls, {us / n:.2f} us each"
                     for name, n, us in acts)


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


@contextlib.contextmanager
def full_f32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _record(key, name, replaces, shape, kernel, plain, library, nbytes, flops, err,
            peak=F32_FLOPS, acts=None):
    b_ms, b_by = bound(nbytes, flops, peak)
    acts = device_activity(kernel) if acts is None else acts
    return dict(key=key, name=name, route="cuda", source="linr_pcgc_tpu_torch/csrc/probes.cu",
                replaces=replaces, shape=shape, ms=device_ms(kernel, acts=acts),
                call_ms=cuda_ms(kernel), plain_ms=device_ms(plain),
                library_ms=None if library is None else device_ms(library),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, acts=acts)


def split_launch_floor(acts):
    """A trace of K7's calls beside the empty yardstick's -> (K7's
    activities, the yardstick's)."""
    empty = [a for a in acts if "probe_empty" in a[0]]
    return [a for a in acts if "probe_empty" not in a[0]], empty


def probe_basic(dev) -> dict:
    """K7 on the JAX probe's (8, 128) arange block; exact.  Each traced call
    also launches the empty yardstick kernel, so that one trace gives K7's
    device time and its launch floor (``launch_ms``), the bound of a kernel
    this small: its bytes take a few nanoseconds."""
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    y = probes.probe_scale_shift(x)
    if not torch.equal(y, probes.probe_scale_shift_plain(x)):
        raise AssertionError("K7 probe_scale_shift differs from x * 2 + 1")

    def both():
        probes.probe_scale_shift(x)
        probes.probe_empty(dev)

    k7_acts, empty_acts = split_launch_floor(device_activity(both))
    rec = _record("K7", "probe_scale_shift", "scripts/prof_pallas.py:38", "(8, 128) f32",
                  lambda: probes.probe_scale_shift(x),
                  lambda: probes.probe_scale_shift_plain(x), None,
                  2 * 4 * x.numel(), 2 * x.numel(), 0.0, acts=k7_acts)
    rec["launch_ms"] = device_ms(None, acts=empty_acts)
    return rec


def probe_matmul_grid(dev) -> dict:
    """K8 on seeded 512^3 float32 operands; the JAX probe's tolerance, and
    the same bits in two runs.  Its bound is its route's: the three TF32
    products over the TF32 peak; the record also keeps the float32
    CUDA-core bound of one product (``bound_f32_ms``)."""
    m = k = n = 512
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=dev)
    b = torch.randn((k, n), generator=gen, device=dev)
    with full_f32_matmul():
        c = probes.probe_matmul(a, b)
        if not torch.equal(c, probes.probe_matmul(a, b)):
            raise AssertionError("K8 probe_matmul gives other bits in a second run")
        ref = probes.probe_matmul_plain(a, b)
        err = (c - ref).abs()
        if not bool(torch.isfinite(c).all()) or bool(
                (err > MATMUL_ATOL + MATMUL_RTOL * ref.abs()).any()):
            raise AssertionError(f"K8 probe_matmul differs from its plain version: max abs err "
                                 f"{err.max().item()}")
        nbytes = 4 * (m * k + k * n + m * n)
        rec = _record("K8", "probe_matmul", "scripts/prof_pallas.py:61", "512x512x512 f32",
                      lambda: probes.probe_matmul(a, b), lambda: probes.probe_matmul_plain(a, b),
                      lambda: torch.matmul(a, b), nbytes, 3 * 2 * m * k * n, err.max().item(),
                      peak=TF32_FLOPS)
        rec["bound_f32_ms"] = bound(nbytes, 2 * m * k * n)[0]
        return rec


def _gather_case(dev, rows, d, nb):
    idx = torch.as_tensor(np.random.default_rng(0).integers(0, rows, nb, dtype=np.int32), device=dev)
    x = torch.randn((rows, d), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    out = probes.probe_row_gather(x, idx)
    if not torch.equal(out, probes.probe_row_gather_plain(x, idx)):
        raise AssertionError(f"K9 probe_row_gather differs from x[idx] at {nb} rows of {d}")
    return x, idx


def probe_scalar_prefetch_gather(dev) -> dict:
    """K9 on a seeded (512, 256) float32 table and 512 seeded indices;
    exact.  Its calls must run one kernel on the card and nothing else
    (the index check is inside it)."""
    nb, d = 512, 256
    x, idx = _gather_case(dev, nb, d, nb)
    rec = _record("K9", "probe_row_gather", "scripts/prof_pallas.py:96", "(512, 256) f32, 512 rows",
                  lambda: probes.probe_row_gather(x, idx),
                  lambda: probes.probe_row_gather_plain(x, idx),
                  lambda: torch.index_select(x, 0, idx), 4 * (2 * nb * d + nb), 0.0, 0.0)
    acts = rec["acts"]
    if len(acts) != 1 or acts[0][1] > REPS or "probe_row_gather" not in acts[0][0]:
        raise AssertionError(f"K9's call runs other device work than its one kernel: {acts}")
    return rec


def gather_large(dev) -> str:
    """K9 at 65,536 rows of 256 float32 (64 MiB gathered), where the
    ring's bytes rate can show against the HBM rate; a log line, not a
    probe record.  Beside the profiler's device time, the CUDA-event time
    of back-to-back launches without the wrapper's sync (the card, not the
    host, is the slower side at this size)."""
    rows, d = 65_536, 256
    reps = 20
    x, idx = _gather_case(dev, rows, d, rows)
    out = torch.empty_like(x)
    ms = device_ms(lambda: probes.probe_row_gather(x, idx), reps)
    ev = cuda_ms(lambda: probes.launch_row_gather(x, idx, out), reps)
    if probes.row_gather_flag(dev):
        raise AssertionError("K9 flagged an index out of range in its timed launches")
    lib = device_ms(lambda: torch.index_select(x, 0, idx), reps)
    lib_ev = cuda_ms(lambda: torch.index_select(x, 0, idx), reps)
    nbytes = 4 * (2 * rows * d + rows)
    return (f"K9 at {rows} rows of {d} f32: kernel {ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s; "
            f"CUDA events, launches back to back: {ev:.4f}), torch.index_select {lib:.4f} "
            f"(CUDA events {lib_ev:.4f}), bound {bound(nbytes, 0.0)[0]:.4f} by bytes")


PROBES = (("basic", probe_basic), ("grid_matmul", probe_matmul_grid),
          ("gather", probe_scalar_prefetch_gather))


def main(device=None) -> list:
    """Run every probe on ``device`` (the card); returns their records."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the probes measure the card; {dev} has no kernels to probe")
    print(f"device: {torch.cuda.get_device_name(dev)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    records = []
    for label, fn in PROBES:
        rec = fn(dev)
        lib = "null" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
        print(f"PROBE {label} ({rec['key']} {rec['name']}, {rec['shape']}): OK  kernel "
              f"{rec['ms']:.4f} ms (a call {rec['call_ms']:.4f}), plain {rec['plain_ms']:.4f}, "
              f"library {lib}, bound "
              f"{rec['bound_ms']:.6f} by {rec['bound_by']}"
              + (f" (f32 CUDA-core bound {rec['bound_f32_ms']:.6f})" if "bound_f32_ms" in rec else "")
              + (f", launch floor {rec['launch_ms']:.4f} (an empty kernel in the same steps; "
                 f"the kernel at {rec['ms'] / rec['launch_ms']:.2f}x it)"
                 if "launch_ms" in rec else "")
              + f", max abs err {rec['max_abs_err']:.3g}", flush=True)
        print(f"  {rec['key']} device activity: {activity_line(rec['acts'])}", flush=True)
        records.append(rec)
    print(gather_large(dev), flush=True)
    return records


if __name__ == "__main__":
    main()
