"""How many of a traced step's launches torch.profiler records, with and
without host idle time around the step's calls.

    python -m linr_pcgc_tpu_torch.tools.trace_edges [--traces N]

prof_probes times a kernel by the device activity of one traced step of
calls (``prof_probes._trace``) and holds the host idle for
``prof_probes.EDGE_S`` before and after them.  This takes ``--traces``
traces of each short probe call (K7 on (8, 128), K9 on 512 and 65,536 rows)
with no idle time and with ``EDGE_S``, and prints for each: the traces that
recorded no launch, those that recorded fewer than the step's calls, and
the median device time per call over the whole traces.  Needs the card.
"""

from __future__ import annotations

import argparse
from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..ops import probes
from . import prof_probes as pp


def cases(dev) -> list:
    """[(name, call, calls a step)] of the short probe calls, seeded."""
    gen = torch.Generator(device=dev).manual_seed(0)
    xb = torch.randn((8, 128), generator=gen, device=dev)
    out = [("K7 (8, 128)", lambda: probes.probe_scale_shift(xb), pp.REPS)]
    for rows, reps in ((512, pp.REPS), (65_536, 20)):
        x = torch.randn((rows, 256), generator=gen, device=dev)
        idx = torch.randint(0, rows, (rows,), generator=gen, device=dev, dtype=torch.int32)
        out.append((f"K9 {rows} rows", partial(probes.probe_row_gather, x, idx), reps))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=40)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    for name, fn, reps in cases(dev):
        fn()
        torch.cuda.synchronize()
        for edge_s in (0.0, pp.EDGE_S):
            empty = short = 0
            whole = []
            for _ in range(args.traces):
                acts = pp._trace(fn, reps, edge_s)
                launches = max((n for _, n, _ in acts), default=0)
                empty += launches == 0
                short += 0 < launches < reps
                if launches >= reps:
                    whole.append(sum(us for _, _, us in acts) / reps / 1e3)
            ms = f"{np.median(whole):.4f}" if whole else "none"
            print(f"{name}, {reps} calls a step, idle {edge_s * 1e3:.0f} ms around them: "
                  f"{empty} of {args.traces} traces recorded no launch, {short} fewer than "
                  f"{reps}; device time per call over the whole ones, median {ms} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
