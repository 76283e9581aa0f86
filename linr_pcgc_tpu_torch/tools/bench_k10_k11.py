"""K10's and K11's device times at their headline shapes, for one checkout.

    python linr_pcgc_tpu_torch/tools/bench_k10_k11.py [--tree DIR]

Imports ``linr_pcgc_tpu_torch`` from ``--tree`` (default: this checkout),
so that two checkouts (a change and its parent, unpacked with ``git
archive``) are timed by one script on the same inputs in one call:

* K11's superbrick form, ``wgrad_sb`` at the trainer's level-0 bucket (Bb
  81,920, bf16): S 4 at (C, O) = (8, 24), (8, 4), (24, 1);
* K11's gather form, ``wgrad_gather`` on frame 0's level-0 map of the
  smoke's training cell (``synthetic_cloud(800_000, depth=10, seed=7)``, N
  786,432): K 27 at 8 -> 8 and 16 -> 16, K 125 at 8 -> 8, and K 1 at 8 -> 24;
* K10, ``gather_conv`` on the same map: K 27 at 8 -> 8 and 16 -> 16, K 125
  at 8 -> 8.

Inputs come from seeded CUDA generators; each case is timed by profiler
device time (``tools/prof_probes.py::device_ms`` of the checkout timed)
and its output's sha256 is kept, so two checkouts' K10 bits compare too.
The last line is one JSON object.  Without a card it raises.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None, help="checkout whose package is timed")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.tree or here))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_k10_k11 runs on the card: torch.cuda.is_available() is False")
    import linr_pcgc_tpu_torch as pkg
    from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud
    from linr_pcgc_tpu_torch.data.dataset import level_arrays_from_coords
    from linr_pcgc_tpu_torch.ops import gather_conv as gc, wgrad
    from linr_pcgc_tpu_torch.tools.prof_probes import device_ms

    dev = torch.device("cuda")
    out = {"tree": os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))),
           "device": torch.cuda.get_device_name(0), "ms": {}, "sha256": {}}

    def case(name, fn):
        res = fn()
        torch.cuda.synchronize()
        out["sha256"][name] = hashlib.sha256(
            np.ascontiguousarray(res.float().cpu().numpy()).tobytes()).hexdigest()
        out["ms"][name] = device_ms(fn)
        print(f"{name}: {out['ms'][name]:.4f} ms device", flush=True)

    gen = torch.Generator(device=dev).manual_seed(12)
    bb, s = 81_920, 4
    for c, o in ((8, 24), (8, 4), (24, 1)):
        x = torch.randn((bb, s, 64 * c), generator=gen, device=dev).to(torch.bfloat16)
        dy = torch.randn((bb, s, 64 * o), generator=gen, device=dev).to(torch.bfloat16)
        case(f"K11 sb Bb={bb} S={s} ({c}, {o}) bf16", lambda: wgrad.wgrad_sb(x, dy, c, o))
        del x, dy
    lev = build_pyramid(synthetic_cloud(800_000, depth=10, seed=7), 7, device=dev).levels[0]
    n = lev.coords.shape[0]
    maps = {k: level_arrays_from_coords(lev.coords, lev.n, k, (1,), dev)[3].T.contiguous()
            for k in (3, 5)}
    for k, cin, cout in ((3, 8, 8), (3, 16, 16), (5, 8, 8), (1, 8, 24)):
        idx = maps.get(k)
        x = torch.randn((n, cin), generator=gen, device=dev)
        dy = torch.randn((n, cout), generator=gen, device=dev)
        case(f"K11 gather N={n} K={k ** 3} ({cin}, {cout})", lambda: wgrad.wgrad_gather(x, dy, idx))
    for k, cin, cout in ((3, 8, 8), (3, 16, 16), (5, 8, 8)):
        idx = maps[k]
        x = torch.randn((n, cin), generator=gen, device=dev)
        w = torch.randn((k ** 3, cin, cout), generator=gen, device=dev) * (cin * k ** 3) ** -0.5
        b = torch.randn((cout,), generator=gen, device=dev)
        case(f"K10 N={n} K={k ** 3} ({cin}, {cout})", lambda: gc.gather_conv(x, idx, w, b))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
