"""Digests of K10's output bits, so two checkouts compare on one card.

    PYTHONPATH=<checkout> python linr_pcgc_tpu_torch/tools/k10_digest.py

Runs the neighbour-gather conv K10 (``ops/gather_conv.py::gather_conv``) of
the checkout on ``PYTHONPATH`` over frame 0's level-0 maps of the smoke's
training cell (``synthetic_cloud(800_000, depth=10, seed=7)``; K 27 at
dilations 1 and 2, K 125) at the widths K10 had instances for before it
took any Cout (Cout 8 and 4; forward with bias at Cin 1-8 and 4, dx without
bias), on inputs drawn from a seeded CUDA generator, and prints one line
per case with the sha256 of the output's bytes, then one JSON object of
them.  Two checkouts whose lines agree gave the same bits.  Without a card
it raises.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

CASES = [(3, 1, 8, 8, True), (3, 1, 8, 4, True), (3, 1, 4, 4, True), (3, 1, 4, 8, False),
         *((3, 1, c, 8, True) for c in range(1, 8)), (3, 2, 8, 8, True), (5, 1, 8, 8, True),
         (5, 1, 4, 4, True)]


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("k10_digest runs K10 on the card: torch.cuda.is_available() is False")
    from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud
    from linr_pcgc_tpu_torch.data.dataset import level_arrays_from_coords
    from linr_pcgc_tpu_torch.ops import gather_conv as gc

    dev = torch.device("cuda")
    lev = build_pyramid(synthetic_cloud(800_000, depth=10, seed=7), 7, device=dev).levels[0]
    n = lev.coords.shape[0]
    out = {}
    for k, d, cin, cout, bias in CASES:
        idx = level_arrays_from_coords(lev.coords, lev.n, k, (d,), dev)[3].T.contiguous()
        gen = torch.Generator(device=dev).manual_seed(1000 * k + 100 * d + 10 * cin + cout)
        x = torch.randn((n, cin), generator=gen, device=dev)
        w = torch.randn((k**3, cin, cout), generator=gen, device=dev) * (cin * k**3) ** -0.5
        b = torch.randn((cout,), generator=gen, device=dev) if bias else None
        y = gc.gather_conv(x, idx, w, b)
        torch.cuda.synchronize()
        digest = hashlib.sha256(np.ascontiguousarray(y.cpu().numpy()).tobytes()).hexdigest()
        key = f"K={k ** 3} d={d} Cin={cin} Cout={cout} {'bias' if bias else 'no bias'}"
        out[key] = digest
        print(f"{key}: {digest}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "digests": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
