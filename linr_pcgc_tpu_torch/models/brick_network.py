"""The brick network's convs on JAX's layout, for the bricks trainer
(runtime/brick_overfit.py).

Port of the conv layer of linr_pcgc_tpu/models/brick_network.py.  JAX keeps
the activations channel-major, (Bb, C, 64), and runs each 3^3 conv as a
6^3 halo exchange and one dense product with the conv matrix, each 1^3 conv
as an einsum.  That is the superbrick network's math at a stage batch of
one, so the port runs the network itself through models/sb_network.py on
the slot-major layout (Bb, 1, 64*C) at S = 1: every 3^3 conv is
ops.superbricks.b4_convsm_bm (K2 then K1 forward; K2, K3 and K4 backward),
every 1^3 conv ops.wgrad.sb_conv1_product (its weight gradient K11's ring
form).  This module is where JAX's brick tensors come in: ``brick_geom``
and the conv counterparts ``bconv3`` and ``bconv1`` take and give JAX's
channel-major (Bb, C, 64) tensors, through the layout maps of
ops/superbricks.py (``to_slot_major``, ``to_channel_major``), which the
superbrick network's channel-major convs share.

``geom`` is the superbrick network's: dict(nbr27 (Bb, 27) int32, mask (Bb,
1, 1, 64), code (Bb, 64), dtype).
"""

from __future__ import annotations

from .sb_network import sbconv1, sbconv3


def brick_geom(nbr27, mask, code, dtype):
    """The network's geom from JAX's arrays: nbr27 (Bb, 27), the slot mask
    (Bb, 64) (any dtype, nonzero = occupied) and code (Bb, 64)."""
    return dict(nbr27=nbr27.int().contiguous(), mask=(mask != 0).to(dtype)[:, None, None, :],
                code=code, dtype=dtype)


def bconv3(x, geom, p):
    """JAX's _bconv3 on its layout: x (Bb, Cin, 64), p {"w": (27, Cin,
    Cout), "b": (Cout,)} -> (conv(x) + b) * mask, (Bb, Cout, 64)."""
    return sbconv3(x[:, None], geom, p["w"][None], p["b"][None])[:, 0]


def bconv1(x, geom, p):
    """JAX's _bconv1 on its layout: x (Bb, Cin, 64), p {"w": (Cin, Cout),
    "b": (Cout,)} -> (x w + b) * mask, (Bb, Cout, 64)."""
    return sbconv1(x[:, None], geom, p["w"][None], p["b"][None])[:, 0]
