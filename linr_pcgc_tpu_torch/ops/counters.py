"""Launch counters of the hand-written kernels.

Each kernel's wrapper adds one to its ``launches`` attribute where it
launches its kernel, and nowhere else (the plain versions on CPU tensors
count nothing).  This module reads and resets them by kernel key, so a
caller (``chip_smoke.py``, a rank of the parallel trainers) can show which
kernels a path ran."""

from __future__ import annotations


def wrappers() -> dict:
    """Kernel key -> its wrappers (K6: the segment decode and the stage
    tail; K11: the superbrick and the gather form)."""
    from . import gather_conv as gc, plane_conv, probes, rans, superbricks as sb, wgrad

    return {"K1": (plane_conv.plane_matmul_bm,), "K2": (sb.b4_halo_sm,),
            "K3": (plane_conv.plane_matmul,), "K4": (plane_conv.plane_moment_dw,),
            "K5": (rans.rans_encode_segment,),
            "K6": (rans.rans_decode_segment, rans.rans_decode_stage),
            "K7": (probes.probe_scale_shift,), "K8": (probes.probe_matmul,),
            "K9": (probes.probe_row_gather,), "K10": (gc.gather_conv,),
            "K11": (wgrad.wgrad_sb, wgrad.wgrad_gather)}


def launches() -> dict:
    """Each kernel's launches since the last reset, summed over its
    wrappers."""
    return {k: sum(fn.launches for fn in fns) for k, fns in wrappers().items()}


def reset_launches() -> None:
    for fns in wrappers().values():
        for fn in fns:
            fn.launches = 0
