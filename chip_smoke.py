"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero):

  1. build the hand-written CUDA kernels from ``linr_pcgc_tpu_torch/csrc``
     (one nvcc per source, all started together; the ptxas report of
     plane_conv (K1, K3) and plane_moment (K4) is printed);
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes its paths give it, and time kernel, plain version, the library
     yardstick and the roofline bound: K1 and K2 at the codec's level-0
     brick grid (stage batches 1 and 2; K2's yardstick is one
     ``torch.index_select`` of x's slot rows), K1, K3, K4 and K2 on dy *
     mask at the trainer's level-0 bucket (stage batches cs and 1 + cs), every
     (C, O) of the network's 3^3 convs, f32 and bf16, K1, K3 and K4 (dw, the 27-tap
     stencil reduced over the bricks) also for the same bits from two
     launches (the codec's encoder and decoder must agree, and two
     trainings of one GOP give one checkpoint); K5
     and K6 (the rANS coder) at the codec's level-0 segment, byte for
     byte, in both valid forms, with both cross-decodes and on a garbage
     stream, timed by profiler device time beside their bytes and chain
     bounds; K6's stage tail (decode, occupancy stores, packed column)
     against the plain stage tail over the 8 stages of the GOP's level 0,
     twice, under ``torch.cuda.set_sync_debug_mode("error")``;
  3. the serving path: two 800k-point frames, a seeded checkpoint at the
     default 54,712-parameter config, ``linr_pcgc_tpu_torch.cli`` encode +
     lossless decode; it must launch K1, K2, K5 and K6;
  4. for the record, a standalone decode from the bitstreams alone (every
     rANS stage tail in it under ``set_sync_debug_mode("error")``: no host
     sync), a profiled one (device time by kernel) and a phase attribution
     of decode and encode;
  5. the training path: three 800k-point frames in two GOPs through
     ``linr_pcgc_tpu_torch.cli --overfit True --encode True --decode
     True`` (GOP 0 two epochs from ``init_params(seed)``, GOP 1 one epoch
     warm-started from GOP 0), default config, bf16; it must decode
     losslessly, end GOP 0 with a lower loss than it started, and launch
     K1 to K6; then one profiled training epoch (device time by kernel);
  6. the probe path: ``linr_pcgc_tpu_torch.tools.prof_probes`` (the port
     of scripts/prof_pallas.py) must launch K7, K8 and K9, hold each
     against its plain version (K7 and K9 bit for bit, K8 to rtol 2e-5 /
     atol 2e-4 with TF32 off, and the same bits twice), and K9's call
     must run one kernel and nothing else (it checks its indices itself);
     K7 is traced beside an empty kernel, its launch floor;
  7. the unfused trainer and the AC wire: the first two training frames
     (one GOP) through ``linr_pcgc_tpu_torch.cli --overfit True
     --block_layers 2 --mid_test True --check_freq 1 --encode True
     --decode True`` for two epochs (the unfused pass: x_glob, then stage
     chunks; a real encode and lossless decode on the AC wire after each
     epoch, then the rANS encode and decode); it must launch K1 to K6,
     decode losslessly and end with a lower loss than it started; then
     ``LINR_CODEC_ENTROPY=ac`` encode of that checkpoint and a standalone
     decode (lossless), once more with the AC phases attributed.  Phase 2
     holds K1, K3 and K4 at this pass's level-0 shapes too (x_glob at S =
     1, the chunks at S = cs).

The last lines are the card's name and power limit, a JSON line of kernel
records (launches counted on the training path for K1-K6, on the probe
path for K7-K9; phase 7's launches are logged on their own line), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

N_POINTS, DEPTH, N_FRAMES = 800_000, 10, 2
N_TRAIN_FRAMES, TRAIN_GOP, FIRST_EPOCH, OTHERS_EPOCH = 3, 2, 2, 1
SCALE_NUM = 7  # the default ModelConfig: 54,712 parameters
CONV_SHAPES = [(7, 8), (8, 8), (12, 8), (4, 4)]  # (C, O) of the codec's 3^3 convs
TRAIN_CONV_SHAPES = [(8, 8), (12, 8), (4, 4)]  # (C, O) of the fused trainer's 3^3 convs
# the unfused pass's stage chunks also run the context blocks' first conv
# on the 7 occupancy channels (C = 7); x_glob runs block_in alone (S = 1)
UNFUSED_CONV_SHAPES = TRAIN_CONV_SHAPES + [(7, 8)]
UNFUSED_LAYERS = 2  # --block_layers of phase 7
HEADLINE = dict(c=8, o=8, s=2, dtype=torch.bfloat16)  # the commonest conv of the codec


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int = 50) -> float:
    """Profiler device time per call of ``fn`` (every activity of ``reps``
    calls after a traced warm-up, over ``reps``; prof_probes' yardstick)."""
    from linr_pcgc_tpu_torch.tools import prof_probes

    return prof_probes.device_ms(fn, reps)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def level0_geometry(pyrs, dev):
    """The codec's level-0 brick geometry of the GOP: (geometry dict of
    ``dev_codec._package_geo``, voxel counts, brick cap, rANS segment
    length)."""
    from linr_pcgc_tpu_torch.runtime import dev_codec as dc

    s_num = pyrs[0].scale_num
    shapes = dc._LevelShapes(s_num, [p.low_coords for p in pyrs])
    for s in range(s_num):
        shapes.set_counts(s, [p.levels[s].n for p in pyrs])
    shapes.set_top_coords(s_num - 2, [p.levels[s_num - 2].coords[: p.levels[s_num - 2].n]
                                      for p in pyrs])
    bv, cap, tv = shapes.buckets(0)
    base = np.zeros((len(pyrs), bv, 3), np.int32)
    for i, p in enumerate(pyrs):
        base[i, : p.levels[0].n] = p.levels[0].coords[: p.levels[0].n]
    counts = shapes.n_vox[0]
    coords, keys = dc._init_level(torch.as_tensor(base, device=dev), counts, bv)
    return dc._brickify_level(coords, keys, counts, 0, cap, tv), counts, cap, tv


def halo_library_args(x, nbr27):
    """K2's library yardstick, built outside the timed call: x's slot rows
    (Bb * S * 64, C) with one zero row appended, and the int32 index of
    every halo column's source row (the zero row where the neighbour is
    absent), so that ``torch.index_select(rows, 0, idx)`` viewed as (Bb,
    S, 216 * C) is the halo.  The port never calls it."""
    from linr_pcgc_tpu_torch.ops import superbricks as sb

    bb, s, vc = x.shape
    c = vc // 64
    tab = torch.as_tensor(sb.halo_source_table().astype(np.int64), device=x.device)
    d, v = tab // 64, tab % 64
    src = torch.where(d[None] == sb._DIR_CENTER, torch.arange(bb, device=x.device)[:, None],
                      nbr27.long()[:, d])  # (bb, 216)
    idx = (src[:, None, :] * s + torch.arange(s, device=x.device)[None, :, None]) * 64 + v
    idx = torch.where(src[:, None, :] >= 0, idx, bb * s * 64)
    rows = torch.cat([x.reshape(bb * s * 64, c), x.new_zeros((1, c))])
    return rows, idx.reshape(-1).to(torch.int32)


def check_kernels(nbr27, occ_mask, dev):
    """Phase 2: every kernel against its plain version; returns the kernel
    records of the headline shape."""
    from linr_pcgc_tpu_torch.ops import plane_conv, superbricks as sb

    bb = nbr27.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    records, worst = {}, {"K1": 0.0, "K2": 0.0}
    log(f"kernel checks at Bb = {bb} bricks (level 0 of the smoke GOP)")
    for dtype in (torch.float32, torch.bfloat16):
        esz = torch.finfo(dtype).bits // 8
        mask = occ_mask.to(dtype).contiguous()
        for s in (1, 2):
            for c, o in CONV_SHAPES:
                x = (torch.randn((bb, s, 64 * c), generator=gen, device=dev)
                     * mask.repeat_interleave(c, 1)[:, None]).to(dtype)
                w = (torch.randn((s, 27, c, o), generator=gen, device=dev) * (c * 27) ** -0.5).to(dtype)
                bias = torch.randn((s, o), generator=gen, device=dev).repeat(1, 64).to(dtype).contiguous()
                # K2: a gather, exact in every dtype
                h = sb.b4_halo_sm(x, nbr27)
                h_plain = sb.b4_halo_sm_plain(x, nbr27)
                torch.cuda.synchronize()
                if not torch.equal(h, h_plain):
                    raise AssertionError(f"K2 differs from its plain version at C={c} S={s} {dtype}")
                # K1: f32 sums in another order, rounded once to the dtype;
                # a second launch gives the same bits (the codec needs it)
                y = plane_conv.plane_matmul_bm(h, w, c, o, bias, mask)
                y_again = plane_conv.plane_matmul_bm(h, w, c, o, bias, mask)
                y_plain = plane_conv.plane_matmul_bm_plain(h, w, c, o, bias, mask)
                torch.cuda.synchronize()
                if not torch.equal(y, y_again):
                    raise AssertionError(f"two launches of K1 differ at C={c} O={o} S={s} {dtype}")
                err = (y.float() - y_plain.float()).abs()
                tol = (1e-5 + 1e-5 * y_plain.float().abs()) if dtype == torch.float32 else \
                    (1e-4 + 2.0**-7 * y_plain.float().abs())
                if not bool(torch.isfinite(y).all()) or bool((err > tol).any()):
                    raise AssertionError(f"K1 differs from its plain version at C={c} O={o} "
                                         f"S={s} {dtype}: max abs err {err.max().item()}")
                worst["K1"] = max(worst["K1"], err.max().item())
                reps = 20
                k2_ms = cuda_ms(lambda: sb.b4_halo_sm(x, nbr27), reps)
                k2_plain = cuda_ms(lambda: sb.b4_halo_sm_plain(x, nbr27), 5)
                rows, idx = halo_library_args(x, nbr27)
                if not torch.equal(torch.index_select(rows, 0, idx).view(h.shape), h_plain):
                    raise AssertionError(f"K2's index_select yardstick differs at C={c} S={s} {dtype}")
                k2_lib = cuda_ms(lambda: torch.index_select(rows, 0, idx), reps)
                del rows, idx
                k1_ms = cuda_ms(lambda: plane_conv.plane_matmul_bm(h, w, c, o, bias, mask), reps)
                k1_plain = cuda_ms(lambda: plane_conv.plane_matmul_bm_plain(h, w, c, o, bias, mask), 5)
                # the library yardstick: one dense product with the conv
                # matrix (built outside the timed call) + the epilogue
                w2 = sb.b4_conv_weight_matrix_sm(w).contiguous()
                mrep = mask.repeat_interleave(o, 1)[:, None, :]
                k1_lib = cuda_ms(lambda: (torch.matmul(h.transpose(0, 1), w2).transpose(0, 1)
                                          + bias) * mrep, reps)
                # the stencil's work: 27 taps of C x O per slot
                k1_b, k1_by = bound(esz * (h.numel() + w.numel() + bias.numel() + mask.numel()
                                           + y.numel()), 2.0 * bb * s * 64 * 27 * c * o, dtype)
                k2_b, k2_by = bound(esz * (x.numel() + h.numel()) + 4 * nbr27.numel(), 0.0, dtype)
                log(f"  {str(dtype)[6:]:8s} S={s} C={c:2d} O={o}: "
                    f"K1 {k1_ms:.4f} ms (plain {k1_plain:.4f}, library {k1_lib:.4f}, bound "
                    f"{k1_b:.4f} by {k1_by}, max abs err {err.max().item():.3g}) | "
                    f"K2 {k2_ms:.4f} ms (plain {k2_plain:.4f}, library {k2_lib:.4f}, bound "
                    f"{k2_b:.4f} by {k2_by}, {100 * k2_b / k2_ms:.1f} % of it)")
                if dict(c=c, o=o, s=s, dtype=dtype) == HEADLINE:
                    shape = f"Bb={bb} S={s} C={c} O={o} {str(dtype)[6:]}"
                    records["K1"] = dict(
                        name="plane_matmul_bm", route="cuda",
                        source="linr_pcgc_tpu_torch/csrc/plane_conv.cu",
                        replaces="linr_pcgc_tpu/ops/pallas_conv.py:116",
                        ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_b, bound_by=k1_by,
                        library_ms=k1_lib, max_abs_err=err.max().item(), shape=shape)
                    records["K2"] = dict(
                        name="b4_halo_sm", route="cuda",
                        source="linr_pcgc_tpu_torch/csrc/halo.cu",
                        replaces="linr_pcgc_tpu/ops/superbricks.py:619",
                        ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_b, bound_by=k2_by,
                        library_ms=k2_lib, max_abs_err=0.0, shape=shape)
                del x, h, h_plain, y, y_again, y_plain, err, tol, w2
    log(f"K1 worst max abs err over all shapes: {worst['K1']:.3g}; K2 bit-exact everywhere")
    return records


def trainer_level0(pyrs, dev):
    """The trainer's first unit (the level-0 group) of GOP 0: (nbr27, slot
    mask, cs of the fused pass, cs of the unfused pass) of its first
    frame, from the assembly and the stage-chunk rule the trainer uses."""
    from linr_pcgc_tpu_torch.models import ModelConfig
    from linr_pcgc_tpu_torch.runtime import sb_overfit

    batch = sb_overfit.assemble_gop_superbricks(pyrs, dev)
    units = sb_overfit.make_frame_grads_sb(ModelConfig(scale_num=SCALE_NUM),
                                           batch.level_slices).units
    unfused = sb_overfit.make_frame_grads_sb(
        ModelConfig(scale_num=SCALE_NUM, block_layers=UNFUSED_LAYERS), batch.level_slices).units
    log(f"trainer units (first brick, end, cs) of GOP 0: {units} (unfused pass: {unfused}); "
        f"level slices {batch.level_slices}")
    _, gb, cs = units[0]  # the level-0 group starts at brick 0
    return batch.nbr27[0, :gb].contiguous(), (batch.code[0, :gb] >= 0), cs, unfused[0][2]


def check_backward_kernels(nbr27, occ_mask, s_values, shapes, dev, headline_s=None):
    """Phase 2, trainer: K1 (the forward conv), K3 and K4 (dw) against their
    plain versions at the trainer's level-0 shapes (stage batches
    ``s_values``, (C, O) in ``shapes``), each for the same bits from two
    launches; returns the K3 and K4 records of the headline shape (C = O =
    8, S = ``headline_s``, bf16), if it is among them."""
    from linr_pcgc_tpu_torch.ops import plane_conv, superbricks as sb

    bb = nbr27.shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    records, worst = {}, {"K1": 0.0, "K3": 0.0, "K4": 0.0}
    log(f"backward kernel checks at Bb = {bb} bricks (the trainer's level-0 bucket), "
        f"S in {tuple(s_values)}, (C, O) in {shapes}")
    for dtype in (torch.float32, torch.bfloat16):
        esz = torch.finfo(dtype).bits // 8
        mask = occ_mask.to(dtype).contiguous()
        for s in s_values:
            for c, o in shapes:
                x = (torch.randn((bb, s, 64 * c), generator=gen, device=dev)
                     * mask.repeat_interleave(c, 1)[:, None]).to(dtype)
                dym = (torch.randn((bb, s, 64 * o), generator=gen, device=dev)
                       * mask.repeat_interleave(o, 1)[:, None]).to(dtype)
                # K2 on dy * mask, as the backward runs it: bit for bit
                g = sb.b4_halo_sm(dym, nbr27)
                if not torch.equal(g, sb.b4_halo_sm_plain(dym, nbr27)):
                    raise AssertionError(f"K2 differs from its plain version on dy * mask at "
                                         f"O={o} S={s} {dtype}")
                w = torch.randn((s, 27, c, o), generator=gen, device=dev) * (o * 27) ** -0.5
                wt = w[:, sb._FLIP].transpose(-1, -2).to(dtype).contiguous()  # the conv's dx taps
                # K1: the trainer's forward conv at these shapes, as in check_kernels
                wf = w.to(dtype).contiguous()
                bias = torch.randn((s, o), generator=gen, device=dev).repeat(1, 64).to(dtype)
                h = sb.b4_halo_sm(x, nbr27)
                y = plane_conv.plane_matmul_bm(h, wf, c, o, bias, mask)
                y_again = plane_conv.plane_matmul_bm(h, wf, c, o, bias, mask)
                y_plain = plane_conv.plane_matmul_bm_plain(h, wf, c, o, bias, mask)
                torch.cuda.synchronize()
                if not torch.equal(y, y_again):
                    raise AssertionError(f"two launches of K1 differ at C={c} O={o} S={s} {dtype}")
                err1 = (y.float() - y_plain.float()).abs()
                tol = (1e-5 + 1e-5 * y_plain.float().abs()) if dtype == torch.float32 else \
                    (1e-4 + 2.0**-7 * y_plain.float().abs())
                if not bool(torch.isfinite(y).all()) or bool((err1 > tol).any()):
                    raise AssertionError(f"K1 differs from its plain version at C={c} O={o} "
                                         f"S={s} {dtype}: max abs err {err1.max().item()}")
                worst["K1"] = max(worst["K1"], err1.max().item())
                k1_ms = cuda_ms(lambda: plane_conv.plane_matmul_bm(h, wf, c, o, bias, mask), 10)
                del h, y, y_again, y_plain
                # K3: f32 sums in another order, rounded once to the dtype;
                # a second launch gives the same bits
                dx = plane_conv.plane_matmul(g, wt, o, c)
                dx_again = plane_conv.plane_matmul(g, wt, o, c)
                dx_plain = plane_conv.plane_matmul_plain(g, wt, o, c)
                torch.cuda.synchronize()
                if not torch.equal(dx, dx_again):
                    raise AssertionError(f"two launches of K3 differ at C={c} O={o} S={s} {dtype}")
                err3 = (dx.float() - dx_plain.float()).abs()
                tol = (1e-5 + 1e-5 * dx_plain.float().abs()) if dtype == torch.float32 else \
                    (1e-4 + 2.0**-7 * dx_plain.float().abs())
                if not bool(torch.isfinite(dx).all()) or bool((err3 > tol).any()):
                    raise AssertionError(f"K3 differs from its plain version at C={c} O={o} "
                                         f"S={s} {dtype}: max abs err {err3.max().item()}")
                # K4: dw, f32 sums over the bricks in another order; within
                # 1e-5 (f32) or 1e-4 (bf16) of dw's L1 scale sum_b |x| |g|;
                # a second launch gives the same bits (deterministic training)
                dw = plane_conv.plane_moment_dw(x, g, c, o)
                dw_again = plane_conv.plane_moment_dw(x, g, c, o)
                dw_plain = plane_conv.plane_moment_dw_plain(x, g, c, o)
                scale = plane_conv.plane_moment_dw_plain(x.abs(), g.abs(), c, o)
                torch.cuda.synchronize()
                if not torch.equal(dw, dw_again):
                    raise AssertionError(f"two launches of K4 differ at C={c} O={o} S={s} {dtype}")
                err4 = (dw - dw_plain).abs()
                rel = 1e-5 if dtype == torch.float32 else 1e-4
                if not bool(torch.isfinite(dw).all()) or bool((err4 > rel * scale).any()):
                    raise AssertionError(f"K4 differs from its plain version at C={c} O={o} "
                                         f"S={s} {dtype}: max abs err {err4.max().item()}")
                worst["K3"] = max(worst["K3"], err3.max().item())
                worst["K4"] = max(worst["K4"], err4.max().item())
                reps = 10
                k2_ms = cuda_ms(lambda: sb.b4_halo_sm(dym, nbr27), reps)
                k3_ms = cuda_ms(lambda: plane_conv.plane_matmul(g, wt, o, c), reps)
                k3_plain = cuda_ms(lambda: plane_conv.plane_matmul_plain(g, wt, o, c), 3)
                wt2 = sb.b4_conv_weight_matrix_sm(wt).contiguous()  # outside the timed call
                k3_lib = cuda_ms(lambda: torch.matmul(g.transpose(0, 1), wt2).transpose(0, 1), reps)
                k4_ms = cuda_ms(lambda: plane_conv.plane_moment_dw(x, g, c, o), reps)
                k4_plain = cuda_ms(lambda: plane_conv.plane_moment_dw_plain(x, g, c, o), 3)
                # the library yardstick computes the same dw: one batched
                # product of the plane windows (a strided view), then the tap
                # selection; the bare product is logged beside it
                xa = x.view(bb, s, 4, 16 * c).permute(1, 2, 3, 0)
                gw = g.as_strided((bb, s, 4, 108 * o), (s * 216 * o, 216 * o, 36 * o, 1)
                                  ).permute(1, 2, 0, 3)
                k4_lib = cuda_ms(lambda: sb.moment_taps(torch.matmul(xa, gw).float(), c, o), reps)
                k4_mm = cuda_ms(lambda: torch.matmul(xa, gw), reps)
                flops = 2.0 * bb * s * 64 * 27 * c * o  # the stencil's work, for both
                k3_b, k3_by = bound(esz * (g.numel() + wt.numel() + dx.numel()), flops, dtype)
                k4_b, k4_by = bound(esz * (x.numel() + g.numel()) + 4 * dw.numel(), flops, dtype)
                k2_b = bound(esz * (dym.numel() + g.numel()) + 4 * nbr27.numel(), 0.0, dtype)[0]
                log(f"  {str(dtype)[6:]:8s} S={s} C={c:2d} O={o}: "
                    f"K1 {k1_ms:.4f} ms (max abs err {err1.max().item():.3g}) | "
                    f"K2 on dy * mask {k2_ms:.4f} ms (bound {k2_b:.4f} by bytes) | "
                    f"K3 {k3_ms:.4f} ms (plain {k3_plain:.4f}, library {k3_lib:.4f}, bound "
                    f"{k3_b:.4f} by {k3_by}, max abs err {err3.max().item():.3g}) | "
                    f"K4 {k4_ms:.4f} ms (plain {k4_plain:.4f}, library {k4_lib:.4f} [bare "
                    f"matmul {k4_mm:.4f}], bound {k4_b:.4f} by {k4_by}, max abs err "
                    f"{err4.max().item():.3g}, max err / L1 scale "
                    f"{(err4 / scale.clamp_min(1e-30)).max().item():.3g})")
                if (c, o, s, dtype) == (8, 8, headline_s, torch.bfloat16):
                    shape = f"Bb={bb} S={s} C={c} O={o} {str(dtype)[6:]}"
                    records["K3"] = dict(
                        name="plane_matmul", route="cuda",
                        source="linr_pcgc_tpu_torch/csrc/plane_conv.cu",
                        replaces="linr_pcgc_tpu/ops/pallas_conv.py:100",
                        ms=k3_ms, plain_ms=k3_plain, bound_ms=k3_b, bound_by=k3_by,
                        library_ms=k3_lib, max_abs_err=err3.max().item(), shape=shape)
                    records["K4"] = dict(
                        name="plane_moment_dw", route="cuda",
                        source="linr_pcgc_tpu_torch/csrc/plane_moment.cu",
                        replaces="linr_pcgc_tpu/ops/pallas_conv.py:226",
                        ms=k4_ms, plain_ms=k4_plain, bound_ms=k4_b, bound_by=k4_by,
                        library_ms=k4_lib, max_abs_err=err4.max().item(), shape=shape)
                del x, dym, g, wt, wt2, dx, dx_again, dx_plain, dw, dw_again, dw_plain, scale, err3, err4, xa, gw
                del wf, bias, err1
    log(f"worst max abs err over all shapes: K1 {worst['K1']:.3g}, K3 {worst['K3']:.3g}, "
        f"K4 {worst['K4']:.3g}")
    return records


def rans_stream(byts, mask):
    """Emissions (K, LANES, 2) in decode order -> (flat lane-major stream
    with a zero tail, lane start offsets, lane lengths), as the codec lays
    out a blob."""
    from linr_pcgc_tpu_torch.ops import rans

    lens, out = rans.rans_compact_emissions(byts, mask, 2 * byts.shape[0])
    payload = out[torch.arange(out.shape[1], device=out.device)[None] < lens[:, None]]
    return torch.cat([payload, payload.new_zeros(1)]), torch.cumsum(lens, 0) - lens, lens


def sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60).stdout.split()
    return float(out[0])


# Dependent operations per step on each coder's state chain (csrc/rans.cu),
# at Hopper's 4-cycle dependent-issue latency of an integer ALU operation:
# K5: compare, select (first byte), compare, select (second byte),
# umulhi, shift, multiply-add = 7; K6: and, subtract, multiply-add, select
# (the decode step), compare, select (first byte), compare, select
# (second byte) = 8.  The chain bound is steps x that / the max SM clock.
CHAIN_CYCLES_PER_STEP = {"K5": 7 * 4, "K6": 8 * 4}


def rans_symbols(tv, total, seed, dev, stages=None):
    """Seeded f16 probabilities skewed as the codec's (70 % at 0.02, the
    rest uniform), the bits drawn from them, and the valid mask."""
    rng = np.random.default_rng(seed)
    shape = (tv,) if stages is None else (stages, tv)
    p = rng.uniform(0.0, 1.0, shape)
    p = np.where(rng.uniform(size=shape) < 0.7, 0.02, p).astype(np.float16)
    v = np.arange(tv) < total
    b = np.where(v, rng.uniform(size=shape) < p.astype(np.float32), 0).astype(np.uint8)
    return tuple(torch.as_tensor(a).to(dev) for a in (p, b, v))


def check_rans(geo, counts, cap, tv, dev):
    """Phase 2, rANS: K5 and K6 against their plain versions on one level-0
    segment of the smoke GOP (tv symbols, the first ``total`` valid) in
    both valid forms and on a garbage stream, and K6's stage tail against
    the plain stage tail over the 8 stages of the GOP's level 0 (no host
    sync inside it, the same bits from two launches); returns their
    records."""
    from linr_pcgc_tpu_torch.ops import rans
    from linr_pcgc_tpu_torch.runtime import dev_codec as dc

    total = sum(counts)
    p, b, v = rans_symbols(tv, total, 5, dev)
    st0 = rans.rans_initial_states(dev)
    steps = tv // rans.LANES
    log(f"rANS checks on one level-0 segment: {tv} symbols ({total} valid), {steps} steps "
        f"of {rans.LANES} lanes")
    enc = rans.rans_encode_segment(st0, p, b, v)
    runs = {"the plain encoder": rans.rans_encode_segment_plain(st0, p, b, v),
            "K5 given a count": rans.rans_encode_segment(st0, p, b, total)}
    torch.cuda.synchronize()
    for what, other in runs.items():
        for name, got, want in zip(("states", "bytes", "mask"), enc, other):
            if not torch.equal(got, want):
                raise AssertionError(f"K5 {name} differ from {what}'s")
    stream, offs, lens = rans_stream(enc[1], enc[2])
    enc_plain = runs["the plain encoder"]
    stream_plain, offs_plain, _ = rans_stream(enc_plain[1], enc_plain[2])
    dec = rans.rans_decode_segment(enc[0], offs, stream, p, v)
    runs = {"K6 on K5's bytes": dec,
            "K6 given a count": rans.rans_decode_segment(enc[0], offs, stream, p, total),
            "the plain decoder on K5's bytes": rans.rans_decode_segment_plain(
                enc[0], offs, stream, p, v),
            "K6 on the plain encoder's bytes": rans.rans_decode_segment(
                enc_plain[0], offs_plain, stream_plain, p, v)}
    torch.cuda.synchronize()
    for what, (st, cur, bits) in runs.items():
        if not (torch.equal(bits, b) and torch.equal(st, st0) and torch.equal(cur, offs + lens)):
            raise AssertionError(f"{what} do not round-trip")
        for got, want in zip((st, cur, bits), dec):
            if not torch.equal(got, want):
                raise AssertionError(f"{what} differ from K6 on K5's bytes")
    # a garbage stream (an unaligned view, cursors past its end): K6 clamps
    # its reads to the last byte as the plain decoder does, in both forms
    gen = torch.Generator(device=dev).manual_seed(3)
    raw = torch.randint(0, 256, (stream.numel() + 3,), generator=gen, device=dev,
                        dtype=torch.uint8)
    gst = torch.randint(1 << 23, 1 << 31, (rans.LANES,), generator=gen, device=dev)
    gcur = torch.randint(0, stream.numel() + 64, (rans.LANES,), generator=gen, device=dev)
    for valid in (v, total):
        got = rans.rans_decode_segment(gst, gcur, raw[3:], p, valid)
        want = rans.rans_decode_segment_plain(gst, gcur, raw[3:], p, valid)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError("K6 differs from the plain decoder on a garbage stream")
    # a launch now takes less device time than its wrapper's host work, so
    # back-to-back CUDA-event times measure the host: the kernels' times
    # are profiler device times (prof_probes.device_ms), the calls' beside
    k5 = lambda: rans.rans_encode_segment(st0, p, b, v)  # noqa: E731
    k6 = lambda: rans.rans_decode_segment(enc[0], offs, stream, p, v)  # noqa: E731
    k5_ms, k6_ms = device_ms(k5), device_ms(k6)
    k5_call, k6_call = cuda_ms(k5, 50), cuda_ms(k6, 50)
    k5_plain = cuda_ms(lambda: rans.rans_encode_segment_plain(st0, p, b, v), 3)
    k6_plain = cuda_ms(lambda: rans.rans_decode_segment_plain(enc[0], offs, stream, p, v), 3)
    k5_count = device_ms(lambda: rans.rans_encode_segment(st0, p, b, total))
    k6_count = device_ms(lambda: rans.rans_decode_segment(enc[0], offs, stream, p, total))
    # bytes per symbol: probability (f16), valid and bit (1 B each), and K5's
    # two slot bytes and two mask bytes; plus the stream, and the int64 lane
    # states (and cursors) in and out
    k5_b, k5_by = bound(8 * tv + 2 * 8 * rans.LANES, 0.0, torch.float32)
    k6_b, k6_by = bound(4 * tv + stream.numel() + 4 * 8 * rans.LANES, 0.0, torch.float32)
    mhz = sm_clock_mhz()
    chain = {k: steps * c / (mhz * 1e3) for k, c in CHAIN_CYCLES_PER_STEP.items()}
    log(f"  K5 rans_encode {k5_ms:.4f} ms device ({k5_count:.4f} given a count; a call "
        f"{k5_call:.4f}; plain {k5_plain:.4f}, bytes bound {k5_b:.5f}, chain bound "
        f"{chain['K5']:.5f} = {steps} steps x {CHAIN_CYCLES_PER_STEP['K5']} cycles at {mhz:.0f} "
        f"MHz); K6 rans_decode {k6_ms:.4f} ms device ({k6_count:.4f} given a count; a call "
        f"{k6_call:.4f}; plain {k6_plain:.4f}, bytes bound {k6_b:.5f}, chain bound "
        f"{chain['K6']:.5f} = {steps} x {CHAIN_CYCLES_PER_STEP['K6']} cycles); "
        f"{stream.numel() - 1} stream bytes; bit for bit, both valid forms, the cross-decodes "
        "lossless, the garbage stream as the plain decoder")

    # the stage tail over the GOP's level 0, as the decoder runs it
    f, bv = geo["vox_brick"].shape
    pr, truth, _ = rans_symbols(tv, total, 6, dev, stages=8)
    st = st0
    emis = []
    for stage in reversed(range(8)):
        st, by, m = rans.rans_encode_segment(st, pr[stage], truth[stage], total)
        emis.append((by, m))
    sstream, soffs, slens = rans_stream(torch.cat([e[0] for e in emis[::-1]]),
                                        torch.cat([e[1] for e in emis[::-1]]))
    plan = dc._stage_plan(geo["vox_fr"], geo["vox_j"], total, geo["vox_brick"], geo["vox_slot"],
                          cap)
    maps = (geo["vox_fr"], geo["vox_j"], total)
    tails = {k: dict(st=st, cur=soffs, acc=torch.zeros((8, tv), dtype=torch.uint8, device=dev),
                     occ=torch.zeros((f * cap, 8, 64), dtype=torch.uint8, device=dev))
             for k in ("plain", "kernel", "again")}
    for stage in range(8):
        packed = {}
        for k, t in tails.items():
            args = (t["st"], t["cur"], sstream, pr[stage], *maps, t["acc"], t["occ"], stage,
                    geo["vox_brick"], geo["vox_slot"])
            if k == "plain":
                out = dc._rans_dec_stage_scatter_plain(*args)
            else:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = dc._rans_dec_stage_scatter(*args, plan)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            t["st"], t["cur"], t["occ"], packed[k], t["acc"] = out
        torch.cuda.synchronize()
        for k in ("kernel", "again"):
            for name in ("st", "cur", "acc", "occ"):
                if not torch.equal(tails[k][name], tails["plain"][name]):
                    raise AssertionError(f"K6's stage tail ({k}) differs from the plain one in "
                                         f"{name} at stage {stage}")
            if not torch.equal(packed[k], packed["plain"]):
                raise AssertionError(f"K6's stage tail ({k}) packs another column at stage "
                                     f"{stage}")
    t = tails["kernel"]
    if not (torch.equal(t["acc"], truth) and torch.equal(t["cur"], soffs + slens)):
        raise AssertionError("K6's stage tail does not decode the level losslessly")
    acc, occ = t["acc"], t["occ"]
    args = (st, soffs, sstream, pr[0], *maps, acc, occ, 0, geo["vox_brick"], geo["vox_slot"])
    tail = lambda: dc._rans_dec_stage_scatter(*args, plan)  # noqa: E731
    stage_ms, stage_call = device_ms(tail), cuda_ms(tail, 50)
    stage_plain = cuda_ms(lambda: dc._rans_dec_stage_scatter_plain(*args), 3)
    log(f"  K6's stage tail at the GOP's level 0 ({f} frames, cap {cap}, Bv {bv}): "
        f"{stage_ms:.4f} ms device a stage (decode + store + pack; a call {stage_call:.4f}; "
        f"plain {stage_plain:.4f}); all 8 stages bit for bit against the plain tail, twice, no "
        "host sync, lossless")
    shape = f"{tv} symbols, {steps} steps x {rans.LANES} lanes, f16"
    common = dict(route="cuda", source="linr_pcgc_tpu_torch/csrc/rans.cu", library_ms=None,
                  max_abs_err=0.0, shape=shape, sm_clock_mhz=mhz)
    return {"K5": dict(common, name="rans_encode", replaces="linr_pcgc_tpu/ops/rans.py:312",
                       ms=k5_ms, call_ms=k5_call, plain_ms=k5_plain, bound_ms=k5_b, bound_by=k5_by,
                       chain_bound_ms=chain["K5"],
                       chain_cycles_per_step=CHAIN_CYCLES_PER_STEP["K5"]),
            "K6": dict(common, name="rans_decode", replaces="linr_pcgc_tpu/ops/rans.py:178",
                       ms=k6_ms, call_ms=k6_call, plain_ms=k6_plain, bound_ms=k6_b, bound_by=k6_by,
                       chain_bound_ms=chain["K6"],
                       chain_cycles_per_step=CHAIN_CYCLES_PER_STEP["K6"],
                       stage_ms=stage_ms, stage_call_ms=stage_call, stage_plain_ms=stage_plain)}


def probe_path(dev):
    """Phase 6: the probe entry point; it holds each probe against its
    plain version, times it and prints its own OK lines, and its records
    are the probes' rows of the kernels line."""
    from linr_pcgc_tpu_torch.tools import prof_probes

    reset_launches()
    records = {rec.pop("key"): rec for rec in prof_probes.main(dev)}
    counts = launches()
    log(f"phase 6: probe path launches {counts}")
    require_launched(counts, ("K7", "K8", "K9"), "probe path")
    return records, counts


def _wrappers():
    from linr_pcgc_tpu_torch.ops import plane_conv, probes, rans, superbricks as sb

    return {"K1": (plane_conv.plane_matmul_bm,), "K2": (sb.b4_halo_sm,),
            "K3": (plane_conv.plane_matmul,), "K4": (plane_conv.plane_moment_dw,),
            "K5": (rans.rans_encode_segment,),
            "K6": (rans.rans_decode_segment, rans.rans_decode_stage),
            "K7": (probes.probe_scale_shift,), "K8": (probes.probe_matmul,),
            "K9": (probes.probe_row_gather,)}


def launches():
    """Each kernel's launches over its entries (K6: the segment decode and
    the stage tail)."""
    return {k: sum(fn.launches for fn in fns) for k, fns in _wrappers().items()}


def reset_launches():
    for fns in _wrappers().values():
        for fn in fns:
            fn.launches = 0


class strict_stage_tail:
    """Within the block, every call of the decoder's rANS stage tail
    (``dev_codec._rans_dec_stage_scatter``) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync in it raises."""

    def __enter__(self):
        from linr_pcgc_tpu_torch.runtime import dev_codec as dc

        self.saved = fn = dc._rans_dec_stage_scatter
        self.calls = 0

        def strict(*args, **kwargs):
            self.calls += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        dc._rans_dec_stage_scatter = strict
        return self

    def __exit__(self, *exc):
        from linr_pcgc_tpu_torch.runtime import dev_codec as dc

        dc._rans_dec_stage_scatter = self.saved
        return False


def log_k2_total(rows, what):
    """K2's device time summed over its template instances (one per copy
    unit) from a profile's rows."""
    k2 = [e for e in rows if "b4_halo_sm_kernel" in e.key]
    log(f"  K2 in the {what}: {sum(e.self_device_time_total for e in k2) / 1e3:.3f} ms over "
        f"{sum(e.count for e in k2)} launches ({len(k2)} instances)")


def profile_decode(argv):
    """Device time by kernel over one standalone decode; prints the top
    kernels and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from linr_pcgc_tpu_torch import cli

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cli.main(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    log(f"profiled standalone decode: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"(idle share {max(0.0, 1 - busy / wall):.3f})")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  {e.count:7d} x  {e.key[:90]}")
    log_k2_total(rows, "profiled decode")


# codec phases, by the dev_codec function that runs each (looked up by name
# at call time, so wrapping the module attribute times every call)
PHASES = {"geometry": "_level_geometry", "x_glob": "_dev_ctx", "producer": "_fused_probs",
          "rans_enc": "_rans_enc_seg", "rans_compact": "rans_compact_emissions",
          "rans_dec": "_rans_dec_stage_scatter", "transition": "_transition",
          "host_rebuild": "np_octree_up", "probs_down": "_probs_down",
          "ac_enc": "binary_encode_batch", "ac_dec": "binary_decode_batch"}


def phase_times(argv, what: str):
    """Host seconds by codec phase over one CLI run, each call synchronised
    at both ends: an attribution (it serialises host and device), not a
    headline time."""
    from linr_pcgc_tpu_torch import cli
    from linr_pcgc_tpu_torch.runtime import dev_codec as dc

    spent = dict.fromkeys(PHASES, 0.0)
    saved = {attr: getattr(dc, attr) for attr in PHASES.values()}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
            return out
        return run

    for name, attr in PHASES.items():
        setattr(dc, attr, timed(name, saved[attr]))
    try:
        t0 = time.perf_counter()
        cli.main(argv)
        total = time.perf_counter() - t0
    finally:
        for attr, fn in saved.items():
            setattr(dc, attr, fn)
    parts = ", ".join(f"{k} {v:.3f}" for k, v in spent.items() if v > 0)
    log(f"synchronised phase attribution, {what}: total {total:.3f} s: {parts}, "
        f"rest {total - sum(spent.values()):.3f}")


def profile_train(pyrs, dev):
    """Device time by kernel over one bf16 training epoch of GOP 0 from
    fresh weights (after one untimed epoch); prints the top kernels and the
    device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from linr_pcgc_tpu_torch.models import ModelConfig, flatten_params, init_params
    from linr_pcgc_tpu_torch.runtime import TrainConfig, adam_init, sb_overfit

    cfg = ModelConfig(scale_num=SCALE_NUM)
    batch = sb_overfit.assemble_gop_superbricks(pyrs, dev)
    epoch_fn = sb_overfit.make_epoch_fn_sb(cfg, TrainConfig(), batch.level_slices)
    flat = flatten_params(init_params(8807, cfg, dev))
    state = (flat, adam_init(flat), np.float32(0.01), 0)
    state = epoch_fn(*state, batch)[:4]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch_fn(*state, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    log(f"profiled training epoch ({len(pyrs)} frames, units {epoch_fn.units}): wall "
        f"{wall:.3f} s, device busy {busy:.3f} s (idle share {max(0.0, 1 - busy / wall):.3f})")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:14]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  {e.count:7d} x  {e.key[:90]}")
    log_k2_total(rows, "profiled epoch")


def log_epochs(entries, n_frames, name):
    """One line per epoch of a result.json: loss, rate, peak memory, and
    the mid-test's numbers where the epoch ran one."""
    prev = 0.0
    for e in entries:
        mid = ""
        if "real_bpp_all" in e:
            mid = (f"; mid-test real_bpp_all {e['real_bpp_all']:.6f} (point "
                   f"{e['real_point_bpp']:.6f}, estimate {e['point_bpp_val']:.6f}, model "
                   f"{e['model_bpp']:.6f}, xyzlow {e['xyzlow_bpp']:.6f}), enc_time "
                   f"{e['enc_time']:.4f} s/frame, dec_time {e['dec_time']:.4f} s/frame")
        log(f"  {name} epoch {e['epoch']}: loss {e['loss']:.6f} bits/point, "
            f"{(e['train_time'] - prev) / n_frames:.4f} s/frame/epoch, peak device memory "
            f"{e['peak_mem_bytes'] / 2**30:.3f} GiB{mid}")
        prev = e["train_time"]


def unfused_and_ac(work, frames, fused_epochs):
    """Phase 7: the unfused trainer with the mid-test, then the AC wire."""
    from linr_pcgc_tpu_torch import cli

    n = TRAIN_GOP
    t_phase = time.perf_counter()
    udirs = ["--result_dir", os.path.join(work, "uout"), "--handle_dir",
             os.path.join(work, "ucache"), "--scale_num", str(SCALE_NUM)]
    uargv = ["--overfit", "True", "--block_layers", str(UNFUSED_LAYERS), "--mid_test", "True",
             "--check_freq", "1", "--encode", "True", "--decode", "True",
             "--frame_num", str(n), "--gop_size", str(n), "--first_epoch", str(FIRST_EPOCH),
             "--ori_dir", os.path.join(work, "ply_train"), "--encode_dir",
             os.path.join(work, "uenc"), "--decode_dir", os.path.join(work, "udec"), *udirs]
    torch.cuda.synchronize()
    reset_launches()
    ustats = cli.main(uargv)
    torch.cuda.synchronize()
    counts = launches()
    log(f"phase 7: unfused training (--block_layers {UNFUSED_LAYERS}, --mid_test True "
        f"--check_freq 1) + rANS encode + decode, launches {counts}")
    require_launched(counts, ("K1", "K2", "K3", "K4", "K5", "K6"), "unfused training path")
    check_lossless(os.path.join(work, "udec"), frames[:n], "decode after unfused training")
    with open(os.path.join(work, "uout", f"gop_0_{n - 1}", "result.json")) as f:
        entries = json.load(f)
    if [e["epoch"] for e in entries] != list(range(FIRST_EPOCH)) or not all(
            "real_bpp_all" in e for e in entries):
        raise AssertionError(f"the mid-test did not run at every epoch: {entries}")
    log_epochs(entries, n, "unfused gop_0_1")
    if not entries[-1]["loss"] < entries[0]["loss"]:
        raise AssertionError(f"the unfused pass's last-epoch loss {entries[-1]['loss']} is not "
                             f"below its first {entries[0]['loss']}")
    log_epochs(fused_epochs, n, "fused gop_0_1 (phase 5, the same frames)")
    rans_enc = ustats["enc_s"] / n
    rsa = cli.main(["--decode", "True", "--ori_dir", os.path.join(work, "absent"),
                    "--encode_dir", os.path.join(work, "uenc"), "--decode_dir",
                    os.path.join(work, "udec_sa"), *udirs])
    check_lossless(os.path.join(work, "udec_sa"), frames[:n], "standalone decode on the rANS wire")
    rans_dec = rsa["dec_s"] / n
    log(f"  rANS wire after unfused training: {ustats['bits'] / ustats['points']:.6f} bits/point "
        f"(all streams), enc {rans_enc:.4f} s/frame, decode with the ground truth "
        f"{ustats['dec_s'] / n:.4f} s/frame, standalone decode {rans_dec:.4f} s/frame, lossless")

    # the AC wire: encode that checkpoint, then decode from the bitstreams alone
    os.environ["LINR_CODEC_ENTROPY"] = "ac"
    try:
        astats = cli.main(["--overfit", "False", "--block_layers", str(UNFUSED_LAYERS),
                           "--encode", "True", "--decode", "False", "--frame_num", str(n),
                           "--gop_size", str(n), "--ori_dir", os.path.join(work, "ply_train"),
                           "--encode_dir", os.path.join(work, "aenc"), *udirs])
        bins = sorted(os.listdir(os.path.join(work, "aenc", f"gop_0_{n - 1}", "bins")))
        if any(b.endswith(".rans") for b in bins) or f"frame{n - 1:04d}_scale0.bin" not in bins:
            raise AssertionError(f"the AC wire wrote {bins}")
        sa_argv = ["--decode", "True", "--ori_dir", os.path.join(work, "absent"),
                   "--encode_dir", os.path.join(work, "aenc"), "--decode_dir",
                   os.path.join(work, "adec"), *udirs]
        reset_launches()
        sa = cli.main(sa_argv)
        counts = launches()
        check_lossless(os.path.join(work, "adec"), frames[:n], "standalone decode on the AC wire")
        log(f"  AC wire: {astats['bits'] / astats['points']:.6f} bits/point (all streams), enc "
            f"{astats['enc_s'] / n:.4f} s/frame, standalone decode {sa['dec_s'] / n:.4f} s/frame "
            f"(lossless, launches {counts}); the rANS wire's enc {rans_enc:.4f}, standalone "
            f"decode {rans_dec:.4f} s/frame")
        phase_times(sa_argv, "standalone decode on the AC wire")
    finally:
        os.environ.pop("LINR_CODEC_ENTROPY", None)
    log(f"phase 7 took {time.perf_counter() - t_phase:.1f} s")


def check_lossless(dec_dir, frames, what):
    from linr_pcgc_tpu_torch.data import read_ply

    for t, pts in enumerate(frames):
        got = read_ply(os.path.join(dec_dir, f"frame{t:04d}.ply"))
        if not np.array_equal(got, np.unique(pts, axis=0)):
            raise AssertionError(f"{what} of frame {t} is not lossless")


def require_launched(counts, names, what):
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the {what} never launched {missing}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from linr_pcgc_tpu_torch import cli
    from linr_pcgc_tpu_torch.coding import ac
    from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud, write_ply_binary
    from linr_pcgc_tpu_torch.models import ModelConfig, init_params, param_count
    from linr_pcgc_tpu_torch.ops import cuda_build
    from linr_pcgc_tpu_torch.runtime import save_checkpoint

    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "tmp", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "ply"))
    os.makedirs(os.path.join(work, "ply_train"))
    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # 1. build (the host arithmetic coder of the weight codec too, so that
    # its g++ build is set-up time and not encode time)
    t0 = time.perf_counter()
    reports = cuda_build.build_all(verbose=True)
    ac._get_lib()
    log(f"phase 1: built {sorted(cuda_build.LIBS)} + csrc/ac.cpp in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if ("registers" in line or "spill" in line
                    or (name in ("plane_conv", "plane_moment") and "Compiling entry" in line)):
                log(f"  {name}: {line.strip()}")

    # 2. kernels against their plain versions at their paths' shapes
    frames = [synthetic_cloud(N_POINTS, depth=DEPTH, seed=7, phase=0.08 * t)
              for t in range(N_TRAIN_FRAMES)]
    pyrs = [build_pyramid(p, SCALE_NUM, device=dev) for p in frames]
    geo, counts, cap, tv = level0_geometry(pyrs[:N_FRAMES], dev)
    log(f"level-0 voxels per frame {counts}")
    records = check_kernels(geo["nbr27"].contiguous(), geo["code"] >= 0, dev)
    records.update(check_rans(geo, counts, cap, tv, dev))
    del geo
    nbr27, occ_mask, cs, cs_unfused = trainer_level0(pyrs[:TRAIN_GOP], dev)
    records.update(check_backward_kernels(nbr27, occ_mask, (cs, 1 + cs), TRAIN_CONV_SHAPES, dev,
                                          headline_s=1 + cs))
    log("the unfused pass's level-0 unit: x_glob at S = 1, stage chunks at S = "
        f"{cs_unfused}")
    check_backward_kernels(nbr27, occ_mask, (1, cs_unfused), UNFUSED_CONV_SHAPES, dev)
    del nbr27, occ_mask
    torch.cuda.empty_cache()
    log("phase 2: kernels agree with their plain versions")

    # 3. the serving path through the CLI
    for t, pts in enumerate(frames):
        write_ply_binary(os.path.join(work, "ply_train", f"frame{t:04d}.ply"), pts)
        if t < N_FRAMES:
            write_ply_binary(os.path.join(work, "ply", f"frame{t:04d}.ply"), pts)
    params = init_params(8807, ModelConfig(scale_num=SCALE_NUM))
    if param_count(params) != 54712:
        raise AssertionError(f"param count {param_count(params)}")
    save_checkpoint(os.path.join(work, "out", "gop_0_1", "model.npz"), params, None, 0.01, 0, 0.0, 8)
    dirs = ["--result_dir", os.path.join(work, "out"), "--encode_dir", os.path.join(work, "enc"),
            "--handle_dir", os.path.join(work, "cache"), "--scale_num", str(SCALE_NUM)]
    argv = ["--overfit", "False", "--encode", "True", "--decode", "True",
            "--frame_num", str(N_FRAMES), "--gop_size", str(N_FRAMES),
            "--ori_dir", os.path.join(work, "ply"), "--decode_dir", os.path.join(work, "dec"), *dirs]
    reset_launches()
    stats = cli.main(argv)
    serve_launches = launches()
    log(f"phase 3: serving path launches {serve_launches}")
    require_launched(serve_launches, ("K1", "K2", "K5", "K6"), "serving path")
    bpp = stats["bits"] / stats["points"]
    log(f"  {stats['points']} points, {bpp:.6f} bits/point (random weights), "
        f"enc {stats['enc_s'] / N_FRAMES:.4f} s/frame, dec {stats['dec_s'] / N_FRAMES:.4f} s/frame "
        "(host clock, first call in the process)")

    # 4. for the record: standalone, profiled and attributed decodes
    sa_argv = ["--decode", "True", "--ori_dir", os.path.join(work, "absent"),
               "--decode_dir", os.path.join(work, "dec_sa"), *dirs]
    reset_launches()
    with strict_stage_tail() as strict:
        sa = cli.main(sa_argv)
    dec_launches = launches()
    log(f"  standalone decode: {strict.calls} stage tails, each under "
        "set_sync_debug_mode('error'): no host sync")
    check_lossless(os.path.join(work, "dec_sa"), frames[:N_FRAMES], "standalone decode")
    log(f"  standalone decode: {sa['dec_s'] / N_FRAMES:.4f} s/frame, lossless, launches "
        f"{dec_launches}; encode launches "
        f"{({k: serve_launches[k] - dec_launches[k] for k in dec_launches})}")
    profile_decode(sa_argv)
    phase_times(sa_argv, "standalone decode")
    phase_times([*argv[:4], "--decode", "False", *argv[6:]], "encode")
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # 5. the training path: overfit -> encode -> decode through the CLI
    tdirs = ["--result_dir", os.path.join(work, "tout"), "--encode_dir", os.path.join(work, "tenc"),
             "--handle_dir", os.path.join(work, "tcache"), "--scale_num", str(SCALE_NUM)]
    targv = ["--overfit", "True", "--encode", "True", "--decode", "True",
             "--frame_num", str(N_TRAIN_FRAMES), "--gop_size", str(TRAIN_GOP),
             "--first_epoch", str(FIRST_EPOCH), "--others_epoch", str(OTHERS_EPOCH),
             "--ori_dir", os.path.join(work, "ply_train"),
             "--decode_dir", os.path.join(work, "tdec"), *tdirs]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    tstats = cli.main(targv)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = launches()
    log(f"phase 5: training path launches {train_launches}")
    require_launched(train_launches, ("K1", "K2", "K3", "K4", "K5", "K6"), "training path")
    check_lossless(os.path.join(work, "tdec"), frames, "decode after training")
    epochs = {}
    for gop in cli.gop_groups(N_TRAIN_FRAMES, TRAIN_GOP):
        name = f"gop_{gop[0]}_{gop[-1]}"
        with open(os.path.join(work, "tout", name, "result.json")) as f:
            epochs[name] = json.load(f)
        log_epochs(epochs[name], len(gop), name)
    first = epochs["gop_0_1"]
    if not first[-1]["loss"] < first[0]["loss"]:
        raise AssertionError(f"GOP 0's last-epoch loss {first[-1]['loss']} is not below its "
                             f"first {first[0]['loss']}")
    tbpp = tstats["bits"] / tstats["points"]
    log(f"  trained: {tstats['points']} points, {tbpp:.6f} bits/point (all streams), lossless; "
        f"train {tstats['train_s']:.3f} s, enc {tstats['enc_s'] / N_TRAIN_FRAMES:.4f} s/frame, "
        f"dec {tstats['dec_s'] / N_TRAIN_FRAMES:.4f} s/frame, whole CLI run {train_wall:.3f} s")
    profile_train(pyrs[:TRAIN_GOP], dev)

    # 6. the probe path
    probe_records, probe_launches = probe_path(dev)
    records.update(probe_records)
    log(f"smoke wall time so far {time.perf_counter() - t_start:.1f} s")

    # 7. the unfused trainer with the mid-test, and the AC wire
    unfused_and_ac(work, frames, epochs["gop_0_1"])
    shutil.rmtree(work, ignore_errors=True)
    log(f"smoke wall time so far {time.perf_counter() - t_start:.1f} s")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    # launches on each kernel's path: K1-K6 training, K7-K9 the probes
    path_launches = {**train_launches, **{k: probe_launches[k] for k in ("K7", "K8", "K9")}}
    kernels = []
    for key in sorted(records):
        rec = dict(records[key], launches=path_launches[key])
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
        extra = ("call_ms", "bound_f32_ms", "chain_bound_ms", "chain_cycles_per_step",
                 "sm_clock_mhz", "stage_ms", "stage_call_ms", "stage_plain_ms", "launch_ms")
        kernels.append({k: rec[k] for k in keys + tuple(e for e in extra if e in rec)})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
