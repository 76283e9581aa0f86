"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent`` names another checkout (a parent commit unpacked with ``git
archive``): its K10 and K11 are then timed at their headline shapes in the
same run (``linr_pcgc_tpu_torch/tools/bench_k10_k11.py --tree DIR``, a
process of its own) and logged beside this checkout's.

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
     twice, under ``torch.cuda.set_sync_debug_mode("error")``; K11 (the
     1^3 convs' weight gradient) in its superbrick form at the trainer's
     level-0 bucket, every stage batch of the trainers' units and every
     (C, O) of their 1^3 convs, bf16, for one bf16 ulp of its plain version
     (f32 sums rounded once) and the same bits from two launches;
     ``b4_convsm`` (the conv without bias and mask) forward and backward at
     the trainer's level-0 bucket (S 4, C = O = 8, bf16) against the plain
     versions of K2, K3 and K4 at K3's and K4's tolerances, launching K2,
     K3 and K4;
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
     K1 to K6 and K11, every K11 shape among phase 2's checks; then one
     profiled training epoch (device time by kernel, and the products by
     input shape: ``tools/prof_train.py``);
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
     epoch, then the rANS encode and decode); it must launch K1 to K6 and
     K11,
     decode losslessly and end with a lower loss than it started; then
     ``LINR_CODEC_ENTROPY=ac`` encode of that checkpoint and a standalone
     decode (lossless), once more with the AC phases attributed.  Phase 2
     holds K1, K3 and K4 at this pass's level-0 shapes too (x_glob at S =
     1, the chunks at S = cs);
  8. the gather backend: K10 (the neighbour-gather conv) against its plain
     version on frame 0's level-0 geometry (at K 27 forward at every
     (Cin, Cout) the phase launches, (1-8, 8), (8, 4), (4, 4), and at
     hidden_channel_conv 16 (16, 16), (16, 8), (1-7, 16), and dx at (8, 8),
     (4, 8), (4, 4), (16, 16), (8, 16); at a dilation-2 map and at K 125;
     the same bits from two launches), timed beside its library yardstick
     and bound; K11's gather form there too (K 1, 27 and 125, every (Cin,
     Cout) of the phase's weight gradients); the phase fails if its path
     launches a K10 or K11 shape not checked; then the first two training
     frames through ``linr_pcgc_tpu_torch.cli --overfit True --outstage 4``
     (one GOP, two epochs from ``init_params(seed)``), its encode + decode
     and a standalone decode, lossless, launching K10 and K11 in training,
     K10 in serving and none of K1-K6; then frame 0 at ``--outstage 4
     --hidden_channel_conv 16``: one epoch, encode, decode and a standalone
     decode, lossless, through K10 and K11; then one frame served at
     ``--block_type dilation`` (an ``init_params(seed)`` checkpoint): encode
     and a standalone decode, lossless, through K10;
  9. multi-device training, two ranks sharing the card over gloo (one
     process each, ``linr_pcgc_tpu_torch.parallel``): the stage-parallel
     trainer on the training cell's GOP 0 (two epochs from
     ``init_params(seed)``), every rank launching K1 to K4 and K11 (counted
     in the rank), the parameters identical on both, the losses within
     SP_LOSS_RTOL of phase 5's one-device run; then
     ``linr_pcgc_tpu_torch.cli --devices 2 --parallel gop --device_ids 0,0``
     on the three training frames at ``--gop_size 1`` (GOP 0 stage-parallel,
     GOPs 1 and 2 side by side), encode and a lossless decode; then the
     serving GOP encoded under ``LINR_CODEC_PROBS=stage`` and decoded
     standalone (lossless, its rate within 0.01 % of phase 3's, every K1
     and K2 shape it launches among phase 2's checks); the NCCL route where
     there are two cards, else a line saying it was not run;
 10. the bricks trainer: K1, K3, K4 and K11's superbrick form against their
     plain versions and timed at S = 1 on the brick batch's first frame
     (every level in one unit); then ``overfit_gop(backend="bricks")`` on
     the first two training frames (one GOP, BRICK_EPOCHS epochs from
     ``init_params(seed)``, bf16), which must launch K1 to K4 and K11, each
     only at shapes held against its plain version, and end with a lower
     loss than it started; the s/frame/epoch and peak device memory of each
     epoch; its checkpoint encoded and decoded through
     ``linr_pcgc_tpu_torch.cli`` (lossless); and ``estimate_bits`` and
     ``compare_methods`` on its weights beside the weight codec's real size;
 11. the host-AC superbrick codec (``runtime/sb_codec.py``) at brick side
     4 and 8: ``encode_gop_streams_sb`` -> ``decode_gop_streams_sb`` of the
     serving GOP with phase 3's dequantized checkpoint, lossless, the two
     sides' rates within SIDE_RATE_RTOL (logged beside phase 3's), enc and
     dec s/frame, every K1 and K2 shape it launches held against the plain
     version there and for the same bits twice; the side-8 trainer on the
     first two training frames (``assemble_gop_superbricks(side=8)``,
     SIDE8_EPOCHS epochs from ``init_params(seed)``, bf16, K1-K4 and K11
     checked at its level-0 sub-brick unit first), its first loss within
     SIDE8_LOSS_RTOL of phase 5's and falling, only checked shapes
     launched, s/frame/epoch and peak memory; and K1 and K2 timed (time,
     plain, library, bound) at each codec side's level 0 and at the
     bricks trainer's commonest conv.

The last lines are the card's name and power limit, a JSON line of kernel
records (launches counted on the training path for K1-K6 and K11's
superbrick form, on the probe path for K7-K9, on phase 8's for K10 and
K11's gather form; phase 7's, 9's, 10's and 11's launches are logged on their
own lines), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
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
GATHER_OUTSTAGE = 4  # --outstage of phase 8
# (kernel size, dilation, Cin, Cout, dx) of K10's checks, dx where the
# network takes the conv's input gradient (K10 again, Cin and Cout swapped):
# every width phase 8 launches (the blocks' convs at ch 8, the inception
# branch's at 4, the context blocks' conv_in over the 1-7 bits coded so
# far, which takes no dx), a dilation-2 map, kernel size 5; phase 8 fails
# if its path launches a (K, Cin, Cout) that is not checked here
GATHER_CASES = [(3, 1, 8, 8, True), (3, 1, 8, 4, True), (3, 1, 4, 4, True),
                *((3, 1, c, 8, False) for c in range(1, 8)), (3, 2, 8, 8, True),
                (5, 1, 8, 8, True), (3, 1, 16, 16, True), (3, 1, 16, 8, True),
                *((3, 1, c, 16, False) for c in range(1, 8))]
GATHER_WIDE = 16  # --hidden_channel_conv of phase 8's second case
# (C, O) of the superbrick trainers' 1^3 convs (K11's superbrick form): the
# inception branch (c10, c12), the inner MLP (l0 and the outstage-8 head)
# and the input embedding's scale MLP
SB_CONV1_SHAPES = [(8, 4), (4, 4), (8, 24), (24, 1), (15, 16), (16, 8)]
SB_CONV1_HEADLINE = (8, 24)  # the inner MLP's first layer, at S = cs
# (K, Cin, Cout) of K11's gather form on phase 8's path: the 1^3 convs
# (K 1) at ch 8 and 16, the k^3 convs' dw (K 27: the blocks', the inception
# branch's, the context blocks' conv_in over the 1-7 bits coded so far), and
# K 125 (kernel size 5); phase 8 fails if its path launches one not here
GATHER_WGRAD_CASES = [*((1, c, o) for c, o in ((8, 4), (4, 4), (8, 24), (24, 2), (16, 8),
                                               (8, 8), (16, 24))),
                      *((27, c, o) for c, o in ((8, 8), (8, 4), (4, 4), (16, 16), (16, 8))),
                      *((27, c, o) for o in (8, 16) for c in range(1, 8)), (125, 8, 8)]
HEADLINE = dict(c=8, o=8, s=2, dtype=torch.bfloat16)  # the commonest conv of the codec
PAR_RANKS = 2  # ranks of phase 9, sharing the one card over gloo
BRICK_EPOCHS = 2  # epochs of phase 10's bricks trainer
# phase 9's sb_sp epoch losses against the one-device trainer's: the first
# epoch, and every later one (the bounds of the JAX package's own check,
# tests/test_parallel.py::test_sb_sp_matches_sequential_trajectory)
SP_LOSS_RTOL = (1e-4, 1e-2)
SB_CODEC_SIDES = (4, 8)  # brick sides of phase 11's host-AC superbrick codec
SIDE_RATE_RTOL = 1e-4  # the two sides' rates against each other
SIDE8_EPOCHS = 2  # epochs of phase 11's side-8 trainer
SIDE8_LOSS_RTOL = 1e-3  # its first loss against phase 5's first GOP-0 loss
B4_CONVSM_S = 4  # the stage batch of phase 2's b4_convsm check (the fused pass's level-0 cs)
BRICKS_SHAPE = (1, 8, 8, torch.bfloat16)  # (S, C, O, dtype) of the bricks trainer's commonest conv


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


def conv_times(x, h_plain, w, bias, mask, nbr27, c, o, reps=20):
    """K2 and K1 at one shape (x (Bb, S, 64*C) and its plain halo h_plain,
    taps w, the bias tiled over the slots, the slot mask, nbr27): CUDA-event
    ms of each, of its plain version and of its library yardstick (K2: one
    ``torch.index_select`` of x's slot rows, checked to give the halo; K1:
    one dense product with the conv matrix, built outside the timed call,
    and the epilogue), and each one's bound and what bounds it."""
    from linr_pcgc_tpu_torch.ops import plane_conv, superbricks as sb

    bb, s, _ = x.shape
    esz = x.element_size()
    k2_ms = cuda_ms(lambda: sb.b4_halo_sm(x, nbr27), reps)
    k2_plain = cuda_ms(lambda: sb.b4_halo_sm_plain(x, nbr27), 5)
    rows, idx = halo_library_args(x, nbr27)
    if not torch.equal(torch.index_select(rows, 0, idx).view(h_plain.shape), h_plain):
        raise AssertionError(f"K2's index_select yardstick differs at C={c} S={s} {x.dtype}")
    k2_lib = cuda_ms(lambda: torch.index_select(rows, 0, idx), reps)
    del rows, idx
    h = h_plain
    k1_ms = cuda_ms(lambda: plane_conv.plane_matmul_bm(h, w, c, o, bias, mask), reps)
    k1_plain = cuda_ms(lambda: plane_conv.plane_matmul_bm_plain(h, w, c, o, bias, mask), 5)
    w2 = sb.b4_conv_weight_matrix_sm(w).contiguous()
    mrep = mask.repeat_interleave(o, 1)[:, None, :]
    k1_lib = cuda_ms(lambda: (torch.matmul(h.transpose(0, 1), w2).transpose(0, 1) + bias) * mrep,
                     reps)
    # the stencil's work: 27 taps of C x O per slot
    k1_b, k1_by = bound(esz * (h.numel() + w.numel() + bias.numel() + mask.numel()
                               + bb * s * 64 * o), 2.0 * bb * s * 64 * 27 * c * o, x.dtype)
    k2_b, k2_by = bound(esz * (x.numel() + h.numel()) + 4 * nbr27.numel(), 0.0, x.dtype)
    return dict(k1_ms=k1_ms, k1_plain=k1_plain, k1_lib=k1_lib, k1_b=k1_b, k1_by=k1_by,
                k2_ms=k2_ms, k2_plain=k2_plain, k2_lib=k2_lib, k2_b=k2_b, k2_by=k2_by)


def check_kernels(nbr27, occ_mask, dev):
    """Phase 2: every kernel against its plain version; returns the kernel
    records of the headline shape and the set of shapes checked, ("K1", S,
    C, O, dtype) and ("K2", S, C, dtype)."""
    from linr_pcgc_tpu_torch.ops import plane_conv, superbricks as sb

    bb = nbr27.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    records, worst, checked = {}, {"K1": 0.0, "K2": 0.0}, set()
    log(f"kernel checks at Bb = {bb} bricks (level 0 of the smoke GOP)")
    for dtype in (torch.float32, torch.bfloat16):
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
                checked |= {("K1", s, c, o, dtype), ("K2", s, c, dtype)}
                t = conv_times(x, h_plain, w, bias, mask, nbr27, c, o)
                k1_ms, k1_plain, k1_lib, k1_b, k1_by = (t[k] for k in (
                    "k1_ms", "k1_plain", "k1_lib", "k1_b", "k1_by"))
                k2_ms, k2_plain, k2_lib, k2_b, k2_by = (t[k] for k in (
                    "k2_ms", "k2_plain", "k2_lib", "k2_b", "k2_by"))
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
                del x, h, h_plain, y, y_again, y_plain, err, tol
    log(f"K1 worst max abs err over all shapes: {worst['K1']:.3g}; K2 bit-exact everywhere")
    return records, checked


def trainer_level0(pyrs, dev):
    """The trainer's first unit (the level-0 group) of GOP 0: (nbr27, slot
    mask, cs of the fused pass, cs of the unfused pass) of its first
    frame, from the assembly and the stage-chunk rule the trainer uses, and
    the stage batches of the 1^3 convs over every unit of both passes (the
    fused pass's blocks at cs and 1 + cs, its MLP at cs, the unfused pass's
    at cs, the input embedding and x_glob at 1)."""
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
    s_conv1 = {1} | {u[2] for u in units} | {u[2] + 1 for u in units} | {u[2] for u in unfused}
    return (batch.nbr27[0, :gb].contiguous(), (batch.code[0, :gb] >= 0), cs, unfused[0][2],
            s_conv1)


def check_backward_kernels(nbr27, occ_mask, s_values, shapes, dev, headline_s=None):
    """Phase 2, trainer: K1 (the forward conv), K3 and K4 (dw) against their
    plain versions at the trainer's level-0 shapes (stage batches
    ``s_values``, (C, O) in ``shapes``), each for the same bits from two
    launches; returns the K3 and K4 records of the headline shape (C = O =
    8, S = ``headline_s``, bf16), if it is among them, and the set of
    (kernel, S, C, O, dtype) checked."""
    from linr_pcgc_tpu_torch.ops import plane_conv, superbricks as sb

    bb = nbr27.shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    records, worst, checked = {}, {"K1": 0.0, "K3": 0.0, "K4": 0.0}, set()
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
                checked |= {(k, s, c, o, dtype) for k in ("K1", "K3", "K4")} | {("K2", s, o, dtype)}
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
                flops = 2.0 * bb * s * 64 * 27 * c * o  # the stencil's work, for all three
                # K1 reads x's halo, w, the bias and the mask and writes y
                k1_b, k1_by = bound(esz * (bb * s * 216 * c + wf.numel() + bias.numel()
                                           + mask.numel() + bb * s * 64 * o), flops, dtype)
                k3_b, k3_by = bound(esz * (g.numel() + wt.numel() + dx.numel()), flops, dtype)
                k4_b, k4_by = bound(esz * (x.numel() + g.numel()) + 4 * dw.numel(), flops, dtype)
                k2_b = bound(esz * (dym.numel() + g.numel()) + 4 * nbr27.numel(), 0.0, dtype)[0]
                log(f"  {str(dtype)[6:]:8s} S={s} C={c:2d} O={o}: "
                    f"K1 {k1_ms:.4f} ms (bound {k1_b:.4f} by {k1_by}, max abs err "
                    f"{err1.max().item():.3g}) | "
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
    return records, checked


def check_b4_convsm(nbr27, occ_mask, dev):
    """Phase 2, trainer: b4_convsm (the conv without bias and mask, JAX's
    b4_convsm) forward and backward on the card at the trainer's level-0
    shape (S = B4_CONVSM_S, C = O = 8, bf16), on masked inputs: y and dx
    against the plain versions of K2 and K3 on the same inputs at K3's
    tolerance, dw against K4's plain version at K4's; the call must launch
    K2 and K3 twice each (forward and backward) and K4 once."""
    from linr_pcgc_tpu_torch.ops import plane_conv, superbricks as sb

    bb, s, c, o, dtype = nbr27.shape[0], B4_CONVSM_S, 8, 8, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    mask = occ_mask.to(dtype)
    x = (torch.randn((bb, s, 64 * c), generator=gen, device=dev)
         * mask.repeat_interleave(c, 1)[:, None]).to(dtype)
    w = torch.randn((s, 27, c, o), generator=gen, device=dev) * (c * 27) ** -0.5
    dy = (torch.randn((bb, s, 64 * o), generator=gen, device=dev)
          * mask.repeat_interleave(o, 1)[:, None]).to(dtype)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = launches()
    y = sb.b4_convsm(xl, wl, nbr27)
    y.backward(dy)
    torch.cuda.synchronize()
    after = launches()
    ran = {k: after[k] - before[k] for k in ("K2", "K3", "K4")}
    if ran != {"K2": 2, "K3": 2, "K4": 1}:
        raise AssertionError(f"b4_convsm's forward and backward launched {ran}, expected K2 and "
                             "K3 twice and K4 once")
    h = sb.b4_halo_sm_plain(x, nbr27)
    g = sb.b4_halo_sm_plain(dy, nbr27)
    wt = w[:, sb._FLIP].transpose(-1, -2).to(dtype).contiguous()
    y_plain = plane_conv.plane_matmul_plain(h, w.to(dtype).contiguous(), c, o)
    errs = {}
    for name, got, want in (("y", y, y_plain),
                            ("dx", xl.grad, plane_conv.plane_matmul_plain(g, wt, o, c))):
        err = (got.float() - want.float()).abs()
        if not bool(torch.isfinite(got).all()) or bool(
                (err > 1e-4 + 2.0**-7 * want.float().abs()).any()):
            raise AssertionError(f"b4_convsm's {name} differs from the plain version: max abs "
                                 f"err {err.max().item()}")
        errs[name] = err.max().item()
    dw_plain = plane_conv.plane_moment_dw_plain(x, g, c, o)
    scale = plane_conv.plane_moment_dw_plain(x.abs(), g.abs(), c, o)
    err = (wl.grad - dw_plain).abs()
    if not bool(torch.isfinite(wl.grad).all()) or bool((err > 1e-4 * scale).any()):
        raise AssertionError(f"b4_convsm's dw differs from the plain version: max abs err "
                             f"{err.max().item()}")
    log(f"b4_convsm at Bb = {bb} S = {s} C = O = 8 bf16: forward and backward launch {ran}; "
        f"max abs err y {errs['y']:.3g}, dx {errs['dx']:.3g}, dw {err.max().item():.3g}")


def bf16_ulp(v):
    """One bf16 ulp at each value's magnitude."""
    return torch.exp2(torch.floor(torch.log2(v.float().abs().clamp_min(2.0**-126))) - 7)


def check_wgrad_sb(occ_mask, s_values, dev, headline_s):
    """Phase 2, trainer: K11's superbrick form against its plain version at
    the trainer's level-0 bucket, every stage batch in ``s_values`` and
    every (C, O) of SB_CONV1_SHAPES, bf16: within one bf16 ulp of the plain
    result (the same products summed in f32 in another order, each rounded
    once) plus 1e-5 of the L1 scale sum |x| |dy| (a sum that cancels to
    near zero), the same bits from two launches; each shape timed at
    ``headline_s`` (the scale MLP's at S 1).  Returns K11's record at
    SB_CONV1_HEADLINE and the set of ("sb", S, C, O, dtype) checked."""
    from linr_pcgc_tpu_torch.ops import wgrad

    bb = occ_mask.shape[0]
    dtype = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)
    m = occ_mask.to(torch.float32)
    checked, record, worst = set(), None, 0.0
    log(f"K11 (superbrick form) checks at Bb = {bb} bricks (the trainer's level-0 bucket), S in "
        f"{sorted(s_values)}, (C, O) in {SB_CONV1_SHAPES}, bf16")
    for s in sorted(s_values):
        for c, o in SB_CONV1_SHAPES:
            x = (torch.randn((bb, s, 64, c), generator=gen, device=dev)
                 * m[:, None, :, None]).to(dtype).reshape(bb, s, 64 * c)
            dy = (torch.randn((bb, s, 64, o), generator=gen, device=dev)
                  * m[:, None, :, None]).to(dtype).reshape(bb, s, 64 * o)
            dw = wgrad.wgrad_sb(x, dy, c, o)
            dw_again = wgrad.wgrad_sb(x, dy, c, o)
            want = wgrad.wgrad_sb_plain(x, dy, c, o)
            scale = wgrad.wgrad_sb_plain(x.abs(), dy.abs(), c, o).float()
            torch.cuda.synchronize()
            if not torch.equal(dw, dw_again):
                raise AssertionError(f"two launches of K11 differ at S={s} C={c} O={o}")
            err = (dw.float() - want.float()).abs()
            if (dw.dtype != dtype or not bool(torch.isfinite(dw).all())
                    or bool((err > bf16_ulp(want) + 1e-5 * scale).any())):
                raise AssertionError(f"K11 differs from its plain version at S={s} C={c} O={o}: "
                                     f"max abs err {err.max().item()}")
            worst = max(worst, (err / bf16_ulp(want)).max().item())
            checked.add(("sb", s, c, o, dtype))
            timed = s == (1 if (c, o) in ((15, 16), (16, 8)) else headline_s)
            if timed:
                x4, dy4 = x.view(bb, s, 64, c), dy.view(bb, s, 64, o)
                lib = lambda: torch.einsum("bsvc,bsvo->sco", x4, dy4)  # noqa: E731
                lib_ulps = ((lib().float() - want.float()).abs() / bf16_ulp(want)).max().item()
                ms = device_ms(lambda: wgrad.wgrad_sb(x, dy, c, o))
                plain = cuda_ms(lambda: wgrad.wgrad_sb_plain(x, dy, c, o), 3)
                lib_ms = cuda_ms(lib, 5)
                # x and dy read once, dw written once; 2 C O flops a slot row
                b_ms, b_by = bound(2 * (x.numel() + dy.numel() + dw.numel()),
                                   2.0 * bb * s * 64 * c * o, dtype)
                plan = wgrad.ring_plan(bb * 64, s, c, o, 2)
                log(f"  S={s} C={c:2d} O={o:2d}: K11 {ms:.4f} ms device (plain {plain:.4f}, library "
                    f"{lib_ms:.4f} [the bf16 einsum, {lib_ulps:.3g} ulps off the plain version], "
                    f"bound {b_ms:.4f} by {b_by}, {100 * b_ms / ms:.1f} % of it; {plan.blocks} "
                    f"blocks x {plan.sg * plan.wps} warps, {plan.nst} ring slots of {plan.tb} "
                    f"bricks); max err {(err / bf16_ulp(want)).max().item():.3g} ulps, the same "
                    "bits twice")
                if (c, o) == SB_CONV1_HEADLINE:
                    record = dict(name="wgrad_sb", route="cuda",
                                  source="linr_pcgc_tpu_torch/csrc/wgrad.cu",
                                  replaces="linr_pcgc_tpu/models/sb_network.py:205",
                                  ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib_ms, max_abs_err=err.max().item(),
                                  shape=f"Bb={bb} S={s} C={c} O={o} bf16")
            del x, dy, dw, dw_again, want, scale, err
    log(f"K11 (superbrick form): worst error {worst:.3g} bf16 ulps of the plain version")
    return record, checked


def k11_sb_key(x, dy, c, o):
    return ("sb", x.shape[1], c, o, x.dtype)


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


def launches():
    """Each kernel's launches over its entries (K6: the segment decode and
    the stage tail)."""
    from linr_pcgc_tpu_torch.ops import counters

    return counters.launches()


def reset_launches():
    from linr_pcgc_tpu_torch.ops import counters

    counters.reset_launches()


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


def profile_train(pyrs, dev, cfg=None):
    """One profiled training epoch of ``pyrs`` (tools/prof_train.py): the
    superbrick trainer in bf16 at the default config, the gather trainer for
    ``cfg``; logs the top kernels, the products by input shape and the
    device's busy share of the wall time."""
    from linr_pcgc_tpu_torch.tools import prof_train

    return prof_train.profile_epoch(pyrs, dev, cfg, log=log)


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


def unfused_and_ac(work, frames, fused_epochs, sb_checked):
    """Phase 7: the unfused trainer with the mid-test, then the AC wire;
    every K11 shape it launches must be among ``sb_checked``."""
    from linr_pcgc_tpu_torch import cli
    from linr_pcgc_tpu_torch.ops import wgrad

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
    sb_seen = set()
    with record_shapes(wgrad, "wgrad_sb", sb_seen, k11_sb_key):
        ustats = cli.main(uargv)
    torch.cuda.synchronize()
    counts = launches()
    require_checked(sb_seen, sb_checked, "K11", "phase 7's path")
    log(f"phase 7: unfused training (--block_layers {UNFUSED_LAYERS}, --mid_test True "
        f"--check_freq 1) + rANS encode + decode, launches {counts}")
    require_launched(counts, ("K1", "K2", "K3", "K4", "K5", "K6", "K11"), "unfused training path")
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


def gather_library_args(x, idx, w):
    """K10's library yardstick, built outside the timed call: x's rows with
    one zero row appended, the (N, K) index of every tap's source row (the
    zero row where the tap is absent) and w as a (K * Cin, Cout) matrix, so
    that ``torch.addmm(b, torch.index_select(rows, 0, idx).view(N, K * Cin),
    w2)`` is the conv.  The port never calls it."""
    n = x.shape[0]
    rows = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    idx_nk = torch.where(idx >= 0, idx, n).T.reshape(-1).contiguous()
    return rows, idx_nk, w.reshape(-1, w.shape[2]).contiguous()


def check_gather_conv(lev, dev):
    """Phase 8: K10 against its plain version on frame 0's level-0 geometry
    at every case of GATHER_CASES, forward (with bias) and, where the case
    says so, dx (Cin and Cout swapped, no bias), within 1e-5 of the L1 scale
    (the same products summed in another order), the same bits from two
    launches; each case timed.  Returns the record of the headline case (K
    27, Cin = Cout = 8) and the set of (K, Cin, Cout) checked."""
    from linr_pcgc_tpu_torch.data.dataset import level_arrays_from_coords
    from linr_pcgc_tpu_torch.ops import gather_conv as gc

    gen = torch.Generator(device=dev).manual_seed(8)
    maps, checked = {}, set()
    for k, d, *_ in GATHER_CASES:
        if (k, d) not in maps:
            maps[k, d] = level_arrays_from_coords(lev.coords, lev.n, k, (d,), dev)[3].T.contiguous()
    n = lev.coords.shape[0]
    log(f"K10 checks on frame 0's level 0: {lev.n} voxels in a bucket of {n} rows")
    record = None
    for k, d, cin, cout, dx in GATHER_CASES:
        idx = maps[k, d]
        kv = idx.shape[0]
        present = int((idx >= 0).sum())
        worst = 0.0
        for ci, co, bias in ((cin, cout, True), (cout, cin, False))[: 1 + dx]:
            checked.add((kv, ci, co))
            x = torch.randn((n, ci), generator=gen, device=dev)
            w = torch.randn((kv, ci, co), generator=gen, device=dev) * (ci * kv) ** -0.5
            b = torch.randn((co,), generator=gen, device=dev) if bias else None
            y = gc.gather_conv(x, idx, w, b)
            y_again = gc.gather_conv(x, idx, w, b)
            want = gc.gather_conv_plain(x, idx, w, b)
            scale = gc.gather_conv_plain(x.abs(), idx, w.abs(), None if b is None else b.abs())
            torch.cuda.synchronize()
            if not torch.equal(y, y_again):
                raise AssertionError(f"two launches of K10 differ at K={kv} d={d} Cin={ci} Cout={co}")
            err = (y - want).abs()
            if not bool(torch.isfinite(y).all()) or bool((err > 1e-5 * scale + 1e-6).any()):
                raise AssertionError(f"K10 differs from its plain version at K={kv} d={d} Cin={ci} "
                                     f"Cout={co}: max abs err {err.max().item()}")
            worst = max(worst, err.max().item())
            del y_again, want, scale, err
        # time the forward of the case (x, w, b of its first pass)
        x = torch.randn((n, cin), generator=gen, device=dev)
        w = torch.randn((kv, cin, cout), generator=gen, device=dev) * (cin * kv) ** -0.5
        b = torch.randn((cout,), generator=gen, device=dev)
        ms = device_ms(lambda: gc.gather_conv(x, idx, w, b))
        plain = cuda_ms(lambda: gc.gather_conv_plain(x, idx, w, b), 3)
        rows, idx_nk, w2 = gather_library_args(x, idx, w)
        lib = lambda: torch.addmm(b, torch.index_select(rows, 0, idx_nk).view(n, -1), w2)  # noqa: E731
        y = gc.gather_conv(x, idx, w, b)
        lib_err = (lib() - y).abs().max().item()
        lib_ms = cuda_ms(lib, 10)
        del rows, idx_nk, w2
        # each input read once, the output written once; the FMAs of the
        # present taps only (the kernel skips absent ones)
        b_ms, b_by = bound(4 * (idx.numel() + x.numel() + w.numel() + b.numel() + y.numel()),
                           2.0 * cin * cout * present, torch.float32)
        log(f"  K={kv:3d} d={d} Cin={cin} Cout={cout} ({present / lev.n:.2f} present taps a "
            f"voxel): K10 {ms:.4f} ms device (plain {plain:.4f}, library {lib_ms:.4f} [max abs diff "
            f"{lib_err:.3g}], bound {b_ms:.4f} by {b_by}, {100 * b_ms / ms:.1f} % of it); max abs "
            f"err {worst:.3g} ({'forward and dx' if dx else 'forward'}), the same bits twice")
        if (k, d, cin, cout) == (3, 1, 8, 8):
            record = dict(name="gather_conv", route="cuda",
                          source="linr_pcgc_tpu_torch/csrc/gather_conv.cu",
                          replaces="linr_pcgc_tpu/models/network.py:395",
                          ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          max_abs_err=worst, shape=f"N={n} K={kv} Cin={cin} Cout={cout} f32")
        del x, w, b, y
    return record, checked


def check_wgrad_gather(lev, dev):
    """Phase 8: K11's gather form against its plain version on frame 0's
    level-0 geometry at every case of GATHER_WGRAD_CASES (K 1: no map; K 27
    and 125: the neighbour maps), within 1e-5 of the L1 scale sum |x| |dy|
    (the same products summed in another order), the same bits from two
    launches; K 1 and the headline case (K 27, Cin = Cout = 8) timed.
    Returns the headline record and the set of (K, Cin, Cout) checked."""
    from linr_pcgc_tpu_torch.data.dataset import level_arrays_from_coords
    from linr_pcgc_tpu_torch.ops import wgrad

    gen = torch.Generator(device=dev).manual_seed(9)
    maps = {k: level_arrays_from_coords(lev.coords, lev.n, round(k ** (1 / 3)), (1,), dev)[3]
            .T.contiguous() for k in (27, 125)}
    n = lev.coords.shape[0]
    checked, record, worst = set(), None, 0.0
    log(f"K11 (gather form) checks on frame 0's level 0: N = {n}, (K, Cin, Cout) in "
        f"{GATHER_WGRAD_CASES}")
    for k, cin, cout in GATHER_WGRAD_CASES:
        idx = maps.get(k)
        x = torch.randn((n, cin), generator=gen, device=dev)
        dy = torch.randn((n, cout), generator=gen, device=dev)
        dw = wgrad.wgrad_gather(x, dy, idx)
        dw_again = wgrad.wgrad_gather(x, dy, idx)
        want = wgrad.wgrad_gather_plain(x, dy, idx)
        scale = wgrad.wgrad_gather_plain(x.abs(), dy.abs(), idx)
        torch.cuda.synchronize()
        if not torch.equal(dw, dw_again):
            raise AssertionError(f"two launches of K11 differ at K={k} Cin={cin} Cout={cout}")
        err = (dw - want).abs()
        if not bool(torch.isfinite(dw).all()) or bool((err > 1e-5 * scale + 1e-6).any()):
            raise AssertionError(f"K11 differs from its plain version at K={k} Cin={cin} "
                                 f"Cout={cout}: max abs err {err.max().item()}")
        worst = max(worst, err.max().item())
        checked.add((k, cin, cout))
        if (k, cin, cout) in ((1, 8, 24), (27, 8, 8), (125, 8, 8)):
            present = n if idx is None else int((idx >= 0).sum())
            ms = device_ms(lambda: wgrad.wgrad_gather(x, dy, idx))
            plain = cuda_ms(lambda: wgrad.wgrad_gather_plain(x, dy, idx), 3)
            if idx is None:
                lib = lambda: torch.matmul(x.t(), dy)  # noqa: E731
                n_idx = 0
            else:  # the library's gather, then its batched product
                rows = torch.cat([x, x.new_zeros((1, cin))])
                flat = torch.where(idx >= 0, idx, n).reshape(-1).contiguous()
                lib = lambda: torch.matmul(  # noqa: E731
                    torch.index_select(rows, 0, flat).view(k, n, cin).transpose(1, 2), dy)
                n_idx = idx.numel()
            lib_ms = cuda_ms(lib, 5)
            # each input read once, dw written once; 2 Cin Cout flops a
            # present (tap, node) pair
            b_ms, b_by = bound(4 * (n_idx + x.numel() + dy.numel() + dw.numel()),
                               2.0 * present * cin * cout,
                               torch.float32)
            if idx is None:  # the ring form at S = 1
                plan = wgrad.ring_plan(n, 1, cin, cout, 4)
                form = f"ring form, {plan.blocks} blocks, {plan.nst} slots of {plan.tb} bricks"
            else:
                plan = wgrad.gather_plan(n, k, cin, cout)
                form = f"{plan.blocks} x {plan.groups} blocks of {plan.per_block} nodes"
            log(f"  K={k:3d} Cin={cin} Cout={cout}: K11 {ms:.4f} ms device (plain {plain:.4f}, "
                f"library {lib_ms:.4f}, bound {b_ms:.4f} by {b_by}, {100 * b_ms / ms:.1f} % of it; "
                f"{form}); max abs err {err.max().item():.3g}, the same bits twice")
            if (k, cin, cout) == (27, 8, 8):
                record = dict(name="wgrad_gather", route="cuda",
                              source="linr_pcgc_tpu_torch/csrc/wgrad.cu",
                              replaces="linr_pcgc_tpu/models/network.py:431",
                              ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms, max_abs_err=err.max().item(),
                              shape=f"N={n} K={k} Cin={cin} Cout={cout} f32")
        del x, dy, dw, dw_again, want, scale, err
    log(f"K11 (gather form): worst max abs err {worst:.3g}")
    return record, checked


class record_shapes:
    """Within the block, every call of ``module.<attr>`` (a kernel's
    wrapper, or the name a caller reaches it by) adds ``key(*args)`` to the
    set given; the wrapper runs as before, and its launch count, which it
    keeps on its own name, reads and writes through to it."""

    def __init__(self, module, attr: str, seen: set, key):
        self.module, self.attr, self.seen, self.key = module, attr, seen, key

    def __enter__(self):
        self.wrapper = getattr(self.module, self.attr)
        setattr(self.module, self.attr, _ShapeRecorder(self.wrapper, self.seen, self.key))

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.wrapper)


@contextlib.contextmanager
def gather_shapes(seen: set, wseen: set):
    """K10's (K, Cin, Cout) and K11's gather-form (K, Cin, Cout) of every
    call within the block."""
    from linr_pcgc_tpu_torch.ops import gather_conv as gc, wgrad

    with record_shapes(gc, "gather_conv", seen, lambda x, idx, w, b=None: tuple(w.shape)), \
            record_shapes(wgrad, "wgrad_gather", wseen, lambda x, dy, idx=None: (
                1 if idx is None else idx.shape[0], x.shape[1], dy.shape[1])):
        yield


class _ShapeRecorder:
    def __init__(self, wrapper, seen: set, key):
        self.wrapper, self.seen, self.key = wrapper, seen, key

    def __call__(self, *args, **kwargs):
        self.seen.add(self.key(*args, **kwargs))
        return self.wrapper(*args, **kwargs)

    @property
    def launches(self):
        return self.wrapper.launches

    @launches.setter
    def launches(self, n):
        self.wrapper.launches = n


def gather_phase(work, frames, pyrs, dev):
    """Phase 8: K10's and K11's checks, then the gather backend through the
    CLI: training at --outstage GATHER_OUTSTAGE with encode + decode, frame 0
    at --hidden_channel_conv GATHER_WIDE, and dilation serving.  Returns
    (K10's and K11's gather-form records, their launches in training and
    serving)."""
    from linr_pcgc_tpu_torch import cli
    from linr_pcgc_tpu_torch.models import ModelConfig, init_params
    from linr_pcgc_tpu_torch.runtime import save_checkpoint

    n = TRAIN_GOP
    t_phase = time.perf_counter()
    record, checked = check_gather_conv(pyrs[0].levels[0], dev)
    wrecord, wchecked = check_wgrad_gather(pyrs[0].levels[0], dev)
    seen, wseen = set(), set()
    torch.cuda.empty_cache()
    gdirs = ["--result_dir", os.path.join(work, "gout"), "--handle_dir",
             os.path.join(work, "gcache"), "--scale_num", str(SCALE_NUM), "--encode_dir",
             os.path.join(work, "genc"), "--outstage", str(GATHER_OUTSTAGE)]
    common = ["--frame_num", str(n), "--gop_size", str(n), "--ori_dir",
              os.path.join(work, "ply_train"), "--decode_dir", os.path.join(work, "gdec"), *gdirs]
    torch.cuda.synchronize()
    reset_launches()
    with gather_shapes(seen, wseen):
        tstats = cli.main(["--overfit", "True", "--encode", "False", "--decode", "False",
                           "--first_epoch", str(FIRST_EPOCH), *common])
    torch.cuda.synchronize()
    train = launches()
    reset_launches()
    with gather_shapes(seen, wseen):
        sstats = cli.main(["--overfit", "False", "--encode", "True", "--decode", "True", *common])
    serve = launches()
    log(f"phase 8: gather training (--outstage {GATHER_OUTSTAGE}) launches {train}; its encode + "
        f"decode {serve}")
    require_launched(train, ("K10", "K11"), "gather training path")
    require_launched(serve, ("K10",), "gather serving path")
    for counts, what in ((train, "gather training path"), (serve, "gather serving path")):
        if any(counts[k] for k in ("K1", "K2", "K3", "K4", "K5", "K6")):
            raise AssertionError(f"the {what} launched a superbrick kernel: {counts}")
    check_lossless(os.path.join(work, "gdec"), frames[:n], "decode after gather training")
    with open(os.path.join(work, "gout", f"gop_0_{n - 1}", "result.json")) as f:
        entries = json.load(f)
    log_epochs(entries, n, f"gather (outstage {GATHER_OUTSTAGE}) gop_0_1")
    if not entries[-1]["loss"] < entries[0]["loss"]:
        raise AssertionError(f"the gather trainer's last-epoch loss {entries[-1]['loss']} is not "
                             f"below its first {entries[0]['loss']}")
    sa_argv = ["--decode", "True", "--ori_dir", os.path.join(work, "absent"),
               "--decode_dir", os.path.join(work, "gdec_sa"), *gdirs]
    sa = cli.main(sa_argv)
    check_lossless(os.path.join(work, "gdec_sa"), frames[:n], "standalone gather decode")
    steps = FIRST_EPOCH * n
    log(f"  gather: {sstats['bits'] / sstats['points']:.6f} bits/point (all streams), enc "
        f"{sstats['enc_s'] / n:.4f} s/frame, decode with the ground truth {sstats['dec_s'] / n:.4f}"
        f" s/frame, standalone decode {sa['dec_s'] / n:.4f} s/frame, lossless; K10 launches "
        f"{train['K10'] / steps:.1f} and K11 {train['K11'] / steps:.1f} per frame step, "
        f"{serve['K10']} K10 in encode + decode")
    profile_decode(sa_argv)
    profile_train(pyrs, dev, ModelConfig(scale_num=SCALE_NUM, outstage=GATHER_OUTSTAGE))

    # frame 0 at hidden_channel_conv GATHER_WIDE: K10 at Cout 16 and 8, K11
    # at the wider convs' widths; one epoch, encode, decode, standalone decode
    wdirs = ["--result_dir", os.path.join(work, "wout"), "--handle_dir",
             os.path.join(work, "wcache"), "--scale_num", str(SCALE_NUM), "--encode_dir",
             os.path.join(work, "wenc"), "--outstage", str(GATHER_OUTSTAGE),
             "--hidden_channel_conv", str(GATHER_WIDE)]
    reset_launches()
    with gather_shapes(seen, wseen):
        wstats = cli.main(["--overfit", "True", "--encode", "True", "--decode", "True",
                           "--first_epoch", "1", "--frame_num", "1", "--gop_size", "1",
                           "--ori_dir", os.path.join(work, "ply_train"), "--decode_dir",
                           os.path.join(work, "wdec"), *wdirs])
        wide = launches()
        wsa = cli.main(["--decode", "True", "--ori_dir", os.path.join(work, "absent"),
                        "--decode_dir", os.path.join(work, "wdec_sa"), *wdirs])
    require_launched(wide, ("K10", "K11"), f"hidden_channel_conv {GATHER_WIDE} path")
    check_lossless(os.path.join(work, "wdec"), frames[:1], f"hidden_channel_conv {GATHER_WIDE} decode")
    check_lossless(os.path.join(work, "wdec_sa"), frames[:1],
                   f"hidden_channel_conv {GATHER_WIDE} standalone decode")
    with open(os.path.join(work, "wout", "gop_0_0", "result.json")) as f:
        wentries = json.load(f)
    log_epochs(wentries, 1, f"gather (outstage {GATHER_OUTSTAGE}, hidden_channel_conv "
                            f"{GATHER_WIDE}) gop_0_0")
    log(f"  hidden_channel_conv {GATHER_WIDE}: {wstats['bits'] / wstats['points']:.6f} bits/point "
        f"(all streams), enc {wstats['enc_s']:.4f} s, decode {wstats['dec_s']:.4f} s, standalone "
        f"decode {wsa['dec_s']:.4f} s, lossless; launches (training + encode + decode) {wide}")

    # dilation serving: one frame from a seeded checkpoint
    ddirs = ["--result_dir", os.path.join(work, "dout"), "--handle_dir",
             os.path.join(work, "dcache"), "--scale_num", str(SCALE_NUM), "--encode_dir",
             os.path.join(work, "denc"), "--block_type", "dilation"]
    cfg = ModelConfig(scale_num=SCALE_NUM, block_type="dilation")
    save_checkpoint(os.path.join(work, "dout", "gop_0_0", "model.npz"), init_params(8807, cfg),
                    None, 0.01, 0, 0.0, 8)
    reset_launches()
    with gather_shapes(seen, wseen):
        dstats = cli.main(["--overfit", "False", "--encode", "True", "--decode", "False",
                           "--frame_num", "1", "--gop_size", "1", "--ori_dir",
                           os.path.join(work, "ply_train"), *ddirs])
    enc_l = launches()
    reset_launches()
    with gather_shapes(seen, wseen):
        dsa = cli.main(["--decode", "True", "--ori_dir", os.path.join(work, "absent"),
                        "--decode_dir", os.path.join(work, "ddec"), *ddirs])
    dec_l = launches()
    log(f"  K10 shapes (K, Cin, Cout) on phase 8's path: {sorted(seen)}")
    log(f"  K11 gather-form shapes (K, Cin, Cout) on phase 8's path: {sorted(wseen)}")
    for kname, got, have in (("K10", seen, checked), ("K11", wseen, wchecked)):
        if got - have:
            raise AssertionError(f"phase 8's path launched {kname} at {sorted(got - have)}, which "
                                 f"its checks against the plain version do not cover")
    require_launched(enc_l, ("K10",), "dilation encode")
    require_launched(dec_l, ("K10",), "dilation decode")
    check_lossless(os.path.join(work, "ddec"), frames[:1], "standalone dilation decode")
    log(f"  dilation serving (1 frame, random weights): {dstats['bits'] / dstats['points']:.6f} "
        f"bits/point, enc {dstats['enc_s']:.4f} s, standalone decode {dsa['dec_s']:.4f} s, "
        f"lossless; K10 launches {enc_l['K10']} (encode), {dec_l['K10']} (decode)")
    log(f"phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return ({"K10": record, "K11g": wrecord},
            {"K10": train["K10"] + serve["K10"], "K11g": train["K11"]})


def parallel_phase(work, frames, pyrs, dev, fused_epochs, serve_bpp, serve_dirs, codec_checked):
    """Phase 9: the parallel trainers on PAR_RANKS ranks sharing the card
    over gloo, and the stage probability producer."""
    from linr_pcgc_tpu_torch import cli
    from linr_pcgc_tpu_torch.models import ModelConfig, flatten_params, init_params
    from linr_pcgc_tpu_torch.ops import superbricks as sb
    from linr_pcgc_tpu_torch.parallel import train_parallel
    from linr_pcgc_tpu_torch.runtime import TrainConfig

    t_phase = time.perf_counter()
    n = TRAIN_GOP
    ids = ",".join("0" * PAR_RANKS)
    # (a) stage-parallel training of the training cell's GOP 0, held to the
    # one-device run of phase 5 (the same frames, init_params(8807), bf16)
    cfg = ModelConfig(scale_num=SCALE_NUM)
    run = dict(backend="sb_sp", cfg=cfg, tc=TrainConfig(), pyramids=pyrs[:n],
               flat=flatten_params(init_params(8807, cfg)).numpy(), epochs=FIRST_EPOCH,
               dtype="bf16")
    t0 = time.perf_counter()
    got = train_parallel([run], PAR_RANKS, device_ids=[0] * PAR_RANKS)[0]
    wall = time.perf_counter() - t0
    log(f"phase 9: sb_sp on {PAR_RANKS} ranks sharing cuda:0 over {got['transport']}, "
        f"{n} frames x {FIRST_EPOCH} epochs in {wall:.3f} s (spawn and set-up included; the "
        f"ranks share one card, so this is no speedup); launches per rank {got['launches']}; "
        f"parameters identical on every rank: {got['identical']}")
    for r, counts in enumerate(got["launches"]):
        require_launched(counts, ("K1", "K2", "K3", "K4", "K11"), f"sb_sp rank {r}")
    if not got["identical"] or got["transport"] != "gloo":
        raise AssertionError(f"sb_sp ranks: identical {got['identical']}, {got['transport']}")
    for e, (losses, one) in enumerate(zip(got["losses"], fused_epochs)):
        mean = float(np.mean(losses))
        rel = abs(mean - one["loss"]) / one["loss"]
        log(f"  sb_sp epoch {e}: loss {mean:.6f} (frames {np.round(losses, 6).tolist()}); the "
            f"one-device trainer {one['loss']:.6f}, relative difference {rel:.3g}")
        if rel > SP_LOSS_RTOL[min(e, 1)]:
            raise AssertionError(f"sb_sp epoch {e} loss {mean} is not within "
                                 f"{SP_LOSS_RTOL[min(e, 1)]} of the one-device {one['loss']}")

    # (b) the CLI's GOP-parallel path: GOP 0 stage-parallel, GOPs 1-2 side
    # by side in one wave of lanes, then encode + decode in this process
    pdirs = ["--result_dir", os.path.join(work, "pout"), "--handle_dir",
             os.path.join(work, "pcache"), "--scale_num", str(SCALE_NUM), "--encode_dir",
             os.path.join(work, "penc")]
    reset_launches()
    t0 = time.perf_counter()
    pstats = cli.main(["--overfit", "True", "--encode", "True", "--decode", "True",
                       "--devices", str(PAR_RANKS), "--parallel", "gop", "--device_ids", ids,
                       "--frame_num", str(N_TRAIN_FRAMES), "--gop_size", "1",
                       "--first_epoch", str(FIRST_EPOCH), "--others_epoch", str(OTHERS_EPOCH),
                       "--ori_dir", os.path.join(work, "ply_train"), "--decode_dir",
                       os.path.join(work, "pdec"), *pdirs])
    wall = time.perf_counter() - t0
    serve = launches()
    check_lossless(os.path.join(work, "pdec"), frames, "decode after GOP-parallel training")
    require_launched(serve, ("K1", "K2", "K5", "K6"), "encode + decode after GOP-parallel training")
    for g in range(N_TRAIN_FRAMES):
        with open(os.path.join(work, "pout", f"gop_{g}_{g}", "result.json")) as f:
            entries = json.load(f)
        last = entries[-1]  # each rank's launches at the end of its training
        ranks = last["rank_launches"]
        log_epochs(entries, 1, f"gop-parallel gop_{g}_{g} ({last['backend']}, {len(ranks)} "
                               f"rank(s), {last['transport']})")
        log(f"    launches per rank: {ranks}")
        for r, counts in enumerate(ranks):
            require_launched(counts, ("K1", "K2", "K3", "K4", "K11"), f"gop_{g}_{g} rank {r}")
    log(f"  GOP-parallel CLI run: {pstats['bits'] / pstats['points']:.6f} bits/point (all "
        f"streams), lossless; train {pstats['train_s']:.3f} s (spawns included), enc "
        f"{pstats['enc_s'] / N_TRAIN_FRAMES:.4f}, dec {pstats['dec_s'] / N_TRAIN_FRAMES:.4f} "
        f"s/frame; whole run {wall:.3f} s; encode + decode launches {serve}")

    # (c) the stage producer: the serving GOP encoded under
    # LINR_CODEC_PROBS=stage, decoded standalone under the default (the
    # decoder adopts the encoder's producer); K1 and K2 at every shape it
    # launches must be among phase 2's checks
    seen = set()
    k1_key = lambda h, w, c, o, *rest: ("K1", h.shape[1], c, o, h.dtype)  # noqa: E731
    k2_key = lambda x, nbr27: ("K2", x.shape[1], x.shape[2] // 64, x.dtype)  # noqa: E731
    sdirs = [*serve_dirs[:2], "--encode_dir", os.path.join(work, "senc"), *serve_dirs[4:]]
    os.environ["LINR_CODEC_PROBS"] = "stage"
    try:
        reset_launches()
        with record_shapes(sb, "plane_matmul_bm", seen, k1_key), \
                record_shapes(sb, "b4_halo_sm", seen, k2_key):
            sstats = cli.main(["--overfit", "False", "--encode", "True", "--decode", "False",
                               "--frame_num", str(N_FRAMES), "--gop_size", str(N_FRAMES),
                               "--ori_dir", os.path.join(work, "ply"), *sdirs])
            enc_l = launches()
            os.environ.pop("LINR_CODEC_PROBS")
            reset_launches()
            sa = cli.main(["--decode", "True", "--ori_dir", os.path.join(work, "absent"),
                           "--decode_dir", os.path.join(work, "sdec"), *sdirs])
            dec_l = launches()
    finally:
        os.environ.pop("LINR_CODEC_PROBS", None)
    with open(os.path.join(work, "senc", f"gop_0_{N_FRAMES - 1}", "side_info.json")) as f:
        probs = json.load(f)["numerics"]["probs"]
    check_lossless(os.path.join(work, "sdec"), frames[:N_FRAMES], "standalone stage decode")
    require_launched(enc_l, ("K1", "K2", "K5"), "stage encode")
    require_launched(dec_l, ("K1", "K2", "K6"), "stage decode")
    unchecked = seen - codec_checked
    log(f"  K1 / K2 shapes (S, C[, O], dtype) of the stage producer: "
        f"{sorted(str(k) for k in seen)}")
    if unchecked:
        raise AssertionError(f"the stage producer launched {sorted(map(str, unchecked))}, which "
                             "phase 2's checks against the plain versions do not cover")
    sbpp = sstats["bits"] / sstats["points"]
    rel = abs(sbpp - serve_bpp) / serve_bpp
    log(f"  stage producer (numerics probs {probs!r}): {sbpp:.6f} bits/point (all streams) "
        f"against the fused producer's {serve_bpp:.6f} (relative {rel:.3g}); enc "
        f"{sstats['enc_s'] / N_FRAMES:.4f}, standalone decode {sa['dec_s'] / N_FRAMES:.4f} "
        f"s/frame, lossless; launches encode {enc_l}, decode {dec_l}")
    if probs != "stage" or rel > 1e-4:
        raise AssertionError(f"stage producer: numerics probs {probs!r}, bits/point {sbpp} "
                             f"against the fused {serve_bpp}")

    # (d) NCCL: only where every rank has a card of its own
    if torch.cuda.device_count() >= PAR_RANKS:
        nccl = train_parallel([run], PAR_RANKS)[0]
        log(f"  sb_sp over {nccl['transport']} on {PAR_RANKS} cards: losses "
            f"{[float(np.mean(x)) for x in nccl['losses']]}, launches {nccl['launches']}")
        if nccl["transport"] != "nccl" or not nccl["identical"]:
            raise AssertionError(f"the NCCL run: {nccl['transport']}, identical "
                                 f"{nccl['identical']}")
    else:
        log(f"  the NCCL route was not run: {torch.cuda.device_count()} card(s) visible, it "
            f"needs {PAR_RANKS}")
    log(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")


def bricks_phase(work, frames, dev, codec_checked):
    """Phase 10: the bricks trainer.  K1, K3 and K4 (S = 1, every (C, O) of
    UNFUSED_CONV_SHAPES, f32 and bf16) and K11's superbrick form (S = 1,
    SB_CONV1_SHAPES) against their plain versions and timed at the brick
    batch's first frame (every level in one unit); then
    ``overfit_gop(backend="bricks")`` on the first two training frames for
    BRICK_EPOCHS epochs from ``init_params(seed)`` in bf16, which must launch
    K1-K4 and K11 at checked shapes only and end with a lower loss than it
    started; its checkpoint encoded and decoded through the CLI (lossless);
    and the weight codec's estimates beside its real size."""
    from linr_pcgc_tpu_torch import cli
    from linr_pcgc_tpu_torch.coding import weights
    from linr_pcgc_tpu_torch.data import PyramidDataset
    from linr_pcgc_tpu_torch.models import ModelConfig
    from linr_pcgc_tpu_torch.ops import superbricks as sb, wgrad
    from linr_pcgc_tpu_torch.runtime import TrainConfig, overfit_gop
    from linr_pcgc_tpu_torch.runtime.brick_overfit import assemble_gop_bricks

    n = TRAIN_GOP
    t_phase = time.perf_counter()
    ds = PyramidDataset(frames[:n], scale_num=SCALE_NUM, device=dev)
    batch = assemble_gop_bricks([ds[i] for i in range(n)], dev)
    nbr27, occ_mask = batch.nbr27[0].contiguous(), batch.mask[0] != 0
    log(f"phase 10: the bricks trainer; its batch: {batch.nbr27.shape[1]} bricks a frame, level "
        f"slices {batch.level_slices}; every conv at S = 1")
    del batch
    _, checked = check_backward_kernels(nbr27, occ_mask, (1,), UNFUSED_CONV_SHAPES, dev)
    k11, k11_checked = check_wgrad_sb(occ_mask, {1}, dev, headline_s=1)
    log(f"  K11 at S = 1 {k11['shape']}: {k11['ms']:.4f} ms (plain {k11['plain_ms']:.4f}, library "
        f"{k11['library_ms']:.4f}, bound {k11['bound_ms']:.4f} by {k11['bound_by']})")
    del nbr27, occ_mask
    torch.cuda.empty_cache()

    seen, k11_seen = set(), set()
    k1_key = lambda h, w, c, o, *rest: ("K1", h.shape[1], c, o, h.dtype)  # noqa: E731
    k2_key = lambda x, nbr27: ("K2", x.shape[1], x.shape[2] // 64, x.dtype)  # noqa: E731
    k3_key = lambda g, wt, kc, no: ("K3", g.shape[1], no, kc, g.dtype)  # noqa: E731
    k4_key = lambda x, g, c, o: ("K4", x.shape[1], c, o, x.dtype)  # noqa: E731
    out = os.path.join(work, "bout")
    bdirs = ["--result_dir", out, "--handle_dir", os.path.join(work, "bcache"),
             "--scale_num", str(SCALE_NUM)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with record_shapes(sb, "plane_matmul_bm", seen, k1_key), \
            record_shapes(sb, "b4_halo_sm", seen, k2_key), \
            record_shapes(sb, "plane_matmul", seen, k3_key), \
            record_shapes(sb, "plane_moment_dw", seen, k4_key), \
            record_shapes(wgrad, "wgrad_sb", k11_seen, k11_sb_key):
        path = overfit_gop(ds, list(range(n)), BRICK_EPOCHS, ModelConfig(scale_num=SCALE_NUM),
                           TrainConfig(), out, handle_dir=os.path.join(work, "bcache"),
                           device=dev, backend="bricks")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    log(f"phase 10: bricks training ({BRICK_EPOCHS} epochs, bf16) launches {counts}, "
        f"{wall:.3f} s (brickify included)")
    require_launched(counts, ("K1", "K2", "K3", "K4", "K11"), "bricks training path")
    require_checked(seen, checked | codec_checked, "K1-K4", "phase 10's path")
    require_checked(k11_seen, k11_checked, "K11", "phase 10's path")
    with open(os.path.join(out, f"gop_0_{n - 1}", "result.json")) as f:
        entries = json.load(f)
    log_epochs(entries, n, f"bricks gop_0_{n - 1}")
    if not entries[-1]["loss"] < entries[0]["loss"]:
        raise AssertionError(f"the bricks trainer's last-epoch loss {entries[-1]['loss']} is not "
                             f"below its first {entries[0]['loss']}")

    reset_launches()
    stats = cli.main(["--overfit", "False", "--encode", "True", "--decode", "True",
                      "--frame_num", str(n), "--gop_size", str(n), "--ori_dir",
                      os.path.join(work, "ply_train"), "--encode_dir", os.path.join(work, "benc"),
                      "--decode_dir", os.path.join(work, "bdec"), *bdirs])
    check_lossless(os.path.join(work, "bdec"), frames[:n], "decode after bricks training")
    log(f"  bricks checkpoint on the rANS wire: {stats['bits'] / stats['points']:.6f} bits/point "
        f"(all streams), lossless, enc {stats['enc_s'] / n:.4f}, dec {stats['dec_s'] / n:.4f} "
        f"s/frame, launches {launches()}")

    flat = np.load(path)["params"]
    real = weights.compress_params(flat, 8)
    est, sizes = weights.estimate_bits(flat, 8), weights.compare_methods(flat, 8)
    blob = 8 * os.path.getsize(os.path.join(work, "benc", f"gop_0_{n - 1}", "bins", "model.bin"))
    chosen = sizes[("bit_tobyte", "bit_zlib", "bit_laplace")[real["enc_mode"]]]
    log(f"  weights ({len(flat)} parameters, bitdepth 8): the codec's model.bin {blob} bits, its "
        f"bit_real {real['bit_real']:.1f} (mode {real['enc_mode']}); compare_methods "
        f"{ {k: float(v) for k, v in sizes.items()} }; estimate_bits: mode {est['enc_mode']}, "
        f"{est['bit_real']:.1f} bits ({est['bpp_real']:.4f} bits/param, Laplace "
        f"{est['laplace_bpp']:.4f}, zlib {est['zlib_bpp']:.4f})")
    if not (math.isclose(chosen, real["bit_real"], rel_tol=1e-12)
            and math.isclose(blob + real["side_info_bit"], real["bit_real"], rel_tol=1e-12)):
        raise AssertionError(f"compare_methods' size of mode {real['enc_mode']} ({chosen}) or "
                             f"model.bin ({blob} + {real['side_info_bit']} side bits) is not the "
                             f"codec's bit_real {real['bit_real']}")
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")


def check_recorded_convs(seen, nbrs, dev):
    """K2 and K1 at every (Bb, S, C[, O], dtype) in ``seen`` (a path's
    launches, K2's with the first nbr27 it had at that Bb in ``nbrs``),
    against their plain versions on seeded inputs, each for the same bits
    from two launches: K2 bit for bit, K1 as in check_kernels."""
    from linr_pcgc_tpu_torch.ops import plane_conv, superbricks as sb

    gen = torch.Generator(device=dev).manual_seed(21)
    for key in sorted(seen, key=str):
        if key[0] == "K2":
            _, bb, s, c, dtype = key
            x = torch.randn((bb, s, 64 * c), generator=gen, device=dev).to(dtype)
            h, h_again = sb.b4_halo_sm(x, nbrs[bb]), sb.b4_halo_sm(x, nbrs[bb])
            if not (torch.equal(h, h_again) and torch.equal(h, sb.b4_halo_sm_plain(x, nbrs[bb]))):
                raise AssertionError(f"K2 differs from its plain version or itself at {key}")
            continue
        _, bb, s, c, o, dtype = key
        x = torch.randn((bb, s, 64 * c), generator=gen, device=dev).to(dtype)
        h = sb.b4_halo_sm_plain(x, nbrs[bb])
        w = (torch.randn((s, 27, c, o), generator=gen, device=dev) * (c * 27) ** -0.5).to(dtype)
        bias = torch.randn((s, o), generator=gen, device=dev).repeat(1, 64).to(dtype).contiguous()
        mask = (torch.rand((bb, 64), generator=gen, device=dev) < 0.5).to(dtype)
        y = plane_conv.plane_matmul_bm(h, w, c, o, bias, mask)
        y_again = plane_conv.plane_matmul_bm(h, w, c, o, bias, mask)
        y_plain = plane_conv.plane_matmul_bm_plain(h, w, c, o, bias, mask)
        err = (y.float() - y_plain.float()).abs()
        tol = (1e-5 + 1e-5 * y_plain.float().abs()) if dtype == torch.float32 else \
            (1e-4 + 2.0**-7 * y_plain.float().abs())
        if not torch.equal(y, y_again) or bool((err > tol).any()) or not bool(y.isfinite().all()):
            raise AssertionError(f"K1 differs from its plain version or itself at {key}: max abs "
                                 f"err {err.max().item()}")
        del x, h, y, y_again, y_plain, err, tol
    log(f"  K1 and K2 checked, each against its plain version and for the same bits twice, "
        f"at {len(seen)} shapes: {sorted(map(str, seen))}")


def time_k1_k2(nbr27, occ_mask, s, c, o, dtype, what):
    """K1 and K2 timed by conv_times at one shape on seeded inputs (x zero
    at the empty slots of ``occ_mask``), K2 first checked bit for bit
    there; logs one line."""
    from linr_pcgc_tpu_torch.ops import superbricks as sb

    bb = nbr27.shape[0]
    gen = torch.Generator(device=nbr27.device).manual_seed(3)
    mask = occ_mask.to(dtype).contiguous()
    x = (torch.randn((bb, s, 64 * c), generator=gen, device=nbr27.device)
         * mask.float().repeat_interleave(c, 1)[:, None]).to(dtype)
    w = (torch.randn((s, 27, c, o), generator=gen, device=nbr27.device) * (c * 27) ** -0.5).to(dtype)
    bias = torch.randn((s, o), generator=gen, device=nbr27.device).repeat(1, 64).to(dtype).contiguous()
    h_plain = sb.b4_halo_sm_plain(x, nbr27)
    if not torch.equal(sb.b4_halo_sm(x, nbr27), h_plain):
        raise AssertionError(f"K2 differs from its plain version at {what}")
    t = conv_times(x, h_plain, w, bias, mask, nbr27, c, o)
    log(f"  {what}, Bb={bb} S={s} C={c} O={o} {str(dtype)[6:]}: K1 {t['k1_ms']:.4f} ms (plain "
        f"{t['k1_plain']:.4f}, library {t['k1_lib']:.4f}, bound {t['k1_b']:.4f} by {t['k1_by']}) | "
        f"K2 {t['k2_ms']:.4f} ms (plain {t['k2_plain']:.4f}, library {t['k2_lib']:.4f}, bound "
        f"{t['k2_b']:.4f} by {t['k2_by']}, {100 * t['k2_b'] / t['k2_ms']:.1f} % of it)")
    return t


def sb_phase(frames, pyrs, dev, serve_stats, fused_epochs, codec_checked):
    """Phase 11: the host-AC superbrick codec at each of SB_CODEC_SIDES on
    the serving frames, with phase 3's dequantized checkpoint
    (``encode_gop_streams_sb`` -> ``decode_gop_streams_sb``: lossless, its
    rate against the other side's and phase 3's, every K1 and K2 shape it
    launches checked); the side-8 trainer on the training cell's first two
    frames (``assemble_gop_superbricks(side=8)``, SIDE8_EPOCHS epochs of
    ``make_epoch_fn_sb(slots=512)`` from ``init_params(seed)``, bf16: its
    first loss within SIDE8_LOSS_RTOL of phase 5's, falling, K1-K4 and K11
    at checked shapes only); and K1 and K2 timed at the bricks trainer's
    commonest conv (BRICKS_SHAPE on its first frame) and at each codec
    side's level 0 (S 1, C = O = 8, f32)."""
    from linr_pcgc_tpu_torch.coding.weights import compress_params
    from linr_pcgc_tpu_torch.models import (ModelConfig, flatten_params, init_params, param_tree,
                                            params_to_flat, unflatten_params)
    from linr_pcgc_tpu_torch.ops import superbricks as sb, wgrad
    from linr_pcgc_tpu_torch.runtime import TrainConfig, adam_init, codec, sb_overfit
    from linr_pcgc_tpu_torch.runtime.brick_overfit import assemble_gop_bricks

    t_phase = time.perf_counter()
    cfg = ModelConfig(scale_num=SCALE_NUM)
    serve = pyrs[:N_FRAMES]
    points = sum(p.point_num for p in serve)
    # the encoder's weights as encode_gop uses them: the dequantized checkpoint
    recon = compress_params(params_to_flat(init_params(8807, cfg)), 8)["recon"]
    params = param_tree(unflatten_params(cfg, recon, dev))
    serve_bpp = serve_stats["point_bits"] / serve_stats["points"]
    log(f"phase 11: the host-AC superbrick codec on the serving GOP ({points} points); phase 3's "
        f"rANS wire {serve_bpp:.6f} occupancy bits/point")
    rates = {}
    for side in SB_CODEC_SIDES:
        seen, nbrs = set(), {}

        def k2_key(x, nbr27):
            nbrs.setdefault(x.shape[0], nbr27)
            return ("K2", x.shape[0], x.shape[1], x.shape[2] // 64, x.dtype)

        k1_key = lambda h, w, c, o, *rest: ("K1", h.shape[0], h.shape[1], c, o, h.dtype)  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        with record_shapes(sb, "b4_halo_sm", seen, k2_key), \
                record_shapes(sb, "plane_matmul_bm", seen, k1_key):
            t0 = time.perf_counter()
            blobs, bits = codec.encode_gop_streams_sb(params, cfg, serve, dev, side=side)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dec = codec.decode_gop_streams_sb(params, cfg, blobs, [p.low_coords for p in serve],
                                              dev, side=side)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        counts = launches()
        require_launched(counts, ("K1", "K2"), f"side-{side} sb codec")
        for t, (d, p, pts) in enumerate(zip(dec, serve, frames)):
            if not np.array_equal(d + p.coord_min, np.unique(pts, axis=0)):
                raise AssertionError(f"the side-{side} sb codec's decode of frame {t} is not "
                                     "lossless")
        rates[side] = bits / points
        log(f"  side {side}: {rates[side]:.6f} occupancy bits/point ({bits} bits), lossless; enc "
            f"{(t1 - t0) / N_FRAMES:.4f}, dec {(t2 - t1) / N_FRAMES:.4f} s/frame (host clock, "
            f"geometry and AC included); peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; launches {counts}")
        check_recorded_convs(seen, nbrs, dev)
        bb0 = max(nbrs)  # level 0 of both frames
        half = torch.rand((bb0, 64), generator=torch.Generator(device=dev).manual_seed(4),
                          device=dev) < 0.5
        time_k1_k2(nbrs[bb0], half, 1, 8, 8, torch.float32,
                   f"the side-{side} codec's level 0 (a random half of the slots occupied)")
        del seen, nbrs, blobs, dec
        torch.cuda.empty_cache()
    rel = abs(rates[8] - rates[4]) / rates[4]
    log(f"  side 8 against side 4: {rel:.3g} relative (limit {SIDE_RATE_RTOL}); against phase 3's "
        f"rANS wire: side 4 {rates[4] / serve_bpp - 1:+.3g}, side 8 {rates[8] / serve_bpp - 1:+.3g}")
    if rel > SIDE_RATE_RTOL:
        raise AssertionError(f"the sb codec's sides disagree on the rate: {rates}")

    # the side-8 trainer
    tc = TrainConfig()
    n = TRAIN_GOP
    batch = sb_overfit.assemble_gop_superbricks(pyrs[:n], dev, side=8)
    epoch_fn = sb_overfit.make_epoch_fn_sb(cfg, tc, batch.level_slices, torch.bfloat16, slots=512)
    units = epoch_fn.units
    fd0 = sb_overfit.frame_on_sub_bricks(next(sb_overfit.sb_frames(batch)))
    _, gb, cs = units[0]  # the level-0 group starts at sub-brick 0
    log(f"  side-8 batch: {batch.nbr27.shape[1]} superbricks a frame ({8 * batch.nbr27.shape[1]} "
        f"sub-bricks), level slices {batch.level_slices}; trainer units (first sub-brick, end, "
        f"cs) {units}")
    s_conv3 = sorted({u[2] for u in units} | {u[2] + 1 for u in units})
    nbr0 = fd0["nbr27"][:gb].contiguous()
    _, checked = check_backward_kernels(nbr0, fd0["code"][:gb] >= 0, s_conv3, TRAIN_CONV_SHAPES,
                                        dev)
    # K2 on the convs' inputs (check_backward_kernels holds it on dy * mask)
    fwd_k2 = {("K2", gb, s, c, torch.bfloat16) for s in s_conv3 for c, _ in TRAIN_CONV_SHAPES}
    check_recorded_convs(fwd_k2, {gb: nbr0}, dev)
    checked |= {(k, s, c, dt) for k, _, s, c, dt in fwd_k2}
    _, k11_checked = check_wgrad_sb(fd0["code"][:gb] >= 0, {1} | set(s_conv3), dev, headline_s=cs)
    del fd0, nbr0
    torch.cuda.empty_cache()
    seen, k11_seen = set(), set()
    k1_key = lambda h, w, c, o, *rest: ("K1", h.shape[1], c, o, h.dtype)  # noqa: E731
    k2_key = lambda x, nbr27: ("K2", x.shape[1], x.shape[2] // 64, x.dtype)  # noqa: E731
    k3_key = lambda g, wt, kc, no: ("K3", g.shape[1], no, kc, g.dtype)  # noqa: E731
    k4_key = lambda x, g, c, o: ("K4", x.shape[1], c, o, x.dtype)  # noqa: E731
    flat = flatten_params(init_params(8807, cfg, dev))
    opt, lr, k = adam_init(flat), np.float32(tc.learning_rate), 0
    losses, walls, peaks = [], [], []
    torch.cuda.synchronize()
    reset_launches()
    with record_shapes(sb, "plane_matmul_bm", seen, k1_key), \
            record_shapes(sb, "b4_halo_sm", seen, k2_key), \
            record_shapes(sb, "plane_matmul", seen, k3_key), \
            record_shapes(sb, "plane_moment_dw", seen, k4_key), \
            record_shapes(wgrad, "wgrad_sb", k11_seen, k11_sb_key):
        for _ in range(SIDE8_EPOCHS):
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            flat, opt, lr, k, frame_losses = epoch_fn(flat, opt, lr, k, batch)
            losses.append(float(frame_losses.mean()))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated(dev))
    counts = launches()
    for e, (loss, wall, peak) in enumerate(zip(losses, walls, peaks)):
        log(f"  side-8 trainer epoch {e}: loss {loss:.6f} bits/point, {wall / n:.4f} s/frame/epoch, "
            f"peak device memory {peak / 2**30:.3f} GiB")
    log(f"  side-8 training launches {counts}")
    require_launched(counts, ("K1", "K2", "K3", "K4", "K11"), "side-8 training path")
    require_checked(seen, checked | codec_checked, "K1-K4", "phase 11's side-8 trainer")
    require_checked(k11_seen, k11_checked, "K11", "phase 11's side-8 trainer")
    want = fused_epochs[0]["loss"]
    log(f"  its first loss against phase 5's first GOP-0 loss {want:.6f}: "
        f"{losses[0] / want - 1:+.3g} (limit {SIDE8_LOSS_RTOL})")
    if abs(losses[0] - want) > SIDE8_LOSS_RTOL * abs(want):
        raise AssertionError(f"the side-8 trainer's first loss {losses[0]} is not phase 5's {want}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the side-8 trainer's last loss {losses[-1]} is not below its first "
                             f"{losses[0]}")
    del batch, epoch_fn, flat, opt
    torch.cuda.empty_cache()

    # K1 and K2 at the bricks trainer's commonest conv
    bricks = assemble_gop_bricks(pyrs[:n], dev)
    time_k1_k2(bricks.nbr27[0].contiguous(), bricks.mask[0] != 0, *BRICKS_SHAPE,
               "the bricks trainer's conv")
    del bricks
    torch.cuda.empty_cache()
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")


def check_lossless(dec_dir, frames, what):
    from linr_pcgc_tpu_torch.data import read_ply

    for t, pts in enumerate(frames):
        got = read_ply(os.path.join(dec_dir, f"frame{t:04d}.ply"))
        if not np.array_equal(got, np.unique(pts, axis=0)):
            raise AssertionError(f"{what} of frame {t} is not lossless")


def require_checked(seen, checked, kernel, what):
    log(f"  {kernel} shapes on {what}: {sorted(map(str, seen))}")
    if seen - checked:
        raise AssertionError(f"{what} launched {kernel} at {sorted(map(str, seen - checked))}, "
                             "which its checks against the plain version do not cover")


def require_launched(counts, names, what):
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the {what} never launched {missing}")


# K10's and K11's headline records (chip_smoke's keys) and the same cases
# in tools/bench_k10_k11.py's output
PARENT_CASES = {"K11": "K11 sb Bb=81920 S=4 (8, 24) bf16",
                "K11g": "K11 gather N=786432 K=27 (8, 8)",
                "K10": "K10 N=786432 K=27 (8, 8)"}


def parent_times(records, parent: str) -> None:
    """Times the checkout ``parent``'s K10 and K11 at their headline shapes
    (tools/bench_k10_k11.py in a process of its own) and logs each beside
    this run's record: time, bound and share of it; adds ``parent_ms`` to
    the records.  Fails if the parent's run fails or lacks a case."""
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "linr_pcgc_tpu_torch",
                        "tools", "bench_k10_k11.py")
    run = subprocess.run([sys.executable, tool, "--tree", parent], capture_output=True, text=True,
                         timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"the parent's bench_k10_k11.py failed:\n{run.stdout}\n{run.stderr}")
    got = json.loads(run.stdout.strip().splitlines()[-1])["ms"]
    log(f"K10 and K11 beside the parent ({parent}), same run, profiler device time:")
    for key, case in PARENT_CASES.items():
        rec = records[key]
        rec["parent_ms"] = got[case]
        log(f"  {key} {rec['shape']}: {rec['ms']:.4f} ms, parent {got[case]:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ({rec['bound_by']}): {100 * rec['bound_ms'] / rec['ms']:.1f} % "
            f"of it (parent {100 * rec['bound_ms'] / got[case]:.1f} %); plain "
            f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}")
    for case, ms in got.items():
        if case not in PARENT_CASES.values():
            log(f"  parent {case}: {ms:.4f} ms")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port")
    ap.add_argument("--parent", default=None,
                    help="a checkout whose K10 and K11 are timed beside this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from linr_pcgc_tpu_torch import cli
    from linr_pcgc_tpu_torch.coding import ac
    from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud, write_ply_binary
    from linr_pcgc_tpu_torch.models import ModelConfig, init_params, param_count
    from linr_pcgc_tpu_torch.ops import cuda_build, wgrad
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
    records, codec_checked = check_kernels(geo["nbr27"].contiguous(), geo["code"] >= 0, dev)
    records.update(check_rans(geo, counts, cap, tv, dev))
    del geo
    nbr27, occ_mask, cs, cs_unfused, s_conv1 = trainer_level0(pyrs[:TRAIN_GOP], dev)
    train_records, _ = check_backward_kernels(nbr27, occ_mask, (cs, 1 + cs), TRAIN_CONV_SHAPES,
                                              dev, headline_s=1 + cs)
    records.update(train_records)
    check_b4_convsm(nbr27, occ_mask, dev)
    log("the unfused pass's level-0 unit: x_glob at S = 1, stage chunks at S = "
        f"{cs_unfused}")
    check_backward_kernels(nbr27, occ_mask, (1, cs_unfused), UNFUSED_CONV_SHAPES, dev)
    records["K11"], sb_checked = check_wgrad_sb(occ_mask, s_conv1, dev, headline_s=cs)
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
    sb_seen = set()
    t0 = time.perf_counter()
    with record_shapes(wgrad, "wgrad_sb", sb_seen, k11_sb_key):
        tstats = cli.main(targv)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = launches()
    log(f"phase 5: training path launches {train_launches}")
    require_launched(train_launches, ("K1", "K2", "K3", "K4", "K5", "K6", "K11"), "training path")
    require_checked(sb_seen, sb_checked, "K11", "phase 5's path")
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
    unfused_and_ac(work, frames, epochs["gop_0_1"], sb_checked)
    log(f"smoke wall time so far {time.perf_counter() - t_start:.1f} s")

    # 8. the gather backend
    gather_records, gather_launches = gather_phase(work, frames, pyrs[:TRAIN_GOP], dev)
    records.update(gather_records)
    log(f"smoke wall time so far {time.perf_counter() - t_start:.1f} s")

    # 9. multi-device training and the stage probability producer
    torch.cuda.empty_cache()
    parallel_phase(work, frames, pyrs, dev, epochs["gop_0_1"], bpp, dirs, codec_checked)
    log(f"smoke wall time so far {time.perf_counter() - t_start:.1f} s")

    # 10. the bricks trainer
    torch.cuda.empty_cache()
    bricks_phase(work, frames, dev, codec_checked)
    shutil.rmtree(work, ignore_errors=True)
    log(f"smoke wall time so far {time.perf_counter() - t_start:.1f} s")

    # 11. the host-AC superbrick codec at both sides, the side-8 trainer
    torch.cuda.empty_cache()
    sb_phase(frames, pyrs, dev, stats, epochs["gop_0_1"], codec_checked)
    log(f"smoke wall time so far {time.perf_counter() - t_start:.1f} s")
    if args.parent is not None:
        parent_times(records, args.parent)
    else:
        log("K10 and K11 beside a parent: not run (no --parent)")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    # launches on each kernel's path: K1-K6 and K11 training, K7-K9 the
    # probes, K10 the gather backend's training and serving, K11's gather
    # form its training
    path_launches = {**train_launches, **{k: probe_launches[k] for k in ("K7", "K8", "K9")},
                     **gather_launches}
    kernels = []
    for key in sorted(records):
        rec = dict(records[key], launches=path_launches[key])
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
        extra = ("call_ms", "bound_f32_ms", "chain_bound_ms", "chain_cycles_per_step",
                 "sm_clock_mhz", "stage_ms", "stage_call_ms", "stage_plain_ms", "launch_ms",
                 "parent_ms")
        kernels.append({k: rec[k] for k in keys + tuple(e for e in extra if e in rec)})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
