"""Command-line entry point with the JAX package's flag surface (itself the
reference ``main.py``'s), plus ``--device``.

    python -m linr_pcgc_tpu_torch.cli --overfit True --encode True \\
        --decode True --ori_dir data/loot/Ply --handle_dir tmp/loot \\
        --result_dir output/loot --encode_dir result_enc/loot \\
        --decode_dir result_dec/loot --frame_num 32 --gop_size 32

overfits every GOP (GOP 0 for ``--first_epoch`` epochs from
``--pretrain_path`` or fresh weights of ``init_params(--seed)``; every
later GOP for ``--others_epoch`` epochs, warm-started from GOP 0's
checkpoint), writes ``<result_dir>/gop_<a>_<b>/model.npz`` (the JAX npz
layout), encodes every GOP with its checkpoint and decodes it losslessly.
With ``--decode True`` only and no ``--ori_dir`` on disk, every ``gop_*``
under ``--encode_dir`` is decoded from its bitstreams alone.  The port's
``init_params`` draws from a torch generator, so a seed gives other
initial weights than the JAX CLI's.  Boolean flags are the strings
'True'/'False', as in the reference's scripts.

``--devices N`` trains on N ranks, one process each (parallel/): stage-
parallel where N divides ``--outstage`` on the superbrick layout, else
frame-parallel, as the JAX CLI chooses; ``--parallel gop`` trains the warm
GOPs side by side in lanes (``--gop_lanes``).  Rank r runs on ``cuda:r``,
or on the cards ``--device_ids`` names (ids that repeat share a card), or
on the CPU with ``--device cpu``.  Encode and decode then run in this
process on ``--device``.

``--mid_test True`` measures the real rate during training (a real encode
and lossless decode on the arithmetic-coder wire, at every epoch below 10
and every ``--check_freq``-th; ``--write_real_bitstream True`` keeps every
50th epoch's bitstream), as the JAX CLI does.  ``LINR_CODEC_ENTROPY=ac``
codes the GOPs' occupancy with the host arithmetic coder
(``bins/frame{i:04d}_scale{s}.bin``) instead of the device rANS coder.
"""

from __future__ import annotations

import argparse
import glob as globmod
import logging
import os
import shutil
import sys
import time

from .data import PyramidDataset
from .device import resolve_device
from .models import ModelConfig
from .parallel import overfit_gops_parallel
from .runtime import TrainConfig, decode_gop, encode_gop, overfit_gop
from .runtime.codec import _use_sb


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("LINR-PCGC (PyTorch)")
    p.add_argument("--others_epoch", default=100, type=int)
    p.add_argument("--first_epoch", default=100, type=int)
    p.add_argument("--gop_size", type=int, default=4)
    p.add_argument("--frame_num", type=int, default=4)
    p.add_argument("--learning_rate", default=0.01, type=float)
    p.add_argument("--gamma", type=float, default=0.992)
    p.add_argument("--min_lr", type=float, default=4e-4)
    p.add_argument("--decay_rate", type=float, default=1e-4)
    p.add_argument("--step_size", type=int, default=32)
    p.add_argument("--scale_num", type=int)
    p.add_argument("--min_point_num", type=int, default=64)
    p.add_argument("--load", default="False", type=str)
    p.add_argument("--pretrain_path", type=str)
    p.add_argument("--write_pth", type=str, default="True")
    p.add_argument("--seed", type=int, default=8807)
    p.add_argument("--delete_cache", type=str, default="False")
    p.add_argument("--write_real_bitstream", type=str, default="False")
    p.add_argument("--check_freq", type=int, default=5)
    p.add_argument("--resume", type=str, default="False")
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--parallel", type=str, default="sp", choices=("sp", "gop"))
    p.add_argument("--gop_lanes", type=int, default=0)
    p.add_argument("--ori_dir", type=str, default="test_pc")
    p.add_argument("--ori_dtype", type=str, default="ply")
    p.add_argument("--handle_dir", type=str, default="tmp/test_pc")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--result_dir", type=str, default="output/test_pc")
    p.add_argument("--hidden_channel_mlp", type=int, default=24)
    p.add_argument("--mlp_out_channel", type=int, default=10)
    p.add_argument("--hidden_channel_conv", type=int, default=8)
    p.add_argument("--block_layers", type=int, default=1)
    p.add_argument("--block_type", type=str, default="inception",
                   choices=["inception", "resnet", "dilation"])
    p.add_argument("--outstage", type=int, default=8, choices=[8, 4, 3, 2, 1])
    p.add_argument("--instage", type=int, default=1)
    p.add_argument("--model_bitdepth", type=int, default=8)
    p.add_argument("--overfit", type=str, default="False")
    p.add_argument("--mid_test", type=str, default="False")
    p.add_argument("--encode", type=str, default="False")
    p.add_argument("--encode_dir", type=str, default="result_enc/test_pc")
    p.add_argument("--decode", type=str, default="True")
    p.add_argument("--decode_dir", type=str, default="result_dec/test_pc")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the codec runs on; 'cpu' runs the plain "
                        "PyTorch versions of the kernels")
    p.add_argument("--device_ids", type=str, default=None,
                   help="with --devices N: the card of each training rank, comma-separated "
                        "(default 0..N-1); ids that repeat share a card over gloo")
    return p


def gop_groups(frame_num: int, gop_size: int):
    return [list(range(i, min(i + gop_size, frame_num))) for i in range(0, frame_num, gop_size)]


def set_logger(logpath: str, name: str = "linr_pcgc_tpu_torch") -> logging.Logger:
    """Message-only logger to ``logpath`` and stdout."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(message)s")
    for h in (logging.FileHandler(logpath, mode="a", encoding="utf-8"),
              logging.StreamHandler(sys.stdout)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def gop_schedule(args, cfg: ModelConfig, groups: list, logger):
    """The GOPs' training order, as the JAX CLI orders it: -> (GOPs trained
    one after another on all --devices, each (index, frames); waves of warm
    GOPs trained side by side; ranks per GOP in a wave).  With --devices > 1
    --parallel gop on the superbrick layout (and neither --mid_test nor
    --resume): GOP 0 first, then the warm GOPs of full size in waves of
    --gop_lanes (default: one GOP a rank), each lane --devices / --gop_lanes
    ranks training stage-parallel; the ragged tail one after another.
    Otherwise every GOP one after another."""
    gop_par = (args.devices > 1 and args.parallel == "gop" and args.mid_test != "True"
               and args.resume != "True" and _use_sb(cfg))
    if args.devices > 1 and args.parallel == "gop" and not gop_par:
        logger.info("gop-parallel unavailable for this config (needs the superbrick backend, "
                    "no --mid_test/--resume) — falling back to stage-parallel")
    seq = list(enumerate(groups))
    lanes = args.gop_lanes or args.devices
    sp_per_lane = 1
    if gop_par and args.gop_lanes:
        if args.devices % lanes or cfg.outstage % (args.devices // lanes):
            logger.info(f"--gop_lanes {lanes} does not divide --devices {args.devices} into sp "
                        f"lanes dividing outstage {cfg.outstage} — using one GOP per chip")
            lanes = args.devices
        else:
            sp_per_lane = args.devices // lanes
    if not (gop_par and len(groups) > 1):
        return seq, [], sp_per_lane
    full = len(groups[0])
    tail = [(i, g) for i, g in seq[1:] if len(g) != full]
    warm = [(i, g) for i, g in seq[1:] if len(g) == full]
    waves = [warm[a: a + lanes] for a in range(0, len(warm), lanes)]
    return [seq[0]] + tail, waves, sp_per_lane


def decode_standalone(args, logger) -> dict:
    """Decode every GOP under ``encode_dir`` from its bitstreams alone (the
    model configuration comes from side_info.json)."""
    gop_dirs = sorted(
        d for d in globmod.glob(os.path.join(args.encode_dir, "gop_*"))
        if os.path.isdir(os.path.join(d, "bins"))
    )
    if not gop_dirs:
        raise FileNotFoundError(f"no gop_* bitstreams under {args.encode_dir}")
    frames = 0
    t0 = time.perf_counter()
    for enc_dir in gop_dirs:
        name = os.path.basename(enc_dir)
        out = decode_gop(enc_dir, args.decode_dir, cfg=None,
                         gop_start_idx=int(name.split("_")[1]), write_flag=True,
                         logger=logger, device=args.device)
        frames += len(out)
        logger.info(f"{name}: decoded standalone")
    return {"frames": frames, "dec_s": time.perf_counter() - t0}


def run(args, logger=None) -> dict:
    """Overfit, encode and decode every GOP, as the flags ask.  Returns the
    run's totals: frames, points, bits, and the host seconds of the
    training, encode and decode phases."""
    if logger is None:
        logger = logging.getLogger("linr_pcgc_tpu_torch")
        if not logger.handlers:
            logger.addHandler(logging.StreamHandler(sys.stdout))
            logger.setLevel(logging.INFO)
    resolve_device(args.device)

    if (args.decode == "True" and args.encode != "True" and args.overfit != "True"
            and args.mid_test != "True" and not os.path.exists(args.ori_dir)):
        return decode_standalone(args, logger)

    dataset = PyramidDataset(args.ori_dir, handle_dir=args.handle_dir,
                             scale_num=args.scale_num, ori_type=args.ori_dtype,
                             min_point_num=args.min_point_num, device=args.device)
    dataset[0]  # scale_num from frame 0
    logger.info(f"scale_num: {dataset.scale_num}")
    cfg = ModelConfig(
        scale_num=dataset.scale_num,
        in_channel=7,
        hidden_channel_conv=args.hidden_channel_conv,
        hidden_channel_mlp=args.hidden_channel_mlp,
        block_layers=args.block_layers,
        block_type=args.block_type,
        outstage=args.outstage,
        instage=args.instage,
    )
    groups = gop_groups(args.frame_num, args.gop_size)
    gop_names = [f"gop_{g[0]}_{g[-1]}" for g in groups]
    stats = {"frames": args.frame_num, "points": 0, "bits": 0.0, "enc_s": 0.0, "dec_s": 0.0,
             "train_s": 0.0}

    if args.overfit == "True":
        tc = TrainConfig(learning_rate=args.learning_rate, gamma=args.gamma,
                         min_lr=args.min_lr, weight_decay=args.decay_rate,
                         step_size=args.step_size)
        warm = args.pretrain_path if args.pretrain_path and os.path.exists(
            str(args.pretrain_path)) else None
        device_ids = (None if args.device_ids is None
                      else [int(i) for i in args.device_ids.split(",")])
        seq_groups, waves, sp_per_lane = gop_schedule(args, cfg, groups, logger)
        first_model = None
        for g_idx, group in seq_groups:
            t0 = time.perf_counter()
            # every later GOP starts from GOP 0's checkpoint
            path = overfit_gop(
                dataset, group, args.first_epoch if g_idx == 0 else args.others_epoch,
                cfg, tc, args.result_dir,
                warm_start_path=warm if g_idx == 0 else first_model,
                seed=args.seed, bitdepth=args.model_bitdepth,
                mid_test=args.mid_test == "True", check_freq=args.check_freq,
                write_pth=args.write_pth == "True",
                write_real_bitstream=args.write_real_bitstream == "True",
                handle_dir=args.handle_dir, resume=args.resume == "True",
                device=args.device, logger=logger, devices=args.devices,
                device_ids=device_ids,
            )
            stats["train_s"] += time.perf_counter() - t0
            if g_idx == 0:
                first_model = path
        for wave in waves:
            t0 = time.perf_counter()
            overfit_gops_parallel(
                dataset, [g for _, g in wave], args.others_epoch, cfg, tc, args.result_dir,
                first_model, bitdepth=args.model_bitdepth, handle_dir=args.handle_dir,
                sp_devices=sp_per_lane, device=args.device,
                device_ids=None if device_ids is None else device_ids[: len(wave) * sp_per_lane],
                logger=logger,
            )
            stats["train_s"] += time.perf_counter() - t0

    if args.encode == "True":
        for group, name in zip(groups, gop_names):
            pyrs = [dataset[i] for i in group]
            t0 = time.perf_counter()
            st = encode_gop(os.path.join(args.result_dir, name, "model.npz"), pyrs,
                            os.path.join(args.encode_dir, name), cfg, logger=logger,
                            device=args.device)
            stats["enc_s"] += time.perf_counter() - t0
            stats["points"] += st["points"]
            stats["bits"] += st["point_bits"] + st["model_bits"] + st["low_bits"]
            logger.info(f"{name}: encoded {st['points']} points, "
                        f"{st['point_bits'] / st['points']:.4f} occupancy bits/point")

    if args.decode == "True":
        for group, name in zip(groups, gop_names):
            gt = lambda i, _g=group: dataset.raw_sorted_points(_g[0] + i)  # noqa: E731
            t0 = time.perf_counter()
            decode_gop(os.path.join(args.encode_dir, name), args.decode_dir, cfg,
                       gop_start_idx=group[0], ground_truth=gt, write_flag=True,
                       logger=logger, device=args.device)
            stats["dec_s"] += time.perf_counter() - t0

    if args.delete_cache == "True" and os.path.exists(args.handle_dir):
        shutil.rmtree(args.handle_dir)
    return stats


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    print(args)
    os.makedirs(args.result_dir, exist_ok=True)
    logger = set_logger(os.path.join(args.result_dir, "info.log"))
    return run(args, logger)


if __name__ == "__main__":
    main()
