"""The mid-training test and the AC wire against the JAX package, on the
CPU: the host arithmetic coder's bytes, a GOP coded on the AC wire
(``LINR_CODEC_ENTROPY=ac``) and decoded losslessly, test_one_gop's record
against JAX's from one checkpoint, and the CLI's ``--mid_test`` cadence.

Frames are ``synthetic_cloud(1500, depth=6)``; the port's pyramids (integer-
equal to JAX's) feed both packages."""

import json
import os

import numpy as np
import pytest
import torch

from linr_pcgc_tpu.coding import ac as jac
from linr_pcgc_tpu.models import ModelConfig as JaxConfig
from linr_pcgc_tpu.runtime import evaluate as jev
from linr_pcgc_tpu_torch import cli
from linr_pcgc_tpu_torch.coding import ac as tac
from linr_pcgc_tpu_torch.data import PyramidDataset, read_ply, synthetic_cloud, write_ply_ascii
from linr_pcgc_tpu_torch.models import ModelConfig, init_params, param_tree
from linr_pcgc_tpu_torch.runtime import (
    decode_frame,
    decode_gop,
    encode_frame,
    encode_gop,
    save_checkpoint,
)
from linr_pcgc_tpu_torch.runtime import codec as tcodec
from linr_pcgc_tpu_torch.runtime import evaluate as tev
from linr_pcgc_tpu_torch.runtime import overfit as tov
from linr_pcgc_tpu_torch.runtime import sb_overfit as tsbo
from linr_pcgc_tpu_torch.runtime.codec import encode_low_all_frames

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)

RESULT_KEYS = ["bpp_all", "dec_time", "enc_mode", "enc_time", "model_bpp", "point_bpp",
               "point_bpp_val", "xyzlow_bpp"]
MID_TEST_KEYS = ["real_bpp_all", "real_point_bpp", "point_bpp_val", "model_bpp", "xyzlow_bpp",
                 "enc_time", "dec_time", "enc_mode", "model_bitdepth_final"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames():
    return [synthetic_cloud(1500, depth=6, seed=7, phase=0.08 * t) for t in range(2)]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def gop(tmp_path_factory):
    """A 2-frame GOP, its base layer and a seeded checkpoint of the default
    config."""
    root = tmp_path_factory.mktemp("midtest")
    frames = _frames()
    ds = PyramidDataset(frames, device="cpu")
    pyrs = [ds[0], ds[1]]
    cfg = ModelConfig(scale_num=ds.scale_num)
    model = str(root / "model.npz")
    save_checkpoint(model, init_params(8807, cfg), None, 0.01, 0, 0.0, 8)
    return dict(root=root, frames=frames, ds=ds, pyrs=pyrs, cfg=cfg, model=model,
                low=encode_low_all_frames(pyrs))


# --------------------------------------------------------- the host coder --


def _seeded_streams(seed):
    """Probabilities as the codec hands them over (f16 widened to f32, 70 %
    near 0.02) and bits drawn from them, over streams of ragged lengths
    (one empty)."""
    rng = np.random.default_rng(seed)
    probs, bits = [], []
    for n in (0, 1, 17, 1000, 4096, 30_001):
        p = np.where(rng.uniform(size=n) < 0.7, 0.02, rng.uniform(size=n)).astype(np.float16)
        probs.append(p.astype(np.float32))
        bits.append((rng.uniform(size=n) < probs[-1]).astype(np.float32))
    return probs, bits


@pytest.mark.parametrize("seed", [0, 1])
def test_binary_coder_bytes_equal_jax(seed):
    """binary_encode_batch gives the JAX package's bytes stream for stream,
    binary_encode and binary_estimate_bits agree with JAX's, and the batch
    and single decoders give the bits back."""
    probs, bits = _seeded_streams(seed)
    mine = tac.binary_encode_batch(probs, bits)
    assert mine == jac.binary_encode_batch(probs, bits)
    for p, b, s in zip(probs, bits, mine):
        assert tac.binary_encode(p, b) == jac.binary_encode(p, b) == s
        assert tac.binary_estimate_bits(p, b) == jac.binary_estimate_bits(p, b)
        np.testing.assert_array_equal(tac.binary_decode(p, s), b.astype(np.uint8))
    for got, b in zip(tac.binary_decode_batch(probs, mine), bits):
        np.testing.assert_array_equal(got, b.astype(np.uint8))
    assert tac.binary_encode_batch([], []) == [] and tac.binary_decode_batch([], []) == []


# ------------------------------------------------------------- the AC wire --


def test_ac_wire_gop_roundtrip(gop, tmp_path, monkeypatch):
    """LINR_CODEC_ENTROPY=ac: encode_gop writes the JAX package's AC layout
    (bins/frame{i:04d}_scale{s}.bin, no chunk files, no entropy key), and
    the GOP decodes losslessly through decode_gop with and without the
    configuration, and a frame alone through encode_frame / decode_frame."""
    monkeypatch.setenv("LINR_CODEC_ENTROPY", "ac")
    g = gop
    enc = str(tmp_path / "enc")
    stats = encode_gop(g["model"], g["pyrs"], enc, g["cfg"], device="cpu")
    s_num = g["cfg"].scale_num
    assert _files(enc) == sorted(
        ["side_info.json", "bins/model.bin", "bins/low_enc_bytes.bin"]
        + [f"bins/frame{i:04d}_scale{s}.bin" for i in range(2) for s in range(s_num)])
    with open(os.path.join(enc, "side_info.json")) as f:
        side = json.load(f)
    assert "entropy" not in side and side["numerics"]["backend"] == "torch-cpu"
    assert stats["point_bits"] == 8 * sum(
        os.path.getsize(os.path.join(enc, "bins", f"frame{i:04d}_scale{s}.bin"))
        for i in range(2) for s in range(s_num))
    for cfg in (g["cfg"], None):
        out = decode_gop(enc, str(tmp_path / "dec"), cfg, write_flag=True, device="cpu",
                         ground_truth=lambda i: g["ds"].raw_sorted_points(i))
        assert len(out) == 2
    for t, pts in enumerate(g["frames"]):
        np.testing.assert_array_equal(read_ply(str(tmp_path / "dec" / f"frame{t:04d}.ply")),
                                      np.unique(pts, axis=0))
    params = param_tree(init_params(8807, g["cfg"]))
    one = encode_frame(params, g["cfg"], g["pyrs"][1], device="cpu")
    assert isinstance(one["blobs"], list) and len(one["blobs"]) == s_num
    got = decode_frame(params, g["cfg"], one["blobs"], g["pyrs"][1].low_coords, device="cpu")
    np.testing.assert_array_equal(got, tev._original_coords(g["pyrs"][1]))


# ------------------------------------------------------------ test_one_gop --


def test_test_one_gop_matches_jax(gop, tmp_path):
    """The port's test_one_gop against JAX's from one checkpoint, both at
    their default bf16 codec: JAX's result.json keys; point_bpp_val,
    model_bpp and xyzlow_bpp within 1e-4 relative; the weight codec's and
    the base layer's rates equal; the same bitstream files and side-info
    keys when the bins are written."""
    g = gop
    mine = tev.test_one_gop(g["model"], g["cfg"], g["pyrs"], str(tmp_path / "t"), g["low"],
                            write_flag=True, device="cpu")
    theirs = jev.test_one_gop(g["model"], JaxConfig(scale_num=g["cfg"].scale_num), g["pyrs"],
                              str(tmp_path / "j"), write_flag=True, low_bytes=g["low"])
    assert sorted(mine) == sorted(theirs) == RESULT_KEYS
    with open(tmp_path / "t" / "result.json") as f:
        assert json.load(f) == mine
    for k in ("point_bpp_val", "model_bpp", "xyzlow_bpp", "point_bpp", "bpp_all"):
        np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-4, err_msg=k)
    assert mine["model_bpp"] == theirs["model_bpp"] and mine["xyzlow_bpp"] == theirs["xyzlow_bpp"]
    assert mine["enc_mode"] == theirs["enc_mode"]
    assert mine["enc_time"] > 0 and mine["dec_time"] > 0
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    for name in ("side_info.json",):
        with open(tmp_path / "t" / name) as f, open(tmp_path / "j" / name) as h:
            assert json.load(f) == json.load(h)
    for name in ("model.bin", "low_enc_bytes.bin"):
        assert (tmp_path / "t" / "bins" / name).read_bytes() == \
            (tmp_path / "j" / "bins" / name).read_bytes()


def test_frame_bit_heatmap_shapes(gop):
    """Per scale: the parent coordinates, and (n, 8) ground truth, quality
    in [0, 1] and its non-negative -log2 cost."""
    g = gop
    params = param_tree(init_params(8807, g["cfg"]))
    maps = tev.frame_bit_heatmap(params, g["cfg"], g["pyrs"][0], device="cpu")
    assert len(maps) == g["cfg"].scale_num
    for lev, m in zip(g["pyrs"][0].levels, maps):
        assert m["coords"].shape == (lev.n, 3)
        for k in ("gt", "quality", "bits"):
            assert m[k].shape == (lev.n, 8), k
        np.testing.assert_array_equal(m["gt"], lev.occ[: lev.n])
        assert ((m["quality"] >= 0) & (m["quality"] <= 1)).all() and (m["bits"] >= 0).all()


# ---------------------------------------------------------------- cadence --


@pytest.mark.parametrize("epochs,freq,want", [(3, 1, [0, 1, 2]), (13, 5, list(range(11)))])
def test_mid_test_cadence(gop, tmp_path, monkeypatch, epochs, freq, want):
    """JAX's cadence: every epoch below 10 and every check_freq-th; the
    checkpoint is saved before each test, and each test writes into <gop
    dir>/<epoch>, its bitstream every 50th epoch; the epochs not tested keep
    the plain entry.  test_one_gop is stubbed here (it is held against JAX
    above), and so is the epoch (a falling loss, the parameters kept): the
    trainer is held against JAX in test_torch_train and test_torch_unfused."""
    g = gop
    calls = []

    def stub(model_path, cfg, pyramids, result_dir, write_flag, low_bytes, device):
        assert os.path.isfile(model_path) and low_bytes == encode_low_all_frames(g["pyrs"][:1])
        calls.append((os.path.basename(result_dir), write_flag))
        return dict(bpp_all=3.0, point_bpp=1.0, point_bpp_val=0.9, model_bpp=1.5,
                    xyzlow_bpp=0.5, enc_time=0.1, dec_time=0.2, enc_mode=2)

    def epoch_fn_stub(*args, **kwargs):
        def epoch_fn(flat, opt, lr, sched_count, batch):
            return flat, opt, lr, sched_count + 1, torch.full((1,), 10.0 - sched_count)
        return epoch_fn

    monkeypatch.setattr(tev, "test_one_gop", stub)
    monkeypatch.setattr(tsbo, "make_epoch_fn_sb", epoch_fn_stub)
    tov.overfit_gop(g["ds"], [0], epochs, g["cfg"], tov.TrainConfig(), str(tmp_path),
                    mid_test=True, check_freq=freq, write_real_bitstream=True,
                    handle_dir=str(tmp_path / "h"), device="cpu")
    assert calls == [(str(e), e % 50 == 0) for e in want]
    with open(tmp_path / "gop_0_0" / "result.json") as f:
        entries = json.load(f)
    assert [e["epoch"] for e in entries] == list(range(epochs))
    for e in entries:
        tested = e["epoch"] in want
        assert all((k in e) == tested for k in MID_TEST_KEYS), e
    assert os.path.isfile(tmp_path / "gop_0_0" / "model.npz")


def test_cli_mid_test_writes_epoch_entries(tmp_path):
    """--overfit True --mid_test True --check_freq 1 --write_real_bitstream
    True --encode True --decode True at --block_layers 2 (the unfused
    trainer): every epoch's result.json entry carries the mid-test's keys,
    each test's directory its result.json, epoch 0's its bitstream; then
    the rANS encode and the decode are lossless."""
    ply = tmp_path / "ply"
    ply.mkdir()
    frames = _frames()
    for t, pts in enumerate(frames):
        write_ply_ascii(str(ply / f"frame{t:04d}.ply"), pts)
    out = tmp_path / "out"
    cli.main([
        "--overfit", "True", "--mid_test", "True", "--check_freq", "1",
        "--write_real_bitstream", "True", "--encode", "True", "--decode", "True",
        "--block_layers", "2", "--frame_num", "2", "--gop_size", "2", "--first_epoch", "2",
        "--ori_dir", str(ply), "--handle_dir", str(tmp_path / "tmp"),
        "--result_dir", str(out), "--encode_dir", str(tmp_path / "enc"),
        "--decode_dir", str(tmp_path / "dec"), "--device", "cpu",
    ])
    gop_dir = out / "gop_0_1"
    with open(gop_dir / "result.json") as f:
        entries = json.load(f)
    assert [e["epoch"] for e in entries] == [0, 1]
    for e in entries:
        assert all(k in e for k in MID_TEST_KEYS), e
        with open(gop_dir / str(e["epoch"]) / "result.json") as f:
            assert sorted(json.load(f)) == RESULT_KEYS
    assert os.path.isfile(gop_dir / "0" / "bins" / "frame0001_scale0.bin")
    assert not os.path.exists(gop_dir / "1" / "bins")
    with open(tmp_path / "enc" / "gop_0_1" / "side_info.json") as f:
        side = json.load(f)
    assert side["entropy"] == "rans-v2" and tcodec.cfg_from_side_info(side).block_layers == 2
    for t, pts in enumerate(frames):
        np.testing.assert_array_equal(read_ply(str(tmp_path / "dec" / f"frame{t:04d}.ply")),
                                      np.unique(pts, axis=0))
