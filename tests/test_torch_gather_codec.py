"""The flat gather backend's codec, mid-test and CLI against the JAX
package, on the CPU: per (level, stage) probabilities against JAX's, GOP
round trips at the groupings, the dilated block and kernel size 5 (always
the AC layout, with the gather numerics), the refusal of a JAX-made gather
stream, test_one_gop at outstage 4 against JAX's (8 streams per (frame,
scale)), and the CLI with a standalone decode.

Frames are ``synthetic_cloud(1500, depth=6)`` for the port's round trips
and the CLI (levels in several buckets) and ``depth=5`` for the comparisons
with JAX (every level in one bucket, so that JAX compiles each codec
function once a configuration); the port's pyramids (integer-equal to
JAX's) feed both packages."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.models import ModelConfig as JaxConfig
from linr_pcgc_tpu.models import init_params as jax_init
from linr_pcgc_tpu.models import unflatten_params as jax_unflatten
from linr_pcgc_tpu.runtime import codec as jcodec
from linr_pcgc_tpu.runtime import evaluate as jev
from linr_pcgc_tpu_torch import cli
from linr_pcgc_tpu_torch.data import PyramidDataset, read_ply, synthetic_cloud, write_ply_ascii
from linr_pcgc_tpu_torch.models import ModelConfig, init_params, param_tree, params_from_flat
from linr_pcgc_tpu_torch.models.network import param_spec
from linr_pcgc_tpu_torch.runtime import (
    decode_frame,
    decode_gop,
    encode_frame,
    encode_gop,
    save_checkpoint,
)
from linr_pcgc_tpu_torch.runtime import codec as tcodec
from linr_pcgc_tpu_torch.runtime import evaluate as tev
from linr_pcgc_tpu_torch.runtime.codec import encode_low_all_frames

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)

ROUNDTRIPS = [{"outstage": 4}, {"outstage": 1}, {"outstage": 3}, {"block_type": "dilation"},
              {"kernel_size": 5}]
ROUNDTRIP_IDS = ["outstage4", "outstage1", "outstage3", "dilation", "kernel5"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(depth):
    return [synthetic_cloud(1500, depth=depth, seed=7, phase=0.08 * t) for t in range(2)]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _gop(root, depth):
    """A 2-frame GOP, its base layer and a seeded outstage-4 checkpoint."""
    frames = _frames(depth)
    ds = PyramidDataset(frames, device="cpu")
    pyrs = [ds[0], ds[1]]
    cfg = ModelConfig(scale_num=ds.scale_num, outstage=4)
    model = str(root / "model.npz")
    save_checkpoint(model, init_params(8807, cfg), None, 0.01, 0, 0.0, 8)
    return dict(root=root, frames=frames, ds=ds, pyrs=pyrs, cfg=cfg, model=model,
                jcfg=JaxConfig(scale_num=ds.scale_num, outstage=4),
                low=encode_low_all_frames(pyrs))


@pytest.fixture(scope="module")
def gop(tmp_path_factory):
    """The GOP the comparisons with JAX take: every level in one bucket."""
    return _gop(tmp_path_factory.mktemp("gather_codec"), 5)


@pytest.fixture(scope="module")
def deep_gop(tmp_path_factory):
    """The GOP the port's round trips take: levels in several buckets."""
    return _gop(tmp_path_factory.mktemp("gather_codec_deep"), 6)


# ----------------------------------------------------- the probabilities --


@pytest.mark.parametrize("kw", [{"outstage": 4}, {"block_type": "dilation"}],
                         ids=["outstage4", "dilation"])
def test_stage_probs_match_jax(gop, kw):
    """Per level: _prep_levels' keys, codes and stacked maps bit for bit,
    x_glob to rtol/atol 1e-5; per (level, stage) _stage_probs_batched on
    the encoder's ground-truth context to rtol 1e-5 / atol 1e-6."""
    pyrs = gop["pyrs"]
    cfg = ModelConfig(scale_num=gop["cfg"].scale_num, **kw)
    jcfg = JaxConfig(scale_num=gop["cfg"].scale_num, **kw)
    n = sum(int(np.prod(shape)) for _, shape in param_spec(cfg))
    flat = np.random.default_rng(3).uniform(-0.1, 0.1, n).astype(np.float32)
    tparams = param_tree(params_from_flat(flat, cfg))
    template = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    jparams = jax_unflatten(template, jnp.asarray(flat))
    perm = list(cfg.group_perm)
    for s in range(cfg.scale_num):
        ns = [p.levels[s].n for p in pyrs]
        coords_np, b = tcodec._pad_level_coords([p.levels[s].coords for p in pyrs], ns)
        mine = tcodec._prep_levels(torch.as_tensor(coords_np), ns, cfg.kernel_size, cfg.dilations)
        theirs = jcodec._prep_levels(jnp.asarray(coords_np), jnp.asarray(ns, jnp.int32),
                                     jcfg.kernel_size, jcfg.dilations)
        for got, want in zip(mine, theirs):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _, code, nbr = mine
        xg = tcodec._context_batched(tparams, cfg, s, code, nbr)
        jxg = jcodec._context_batched(jparams, jcfg, jnp.int32(s), jnp.asarray(code.numpy()),
                                      jnp.asarray(nbr.numpy()))
        np.testing.assert_allclose(xg.numpy().transpose(0, 2, 1), np.asarray(jxg), rtol=1e-5,
                                   atol=1e-5)
        occ = np.zeros((len(pyrs), b, 8), np.float32)
        for i, p in enumerate(pyrs):
            occ[i, : ns[i]] = p.levels[s].occ[: ns[i]]
        occ7 = np.ascontiguousarray(occ.transpose(0, 2, 1)[:, perm][:, : cfg.ctx_channels])
        for g in range(cfg.outstage):
            pr = tcodec._stage_probs_batched(tparams, cfg, g, xg, torch.as_tensor(occ7), nbr)
            jpr = jcodec._stage_probs_batched(jparams, jcfg, jnp.int32(g), jxg, jnp.asarray(occ7),
                                              jnp.asarray(nbr.numpy()))
            assert pr.shape == (len(pyrs), cfg.gmax, b)
            np.testing.assert_allclose(pr.numpy(), np.asarray(jpr), rtol=1e-5, atol=1e-6,
                                       err_msg=f"level {s} stage {g}")


# ------------------------------------------------------------ round trips --


@pytest.mark.parametrize("kw", ROUNDTRIPS, ids=ROUNDTRIP_IDS)
def test_gather_gop_roundtrip(deep_gop, tmp_path, monkeypatch, kw):
    """encode_gop -> decode_gop on the gather backend, lossless with and
    without the configuration; the AC layout (one blob of 8 streams per
    (frame, scale), no entropy key) even with LINR_CODEC_ENTROPY=rans, the
    gather numerics, and the point bits as the blobs' sizes."""
    monkeypatch.setenv("LINR_CODEC_ENTROPY", "rans")
    g = deep_gop
    cfg = ModelConfig(scale_num=g["cfg"].scale_num, **kw)
    model = str(tmp_path / "model.npz")
    save_checkpoint(model, init_params(8807, cfg), None, 0.01, 0, 0.0, 8)
    enc = str(tmp_path / "enc")
    stats = encode_gop(model, g["pyrs"], enc, cfg, device="cpu")
    s_num = cfg.scale_num
    assert _files(enc) == sorted(
        ["side_info.json", "bins/model.bin", "bins/low_enc_bytes.bin"]
        + [f"bins/frame{i:04d}_scale{s}.bin" for i in range(2) for s in range(s_num)])
    with open(os.path.join(enc, "side_info.json")) as f:
        side = json.load(f)
    assert "entropy" not in side
    assert side["numerics"] == {"dtype": "f32", "conv_kernel": "gather", "backend": "torch-cpu"}
    assert tcodec.cfg_from_side_info(side) == cfg
    assert stats["point_bits"] == 8 * sum(
        os.path.getsize(os.path.join(enc, "bins", f"frame{i:04d}_scale{s}.bin"))
        for i in range(2) for s in range(s_num))
    for c in (cfg, None):
        decode_gop(enc, str(tmp_path / "dec"), c, write_flag=True, device="cpu",
                   ground_truth=lambda i: g["ds"].raw_sorted_points(i))
    for t, pts in enumerate(g["frames"]):
        np.testing.assert_array_equal(read_ply(str(tmp_path / "dec" / f"frame{t:04d}.ply")),
                                      np.unique(pts, axis=0))


def test_gather_frame_roundtrip(deep_gop):
    """encode_frame / decode_frame (a GOP of one) on the gather wire."""
    g = deep_gop
    params = param_tree(init_params(8807, g["cfg"]))
    one = encode_frame(params, g["cfg"], g["pyrs"][1], device="cpu")
    assert isinstance(one["blobs"], list) and len(one["blobs"]) == g["cfg"].scale_num
    got = decode_frame(params, g["cfg"], one["blobs"], g["pyrs"][1].low_coords, device="cpu")
    np.testing.assert_array_equal(got, tev._original_coords(g["pyrs"][1]))


def test_jax_gather_stream_is_refused(gop, tmp_path):
    """A gather stream the JAX package encoded carries JAX's numerics, with
    no backend tag: the port refuses it (its probabilities are JAX's)."""
    g = gop
    jdir = str(tmp_path / "jax_enc")
    jcodec.encode_gop(g["model"], g["pyrs"], jdir, g["jcfg"])
    with open(os.path.join(jdir, "side_info.json")) as f:
        assert "backend" not in json.load(f)["numerics"]
    with pytest.raises(ValueError, match="backend"):
        decode_gop(jdir, None, device="cpu")


# ---------------------------------------------------------- the mid-test --


def test_test_one_gop_matches_jax(gop, tmp_path):
    """test_one_gop at outstage 4 against JAX's from one checkpoint: the
    rates within 1e-4 relative, the weight codec's and the base layer's
    equal, the same files; its own decode of the 8 streams per (frame,
    scale) it packed is lossless (it asserts so), and they are the
    production encoder's bytes."""
    g = gop
    mine = tev.test_one_gop(g["model"], g["cfg"], g["pyrs"], str(tmp_path / "t"), g["low"],
                            write_flag=True, device="cpu")
    theirs = jev.test_one_gop(g["model"], g["jcfg"], g["pyrs"], str(tmp_path / "j"),
                              write_flag=True, low_bytes=g["low"])
    assert sorted(mine) == sorted(theirs)
    for k in ("bpp_all", "point_bpp", "point_bpp_val", "model_bpp", "xyzlow_bpp"):
        np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-4, err_msg=k)
    assert mine["model_bpp"] == theirs["model_bpp"] and mine["xyzlow_bpp"] == theirs["xyzlow_bpp"]
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    # the mid-test's probabilities are the production encoder's, bit for
    # bit: the same bytes per (frame, scale)
    enc = str(tmp_path / "enc")
    encode_gop(g["model"], g["pyrs"], enc, g["cfg"], device="cpu")
    for s in range(g["cfg"].scale_num):
        for i in range(2):
            name = f"frame{i:04d}_scale{s}.bin"
            assert (tmp_path / "t" / "bins" / name).read_bytes() == \
                open(os.path.join(enc, "bins", name), "rb").read()


# ---------------------------------------------------------------- the CLI --


@pytest.mark.parametrize("flags", [["--outstage", "4"], ["--block_type", "dilation"]],
                         ids=["outstage4", "dilation"])
def test_cli_gather_overfit_encode_decode(tmp_path, flags):
    """--overfit True --encode True --decode True on the gather backend (1
    epoch, 2 frames, 1 GOP), lossless; then a standalone decode from the
    bins alone, lossless too."""
    ply = tmp_path / "ply"
    ply.mkdir()
    frames = _frames(6)
    for t, pts in enumerate(frames):
        write_ply_ascii(str(ply / f"frame{t:04d}.ply"), pts)
    dirs = ["--handle_dir", str(tmp_path / "tmp"), "--result_dir", str(tmp_path / "out"),
            "--encode_dir", str(tmp_path / "enc"), "--device", "cpu"]
    stats = cli.main(["--overfit", "True", "--encode", "True", "--decode", "True",
                      "--first_epoch", "1", "--frame_num", "2", "--gop_size", "2",
                      "--ori_dir", str(ply), "--decode_dir", str(tmp_path / "dec"), *flags, *dirs])
    assert stats["frames"] == 2 and stats["bits"] > 0
    with open(tmp_path / "out" / "gop_0_1" / "result.json") as f:
        assert [e["epoch"] for e in json.load(f)] == [0]
    cli.main(["--decode", "True", "--ori_dir", str(tmp_path / "absent"),
              "--decode_dir", str(tmp_path / "dec_sa"), *dirs])
    for t, pts in enumerate(frames):
        for d in ("dec", "dec_sa"):
            np.testing.assert_array_equal(read_ply(str(tmp_path / d / f"frame{t:04d}.ply")),
                                          np.unique(pts, axis=0))
