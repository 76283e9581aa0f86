"""The slice end to end on the CPU: the port's encode -> decode of a 2-frame
GOP is lossless, writes the JAX package's artifact layout and side-info
keys (plus the backend tag), refuses the JAX package's streams and is
refused by it, and the port's CLI serves a checkpoint written by JAX."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.data import PyramidDataset as JaxDataset
from linr_pcgc_tpu.models import ModelConfig as JaxConfig
from linr_pcgc_tpu.models import init_params as jax_init
from linr_pcgc_tpu.models import unflatten_params as jax_unflatten
from linr_pcgc_tpu.runtime import adam_init as jax_adam_init
from linr_pcgc_tpu.runtime import codec as jcodec
from linr_pcgc_tpu.runtime import save_checkpoint as jax_save_checkpoint
from linr_pcgc_tpu_torch import cli
from linr_pcgc_tpu_torch.data import PyramidDataset, synthetic_cloud, write_ply_ascii
from linr_pcgc_tpu_torch.models import ModelConfig, init_params
from linr_pcgc_tpu_torch.runtime import decode_gop, encode_gop, save_checkpoint


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
def encoded(tmp_path_factory):
    """The port's encode of a 2-frame GOP with a seeded checkpoint."""
    root = tmp_path_factory.mktemp("slice")
    frames = _frames()
    ds = PyramidDataset(frames, device="cpu")
    cfg = ModelConfig(scale_num=ds[0].scale_num)
    model = str(root / "model.npz")
    save_checkpoint(model, init_params(8807, cfg), None, 0.01, 0, 0.0, 8)
    enc = str(root / "enc")
    stats = encode_gop(model, [ds[0], ds[1]], enc, cfg, device="cpu")
    return dict(root=root, frames=frames, ds=ds, cfg=cfg, model=model, enc=enc, stats=stats)


def test_codec_shapes_equal_jax(encoded):
    """Buckets, brick caps, segment lengths and the stage-batch width are
    derived as in the JAX codec, so for given probabilities the rANS
    segments (and bytes) line up with JAX's."""
    from linr_pcgc_tpu.data import bucket_size as jax_bucket
    from linr_pcgc_tpu.runtime import dev_codec as jdc
    from linr_pcgc_tpu_torch.data import bucket_size
    from linr_pcgc_tpu_torch.runtime import dev_codec as tdc

    for n in (1, 64, 65, 1024, 1025, 5000, 81_920, 672_132, 2_000_001):
        assert bucket_size(n) == jax_bucket(n)
        assert tdc._brick_bucket(n) == jdc._brick_bucket(n)
        assert tdc._lane_bucket(n) == jdc._lane_bucket(n)
    cfg, jcfg = encoded["cfg"], JaxConfig(scale_num=encoded["cfg"].scale_num)
    for bb in (64, 163_840, 400_000, 2_000_000):
        for cap in (None, 1, 2, 8):
            assert tdc._fused_cs(bb, cfg, 8.0, cap) == jdc._fused_cs(bb, jcfg, 8.0, cap)
    pyrs = [encoded["ds"][0], encoded["ds"][1]]
    lows = [p.low_coords for p in pyrs]
    ts, js = tdc._LevelShapes(cfg.scale_num, lows), jdc._LevelShapes(cfg.scale_num, lows)
    for sh in (ts, js):
        for s in range(cfg.scale_num):
            sh.set_counts(s, [p.levels[s].n for p in pyrs])
        sh.set_top_coords(cfg.scale_num - 2, [p.levels[cfg.scale_num - 2].coords[
            : p.levels[cfg.scale_num - 2].n] for p in pyrs])
    assert [ts.buckets(s) for s in range(cfg.scale_num)] == [
        js.buckets(s) for s in range(cfg.scale_num)]


def test_encode_decode_lossless(encoded):
    e = encoded
    out = decode_gop(e["enc"], str(e["root"] / "dec"), None,
                     ground_truth=e["ds"].raw_sorted_points, write_flag=True, device="cpu")
    for got, pts in zip(out, e["frames"]):
        np.testing.assert_array_equal(got, np.unique(pts, axis=0))
    assert sorted(os.listdir(e["root"] / "dec")) == ["frame0000.ply", "frame0001.ply"]
    assert e["stats"]["points"] == sum(len(np.unique(f, axis=0)) for f in e["frames"])


def test_artifacts_and_side_info_keys_equal_jax(encoded, tmp_path, monkeypatch):
    """JAX's encode_gop writes the layout (its occupancy coder is stubbed:
    the file set and keys are fixed by encode_gop, not by the stream)."""
    e = encoded
    jds = JaxDataset(e["frames"])
    jcfg = JaxConfig(scale_num=e["cfg"].scale_num)
    monkeypatch.setattr(jcodec, "encode_gop_streams",
                        lambda params, cfg, pyrs: ({"rans": [b"\0"], "s_num": 0}, 8))
    monkeypatch.setattr(jcodec, "params_template", lambda cfg: jax.eval_shape(
        lambda k: jax_init(k, cfg), jax.random.PRNGKey(0)))
    jenc = str(tmp_path / "jenc")
    jcodec.encode_gop(e["model"], [jds[0], jds[1]], jenc, jcfg)
    assert _files(e["enc"]) == _files(jenc)
    with open(os.path.join(e["enc"], "side_info.json")) as f:
        mine = json.load(f)
    with open(os.path.join(jenc, "side_info.json")) as f:
        theirs = json.load(f)
    assert sorted(mine) == sorted(theirs)
    assert sorted(mine["numerics"]) == sorted(list(theirs["numerics"]) + ["backend"])
    assert mine["numerics"]["backend"] == "torch-cpu"
    for k in ("model_cfg", "frame_points", "entropy", "mu", "b", "min_param", "max_param",
              "enc_mode", "bitdepth"):
        assert mine[k] == theirs[k], k
    assert {k: v for k, v in mine["numerics"].items() if k != "backend"} == {
        **theirs["numerics"], "conv_kernel": "plane"}


def test_streams_are_refused_across_packages(encoded, tmp_path):
    e = encoded
    # JAX refuses the port's stream: its numerics check sees the extra key
    with pytest.raises(ValueError, match="numerics"):
        jcodec.decode_gop(e["enc"], None)
    # the port refuses a stream carrying the JAX package's numerics
    import shutil

    jdir = str(tmp_path / "as_jax")
    shutil.copytree(e["enc"], jdir)
    path = os.path.join(jdir, "side_info.json")
    with open(path) as f:
        side = json.load(f)
    side["numerics"] = jcodec._numerics_info()
    with open(path, "w") as f:
        json.dump(side, f)
    with pytest.raises(ValueError, match="backend"):
        decode_gop(jdir, None, device="cpu")


def test_card_refuses_streams_of_the_plane_window_conv(monkeypatch):
    """A stream the card encoded while K1 ran the plane-window product (its
    numerics say conv_kernel "plane", as every card stream did before the
    tap form) has other probabilities: the card's decoder refuses it and
    takes its own numerics."""
    from linr_pcgc_tpu_torch.runtime import codec as tcodec

    monkeypatch.setattr(tcodec, "backend_tag", lambda device: "torch-cuda-sm90")
    card, cfg = torch.device("cuda"), ModelConfig()
    mine = tcodec._numerics_info(card, cfg)
    assert mine["conv_kernel"] == "taps" and tcodec._numerics_info(torch.device("cpu"), cfg)[
        "conv_kernel"] == "plane"
    with pytest.raises(ValueError, match="numerics"):
        tcodec._check_numerics(dict(mine, conv_kernel="plane"), card, cfg)
    assert tcodec._check_numerics(mine, card, cfg) == (
        mine["probs"], mine["fused_budget_gb"], mine["fused_cs_cap"])


def test_cli_serves_a_jax_checkpoint(tmp_path, monkeypatch):
    """Encode + decode through the port's CLI from a checkpoint written by
    the JAX package's save_checkpoint; the decode checks every frame.  Then
    --overfit True --devices 2 hands every GOP to overfit_gop's multi-device
    dispatch (GOP 1 warm-started from GOP 0), as the JAX CLI does."""
    ply = tmp_path / "ply"
    ply.mkdir()
    for t, pts in enumerate(_frames()):
        write_ply_ascii(str(ply / f"frame{t:04d}.ply"), pts)
    jcfg = JaxConfig(scale_num=PyramidDataset(str(ply), device="cpu")[0].scale_num)
    template = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    n = sum(int(np.prod(t.shape)) for t in jax.tree_util.tree_leaves(template))
    rng = np.random.default_rng(3)
    params = jax_unflatten(template, jnp.asarray(rng.uniform(-0.3, 0.3, n).astype(np.float32)))
    jax_save_checkpoint(str(tmp_path / "out" / "gop_0_1" / "model.npz"), params,
                        jax_adam_init(params), 0.01, 1, 0.0, 8)
    stats = cli.main([
        "--overfit", "False", "--encode", "True", "--decode", "True", "--frame_num", "2",
        "--gop_size", "2", "--ori_dir", str(ply), "--handle_dir", str(tmp_path / "tmp"),
        "--result_dir", str(tmp_path / "out"), "--encode_dir", str(tmp_path / "enc"),
        "--decode_dir", str(tmp_path / "dec"), "--device", "cpu",
    ])
    assert stats["frames"] == 2 and stats["points"] > 0 and stats["bits"] > 0
    assert sorted(os.listdir(tmp_path / "dec")) == ["frame0000.ply", "frame0001.ply"]
    # --devices 2 reaches overfit_gop's parallel dispatch (trained in
    # tests/test_torch_parallel.py; stubbed here)
    calls = []
    monkeypatch.setattr(cli, "overfit_gop", lambda *a, **kw: calls.append(kw) or "model.npz")
    cli.main(["--overfit", "True", "--encode", "False", "--decode", "False", "--devices", "2",
              "--frame_num", "2", "--gop_size", "1", "--ori_dir", str(ply), "--handle_dir",
              str(tmp_path / "tmp"), "--result_dir", str(tmp_path / "out2"), "--device", "cpu"])
    assert [(kw["devices"], kw["device_ids"], kw["warm_start_path"]) for kw in calls] == [
        (2, None, None), (2, None, "model.npz")]
