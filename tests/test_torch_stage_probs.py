"""The stage probability producer (``LINR_CODEC_PROBS=stage``) against the
JAX package, on the CPU: ``dev_codec._stage_step`` stage by stage over one
level (its occupancy updates bit for bit, its f16 probabilities against
JAX's ``_stage_step`` on the same inputs, both in float32), the stage and
fused producers' rows, the numerics it records, and stage-encoded GOPs on
both wires decoding losslessly whatever ``LINR_CODEC_PROBS`` says at
decode (the decoder adopts the encoder's producer).

JAX's ``_stage_step`` is jitted once, from its own function with the
module's codec dtype set to float32 (it is fixed when the module is
imported); at the default ``LINR_CONV_KERNEL=xla`` it reaches no Pallas
kernel.  Frames are ``synthetic_cloud(1500, depth=6)``."""

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
from linr_pcgc_tpu.runtime import dev_codec as jdc
from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud
from linr_pcgc_tpu_torch.models import ModelConfig, init_params, param_tree, params_from_flat
from linr_pcgc_tpu_torch.models.network import param_spec
from linr_pcgc_tpu_torch.runtime import codec as tcodec
from linr_pcgc_tpu_torch.runtime import decode_gop, encode_gop, save_checkpoint
from linr_pcgc_tpu_torch.runtime import dev_codec as dc

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FRAMES = [synthetic_cloud(1500, depth=6, seed=7, phase=0.08 * t) for t in range(2)]


@pytest.fixture(scope="module")
def pyrs():
    return [build_pyramid(pts, device="cpu") for pts in FRAMES]


def _truth(i):
    """Frame i's points as the decoder restores them (deduplicated,
    sorted); decode_gop raises on a frame that differs."""
    return np.unique(FRAMES[i][:, :3].astype(np.int64), axis=0).astype(np.int32)


def _level_geometry(pyrs, s):
    """Level ``s`` of the two-frame GOP through the port's brickify, as the
    codec derives it: (geo, counts, bv, cap, tv)."""
    s_num = pyrs[0].scale_num
    shapes = dc._LevelShapes(s_num, [p.low_coords for p in pyrs])
    for lev in range(s_num):
        shapes.set_counts(lev, [p.levels[lev].n for p in pyrs])
    shapes.set_top_coords(s_num - 2, [p.levels[s_num - 2].coords[: p.levels[s_num - 2].n]
                                      for p in pyrs])
    bv, cap, tv = shapes.buckets(s)
    counts = shapes.n_vox[s]
    base = np.zeros((len(pyrs), bv, 3), np.int32)
    for i, p in enumerate(pyrs):
        base[i, : p.levels[s].n] = p.levels[s].coords[: p.levels[s].n]
    coords, keys = dc._init_level(torch.as_tensor(base), counts, bv)
    return dc._brickify_level(coords, keys, counts, s, cap, tv), counts, bv, cap, tv


def test_probs_mode_reads_the_environment(monkeypatch):
    monkeypatch.delenv("LINR_CODEC_PROBS", raising=False)
    assert dc._probs_mode() == "fused"
    monkeypatch.setenv("LINR_CODEC_PROBS", "stage")
    assert dc._probs_mode() == "stage"
    monkeypatch.setenv("LINR_CODEC_PROBS", "chunk")
    with pytest.raises(ValueError, match="LINR_CODEC_PROBS"):
        dc._probs_mode()


def test_stage_step_matches_jax(pyrs, monkeypatch):
    """Level 0, stages 0..7 as the encoder runs them (each stage fed the
    ground-truth column of the stage before it): the brick buffer and
    per-voxel occupancy equal JAX's bit for bit after every stage, and the f16
    probabilities agree within 1e-3 (two f16 steps at 1; the float32 sums
    run in another order through ~11 stacked convs)."""
    s = 0
    geo, counts, bv, cap, tv = _level_geometry(pyrs, s)
    f = len(pyrs)
    cfg = ModelConfig(scale_num=pyrs[0].scale_num)
    n = sum(int(np.prod(shape)) for _, shape in param_spec(cfg))
    flat = np.random.default_rng(9).uniform(-0.3, 0.3, n).astype(np.float32)
    tparams = param_tree(params_from_flat(flat, cfg))
    jcfg = JaxConfig(scale_num=cfg.scale_num)
    template = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    jparams = jax_unflatten(template, jnp.asarray(flat))
    monkeypatch.setattr(jdc, "CDT", jnp.float32)
    jstep = jax.jit(jdc._stage_step.__wrapped__, static_argnames=("cfg",))

    xg = dc._dev_ctx(tparams, cfg, geo["code"], geo["nbr27"], s, torch.float32)
    cols = [dc._pack_bits_frames([p.levels[s].occ[: p.levels[s].n, st] for p in pyrs], bv, "cpu")
            for st in range(8)]
    occ_buf, vox_occ = dc._zero_buffers(f, cap, bv, "cpu")
    j_occ, j_vox = jnp.asarray(occ_buf.numpy()), jnp.asarray(vox_occ.numpy())
    jgeo = {k: jnp.asarray(geo[k].numpy().astype(np.int32))
            for k in ("nbr27", "vox_brick", "vox_slot", "sel")}
    jcode, jxg = jnp.asarray(geo["code"].numpy()), jnp.asarray(xg.numpy())
    prev = torch.zeros((f, bv // 8), dtype=torch.uint8)
    for stage in range(8):
        occ_buf, vox_occ, pr = dc._stage_step(
            tparams, cfg, occ_buf, vox_occ, geo["code"], geo["nbr27"], xg, stage, prev,
            geo["vox_brick"], geo["vox_slot"], geo["sel"], torch.float32)
        j_occ, j_vox, jpr = jstep(jparams, jcfg, j_occ, j_vox, jcode, jgeo["nbr27"], jxg,
                                  jnp.int32(stage), jnp.asarray(prev.numpy()), jgeo["vox_brick"],
                                  jgeo["vox_slot"], jgeo["sel"])
        np.testing.assert_array_equal(occ_buf.numpy(), np.asarray(j_occ), err_msg=f"stage {stage}")
        np.testing.assert_array_equal(vox_occ.numpy(), np.asarray(j_vox), err_msg=f"stage {stage}")
        assert pr.dtype == torch.float16 and pr.shape == (tv,)
        np.testing.assert_allclose(pr.float().numpy()[: sum(counts)],
                                   np.asarray(jpr, np.float32)[: sum(counts)], rtol=0, atol=1e-3,
                                   err_msg=f"stage {stage}")
        prev = cols[stage]


def test_stage_producer_rows_equal_the_fused_producers(pyrs):
    """On the encoder's full buffer, the stage producer's prediction of
    each stage equals the fused producer's row of it (cs 2), bit for bit:
    each stage row of a stage batch is computed independently."""
    s = 1
    geo, counts, bv, cap, tv = _level_geometry(pyrs, s)
    cfg = ModelConfig(scale_num=pyrs[0].scale_num)
    params = param_tree(init_params(8807, cfg, "cpu"))
    dt = torch.bfloat16
    xg = dc._dev_ctx(params, cfg, geo["code"], geo["nbr27"], s, dt)
    occ_buf, vox_occ = dc._zero_buffers(len(pyrs), cap, bv, "cpu")
    cols = [dc._pack_bits_frames([p.levels[s].occ[: p.levels[s].n, st] for p in pyrs], bv, "cpu")
            for st in range(7)]
    dc._enc_occ_buffers(torch.stack(cols), geo["vox_brick"], geo["vox_slot"], occ_buf, vox_occ)
    for b0 in range(0, 8, 2):
        fused = dc._fused_probs(params, cfg, occ_buf, geo["code"], geo["nbr27"], xg, geo["sel"],
                                b0, 2, b0 == 0, dt)
        for stage in (b0, b0 + 1):
            got = dc._stage_probs(params, cfg, occ_buf, geo["code"], geo["nbr27"], xg, geo["sel"],
                                  stage, dt)
            assert torch.equal(got, fused[stage - b0]), stage


def test_numerics_record_the_producer(monkeypatch):
    """side_info["numerics"]["probs"] is the producer; the fused one's
    budget and cap are recorded with it alone, as in JAX; the decoder
    adopts the encoder's producer."""
    cfg, cpu = ModelConfig(), torch.device("cpu")
    monkeypatch.setenv("LINR_CODEC_PROBS", "stage")
    stage = tcodec._numerics_info(cpu, cfg)
    assert stage["probs"] == "stage" and "fused_budget_gb" not in stage
    monkeypatch.setenv("LINR_CODEC_PROBS", "fused")
    fused = tcodec._numerics_info(cpu, cfg)
    assert fused["probs"] == "fused" and fused["fused_cs_cap"] == 2
    assert tcodec._check_numerics(stage, cpu, cfg)[0] == "stage"
    monkeypatch.setenv("LINR_CODEC_PROBS", "stage")
    assert tcodec._check_numerics(fused, cpu, cfg) == ("fused", fused["fused_budget_gb"], 2)


@pytest.fixture(scope="module")
def encoded(pyrs, tmp_path_factory):
    """The GOP encoded on the rANS and the AC wire by each producer, from
    one random-weight checkpoint: {(wire, producer): (enc dir, stats)}."""
    root = tmp_path_factory.mktemp("stage_probs")
    cfg = ModelConfig(scale_num=pyrs[0].scale_num)
    model = str(root / "model.npz")
    save_checkpoint(model, init_params(8807, cfg, "cpu"), None, 0.01, 0, 0.0, 8)
    out = {}
    saved = {k: os.environ.get(k) for k in ("LINR_CODEC_PROBS", "LINR_CODEC_ENTROPY")}
    try:
        for wire in ("rans", "ac"):
            os.environ["LINR_CODEC_ENTROPY"] = wire
            for producer in ("stage", "fused"):
                os.environ["LINR_CODEC_PROBS"] = producer
                enc = str(root / f"{wire}_{producer}")
                out[wire, producer] = enc, encode_gop(model, pyrs, enc, cfg, device="cpu")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


@pytest.mark.parametrize("wire", ["rans", "ac"])
@pytest.mark.parametrize("env", ["stage", "fused"])
def test_stage_stream_decodes_losslessly_under_any_env(encoded, pyrs, wire, env, monkeypatch):
    """A stage-encoded GOP records "probs": "stage" and decodes standalone
    (the model from side_info) losslessly with LINR_CODEC_PROBS set either
    way; on the CPU its bits equal the fused producer's stream's."""
    enc, stats = encoded[wire, "stage"]
    with open(os.path.join(enc, "side_info.json")) as f:
        side = json.load(f)
    assert side["numerics"]["probs"] == "stage" and ("entropy" in side) == (wire == "rans")
    assert stats["point_bits"] == encoded[wire, "fused"][1]["point_bits"]
    monkeypatch.setenv("LINR_CODEC_PROBS", env)
    got = decode_gop(enc, None, ground_truth=_truth, device="cpu")
    assert [len(c) for c in got] == [p.point_num for p in pyrs]


def test_fused_stream_decodes_as_fused_under_stage_env(encoded, pyrs, monkeypatch):
    enc, _ = encoded["rans", "fused"]
    monkeypatch.setenv("LINR_CODEC_PROBS", "stage")
    assert len(decode_gop(enc, None, ground_truth=_truth, device="cpu")) == len(pyrs)
