"""Multi-device training of the port (``linr_pcgc_tpu_torch/parallel``)
against the JAX package's parallel trainers and against the port's own
one-device trainers, on the CPU: gloo ranks spawned by
``parallel/launch.py``, one torch thread each, one spawn per module-scoped
fixture (every rank target lives in the port package: a spawned rank
imports its target's module, and this one imports JAX).

JAX runs on 2 of the conftest's 8 host devices, jitted once per trainer,
float32, from the same numpy-drawn parameters the port's ranks start from.
Tolerances: against JAX, per-frame losses rtol/atol 2e-4 and final params
rtol 1e-2 / atol 1e-4 (tests/test_torch_train.py's cross-package trainer
tolerances); against the port's one-device trainers run with the same
stage chunks and frame gradients, the same bits (every rank runs the same
plain kernels on one thread; a sum of two addends is exact in either
order)."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.models import ModelConfig as JaxConfig
from linr_pcgc_tpu.models import flatten_params as jax_flatten
from linr_pcgc_tpu.models import init_params as jax_init
from linr_pcgc_tpu.models import unflatten_params as jax_unflatten
from linr_pcgc_tpu.parallel import make_epoch_fn_dp as jax_epoch_dp
from linr_pcgc_tpu.parallel import make_epoch_fn_sb_dp as jax_epoch_sb_dp
from linr_pcgc_tpu.parallel import make_epoch_fn_sb_sp as jax_epoch_sb_sp
from linr_pcgc_tpu.parallel import make_mesh, shard_gop as jax_shard_gop
from linr_pcgc_tpu.parallel import shard_sb_gop as jax_shard_sb_gop
from linr_pcgc_tpu.runtime import adam_init as jax_adam_init
from linr_pcgc_tpu.runtime import overfit as jov
from linr_pcgc_tpu.runtime import sb_overfit as jsbo
from linr_pcgc_tpu_torch import cli
from linr_pcgc_tpu_torch.data import PyramidDataset, read_ply, synthetic_cloud, write_ply_ascii
from linr_pcgc_tpu_torch.models import ModelConfig
from linr_pcgc_tpu_torch.models.network import param_spec
from linr_pcgc_tpu_torch.parallel import mesh, overfit_gops_parallel, train_parallel
from linr_pcgc_tpu_torch.runtime import overfit as tov
from linr_pcgc_tpu_torch.runtime import sb_overfit as tsbo

LOSS = dict(rtol=2e-4, atol=2e-4)
PARAMS = dict(rtol=1e-2, atol=1e-4)
TC = tov.TrainConfig(step_size=2)  # the schedule steps inside the runs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once
    (the ranks take the parent's share, one each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n=3):
    return [synthetic_cloud(1500, depth=6, seed=7, phase=0.08 * t) for t in range(n)]


def _flat(cfg, seed):
    n = sum(int(np.prod(shape)) for _, shape in param_spec(cfg))
    return np.random.default_rng(seed).uniform(-0.1, 0.1, n).astype(np.float32)


def _jax_params(jcfg, flat):
    template = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    return jax_unflatten(template, jnp.asarray(flat))


def _jax_state(jcfg, flat):
    p = _jax_params(jcfg, flat)
    return p, jax_adam_init(p), jnp.asarray(TC.learning_rate, jnp.float32), jnp.zeros((), jnp.int32)


@pytest.fixture(scope="module")
def gop():
    ds = PyramidDataset(_frames(), device="cpu")
    pyrs = [ds[i] for i in range(3)]
    s_num = ds.scale_num
    return dict(pyrs=pyrs, cfg=ModelConfig(scale_num=s_num), jcfg=JaxConfig(scale_num=s_num),
                cfg4=ModelConfig(scale_num=s_num, outstage=4),
                cfg_unfused=ModelConfig(scale_num=s_num, block_layers=2),
                jcfg4=JaxConfig(scale_num=s_num, outstage=4))


@pytest.fixture(scope="module")
def world(gop):
    """One world of 2 gloo ranks on the CPU trains, from numpy parameters,
    f32: sb_sp on frames 0-1 for 1 epoch (its lr decays after it), the
    same on the unfused pass (--block_layers 2), sb_dp on frames 0-2 (the
    second super-step padded with a zero-weight copy of frame 0) for 1
    epoch, and dp (the gather backend at outstage 4) on frames 0-1 for 2
    epochs."""
    g = gop
    runs = [
        dict(backend="sb_sp", cfg=g["cfg"], tc=TC, pyramids=g["pyrs"][:2],
             flat=_flat(g["cfg"], 5), epochs=1, dtype="f32"),
        dict(backend="sb_sp", cfg=g["cfg_unfused"], tc=TC, pyramids=g["pyrs"][:2],
             flat=_flat(g["cfg_unfused"], 8), epochs=1, dtype="f32"),
        dict(backend="sb_dp", cfg=g["cfg"], tc=TC, pyramids=g["pyrs"],
             flat=_flat(g["cfg"], 6), epochs=1, dtype="f32"),
        dict(backend="dp", cfg=g["cfg4"], tc=TC, pyramids=g["pyrs"][:2],
             flat=_flat(g["cfg4"], 7), epochs=2, dtype="f32"),
    ]
    out = train_parallel(runs, 2, device="cpu")
    return dict(zip(("sb_sp", "sb_sp_unfused", "sb_dp", "dp"), zip(runs, out)))


# ------------------------------------------------------------- the world --


def test_rank_devices_and_transport(monkeypatch):
    """Rank r on cuda:r, or on the ids given; more ranks than cards raises
    (JAX's make_mesh); NCCL only where every rank has its own card, gloo on
    the CPU and where ids repeat."""
    cpu = mesh.rank_devices(3, "cpu")
    assert cpu == [torch.device("cpu")] * 3 and mesh.transport(cpu) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = mesh.rank_devices(2)
    assert two == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh.transport(two) == "nccl"
    shared = mesh.rank_devices(2, device_ids=[0, 0])
    assert shared == [torch.device("cuda", 0)] * 2 and mesh.transport(shared) == "gloo"
    with pytest.raises(ValueError, match="requested 4 devices, only 2 available"):
        mesh.rank_devices(4)
    with pytest.raises(ValueError, match="requested 3 devices, only 2 available"):
        mesh.rank_devices(2, device_ids=[0, 2])
    with pytest.raises(ValueError, match="device ids"):
        mesh.rank_devices(2, "cpu", device_ids=[0, 1])


def test_a_failing_rank_fails_the_launch(gop):
    """A rank that raises fails the whole launch with its traceback (here:
    2 ranks cannot split outstage 3's stages), and no rank is left
    running."""
    cfg = ModelConfig(scale_num=gop["cfg"].scale_num, outstage=3)
    run = dict(backend="sb_sp", cfg=cfg, tc=TC, pyramids=gop["pyrs"][:1], flat=_flat(cfg, 1),
               epochs=1, dtype="f32")
    with pytest.raises(RuntimeError, match="do not divide outstage 3"):
        train_parallel([run], 2, device="cpu")


# ------------------------------------------------------ (a) stage-parallel --


def test_sb_sp_matches_jax(gop, world):
    """One epoch (frame 0 at the initial parameters, frame 1 after one
    step): the port's losses against JAX's make_epoch_fn_sb_sp at 2e-4.

    JAX's stage-parallel step takes Adam on D times the frame gradient
    (make_group_chunk_grads psums gradients of replicated parameters whose
    shard_map transpose has already summed them), where its docstring, its
    sequential trainer and the port take the frame gradient itself.  So
    JAX's parameters are held to Adam on 2 x the port's one-device frame
    gradient (which the port's sb_sp equals bit for bit, the next test),
    at rtol 1e-2 / atol 1e-4."""
    run, got = world["sb_sp"]
    jb = jsbo.assemble_gop_superbricks(run["pyramids"])
    fn = jax_epoch_sb_sp(gop["jcfg"], TC, jb.level_slices, make_mesh(2), compute_dtype=jnp.float32)
    *state, losses = fn(*_jax_state(gop["jcfg"], run["flat"]), jb)
    np.testing.assert_allclose(got["losses"][0], np.asarray(losses), **LOSS)
    assert got["k"] == int(state[3]) == 2 and got["t"] == 2
    assert np.float32(got["lr"]) == np.float32(state[2]) < TC.learning_rate

    tb = tsbo.assemble_gop_superbricks(run["pyramids"], "cpu")
    grads = tsbo.make_frame_grads_sb(gop["cfg"], tb.level_slices, torch.float32, stage_chunk=4)
    flat = torch.as_tensor(run["flat"])
    opt = tov.adam_init(flat)
    for fd in tsbo.sb_frames(tb):
        flat, opt = tov.adam_frame_update(flat, opt, np.float32(TC.learning_rate),
                                          2 * grads(flat, fd)[1], TC)
    np.testing.assert_allclose(np.asarray(jax_flatten(state[0])), flat.numpy(), **PARAMS)


@pytest.mark.parametrize("name", ["sb_sp", "sb_sp_unfused"])
def test_sb_sp_equals_the_sequential_trainer(world, name):
    """The port's one-device trainer at the same stage chunks (cs = 4 =
    outstage / 2) gives the same losses and parameters bit for bit: rank
    r's chunk r and the sum of the two.  On the unfused pass too: x_glob's
    cotangent summed over the ranks before it folds back through
    block_in, the fold added after the gradient's sum."""
    run, got = world[name]
    assert tsbo.is_fused(run["cfg"]) == (name == "sb_sp")
    tb = tsbo.assemble_gop_superbricks(run["pyramids"], "cpu")
    fn = tsbo.make_epoch_fn_sb(run["cfg"], TC, tb.level_slices, torch.float32, stage_chunk=4)
    flat = torch.as_tensor(run["flat"])
    state = (flat, tov.adam_init(flat), np.float32(TC.learning_rate), 0)
    for epoch in range(run["epochs"]):
        *state, losses = fn(*state, tb)
        np.testing.assert_array_equal(got["losses"][epoch], losses.numpy())
    np.testing.assert_array_equal(got["flat"], state[0].numpy())
    np.testing.assert_array_equal(got["v"], state[1]["v"].numpy())


def test_ranks_hold_identical_params(world):
    """After every run each rank holds the parameters of rank 0 bit for
    bit (one all_reduce result, then the same Adam arithmetic), over gloo."""
    for name, (_, got) in world.items():
        assert got["identical"], name
        assert got["transport"] == "gloo"
        assert len(got["launches"]) == 2  # counted per rank (0 on the CPU: plain versions)


# ------------------------------------------------------- (b) frame-DP, sb --


def test_sb_dp_matches_jax(gop, world):
    """3 frames on 2 ranks: super-steps (0, 1) and (2, pad), the pad of
    weight 0; step_size / 2 as JAX's overfit_gop converts it."""
    run, got = world["sb_dp"]
    jb = jsbo.assemble_gop_superbricks(run["pyramids"])
    m = make_mesh(2)
    data = jax_shard_sb_gop(jb, m)
    np.testing.assert_array_equal(np.asarray(data["loss_weight"]), [[1, 1], [1, 0]])
    fn = jax_epoch_sb_dp(gop["jcfg"], jov.dp_train_config(TC, 2), jb.level_slices, m,
                         compute_dtype=jnp.float32)
    *state, losses = fn(*_jax_state(gop["jcfg"], run["flat"]), data)
    np.testing.assert_allclose(got["losses"][0], np.asarray(losses), **LOSS)
    assert got["t"] == int(state[1]["t"]) == 2 and got["k"] == int(state[3]) == 2
    np.testing.assert_allclose(got["flat"], np.asarray(jax_flatten(state[0])), **PARAMS)


def test_sb_dp_is_the_weighted_mean_of_sequential_frame_gradients(gop, world):
    """Each super-step is one Adam step on the mean of its real frames'
    gradients (the port's one-device frame gradient), at step_size / 2:
    (g0 + g1) / 2, the lr decay, then g2 alone; the same bits."""
    run, got = world["sb_dp"]
    tb = tsbo.assemble_gop_superbricks(run["pyramids"], "cpu")
    grads = tsbo.make_frame_grads_sb(gop["cfg"], tb.level_slices, torch.float32)
    frames = list(tsbo.sb_frames(tb))
    flat = torch.as_tensor(run["flat"])
    opt, lr = tov.adam_init(flat), np.float32(TC.learning_rate)
    assert tov.dp_train_config(TC, 2).step_size == 1
    want_losses = []
    for step in ((0, 1), (2,)):
        out = [grads(flat, frames[i]) for i in step]
        want_losses += [o[0].item() for o in out]
        g = out[0][1] + out[1][1] if len(out) > 1 else out[0][1]
        flat, opt = tov.adam_frame_update(flat, opt, lr, g / len(step), TC)
        lr = np.float32(lr * np.float32(TC.gamma))
    np.testing.assert_array_equal(got["losses"][0].reshape(-1)[:3], np.float32(want_losses))
    np.testing.assert_array_equal(got["flat"], flat.numpy())
    assert got["lr"] == max(lr, np.float32(TC.min_lr))


# --------------------------------------------------- (c) frame-DP, gather --


def test_dp_matches_jax(gop, world):
    """The gather backend's frame-DP at outstage 4 (K10's plain version in
    every rank) against JAX's make_epoch_fn_dp: 2 epochs of one super-step."""
    run, got = world["dp"]
    m = make_mesh(2)
    data = jax_shard_gop(jov.assemble_gop(run["pyramids"]), m)
    fn = jax_epoch_dp(gop["jcfg4"], jov.dp_train_config(TC, 2), m)
    state = _jax_state(gop["jcfg4"], run["flat"])
    for epoch in range(run["epochs"]):
        *state, losses = fn(*state, data)
        np.testing.assert_allclose(got["losses"][epoch], np.asarray(losses), **LOSS)
    assert got["t"] == int(state[1]["t"]) == 2
    np.testing.assert_allclose(got["flat"], np.asarray(jax_flatten(state[0])), **PARAMS)


# ----------------------------------------------- (d, e) the CLI, GOP lanes --


def test_gop_schedule_is_the_jax_clis():
    """The JAX CLI's GOP order: GOP 0 first on all ranks, the ragged tail
    one after another, the full warm GOPs in waves of --gop_lanes (each
    lane --devices / --gop_lanes ranks); stage-parallel for every GOP where
    GOP-parallel does not apply (logged), one GOP a rank where the lanes
    do not divide the ranks into sp groups dividing outstage (logged)."""
    logged = []
    log = type("Log", (), {"info": staticmethod(logged.append)})

    def schedule(*flags, frames=5, gop=1, cfg=ModelConfig()):
        args = cli.build_parser().parse_args(["--frame_num", str(frames), "--gop_size", str(gop),
                                              *flags])
        seq, waves, sp = cli.gop_schedule(args, cfg, cli.gop_groups(frames, gop), log)
        return [i for i, _ in seq], [[i for i, _ in w] for w in waves], sp

    assert schedule("--devices", "2") == ([0, 1, 2, 3, 4], [], 1)
    assert schedule("--devices", "2", "--parallel", "gop") == ([0], [[1, 2], [3, 4]], 1)
    assert schedule("--devices", "4", "--parallel", "gop", "--gop_lanes", "2") == (
        [0], [[1, 2], [3, 4]], 2)
    assert schedule("--devices", "2", "--parallel", "gop", gop=2) == ([0, 2], [[1]], 1)
    assert not logged
    assert schedule("--devices", "6", "--parallel", "gop", "--gop_lanes", "2") == (
        [0], [[1, 2, 3, 4]], 1)
    assert "one GOP per chip" in logged.pop()
    for flags, cfg in ((("--mid_test", "True"), ModelConfig()), ((), ModelConfig(outstage=4))):
        assert schedule("--devices", "2", "--parallel", "gop", *flags, cfg=cfg) == (
            [0, 1, 2, 3, 4], [], 1)
        assert "falling back to stage-parallel" in logged.pop()


def _cli(tmp, frames, *flags):
    ply = tmp / "ply"
    if not ply.exists():
        ply.mkdir()
        for t, pts in enumerate(frames):
            write_ply_ascii(str(ply / f"frame{t:04d}.ply"), pts)
    return cli.main([
        "--overfit", "True", "--encode", "True", "--decode", "True", "--device", "cpu",
        "--first_epoch", "2", "--others_epoch", "1", "--ori_dir", str(ply),
        "--handle_dir", str(tmp / "tmp"), "--result_dir", str(tmp / "out"),
        "--encode_dir", str(tmp / "enc"), "--decode_dir", str(tmp / "dec"), *flags])


def _check_artifacts(tmp, frames, gops):
    for t, pts in enumerate(frames):
        np.testing.assert_array_equal(read_ply(str(tmp / "dec" / f"frame{t:04d}.ply")),
                                      np.unique(pts, axis=0))
    for name in gops:
        assert os.path.isfile(tmp / "out" / name / "model.npz")
        assert os.path.isfile(tmp / "tmp" / f"{name}_xyzlow.bin")
        assert sorted(os.listdir(tmp / "enc" / name)) == ["bins", "side_info.json"]


@pytest.fixture(scope="module")
def cli_gop(tmp_path_factory):
    """--devices 2 --parallel gop over 3 one-frame GOPs: GOP 0 stage-
    parallel on both ranks, GOPs 1 and 2 side by side in one wave of 2
    lanes, then encode and a lossless decode."""
    tmp = tmp_path_factory.mktemp("cli_gop")
    frames = _frames()
    stats = _cli(tmp, frames, "--devices", "2", "--parallel", "gop", "--gop_size", "1",
                 "--frame_num", "3")
    return tmp, frames, stats


def test_cli_sp_overfit_encode_decode(tmp_path):
    """--devices 2 --parallel sp: one GOP of 2 frames trains stage-parallel
    over gloo, writes JAX's artifacts (its result.json also names the
    trainer, the transport and each rank's kernel launches), and encodes
    and decodes losslessly."""
    frames = _frames(2)
    stats = _cli(tmp_path, frames, "--devices", "2", "--parallel", "sp", "--gop_size", "2",
                 "--frame_num", "2")
    assert stats["frames"] == 2 and stats["points"] > 0
    _check_artifacts(tmp_path, frames, ["gop_0_1"])
    with open(tmp_path / "out" / "gop_0_1" / "result.json") as f:
        entries = json.load(f)
    assert [e["epoch"] for e in entries] == [0, 1] and entries[1]["loss"] < entries[0]["loss"]
    assert {(e["backend"], e["devices"], e["transport"]) for e in entries} == {("sb_sp", 2, "gloo")}
    assert all(len(e["rank_launches"]) == 2 for e in entries)


def test_cli_gop_parallel_overfit_encode_decode(cli_gop):
    tmp, frames, stats = cli_gop
    assert stats["frames"] == 3
    _check_artifacts(tmp, frames, ["gop_0_0", "gop_1_1", "gop_2_2"])
    for name, backend in (("gop_0_0", "sb_sp"), ("gop_1_1", "sb"), ("gop_2_2", "sb")):
        with open(tmp / "out" / name / "result.json") as f:
            entries = json.load(f)
        assert [e["backend"] for e in entries] == [backend] * (2 if name == "gop_0_0" else 1)


@pytest.fixture(scope="module")
def sequential(cli_gop):
    """GOPs 1 and 2 trained one by one on one device (overfit_gop) from the
    CLI run's GOP 0 checkpoint: {gop: (checkpoint params, result.json)}."""
    tmp, _, _ = cli_gop
    ds = PyramidDataset(str(tmp / "ply"), device="cpu")
    ds[0]
    out = {}
    for g in (1, 2):
        path = tov.overfit_gop(ds, [g], 1, ModelConfig(scale_num=ds.scale_num), tov.TrainConfig(),
                               str(tmp / "seq"), warm_start_path=str(tmp / "out" / "gop_0_0" /
                                                                     "model.npz"),
                               handle_dir=str(tmp / "tmp"), device="cpu")
        with open(os.path.join(os.path.dirname(path), "result.json")) as f:
            out[g] = (np.load(path)["params"], json.load(f))
    return out


def test_gop_lanes_equal_per_gop_sequential_training(cli_gop, sequential):
    """Each lane of the wave (one rank, the sequential trainer) trains its
    GOP from GOP 0's checkpoint exactly as overfit_gop does alone: the
    same loss and checkpoint bits."""
    tmp, _, _ = cli_gop
    for g, (params, entries) in sequential.items():
        with open(tmp / "out" / f"gop_{g}_{g}" / "result.json") as f:
            lane = json.load(f)
        assert lane[0]["loss"] == entries[0]["loss"]
        np.testing.assert_array_equal(np.load(tmp / "out" / f"gop_{g}_{g}" / "model.npz")["params"],
                                      params)


def test_gop_by_sp_lanes_match_per_gop_sequential_training(cli_gop, sequential, tmp_path):
    """The 2 x 2 (gop x sp) split: 2 lanes of 2 ranks, each lane training
    its GOP stage-parallel (cs 4 against the sequential trainer's 8, bf16)
    from GOP 0's checkpoint; the one loss of each GOP within rtol 1e-5 of
    the sequential run's (it is computed before the first update)."""
    tmp, _, _ = cli_gop
    ds = PyramidDataset(str(tmp / "ply"), device="cpu")
    ds[0]
    cfg = ModelConfig(scale_num=ds.scale_num)
    paths = overfit_gops_parallel(ds, [[1], [2]], 1, cfg, tov.TrainConfig(), str(tmp_path / "out"),
                                  str(tmp / "out" / "gop_0_0" / "model.npz"),
                                  handle_dir=str(tmp / "tmp"), sp_devices=2, device="cpu")
    for g, path in zip((1, 2), paths):
        with open(os.path.join(os.path.dirname(path), "result.json")) as f:
            lane = json.load(f)
        assert lane[0]["backend"] == "sb_sp" and lane[0]["devices"] == 2
        np.testing.assert_allclose(lane[0]["loss"], sequential[g][1][0]["loss"], rtol=1e-5)
