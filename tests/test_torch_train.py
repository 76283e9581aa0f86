"""The trainer slice against the JAX package, float32 on the CPU: the conv's
backward kernels' plain versions (K3, K4) and the tap map, K4's 27-tap dw
formula walked tap by tap, its launch plan, the conv's
gradients, the GOP assembly, Adam, two epochs of the epoch trainer, and the
CLI's overfit -> encode -> decode.

Inputs come from numpy seeds; the networks start from one numpy-drawn
flat parameter vector, which each package reads in its flatten order
(drawing with jax.random would cost a 12 s compile).  JAX's trainer runs in its
default XLA conv mode (f32-identical to its Pallas mode, and far faster to
compile); the conv gradient is held against the Pallas custom VJP run in
interpret mode, as the JAX package's own tests run it."""

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
from linr_pcgc_tpu.ops import superbricks as jsb
from linr_pcgc_tpu.ops.pallas_conv import plane_matmul as jax_plane_matmul
from linr_pcgc_tpu.ops.pallas_conv import plane_moment as jax_plane_moment
from linr_pcgc_tpu.runtime import adam_init as jax_adam_init
from linr_pcgc_tpu.runtime import load_checkpoint as jax_load_checkpoint
from linr_pcgc_tpu.runtime import overfit as jov
from linr_pcgc_tpu.runtime import sb_overfit as jsbo
from linr_pcgc_tpu_torch import cli
from linr_pcgc_tpu_torch.data import PyramidDataset, read_ply, synthetic_cloud, write_ply_ascii
from linr_pcgc_tpu_torch.models import ModelConfig, params_from_flat, params_to_flat
from linr_pcgc_tpu_torch.models.network import param_spec
from linr_pcgc_tpu_torch.ops import plane_conv, superbricks as tsb, taps
from linr_pcgc_tpu_torch.runtime import overfit as tov
from linr_pcgc_tpu_torch.runtime import sb_overfit as tsbo


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _geometric_nbr(bb, side, seed):
    """Bricks on random sites of a side^3 grid and their 27-neighbour map."""
    rng = np.random.default_rng(seed)
    sites = rng.choice(side**3, size=bb, replace=False)
    coords = np.stack([sites // side**2, (sites // side) % side, sites % side], axis=1)
    lut = {tuple(c): i for i, c in enumerate(coords)}
    nbr = np.full((bb, 27), -1, np.int32)
    for b in range(bb):
        for k, d in enumerate(tsb._DIRS):
            nbr[b, k] = lut.get(tuple(coords[b] + np.asarray(d)), -1)
    return nbr


# ----------------------------------------------------- kernels' plain twins --


@pytest.mark.parametrize("kc,no", [(8, 12), (4, 4)])
def test_plane_matmul_plain_matches_pallas(kc, no):
    """K3's plain version on the taps w against JAX plane_matmul with no
    epilogue on the conv matrix gathered from them (the backward's dx
    shapes, kc = O, no = C), ragged Bb = 600, S = 2, f32, 1e-5 (the same
    products summed in another order).  A real conv matrix, since the JAX
    entry point's dense fallback reads the whole of w2."""
    bb, s = 600, 2
    h = _rand((bb, s, 216 * kc), 20)
    w = _rand((s, 27, kc, no), 21, 0.1)
    w2 = np.asarray(jsb.b4_conv_weight_matrix_sm(jnp.asarray(w)))
    want = jax_plane_matmul(jnp.asarray(h), jnp.asarray(w2), kc, no)
    got = plane_conv.plane_matmul(torch.as_tensor(h), torch.as_tensor(w), kc, no)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kc,no", [(12, 8), (4, 4)])
def test_plane_moment_plain_matches_pallas(kc, no):
    """K4's plain version against JAX plane_moment (Pallas interpret mode,
    a ragged last row block at Bb = 600), f32, 1e-5 relative to the
    moment's scale."""
    bb, s = 600, 2
    x = _rand((bb, s, 64 * kc), 22)
    g = _rand((bb, s, 216 * no), 23)
    want = np.asarray(jax_plane_moment(jnp.asarray(x), jnp.asarray(g), kc, no))
    got = plane_conv.plane_moment_plain(torch.as_tensor(x), torch.as_tensor(g), kc, no).numpy()
    assert got.shape == want.shape == (s, 4, 16 * kc, 108 * no)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_moment_taps_equal_jax():
    """The tap map exactly: integer-valued moments make every sum exact in
    f32, whatever its order."""
    c, o, s = 3, 2, 2
    mc = np.random.default_rng(24).integers(-64, 64, (s, 4, 16 * c, 108 * o)).astype(np.float32)
    want = np.asarray(jsb.moment_taps(jnp.asarray(mc), c, o))
    got = tsb.moment_taps(torch.as_tensor(mc), c, o).numpy()
    np.testing.assert_array_equal(got, want)


TRAIN_CONV_SHAPES = [(8, 8), (12, 8), (4, 4)]  # (C, O) of the fused trainer's 3^3 convs


def _dw_tap_walk(x, g, c, o):
    """K4's formula, walked tap by tap in float64 from the table the kernel
    gets: dw[s, k, c', o'] = sum_b sum_u x[b, s, u*c + c'] *
    g[b, s, T[u, flip(k)]*o + o'], flip(k) the tap of the opposite offset."""
    bb, s, _ = x.shape
    cols = taps.tap_columns().astype(np.int64)  # (64, 27): T[u, k]
    flip = [taps._DIRS.index((-dx, -dy, -dz)) for dx, dy, dz in taps._DIRS]
    assert flip == [26 - k for k in range(27)]  # the kernel's flip(k) = 26 - k
    gk = g.reshape(bb, s, 216, o).astype(np.float64)[:, :, cols[:, flip], :]  # (bb, s, 64, 27, o)
    return np.einsum("bsuc,bsuko->skco", x.reshape(bb, s, 64, c).astype(np.float64), gk)


@pytest.mark.parametrize("c,o", TRAIN_CONV_SHAPES)
def test_dw_tap_walk_equals_plain_exactly(c, o):
    """The stencil K4 computes equals its plain version (the dense window
    moment, then moment_taps' selection) exactly on integer-valued x and g,
    where every f32 sum is exact whatever its order; S = 2."""
    bb, s = 60, 2
    rng = np.random.default_rng(40 + c)
    x = rng.integers(-4, 5, (bb, s, 64 * c)).astype(np.float32)
    g = rng.integers(-4, 5, (bb, s, 216 * o)).astype(np.float32)
    got = plane_conv.plane_moment_dw(torch.as_tensor(x), torch.as_tensor(g), c, o)
    assert got.dtype == torch.float32 and tuple(got.shape) == (s, 27, c, o)
    np.testing.assert_array_equal(got.numpy(), _dw_tap_walk(x, g, c, o))


@pytest.mark.parametrize("c,o", TRAIN_CONV_SHAPES)
def test_dw_tap_walk_matches_pallas_moment(c, o):
    """The tap walk and K4's plain version against JAX's dw path,
    moment_taps(plane_moment(x, g)) with the Pallas moment in interpret
    mode, f32, within 1e-5 of dw's L1 scale (sum |x||g| over the same
    terms): the same products summed in another order."""
    bb, s = 300, 2
    x = _rand((bb, s, 64 * c), 44)
    g = _rand((bb, s, 216 * o), 45)
    want = np.asarray(jsb.moment_taps(jax_plane_moment(jnp.asarray(x), jnp.asarray(g), c, o), c, o))
    scale = _dw_tap_walk(np.abs(x), np.abs(g), c, o)
    walk = _dw_tap_walk(x, g, c, o)
    port = plane_conv.plane_moment_dw(torch.as_tensor(x), torch.as_tensor(g), c, o).numpy()
    for got in (walk, port):
        assert bool((np.abs(got - want) <= 1e-5 * scale).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moment_plan_depends_on_shapes_only(dtype):
    """K4's partition (tile, ring, blocks, brick ranges) is a function of
    the shapes alone, so are dw's bits; a block's range is a whole number of
    staged tiles, never less than one; the ranges cover the bricks; and the
    plan fits one block of the kernel."""
    for bb, s, c, o in [(81_920, 5, 8, 8), (81_920, 4, 12, 8), (81_920, 5, 4, 4),
                        (27_264, 8, 8, 8), (10, 1, 4, 4), (1, 12, 8, 8), (333, 2, 5, 3)]:
        p = plane_conv.moment_plan(bb, s, c, o, dtype)
        assert p == plane_conv.moment_plan(bb, s, c, o, dtype)
        assert p.tile_bricks >= 1 and p.per_block % p.tile_bricks == 0
        assert (p.blocks - 1) * p.per_block < bb <= p.blocks * p.per_block
        assert p.blocks <= plane_conv.MOMENT_SMS and 2 <= p.nst <= 4
        assert p.warps_per_stage * p.stages_per_launch <= plane_conv.MOMENT_MAX_WARPS
        assert p.stages_per_launch == min(s, plane_conv.MOMENT_MAX_WARPS)
        assert p.smem <= 232448 - 1024
        esz = 4 if dtype == torch.float32 else 2
        assert p.slot_bytes % 128 == 0
        assert p.slot_bytes >= p.tile_bricks * s * (64 * c + 216 * o) * esz
        assert p.smem >= 3584 + p.nst * p.slot_bytes  # the ring after the tap table
        own = (c, o) in plane_conv.MOMENT_SHAPES
        assert p.path == (("tensor_cores" if dtype == torch.bfloat16 else "cuda_cores")
                          if own else "any_shape")
    big = plane_conv.moment_plan(81_920, 5, 8, 8, dtype)
    assert big.blocks == plane_conv.MOMENT_SMS  # the level-0 unit fills every SM


# ----------------------------------------------------------- conv gradient --


@pytest.mark.parametrize("need_dx", [True, False])
def test_b4_convsm_bm_grads_match_jax_vjp(need_dx):
    """dx, dw, db of the port's conv against jax.vjp of the JAX custom-VJP
    conv (its Pallas kernels in interpret mode), f32, rtol 1e-4 / atol 1e-5:
    the brick sums run in another order.  Without dx the backward skips K3
    and still gives dw and db."""
    bb, s, c, o = 60, 2, 5, 4
    x = _rand((bb, s, 64 * c), 25)
    w = _rand((s, 27, c, o), 26, 0.3)
    b = _rand((s, o), 27)
    mask = (np.random.default_rng(28).uniform(size=(bb, 64)) < 0.7).astype(np.float32)
    nbr = _geometric_nbr(bb, 5, 29)
    dy = _rand((bb, s, 64 * o), 30)
    y, vjp = jax.vjp(lambda x_, w_, b_: jsb.b4_convsm_bm(x_, w_, b_, jnp.asarray(mask),
                                                          jnp.asarray(nbr)),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = (np.asarray(a) for a in vjp(jnp.asarray(dy)))

    tx = torch.as_tensor(x).requires_grad_(need_dx)
    tw = torch.as_tensor(w).requires_grad_()
    tb = torch.as_tensor(b).requires_grad_()
    ty = tsb.b4_convsm_bm(tx, tw, tb, torch.as_tensor(mask), torch.as_tensor(nbr))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    ty.backward(torch.as_tensor(dy))
    tol = dict(rtol=1e-4, atol=1e-5)
    if need_dx:
        np.testing.assert_allclose(tx.grad.numpy(), jdx, **tol)
    else:
        assert tx.grad is None
    np.testing.assert_allclose(tw.grad.numpy(), jdw, **tol)
    np.testing.assert_allclose(tb.grad.numpy(), jdb, **tol)


# --------------------------------------------------------------- assembly --


def _frames(n=2):
    return [synthetic_cloud(1500, depth=6, seed=7, phase=0.08 * t) for t in range(n)]


def _jax_template(s_num):
    return jax.eval_shape(lambda k: jax_init(k, JaxConfig(scale_num=s_num)),
                          jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def gop():
    """A 2-frame GOP (the port's pyramids, integer-equal to JAX's, feed
    both assemblies), both batches, and one parameter set of the default
    config (uniform in +-0.1, about the init's conv scale)."""
    ds = PyramidDataset(_frames(), device="cpu")
    pyrs = [ds[0], ds[1]]
    s_num = ds.scale_num
    cfg = ModelConfig(scale_num=s_num)
    n = sum(int(np.prod(shape)) for _, shape in param_spec(cfg))
    flat = np.random.default_rng(5).uniform(-0.1, 0.1, n).astype(np.float32)
    jparams = jax_unflatten(_jax_template(s_num), jnp.asarray(flat))
    return dict(pyrs=pyrs, cfg=cfg, jcfg=JaxConfig(scale_num=s_num), jparams=jparams, flat=flat,
                jbatch=jsbo.assemble_gop_superbricks(pyrs),
                tbatch=tsbo.assemble_gop_superbricks(pyrs, "cpu"))


def test_assemble_gop_superbricks_and_level_groups_equal_jax(gop):
    jb, tb = gop["jbatch"], gop["tbatch"]
    assert tb.level_slices == jb.level_slices
    for name in ("nbr27", "code", "occ", "point_num"):
        want = np.asarray(getattr(jb, name))
        got = getattr(tb, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(tb.occ_dense(1).numpy(), np.asarray(jb.occ_dense(1)))
    total = jb.level_slices[-1][1]
    for cap in (None, 64, total // 2, total):
        assert tsbo.level_groups(jb.level_slices, cap) == jsbo.level_groups(jb.level_slices, cap)
    for n in (1, 64, 65, 700, 81_920, 1_000_001):
        assert tsbo._sb_bucket(n) == jsbo._sb_bucket(n)


def test_adam_frame_update_matches_jax():
    """Three Adam steps from zero moments, float32, within 1e-6."""
    tc = tov.TrainConfig()
    p0 = _rand((1000,), 31, 0.5)
    jp, jo = {"a": jnp.asarray(p0)}, jax_adam_init({"a": jnp.asarray(p0)})
    tp = torch.as_tensor(p0)
    to = tov.adam_init(tp)
    lr = np.float32(0.01)
    for step in range(3):
        g = _rand((1000,), 32 + step)
        jp, jo = jov.adam_frame_update(jp, jo, jnp.float32(lr), {"a": jnp.asarray(g)}, tc)
        tp, to = tov.adam_frame_update(tp, to, lr, torch.as_tensor(g), tc)
    assert to["t"] == int(jo["t"]) == 3
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp["a"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to["m"].numpy(), np.asarray(jo["m"]["a"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to["v"].numpy(), np.asarray(jo["v"]["a"]), rtol=1e-6, atol=1e-6)


def test_two_epochs_match_jax_trainer(gop):
    """The slice as a whole: two epochs of the port's epoch trainer against
    JAX's make_epoch_fn_sb from one JAX-drawn parameter set, f32, with two
    level groups and stage chunks of 4 forced on both.  Per-frame losses
    rtol/atol 2e-4 and final params rtol 1e-2 / atol 1e-4, the tolerances
    of the JAX package's own trainer cross-checks."""
    tc = tov.TrainConfig()
    jb, tb = gop["jbatch"], gop["tbatch"]
    total = jb.level_slices[-1][1]
    cap = max(total // 2, 64)
    assert len(tsbo.level_groups(jb.level_slices, cap)) >= 2
    jfn = jsbo.make_epoch_fn_sb(gop["jcfg"], tc, jb.level_slices, compute_dtype=jnp.float32,
                                max_group_bricks=cap, stage_chunk=4)
    tfn = tsbo.make_epoch_fn_sb(gop["cfg"], tc, tb.level_slices, compute_dtype=torch.float32,
                                max_group_bricks=cap, stage_chunk=4)
    assert all(cs == 4 for _, _, cs in tfn.units) and len(tfn.units) >= 2
    jp, jo = gop["jparams"], jax_adam_init(gop["jparams"])
    jlr, jk = jnp.asarray(tc.learning_rate, jnp.float32), jnp.zeros((), jnp.int32)
    tp = torch.as_tensor(gop["flat"])
    to, tlr, tk = tov.adam_init(tp), np.float32(tc.learning_rate), 0
    for _ in range(2):
        jp, jo, jlr, jk, jl = jfn(jp, jo, jlr, jk, jb)
        tp, to, tlr, tk, tl = tfn(tp, to, tlr, tk, tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    assert tk == int(jk) and tlr == np.float32(jlr)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jax_flatten(jp)), rtol=1e-2, atol=1e-4)


# -------------------------------------------------------------------- CLI --


def test_cli_overfit_encode_decode_two_gops(tmp_path):
    """--overfit True --encode True --decode True on the CPU over two GOPs
    (the second warm-started from the first): lossless, the JAX artifact
    files, and checkpoints that load in JAX's load_checkpoint."""
    ply = tmp_path / "ply"
    ply.mkdir()
    frames = _frames()
    for t, pts in enumerate(frames):
        write_ply_ascii(str(ply / f"frame{t:04d}.ply"), pts)
    out = tmp_path / "out"
    stats = cli.main([
        "--overfit", "True", "--encode", "True", "--decode", "True", "--frame_num", "2",
        "--gop_size", "1", "--first_epoch", "1", "--others_epoch", "1",
        "--ori_dir", str(ply), "--handle_dir", str(tmp_path / "tmp"),
        "--result_dir", str(out), "--encode_dir", str(tmp_path / "enc"),
        "--decode_dir", str(tmp_path / "dec"), "--device", "cpu",
    ])
    assert stats["points"] > 0 and stats["train_s"] > 0
    for t, pts in enumerate(frames):
        got = read_ply(str(tmp_path / "dec" / f"frame{t:04d}.ply"))
        np.testing.assert_array_equal(got, np.unique(pts, axis=0))
    assert sorted(os.listdir(tmp_path / "tmp")) == [
        "frame0000.npz", "frame0001.npz", "gop_0_0_xyzlow.bin", "gop_1_1_xyzlow.bin"]
    s_num = PyramidDataset(str(ply), device="cpu")[0].scale_num
    template = _jax_template(s_num)
    steps = []
    for name, epochs in (("gop_0_0", 1), ("gop_1_1", 1)):
        with open(out / name / "result.json") as f:
            assert [e["epoch"] for e in json.load(f)] == list(range(epochs))
        params, opt, meta = jax_load_checkpoint(str(out / name / "model.npz"), template)
        flat = np.asarray(jax_flatten(params))
        assert np.isfinite(flat).all() and meta["bitdepth"] == 8
        mine = params_to_flat(params_from_flat(flat, ModelConfig(scale_num=s_num)))
        np.testing.assert_array_equal(mine, flat)
        steps.append(int(opt["t"]))
    assert steps[1] > steps[0] >= 1  # GOP 1 went on from GOP 0's Adam state
