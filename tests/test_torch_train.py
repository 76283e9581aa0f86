"""The trainer slice against the JAX package, float32 on the CPU: K3's
plain version, the conv's gradients, the GOP assembly, Adam, two epochs of
the epoch trainer, and the CLI's overfit -> encode -> decode.  K4's plain
version, the tap map and its 27-tap dw formula are in
tests/test_torch_moment.py, its launch plan in tests/test_torch_kernels.py.

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
from linr_pcgc_tpu.runtime import adam_init as jax_adam_init
from linr_pcgc_tpu.runtime import load_checkpoint as jax_load_checkpoint
from linr_pcgc_tpu.runtime import overfit as jov
from linr_pcgc_tpu.runtime import sb_overfit as jsbo
from linr_pcgc_tpu_torch import cli
from linr_pcgc_tpu_torch.data import PyramidDataset, read_ply, synthetic_cloud, write_ply_ascii
from linr_pcgc_tpu_torch.models import ModelConfig, params_from_flat, params_to_flat
from linr_pcgc_tpu_torch.models.network import param_spec
from linr_pcgc_tpu_torch.ops import plane_conv, superbricks as tsb
from linr_pcgc_tpu_torch.runtime import overfit as tov
from linr_pcgc_tpu_torch.runtime import sb_overfit as tsbo

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)


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
