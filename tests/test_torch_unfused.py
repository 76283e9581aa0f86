"""The trainer's unfused pass against the JAX package, float32 on the CPU:
the configs whose block_in does not ride the stage chunks (block_layers 2,
resnet blocks).  sb_x_glob and sb_chunk_bits on one tiny level, the stage
chunk rule, and two epochs of the epoch trainer against JAX's
make_epoch_fn_sb.

Inputs come from numpy seeds; both packages read one numpy-drawn flat
parameter vector in their flatten order.  JAX's functions are jitted with
the geometry closed over (one compile each); its trainer runs in its
default XLA conv mode."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.models import ModelConfig as JaxConfig
from linr_pcgc_tpu.models import flatten_params as jax_flatten
from linr_pcgc_tpu.models import init_params as jax_init
from linr_pcgc_tpu.models import sb_network as jnet
from linr_pcgc_tpu.models import unflatten_params as jax_unflatten
from linr_pcgc_tpu.runtime import adam_init as jax_adam_init
from linr_pcgc_tpu.runtime import sb_overfit as jsbo
from linr_pcgc_tpu_torch.data import PyramidDataset, build_pyramid, synthetic_cloud
from linr_pcgc_tpu_torch.models import ModelConfig, param_tree, params_from_flat
from linr_pcgc_tpu_torch.models import sb_network as tnet
from linr_pcgc_tpu_torch.models.network import param_spec
from linr_pcgc_tpu_torch.ops.coords import coord_key
from linr_pcgc_tpu_torch.ops.superbricks import dev_brickify
from linr_pcgc_tpu_torch.parallel import launch as tlaunch
from linr_pcgc_tpu_torch.runtime import brick_overfit as tbo
from linr_pcgc_tpu_torch.runtime import overfit as tov
from linr_pcgc_tpu_torch.runtime import sb_overfit as tsbo

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)

UNFUSED = [{"block_layers": 2}, {"block_type": "resnet"}]
IDS = ["block_layers2", "resnet"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(cfg: ModelConfig, seed: int) -> np.ndarray:
    n = sum(int(np.prod(shape)) for _, shape in param_spec(cfg))
    return np.random.default_rng(seed).uniform(-0.1, 0.1, n).astype(np.float32)


def _jax_params(jcfg, flat):
    template = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    return jax_unflatten(template, jnp.asarray(flat))


# ------------------------------------------------------------ the network --


@pytest.fixture(scope="module")
def level():
    """Level 1 of a small cloud: geometry and occupancy on both sides."""
    pyr = build_pyramid(synthetic_cloud(1500, depth=6, seed=2), device="cpu")
    lev, scale = pyr.levels[1], 1
    coords = torch.as_tensor(lev.coords)
    keys = coord_key(coords, torch.arange(len(coords)) < lev.n)
    geo = dev_brickify(coords, keys, scale, 64)
    occ = np.zeros((64, 8, 64), np.float32)
    vb, vs = geo["vox_brick"][: lev.n].numpy(), geo["vox_slot"][: lev.n].numpy()
    occ[vb, :, vs] = lev.occ[: lev.n]
    code, nbr = geo["code"], geo["nbr27"]
    tgeom = dict(nbr27=nbr, mask=(code >= 0).float()[:, None, None, :], code=code,
                 dtype=torch.float32)
    jgeom = dict(nbr27=jnp.asarray(nbr.numpy()), mask=jnp.asarray(tgeom["mask"].numpy()),
                 code=jnp.asarray(code.numpy()), dtype=jnp.float32)
    return dict(scale_num=pyr.scale_num, scale=scale, occ=occ, tgeom=tgeom, jgeom=jgeom)


@pytest.fixture(scope="module", params=UNFUSED, ids=IDS)
def net(request, level):
    """One unfused config: both parameter sets and both x_glob."""
    cfg = ModelConfig(scale_num=level["scale_num"], **request.param)
    jcfg = JaxConfig(scale_num=level["scale_num"], **request.param)
    flat = _flat(cfg, 11)
    tparams = param_tree(params_from_flat(flat, cfg))
    jparams = _jax_params(jcfg, flat)
    slices = [(0, 64, level["scale"])]
    txg = tnet.sb_x_glob(tparams, cfg, level["tgeom"], slices)
    jxg = jax.jit(lambda p: jnet.sb_x_glob(p, jcfg, level["jgeom"], slices))(jparams)
    return dict(cfg=cfg, jcfg=jcfg, tparams=tparams, jparams=jparams, txg=txg, jxg=jxg)


def test_sb_x_glob_matches_jax(net):
    """block_in at two layers or as resnet blocks: the network test's
    tolerance (the same products summed in another order through the
    stacked convs)."""
    assert net["txg"].shape == (64, 1, 64 * 8)
    np.testing.assert_allclose(net["txg"].numpy(), np.asarray(net["jxg"]), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("base,cs", [(0, 8), (4, 4)])
def test_sb_chunk_bits_matches_jax(level, net, base, cs):
    """The unfused chunk's bits (stage 0's gated-off row computed, as the
    JAX trainer computes it) given the same x_glob, f32, rtol/atol 1e-5;
    and the bits are finite and positive."""
    xg = np.array(net["jxg"])  # a writable copy
    occ = level["occ"]
    got = tnet.sb_chunk_bits(net["tparams"], net["cfg"], level["tgeom"], torch.as_tensor(occ),
                             base, cs, torch.as_tensor(xg))
    want = jax.jit(lambda p, o, x: jnet.sb_chunk_bits(p, net["jcfg"], level["jgeom"], o, base, cs,
                                                      x))(net["jparams"], jnp.asarray(occ),
                                                          jnp.asarray(xg))
    assert got.dtype == torch.float32 and float(got) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------- the stage chunk --


def test_stage_chunk_picker_unfused_widths():
    """JAX's base widths: the fused pass starts from 8 (bf16) or 4 (f32),
    the unfused from 4 or 2, each then capped by the memory budget; at the
    smoke's level-0 group (81,920 bricks) both passes take 4, at its
    levels 1-6 (27,264) the fused takes 8 and the unfused 4."""
    total = 163_840  # production scale: not the small-batch rule
    fused = ModelConfig()
    for kw in UNFUSED:
        cfg = ModelConfig(**kw)
        assert not tsbo.is_fused(cfg)
        for bricks, want_f, want_u in ((81_920, 4, 4), (27_264, 8, 4)):
            assert tsbo.stage_chunk_picker(fused, total, torch.bfloat16)(bricks) == want_f
            assert tsbo.stage_chunk_picker(cfg, total, torch.bfloat16)(bricks) == want_u
        assert tsbo.stage_chunk_picker(cfg, total, torch.float32)(27_264) == 2
        assert tsbo.stage_chunk_picker(cfg, 100, torch.bfloat16)(100) == 8  # small: outstage
    assert tsbo.is_fused(fused)


def test_overfit_gop_dispatches_like_jax(tmp_path, monkeypatch):
    """JAX's overfit_gop dispatch.  On one device: dilation, kernel sizes
    other than 3 and outstage other than 8 stay off the superbrick layout
    and go to the gather trainer (held against JAX in
    tests/test_torch_gather.py), the default and unfused configs to the
    superbrick trainer.  On devices > 1: the layout's configs train
    stage-parallel where the rank count divides outstage ("sb_sp") and
    frame-parallel on the layout where it does not ("sb_dp"), every other
    config frame-parallel on the gather backend ("dp"), and an explicit
    backend keeps JAX's meaning ("sb_dp" stays, others go to "dp" off the
    layout).  "bricks" on one device takes the brick grid's trainer (held
    against JAX in tests/test_torch_bricks.py); an unknown backend raises.
    The epoch functions and the launch of the ranks are stubbed:
    only the choice is checked here (the parallel trainers are trained in
    tests/test_torch_parallel.py)."""
    ds = PyramidDataset([synthetic_cloud(1500, depth=6, seed=3)], device="cpu")
    chosen = []

    def stub(name):
        def make(*args, **kwargs):
            chosen.append(name)
            return lambda flat, opt, lr, k, batch: (flat, opt, lr, k + 1, torch.ones(1))
        return make

    monkeypatch.setattr(tov, "make_epoch_fn", stub("gather"))
    monkeypatch.setattr(tsbo, "make_epoch_fn_sb", stub("sb"))
    monkeypatch.setattr(tlaunch, "launch", lambda target, devs, args, *rest: chosen.append(
        (args[0].backend, len(devs))) or args[0].model_path)
    kws = ({"block_type": "dilation"}, {"kernel_size": 5}, {"outstage": 4}, {}) + tuple(UNFUSED)

    def run(i, kw, **opts):
        tov.overfit_gop(ds, [0], 1, ModelConfig(scale_num=ds[0].scale_num, **kw),
                        tov.TrainConfig(), str(tmp_path / str(i)), handle_dir=str(tmp_path / "h"),
                        device="cpu", **opts)

    for i, kw in enumerate(kws):
        run(i, kw)
    assert chosen == ["gather"] * 3 + ["sb"] * 3
    chosen.clear()
    for i, kw in enumerate(kws):
        run(i, kw, devices=2)
    run(0, {}, devices=3)
    run(0, {}, devices=4, backend="sb_dp")
    run(0, {"outstage": 4}, devices=2, backend="sb_sp")
    run(0, {}, backend="dp")
    assert chosen == [("dp", 2)] * 3 + [("sb_sp", 2)] * 3 + [
        ("sb_dp", 3), ("sb_dp", 4), ("dp", 2), ("dp", 1)]
    for backend, devices in (("auto", 2), ("sb_sp", 5), ("gather", 2), ("bricks", 2)):
        assert tov.select_backend(ModelConfig(), backend, devices) == {
            "auto": "sb_sp", "sb_sp": "sb_dp", "gather": "dp", "bricks": "dp"}[backend]
    chosen.clear()
    monkeypatch.setattr(tbo, "make_epoch_fn_bricks", stub("bricks"))
    run(0, {}, backend="bricks")
    assert chosen == ["bricks"]
    with pytest.raises(ValueError, match="backend 'bogus'"):
        tov.select_backend(ModelConfig(), "bogus")


# ------------------------------------------------------------ the trainer --


@pytest.fixture(scope="module")
def gop():
    ds = PyramidDataset([synthetic_cloud(1500, depth=6, seed=7, phase=0.08 * t)
                         for t in range(2)], device="cpu")
    pyrs = [ds[0], ds[1]]
    return dict(pyrs=pyrs, scale_num=ds.scale_num, jbatch=jsbo.assemble_gop_superbricks(pyrs),
                tbatch=tsbo.assemble_gop_superbricks(pyrs, "cpu"))


@pytest.mark.parametrize("kw", UNFUSED, ids=IDS)
def test_two_epochs_unfused_match_jax_trainer(gop, kw):
    """Two epochs of the port's epoch trainer on the unfused pass against
    JAX's make_epoch_fn_sb from one parameter set, f32, with two level
    groups and stage chunks of 4 forced on both (so d(x_glob) sums over two
    chunks).  Per-frame losses rtol/atol 2e-4 and final params rtol 1e-2 /
    atol 1e-4, the tolerances of the fused trainer's test."""
    tc = tov.TrainConfig()
    cfg = ModelConfig(scale_num=gop["scale_num"], **kw)
    jcfg = JaxConfig(scale_num=gop["scale_num"], **kw)
    flat = _flat(cfg, 5)
    jb, tb = gop["jbatch"], gop["tbatch"]
    cap = max(jb.level_slices[-1][1] // 2, 64)
    jfn = jsbo.make_epoch_fn_sb(jcfg, tc, jb.level_slices, compute_dtype=jnp.float32,
                                max_group_bricks=cap, stage_chunk=4)
    tfn = tsbo.make_epoch_fn_sb(cfg, tc, tb.level_slices, compute_dtype=torch.float32,
                                max_group_bricks=cap, stage_chunk=4)
    assert all(cs == 4 for _, _, cs in tfn.units) and len(tfn.units) >= 2
    jp = _jax_params(jcfg, flat)
    jo = jax_adam_init(jp)
    jlr, jk = jnp.asarray(tc.learning_rate, jnp.float32), jnp.zeros((), jnp.int32)
    tp = torch.as_tensor(flat)
    to, tlr, tk = tov.adam_init(tp), np.float32(tc.learning_rate), 0
    for _ in range(2):
        jp, jo, jlr, jk, jl = jfn(jp, jo, jlr, jk, jb)
        tp, to, tlr, tk, tl = tfn(tp, to, tlr, tk, tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    assert tk == int(jk) and tlr == np.float32(jlr)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jax_flatten(jp)), rtol=1e-2, atol=1e-4)


def _frame(batch, i):
    return dict(nbr27=batch.nbr27[i], code=batch.code[i], occ=batch.occ[i],
                point_num=batch.point_num[i])


@pytest.mark.parametrize("kw", UNFUSED, ids=IDS)
def test_frame_grads_unfused_bf16_match_jax(gop, kw):
    """One frame's loss and gradient on the unfused pass in bf16 (the
    trainer's dtype) against JAX's make_frame_grads_sb in bf16, with stage
    chunks of 2 (d(x_glob) summed in bf16 over four chunks).  The loss within rtol 1e-4; the gradient within 3e-2 of JAX's
    in relative L2 norm (about four bf16 epsilons: both are bf16 networks
    rounding in different orders), and no farther from the port's f32
    gradient than twice JAX's bf16 gradient is."""
    cfg = ModelConfig(scale_num=gop["scale_num"], **kw)
    jcfg = JaxConfig(scale_num=gop["scale_num"], **kw)
    flat = _flat(cfg, 5)
    jb, tb = gop["jbatch"], gop["tbatch"]
    jfg = jax.jit(jsbo.make_frame_grads_sb(jcfg, jb.level_slices, compute_dtype=jnp.bfloat16,
                                           stage_chunk=2))
    jl, jg = jfg(_jax_params(jcfg, flat), _frame(jb, 0))
    jg = np.asarray(jax_flatten(jg))
    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        fg = tsbo.make_frame_grads_sb(cfg, tb.level_slices, compute_dtype=dtype,
                                      stage_chunk=2)
        assert [cs for _, _, cs in fg.units] == [2]
        loss, g = fg(torch.as_tensor(flat), _frame(tb, 0))
        grads[dtype] = g.numpy()
        if dtype == torch.bfloat16:
            np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    tg, fg32 = grads[torch.bfloat16], grads[torch.float32]
    assert np.linalg.norm(tg - jg) <= 3e-2 * np.linalg.norm(jg)
    assert np.linalg.norm(tg - fg32) <= 2 * np.linalg.norm(jg - fg32)


def test_x_glob_grad_sums_in_bf16_in_chunk_order(gop, monkeypatch):
    """On the bf16 unfused pass d(x_glob) stays bf16 and is the chunk-ordered
    bf16 sum of the chunks' gradients, as JAX's gx_a: no hidden f32
    accumulation (four chunks, so that one rounding per add shows)."""
    cfg = ModelConfig(scale_num=gop["scale_num"], block_layers=2)
    tb = gop["tbatch"]
    seen = {}
    chunk_bits = tsbo.sb_chunk_bits

    def recording(params, cfg_, geom, occ, base, cs, xg):
        if id(xg) not in seen:
            seen[id(xg)] = (xg, [])
            xg.register_hook(lambda g, got=seen[id(xg)][1]: got.append(g.clone()))
        return chunk_bits(params, cfg_, geom, occ, base, cs, xg)

    monkeypatch.setattr(tsbo, "sb_chunk_bits", recording)
    fg = tsbo.make_frame_grads_sb(cfg, tb.level_slices, compute_dtype=torch.bfloat16,
                                  stage_chunk=2)
    fg(torch.as_tensor(_flat(cfg, 5)), _frame(tb, 0))
    rounded_apart = False
    for xg, chunk_grads in seen.values():
        assert len(chunk_grads) == 4 and all(g.dtype == torch.bfloat16 for g in chunk_grads)
        want = chunk_grads[0]
        for g in chunk_grads[1:]:
            want = want + g
        assert xg.grad.dtype == torch.bfloat16 and torch.equal(xg.grad, want)
        f32 = torch.stack([g.float() for g in chunk_grads]).sum(0).to(torch.bfloat16)
        rounded_apart |= not torch.equal(f32, want)
    assert seen and rounded_apart  # the data tells the two sums apart
