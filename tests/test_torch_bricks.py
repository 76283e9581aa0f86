"""The bricks trainer (``overfit_gop(backend="bricks")``) against the JAX
package, float32 on the CPU: the brick level and the GOP batch bit for bit,
the brick convs at the tolerance of JAX's own brick tests
(tests/test_bricks.py), one frame's loss and gradient, one two-frame epoch
of the epoch trainer, and overfit_gop end to end with the port's encode and
a lossless decode; configurations off the brick grid are refused.

Inputs come from numpy seeds over ``synthetic_cloud(1500, depth=6)``
frames; both packages read one numpy-drawn flat parameter vector in their
flatten order.  JAX compiles three times in this file
(tests/jax_reference.py's options), each in ``slow`` cases (run them with
``-m slow``): one jit of the frame loss's value_and_grad that also returns
the brick convs on one level (~30 s on the CPU, ~60 s in the 6-worker
suite), the epoch trainer's own step (~40 s), and one jit of JAX's public
brick-network functions on one frame (~15 s).  The cases that compile
nothing run by default: the level and the batch bit for bit against JAX,
the brick-network names against the superbrick pass they wrap,
overfit_gop end to end, the refusals."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.models import ModelConfig as JaxConfig
from linr_pcgc_tpu.models import brick_network as jbn
from linr_pcgc_tpu.models import flatten_params as jax_flatten
from linr_pcgc_tpu.models import init_params as jax_init
from linr_pcgc_tpu.models import unflatten_params as jax_unflatten
from linr_pcgc_tpu.ops import bricks as jbricks
from linr_pcgc_tpu.runtime import adam_init as jax_adam_init
from linr_pcgc_tpu.runtime import brick_overfit as jbo
from linr_pcgc_tpu.runtime import overfit as jov
from linr_pcgc_tpu_torch.data import PyramidDataset, read_ply, synthetic_cloud
from linr_pcgc_tpu_torch.models import ModelConfig, param_tree, params_from_flat
from linr_pcgc_tpu_torch.models import brick_network as tbn
from linr_pcgc_tpu_torch.models import sb_network as tsbn
from linr_pcgc_tpu_torch.models.network import param_spec
from linr_pcgc_tpu_torch.ops import bricks as tbricks
from linr_pcgc_tpu_torch.ops import superbricks as tsb
from linr_pcgc_tpu_torch.runtime import brick_overfit as tbo
from linr_pcgc_tpu_torch.runtime import decode_gop, encode_gop
from linr_pcgc_tpu_torch.runtime import overfit as tov

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)

CONV = dict(rtol=2e-4, atol=2e-5)  # tests/test_bricks.py's brick-conv tolerance
CONV3_SHAPES = [(8, 8), (7, 8)]  # (Cin, Cout): a block conv, a context block's conv_in
CONV1_SHAPES = [(8, 4), (24, 1)]  # the inception branch's c10, the stage head's last layer
CONV_LEVEL = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n=2):
    return [synthetic_cloud(1500, depth=6, seed=7, phase=0.08 * t) for t in range(n)]


@pytest.fixture(scope="module")
def gop():
    """A 2-frame GOP, both packages' brick batches and one parameter set of
    the default config (uniform in +-0.1, about the init's conv scale)."""
    ds = PyramidDataset(_frames(), device="cpu")
    pyrs = [ds[0], ds[1]]
    cfg, jcfg = ModelConfig(scale_num=ds.scale_num), JaxConfig(scale_num=ds.scale_num)
    n = sum(int(np.prod(shape)) for _, shape in param_spec(cfg))
    flat = np.random.default_rng(5).uniform(-0.1, 0.1, n).astype(np.float32)
    template = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    return dict(ds=ds, pyrs=pyrs, cfg=cfg, jcfg=jcfg, flat=flat,
                jparams=jax_unflatten(template, jnp.asarray(flat)),
                jbatch=jbo.assemble_gop_bricks(pyrs), tbatch=tbo.assemble_gop_bricks(pyrs, "cpu"))


def _level(pyr, s, brick):
    lev = pyr.levels[s]
    return brick.build_brick_level(lev.coords[: lev.n], lev.occ[: lev.n],
                                   lev.feat_code[: lev.n], s)


def _conv_inputs(pyr):
    """Level CONV_LEVEL of frame 0 and seeded channel-major inputs and
    weights for every conv shape: {(kind, cin, cout): (x, w, b)}."""
    lev = _level(pyr, CONV_LEVEL, tbricks)
    mask = lev.slot_mask.astype(np.float32)
    rng = np.random.default_rng(12)
    cases = {}
    for kind, shapes, kvol in (("conv3", CONV3_SHAPES, (27,)), ("conv1", CONV1_SHAPES, ())):
        for cin, cout in shapes:
            x = rng.standard_normal((lev.n_bricks, cin, 64)).astype(np.float32) * mask[:, None]
            w = (rng.standard_normal((*kvol, cin, cout)) / np.sqrt(cin * max(kvol, default=1))
                 ).astype(np.float32)
            cases[kind, cin, cout] = (x, w, rng.standard_normal(cout).astype(np.float32))
    return lev, cases


@pytest.fixture(scope="module")
def jax_ref(gop):
    """JAX's compile of this file's references: frame 0's (loss, flat
    gradient) of jax.value_and_grad(brick_frame_loss), and _bconv3 and
    _bconv1 on one level at every conv shape, float32."""
    jb = gop["jbatch"]
    fd = {k: getattr(jb, k)[0] for k in ("nbr27", "mask", "code", "occ", "point_num")}
    lev, cases = _conv_inputs(gop["pyrs"][0])
    geom = dict(nbr27=jnp.asarray(lev.nbr27),
                mask=jnp.asarray(lev.slot_mask.astype(np.float32))[:, None, :],
                dtype=jnp.float32)
    conv = {"conv3": jbn._bconv3, "conv1": jbn._bconv1}

    def refs(params, fd, cases):
        loss_grad = jax.value_and_grad(
            lambda p: jbo.brick_frame_loss(p, gop["jcfg"], fd, jb.level_slices))(params)
        return loss_grad, {key: conv[key[0]](x, geom, {"w": w, "b": b})
                           for key, (x, w, b) in cases.items()}

    (loss, grad), convs = jax.jit(refs)(gop["jparams"], fd, cases)
    return dict(loss=float(loss), grad=np.asarray(jax_flatten(grad)),
                convs={k: np.asarray(v) for k, v in convs.items()})


# ------------------------------------------------------ level and batch --


def test_brick_level_equals_jax(gop):
    """Every level of both frames: the same bricks, neighbour map, slot
    mask, scale codes, occupancy and voxel placement, bit for bit and in
    JAX's dtypes."""
    for pyr in gop["pyrs"]:
        for s in range(pyr.scale_num):
            mine, theirs = _level(pyr, s, tbricks), _level(pyr, s, jbricks)
            assert mine.n_vox == theirs.n_vox and mine.n_bricks == theirs.n_bricks
            for name in ("brick_coords", "nbr27", "slot_mask", "scale_code", "occ",
                         "voxel_brick", "voxel_slot"):
                got, want = getattr(mine, name), getattr(theirs, name)
                assert got.dtype == want.dtype, name
                np.testing.assert_array_equal(got, want, err_msg=f"level {s} {name}")
    assert (tbricks.SLOTS, tbricks.EMPTY_CODE_SENTINEL) == (jbricks.SLOTS,
                                                            jbricks.EMPTY_CODE_SENTINEL)


def test_assemble_gop_bricks_equals_jax(gop):
    jb, tb = gop["jbatch"], gop["tbatch"]
    assert tb.level_slices == jb.level_slices and tb.n_frames == 2
    for name in ("nbr27", "mask", "code", "occ", "point_num"):
        want = np.asarray(getattr(jb, name))
        got = getattr(tb, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for n in (1, 256, 257, 700, 20_480, 1_000_001):
        assert tbo._brick_bucket(n) == jbo._brick_bucket(n)


# ---------------------------------------------------------- the convs --


@pytest.mark.slow
@pytest.mark.parametrize("kind,cin,cout", [("conv3", *s) for s in CONV3_SHAPES]
                         + [("conv1", *s) for s in CONV1_SHAPES])
def test_brick_convs_match_jax(gop, jax_ref, kind, cin, cout):
    """bconv3 (K2 -> K1 at S = 1 on the card) and bconv1 on JAX's
    channel-major layout against _bconv3 and _bconv1: (conv(x) + b) *
    mask, exact zeros at the empty slots."""
    lev, cases = _conv_inputs(gop["pyrs"][0])
    x, w, b = cases[kind, cin, cout]
    geom = tbn.brick_geom(torch.as_tensor(lev.nbr27), torch.as_tensor(lev.slot_mask), None,
                          torch.float32)
    fn = tbn.bconv3 if kind == "conv3" else tbn.bconv1
    got = fn(torch.as_tensor(x), geom, {"w": torch.as_tensor(w), "b": torch.as_tensor(b)})
    assert got.shape == (lev.n_bricks, cout, 64)
    np.testing.assert_allclose(got.numpy(), jax_ref["convs"][kind, cin, cout], **CONV)
    assert bool((got.permute(0, 2, 1)[torch.as_tensor(~lev.slot_mask)] == 0).all())
    np.testing.assert_array_equal(tsb.to_channel_major(tsb.to_slot_major(got)).numpy(),
                                  got.numpy())


# ---------------------------------------------------- loss and trainer --


def _frame0(gop):
    """Frame 0 of the port's brick batch: its network geom (f32), dense
    occupancy (Bb, 8, 64) f32 and the nested parameters."""
    cfg, tb = gop["cfg"], gop["tbatch"]
    fd = next(tbo.brick_frames(tb))
    geom = tbn.brick_geom(fd["nbr27"], fd["code"] >= 0, fd["code"], torch.float32)
    return geom, fd["occ"].float(), param_tree(params_from_flat(gop["flat"], cfg))


def test_brick_network_is_the_superbrick_pass(gop):
    """JAX's brick-network names on frame 0, f32, without JAX: the logits
    of brick_forward_all_stages are sb_forward_all_stages's with the stage
    axis first, and brick_training_bits their masked BCE (sb_training_bits),
    bit for bit;
    brick_input_features is the superbrick embedding, channel-major; the
    stage functions on x_glob give stages 0 and 3 of those logits (1e-5:
    a stage batch of one against one of eight); and halo_exchange's halo
    times conv_weight_matrix, plus the bias and masked, is bconv3 (1e-5)."""
    cfg, tb = gop["cfg"], gop["tbatch"]
    geom, occ, params = _frame0(gop)
    slices = tb.level_slices
    sb_slices = tbn.sb_level_slices(slices)
    logits = tbn.brick_forward_all_stages(params, cfg, geom, occ, slices)
    want = tsbn.sb_forward_all_stages(params, cfg, geom, occ, sb_slices)
    assert tuple(logits.shape) == (cfg.outstage, occ.shape[0], 64)
    assert torch.equal(logits, want.transpose(0, 1))
    assert torch.equal(tbn.brick_training_bits(params, cfg, geom, occ, slices),
                       tsbn._masked_bits(want, geom, occ, 0, cfg.outstage))
    feats = tbn.brick_input_features(params, cfg, geom, slices)
    assert torch.equal(feats, tsb.to_channel_major(
        tsbn.sb_input_features(params, cfg, geom, sb_slices))[:, 0])
    x_glob = tsb.to_channel_major(tsbn.sb_x_glob(params, cfg, geom, sb_slices))[:, 0]
    for stage in (0, 3):
        ctx = tbn.brick_stage_context(params, cfg, stage, x_glob, occ[:, :cfg.outstage - 1], geom)
        torch.testing.assert_close(tbn.brick_stage_head(params, stage, ctx, geom), logits[stage],
                                   rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(14)
    mask = geom["mask"][:, 0]  # (Bb, 1, 64)
    x = torch.as_tensor(rng.standard_normal((occ.shape[0], 8, 64)).astype(np.float32)) * mask
    w = torch.as_tensor((rng.standard_normal((27, 8, 4)) / np.sqrt(8 * 27)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal(4).astype(np.float32))
    y = tbn.halo_exchange(x, geom["nbr27"]) @ tbn.conv_weight_matrix(w)
    torch.testing.assert_close((y.reshape(-1, 4, 64) + b[:, None]) * mask,
                               tbn.bconv3(x, geom, {"w": w, "b": b}), rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_brick_network_functions_match_jax(gop):
    """JAX's public brick-network functions against the port's on frame 0,
    f32, in one jit: brick_input_features, the context and head of stage 3
    from JAX's x_glob (block_in on the features), brick_forward_all_stages
    and brick_training_bits at the brick-conv tolerance (the bits to 1e-5
    relative), halo_exchange and conv_weight_matrix bit for bit."""
    cfg, jcfg, jb, tb = gop["cfg"], gop["jcfg"], gop["jbatch"], gop["tbatch"]
    geom, occ, params = _frame0(gop)
    jgeom = dict(nbr27=jnp.asarray(jb.nbr27[0]),
                 mask=jnp.asarray(jb.mask[0]).astype(jnp.float32)[:, None, :],
                 code=jnp.asarray(jb.code[0]), dtype=jnp.float32)
    jocc = jnp.asarray(jb.occ[0]).astype(jnp.float32)
    rng = np.random.default_rng(15)
    x = (rng.standard_normal((occ.shape[0], 8, 64)).astype(np.float32)
         * geom["mask"][:, 0].numpy())
    w = rng.standard_normal((27, 8, 4)).astype(np.float32)
    stage = 3

    def refs(p, x, w):
        feats = jbn.brick_input_features(p, jcfg, jgeom, jb.level_slices)
        x_glob = jbn._bblock(feats, jgeom, p["block_in"])
        ctx = jbn.brick_stage_context(p, jcfg, stage, x_glob, jocc[:, :jcfg.outstage - 1], jgeom)
        return dict(feats=feats, x_glob=x_glob, ctx=ctx,
                    head=jbn.brick_stage_head(p, stage, ctx, jgeom),
                    logits=jbn.brick_forward_all_stages(p, jcfg, jgeom, jocc, jb.level_slices),
                    bits=jbn.brick_training_bits(p, jcfg, jgeom, jocc, jb.level_slices),
                    halo=jbn.halo_exchange(x, jgeom["nbr27"]), w2=jbn.conv_weight_matrix(w))

    want = {k: np.asarray(v) for k, v in jax.jit(refs)(gop["jparams"], x, w).items()}
    slices = tb.level_slices
    x_glob = torch.tensor(want["x_glob"])
    ctx = tbn.brick_stage_context(params, cfg, stage, x_glob, occ[:, :cfg.outstage - 1], geom)
    got = dict(feats=tbn.brick_input_features(params, cfg, geom, slices), ctx=ctx,
               head=tbn.brick_stage_head(params, stage, ctx, geom),
               logits=tbn.brick_forward_all_stages(params, cfg, geom, occ, slices))
    for k, v in got.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], **CONV, err_msg=k)
    np.testing.assert_allclose(float(tbn.brick_training_bits(params, cfg, geom, occ, slices)),
                               float(want["bits"]), rtol=1e-5)
    np.testing.assert_array_equal(tbn.halo_exchange(torch.as_tensor(x), geom["nbr27"]).numpy(),
                                  want["halo"])
    np.testing.assert_array_equal(tbn.conv_weight_matrix(torch.as_tensor(w)).numpy(), want["w2"])


@pytest.mark.slow
def test_frame_loss_and_gradient_match_jax(gop, jax_ref):
    """Frame 0: brick_frame_loss (all 8 stages in one pass) and the
    trainer's stage-by-stage frame gradient against JAX's
    value_and_grad(brick_frame_loss): loss to 1e-5 relative, gradient to
    rtol 1e-4 / atol 1e-6."""
    cfg, tb = gop["cfg"], gop["tbatch"]
    fd = next(tbo.brick_frames(tb))
    loss = tbo.brick_frame_loss(param_tree(params_from_flat(gop["flat"], cfg)), cfg, fd,
                                tb.level_slices)
    fg = tbo.make_frame_grads_bricks(cfg, tb.level_slices, torch.float32)
    loss_g, grad = fg(torch.as_tensor(gop["flat"]), fd)
    for got in (loss, loss_g):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), jax_ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), jax_ref["grad"], rtol=1e-4, atol=1e-6)
    assert float(grad.abs().max()) > 0


@pytest.mark.slow
def test_epoch_matches_jax_trainer(gop):
    """One f32 epoch of make_epoch_fn_bricks on the two frames (two Adam
    steps) from the same parameters: losses to rtol 2e-3, parameters to
    rtol 5e-2 / atol 5e-3 (tests/test_bricks.py's trainer envelope), the
    same schedule count and learning rate."""
    tc = tov.TrainConfig()
    jb, tb = gop["jbatch"], gop["tbatch"]
    jfn = jbo.make_epoch_fn_bricks(gop["jcfg"], tc, jb.level_slices, compute_dtype=jnp.float32)
    tfn = tbo.make_epoch_fn_bricks(gop["cfg"], tc, tb.level_slices, compute_dtype=torch.float32)
    jp, jo, jlr, jk, jl = jfn(gop["jparams"], jax_adam_init(gop["jparams"]),
                              jnp.asarray(tc.learning_rate, jnp.float32),
                              jnp.zeros((), jnp.int32), jb)
    tp = torch.as_tensor(gop["flat"])
    tp, to, tlr, tk, tl = tfn(tp, tov.adam_init(tp), np.float32(tc.learning_rate), 0, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3)
    assert tk == int(jk) == 2 and to["t"] == int(jo["t"]) and tlr == np.float32(jlr)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jax_flatten(jp)), rtol=5e-2, atol=5e-3)


# ---------------------------------------------------------- overfit_gop --


def test_overfit_gop_bricks_encodes_and_decodes_losslessly(gop, tmp_path):
    """overfit_gop(backend="bricks") in f32 on a one-frame GOP for one
    epoch writes JAX's artifacts; its checkpoint encodes through the port's
    codec and decodes losslessly."""
    ds = gop["ds"]
    cfg = gop["cfg"]
    path = tov.overfit_gop(ds, [0], 1, cfg, tov.TrainConfig(), str(tmp_path / "out"),
                           handle_dir=str(tmp_path / "h"), device="cpu", backend="bricks",
                           train_dtype="f32")
    assert path == str(tmp_path / "out" / "gop_0_0" / "model.npz") and os.path.isfile(path)
    with open(tmp_path / "out" / "gop_0_0" / "result.json") as f:
        entries = json.load(f)
    assert [e["epoch"] for e in entries] == [0] and np.isfinite(entries[0]["loss"])
    assert entries[0]["loss"] > 0
    encode_gop(path, [ds[0]], str(tmp_path / "enc"), cfg, device="cpu")
    decode_gop(str(tmp_path / "enc"), str(tmp_path / "dec"), cfg, write_flag=True, device="cpu",
               ground_truth=lambda i: ds.raw_sorted_points(i))
    np.testing.assert_array_equal(read_ply(str(tmp_path / "dec" / "frame0000.ply")),
                                  np.unique(_frames(1)[0], axis=0))


@pytest.mark.parametrize("kw,what", [({"block_type": "dilation"}, "block_type 'dilation'"),
                                     ({"outstage": 4}, "outstage 4"),
                                     ({"kernel_size": 5}, "kernel_size 5")])
def test_bricks_refuses_configs_off_the_brick_grid(gop, tmp_path, kw, what):
    """The brick grid covers exactly the superbrick layout's configurations
    (JAX's codec._use_sb): elsewhere backend="bricks" raises a ValueError
    that names the reason, before any training; the layout's own
    configurations train with it."""
    cfg = ModelConfig(scale_num=gop["cfg"].scale_num, **kw)
    with pytest.raises(ValueError, match=f"backend 'bricks' trains kernel_size 3, outstage 8 "
                                         f"and no dilation only.*{what}"):
        tov.overfit_gop(gop["ds"], [0], 1, cfg, tov.TrainConfig(), str(tmp_path), device="cpu",
                        backend="bricks")
    assert not os.path.exists(tmp_path / "gop_0_0" / "model.npz")
    for ok in ({}, {"block_layers": 2}, {"block_type": "resnet"}):
        assert tov.select_backend(ModelConfig(**ok), "bricks") == "bricks"
