"""The host-AC superbrick codec (``encode_gop_streams_sb`` /
``decode_gop_streams_sb``, runtime/sb_codec.py) and JAX's 8^3 and
channel-major layouts on the port's 4^3 conv (the sub-brick map of
ops/superbricks.py), against the JAX package, float32 on the CPU.

Inputs come from numpy seeds over ``synthetic_cloud(1500, depth=6)``
frames; both packages read one numpy-drawn flat parameter vector in their
flatten order.  JAX compiles its codec network once per level and side
(its level slices are static), so the tier-1 cases compare one level a
side (two compile pairs) and the convs in one jit; the whole-GOP rates and
a side-8 epoch against JAX are ``slow`` (``-m slow``).  The host geometry
is compared bit for bit with no compile; the port's round trips, the
sub-brick map and side 8 against side 4 are the port's own."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.models import ModelConfig as JaxConfig
from linr_pcgc_tpu.models import flatten_params as jax_flatten
from linr_pcgc_tpu.models import init_params as jax_init
from linr_pcgc_tpu.models import sb_network as jsbn
from linr_pcgc_tpu.models import unflatten_params as jax_unflatten
from linr_pcgc_tpu.ops import superbricks as jsb
from linr_pcgc_tpu.runtime import adam_init as jax_adam_init
from linr_pcgc_tpu.runtime import codec as jcodec
from linr_pcgc_tpu.runtime import sb_codec as jsbc
from linr_pcgc_tpu.runtime import sb_overfit as jsbo
from linr_pcgc_tpu_torch.data import PyramidDataset, synthetic_cloud
from linr_pcgc_tpu_torch.models import ModelConfig, param_tree, params_from_flat
from linr_pcgc_tpu_torch.models import sb_network as tsbn
from linr_pcgc_tpu_torch.models.network import param_spec
from linr_pcgc_tpu_torch.ops import superbricks as tsb
from linr_pcgc_tpu_torch.runtime import TrainConfig, adam_init
from linr_pcgc_tpu_torch.runtime import codec as tcodec
from linr_pcgc_tpu_torch.runtime import sb_codec as tsbc
from linr_pcgc_tpu_torch.runtime import sb_overfit as tsbo

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)

SIDES = (4, 8)
# Two scales (levels of 1,154 and 620 voxels, 256 and 64 bricks at side 4):
# at side 8 every level costs at least a 64-superbrick bucket (512
# sub-bricks) a frame, so each scale more adds ~40 % to the side-8 cases.
SCALE_NUM = 2
PROBE_LEVEL = 1  # the level whose probabilities are held against JAX's
CONV_LEVEL = 1   # the level of the conv comparison (the smaller)
CONV_S, CONV_C, CONV_O = 2, 8, 8
CONV = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gop():
    """A 2-frame GOP and one parameter set of the default config (uniform in
    +-0.1, about the init's conv scale), in both packages' forms."""
    frames = [synthetic_cloud(1500, depth=6, seed=7, phase=0.08 * t) for t in range(2)]
    ds = PyramidDataset(frames, scale_num=SCALE_NUM, device="cpu")
    pyrs = [ds[0], ds[1]]
    cfg, jcfg = ModelConfig(scale_num=ds.scale_num), JaxConfig(scale_num=ds.scale_num)
    n = sum(int(np.prod(shape)) for _, shape in param_spec(cfg))
    flat = np.random.default_rng(5).uniform(-0.1, 0.1, n).astype(np.float32)
    template = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    return dict(frames=frames, pyrs=pyrs, cfg=cfg, jcfg=jcfg, flat=flat,
                params=param_tree(params_from_flat(flat, cfg)),
                jparams=jax_unflatten(template, jnp.asarray(flat)))


def _trimmed(pyr, s):
    lev = pyr.levels[s]
    return lev.coords[: lev.n], lev.occ[: lev.n], lev.feat_code[: lev.n]


@pytest.fixture(scope="module")
def roundtrips(gop):
    """encode_gop_streams_sb -> decode_gop_streams_sb of the GOP at each
    side, with the encoder's probabilities of PROBE_LEVEL kept:
    {side: dict(blobs, bits, decoded, probs, level_bits)}."""
    real = tsbc.encode_level_probs
    out = {}
    for side in SIDES:
        kept = {}

        def keep(params, cfg, level, device):
            probs, bits = real(params, cfg, level, device)
            if level.scale_idx == PROBE_LEVEL:
                kept.update(probs=probs, level_bits=bits)
            return probs, bits

        tsbc.encode_level_probs = keep
        try:
            blobs, bits = tcodec.encode_gop_streams_sb(gop["params"], gop["cfg"], gop["pyrs"],
                                                       "cpu", side=side)
        finally:
            tsbc.encode_level_probs = real
        decoded = tcodec.decode_gop_streams_sb(gop["params"], gop["cfg"], blobs,
                                               [p.low_coords for p in gop["pyrs"]], "cpu",
                                               side=side)
        out[side] = dict(blobs=blobs, bits=bits, decoded=decoded, **kept)
    return out


# --------------------------------------------------- host geometry ----


def test_side8_levels_and_batch_equal_jax(gop, batches):
    """build_superbrick_level(side=8) on every level of both frames (the
    same superbricks, neighbour map, codes, occupancy and voxel placement)
    and assemble_gop_superbricks(side=8) (JAX's 512-slot batch), bit for
    bit and in JAX's dtypes."""
    jb, tb = jsbo.assemble_gop_superbricks(gop["pyrs"], side=8), batches[8]
    assert tb.level_slices == jb.level_slices and tb.slots == 512
    for name in ("nbr27", "code", "occ", "point_num"):
        want, got = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for pyr in gop["pyrs"]:
        for s in range(pyr.scale_num):
            mine = tsb.build_superbrick_level(*_trimmed(pyr, s), s, side=8)
            theirs = jsb.build_superbrick_level(*_trimmed(pyr, s), s, side=8)
            assert mine.n_vox == theirs.n_vox and mine.n_bricks == theirs.n_bricks
            for name in ("brick_coords", "nbr27", "scale_code", "occ", "voxel_brick",
                         "voxel_slot"):
                got, want = getattr(mine, name), getattr(theirs, name)
                assert got.dtype == want.dtype, name
                np.testing.assert_array_equal(got, want, err_msg=f"level {s} {name}")


def test_codec_level_equals_jax(gop):
    """build_codec_level of every level at side 4 and at side 8, the
    encoder's (with the ground truth) and the decoder's (zeros): nbr27,
    code, occ, voxel maps, bucket and slices, bit for bit."""
    for side in SIDES:
        for occs_of in (lambda s: [_trimmed(p, s)[1] for p in gop["pyrs"]], lambda s: None):
            for s in range(gop["pyrs"][0].scale_num):
                coords = [_trimmed(p, s)[0] for p in gop["pyrs"]]
                mine = tsbc.build_codec_level(coords, s, occs_of(s), side=side)
                theirs = jsbc.build_codec_level(coords, s, occs_of(s), side=side)
                assert (mine.bucket, mine.scale_idx, mine.slices) == (
                    theirs.bucket, theirs.scale_idx, theirs.slices)
                for name in ("nbr27", "code", "occ"):
                    got, want = getattr(mine, name), getattr(theirs, name)
                    assert got.dtype == want.dtype, name
                    np.testing.assert_array_equal(got, want, err_msg=f"side {side} level {s} {name}")
                for (vb, vs, n), (jvb, jvs, jn) in zip(mine.voxel_maps, theirs.voxel_maps,
                                                       strict=True):
                    assert n == jn
                    np.testing.assert_array_equal(vb, jvb)
                    np.testing.assert_array_equal(vs, jvs)
    assert tsbc.CODEC_FRAME_CHUNK == jsbc.CODEC_FRAME_CHUNK
    assert tsbc._frame_chunks(19) == jsbc._frame_chunks(19)


def test_sub_brick_map_equals_side4_level(gop):
    """Every level of frame 0: the occupied sub-bricks of the side-8 level's
    map are the side-4 level's bricks (coordinate 2 x superbrick + p), with
    the same codes, occupancy and 26 neighbours; the slot maps invert each
    other."""
    pyr = gop["pyrs"][0]
    for s in range(pyr.scale_num):
        lv8 = tsb.build_superbrick_level(*_trimmed(pyr, s), s, side=8)
        lv4 = tsb.build_superbrick_level(*_trimmed(pyr, s), s, side=4)
        nbr, code, occ = (t.numpy() for t in tsb.sub_brick_map(
            torch.as_tensor(lv8.nbr27), torch.as_tensor(lv8.scale_code),
            torch.as_tensor(lv8.occ)))
        p = np.arange(8)
        sub_xyz = (2 * lv8.brick_coords[:, None, :]
                   + np.stack([p >> 2, (p >> 1) & 1, p & 1], axis=1)[None]).reshape(-1, 3)
        present = (code >= 0).any(axis=1)
        index4 = {tuple(c): i for i, c in enumerate(lv4.brick_coords)}
        rows = np.flatnonzero(present)
        assert sorted(index4) == sorted(tuple(sub_xyz[r]) for r in rows)
        for r in rows:
            i = index4[tuple(sub_xyz[r])]
            np.testing.assert_array_equal(code[r], lv4.scale_code[i])
            np.testing.assert_array_equal(occ[r], lv4.occ[i])
            for k, d in enumerate(tsb._DIRS):
                q = nbr[r, k]
                want = lv4.nbr27[i, k]
                if q >= 0 and present[q]:
                    assert tuple(sub_xyz[q]) == tuple(sub_xyz[r] + np.asarray(d))
                    assert index4[tuple(sub_xyz[q])] == want
                else:
                    assert want == -1
        x = torch.randn(lv8.n_bricks, 3, 5, 512)
        assert torch.equal(tsb.from_sub_bricks(tsb.to_sub_bricks(x)), x)
        assert torch.equal(tsb.to_channel_major(tsb.to_slot_major(x[..., :64])), x[..., :64])
    assert tsb.sub_brick_slices(((0, 64, 0), (64, 192, 1))) == ((0, 512, 0), (512, 1536, 1))


# ---------------------------------------------------------- the convs --


def _conv_case(gop, side, kind):
    """Frame 0's CONV_LEVEL at ``side``: geometry, a masked channel-major x
    (Bb, S, C, side^3), weights (3^3 taps or 1^3), bias and a cotangent,
    numpy-drawn."""
    lev = tsb.build_superbrick_level(*_trimmed(gop["pyrs"][0], CONV_LEVEL), CONV_LEVEL,
                                     side=side)
    slots = side**3
    mask = (lev.scale_code >= 0).astype(np.float32)
    rng = np.random.default_rng(20 + side + 10 * len(kind))
    x = rng.standard_normal((lev.n_bricks, CONV_S, CONV_C, slots)).astype(np.float32)
    x *= mask[:, None, None]
    taps = (27,) if kind == "conv3" else ()
    w = (rng.standard_normal((CONV_S, *taps, CONV_C, CONV_O))
         / np.sqrt(CONV_C * max(taps, default=1))).astype(np.float32)
    b = rng.standard_normal((CONV_S, CONV_O)).astype(np.float32)
    dy = rng.standard_normal((lev.n_bricks, CONV_S, CONV_O, slots)).astype(np.float32)
    return dict(nbr27=lev.nbr27, mask=mask[:, None, None, :], code=lev.scale_code, x=x, w=w,
                b=b, dy=dy)


CONV_CASES = [("conv3", 8), ("conv3", 4), ("conv1", 8), ("conv1", 4)]


@pytest.fixture(scope="module")
def jax_convs(gop):
    """JAX's sbconv3 on 8^3 superbricks, b4conv3 on 4^3 bricks and sbconv1
    on both, channel-major, forward and VJP (dx, dw, db), in one jit:
    {(kind, side): (y, dx, dw, db)}."""
    cases = {key: _conv_case(gop, key[1], key[0]) for key in CONV_CASES}
    fns = {("conv3", 8): jsbn.sbconv3, ("conv3", 4): jsbn.b4conv3,
           ("conv1", 8): jsbn.sbconv1, ("conv1", 4): jsbn.sbconv1}

    def refs(arrays):
        out = {}
        for key, c in arrays.items():
            geom = dict(nbr27=c["nbr27"], mask=c["mask"], dtype=jnp.float32)
            y, vjp = jax.vjp(lambda x, w, b: fns[key](x, geom, w, b), c["x"], c["w"], c["b"])
            out[key] = (y, *vjp(c["dy"]))
        return out

    arrays = {key: {k: c[k] for k in ("nbr27", "mask", "x", "w", "b", "dy")}
              for key, c in cases.items()}
    got = jax.jit(refs)(arrays)
    return cases, {key: tuple(np.asarray(t) for t in v) for key, v in got.items()}


@pytest.mark.parametrize("kind,side", CONV_CASES)
def test_channel_major_convs_match_jax(jax_convs, kind, side):
    """sbconv3 on (Bb, S, C, 512) (the sub-brick map, then K2 -> K1 on the
    card), b4conv3 on (Bb, S, C, 64) and sbconv1 on both against JAX's
    sbconv3, b4conv3 and sbconv1, f32, forward and gradients, at rtol =
    atol = 1e-5; exact zeros at the empty slots."""
    cases, want = jax_convs
    c = cases[kind, side]
    geom = dict(nbr27=torch.as_tensor(c["nbr27"]), mask=torch.as_tensor(c["mask"]),
                code=torch.as_tensor(c["code"]), dtype=torch.float32)
    x, w, b = (torch.as_tensor(c[k]).requires_grad_() for k in ("x", "w", "b"))
    fn = {("conv3", 8): tsbn.sbconv3, ("conv3", 4): tsbn.b4conv3}.get((kind, side), tsbn.sbconv1)
    y = fn(x, geom, w, b)
    y.backward(torch.as_tensor(c["dy"]))
    for got, ref, name in zip((y, x.grad, w.grad, b.grad), want[kind, side],
                              ("y", "dx", "dw", "db")):
        assert tuple(got.shape) == ref.shape, name
        np.testing.assert_allclose(got.detach().numpy(), ref, **CONV, err_msg=name)
    empty = torch.as_tensor(c["mask"][:, 0, 0] == 0)
    assert bool((y.detach().permute(0, 1, 3, 2)[empty[:, None].expand(-1, CONV_S, -1)] == 0).all())


# --------------------------------------------------------- the codec --


@pytest.mark.parametrize("side", SIDES)
def test_level_probs_match_jax(gop, roundtrips, side):
    """The encoder's probabilities of PROBE_LEVEL (both frames, every
    stage) against JAX's encode_level_probs on the same level: within 1e-3
    (f16 ulps from the f32 summation order), at most 0.1 % of them more
    than 1e-6 apart; the bits equal."""
    coords = [_trimmed(p, PROBE_LEVEL)[0] for p in gop["pyrs"]]
    occs = [_trimmed(p, PROBE_LEVEL)[1] for p in gop["pyrs"]]
    level = jsbc.build_codec_level(coords, PROBE_LEVEL, occs, side=side)
    want_p, want_b = jsbc.encode_level_probs(gop["jparams"], gop["jcfg"], level)
    got = roundtrips[side]
    n_far, n_all = 0, 0
    for stage in range(gop["cfg"].outstage):
        for f in range(len(coords)):
            gp, wp = got["probs"][stage][f], want_p[stage][f]
            assert gp.dtype == np.float32 and gp.shape == wp.shape
            np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-3)
            np.testing.assert_array_equal(got["level_bits"][stage][f], want_b[stage][f])
            n_far += int((np.abs(gp - wp) > 1e-6).sum())
            n_all += gp.size
    assert n_far <= 1e-3 * n_all, f"{n_far} of {n_all} probabilities differ by more than 1e-6"


@pytest.mark.parametrize("side", SIDES)
def test_roundtrip_is_lossless(gop, roundtrips, side):
    """decode_gop_streams_sb gives back every frame's points exactly; each
    (frame, scale) blob packs outstage streams."""
    rt = roundtrips[side]
    for dec, pyr, pts in zip(rt["decoded"], gop["pyrs"], gop["frames"], strict=True):
        np.testing.assert_array_equal(dec + pyr.coord_min, np.unique(pts, axis=0))
    assert rt["bits"] == sum(8 * len(b) for fr in rt["blobs"] for b in fr)
    from linr_pcgc_tpu_torch.coding import unpack_bitstream

    assert all(len(unpack_bitstream(b)) == gop["cfg"].outstage for fr in rt["blobs"] for b in fr)


def test_sides_agree_on_rate(roundtrips):
    """Side 4 and side 8 code the GOP at the same rate within 1e-4."""
    b4, b8 = roundtrips[4]["bits"], roundtrips[8]["bits"]
    assert abs(b4 - b8) <= 1e-4 * b4, (b4, b8)


# ------------------------------------------------------ the trainer --


@pytest.fixture(scope="module")
def batches(gop):
    return {side: tsbo.assemble_gop_superbricks(gop["pyrs"], "cpu", side=side) for side in SIDES}


def _top_level(b):
    """Frame 0's top level of batch ``b`` alone: (frame data with its
    neighbours rebased and point_num 1, its level slices)."""
    lo, hi, s = b.level_slices[-1]
    nbr = b.nbr27[0, lo:hi]
    fd = dict(nbr27=torch.where(nbr >= 0, nbr - lo, -1), code=b.code[0, lo:hi],
              occ=b.occ[0, lo:hi], point_num=torch.ones(()))
    return fd, ((0, hi - lo, s),)


def test_side8_frame_loss_and_gradient_equal_side4(gop, batches):
    """Frame 0 through the trainer's frame gradient at side 8 (each frame
    mapped onto its sub-bricks) and at side 4: loss to 1e-5 relative,
    gradient to 1e-4.  On the top level alone, sb_frame_loss of the side-8
    frame and sb_training_bits on its raw 512-slot geometry (the network's
    own entry map) give side 4's bits."""
    cfg, flat = gop["cfg"], torch.as_tensor(gop["flat"])
    out = {}
    for side in SIDES:
        b = batches[side]
        fg = tsbo.make_frame_grads_sb(cfg, b.level_slices, torch.float32, slots=b.slots)
        out[side] = fg(flat, next(tsbo.sb_frames(b)))
    np.testing.assert_allclose(float(out[8][0]), float(out[4][0]), rtol=1e-5)
    np.testing.assert_allclose(out[8][1].numpy(), out[4][1].numpy(), rtol=0, atol=1e-4)
    with torch.no_grad():
        want = tsbo.sb_frame_loss(gop["params"], cfg, *_top_level(batches[4]))
        fd, slices = _top_level(batches[8])
        geom = dict(nbr27=fd["nbr27"], mask=(fd["code"] >= 0).float()[:, None, None, :],
                    code=fd["code"], dtype=torch.float32)
        got = (tsbo.sb_frame_loss(gop["params"], cfg, fd, slices),
               tsbn.sb_training_bits(gop["params"], cfg, geom, tsb.unpack_bits(fd["occ"]),
                                     slices))
    for g in got:
        np.testing.assert_allclose(float(g), float(want), rtol=1e-5)


# ------------------------------------------------------ slow: JAX GOP --


def _jax_encode_sb(gop, side):
    """JAX's encode_gop_streams_sb, at ``side`` through its
    build_codec_level (JAX's GOP function brickifies at 4 and takes no side)."""
    real = jsbc.build_codec_level
    jsbc.build_codec_level = functools.partial(real, side=side)
    try:
        return jcodec.encode_gop_streams_sb(gop["jparams"], gop["jcfg"], gop["pyrs"])
    finally:
        jsbc.build_codec_level = real


@pytest.mark.slow
@pytest.mark.parametrize("side", SIDES)
def test_gop_rate_matches_jax(gop, roundtrips, side):
    """The whole GOP's total bits against JAX's encode_gop_streams_sb at
    the same side, within 1e-4 relative (one JAX compile pair a level)."""
    _, want = _jax_encode_sb(gop, side)
    got = roundtrips[side]["bits"]
    assert abs(got - want) <= 1e-4 * want, (got, want)


@pytest.mark.slow
def test_side8_epoch_matches_jax(gop, batches):
    """One two-frame epoch of make_epoch_fn_sb on the side-8 batch against
    JAX's make_epoch_fn_sb(slots=512) on its own side-8 batch, f32, from one
    parameter set: per-frame losses rtol/atol 2e-4 and parameters rtol 1e-2
    / atol 1e-4 (the tolerances of tests/test_torch_train.py's epochs).
    JAX takes its unfused pass at 512 slots, the port its fused one on the
    sub-bricks: the same loss."""
    tc = TrainConfig()
    jb, tb = jsbo.assemble_gop_superbricks(gop["pyrs"], side=8), batches[8]
    jfn = jsbo.make_epoch_fn_sb(gop["jcfg"], tc, jb.level_slices, compute_dtype=jnp.float32,
                                slots=512)
    tfn = tsbo.make_epoch_fn_sb(gop["cfg"], tc, tb.level_slices, torch.float32, slots=512)
    jp, jo = gop["jparams"], jax_adam_init(gop["jparams"])
    jlr, jk = jnp.asarray(tc.learning_rate, jnp.float32), jnp.zeros((), jnp.int32)
    tp = torch.as_tensor(gop["flat"])
    jp, jo, jlr, jk, jl = jfn(jp, jo, jlr, jk, jb)
    tp, _, tlr, tk, tl = tfn(tp, adam_init(tp), np.float32(tc.learning_rate), 0, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    assert tk == int(jk) and tlr == np.float32(jlr)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jax_flatten(jp)), rtol=1e-2, atol=1e-4)
