"""The codec's probability producer against the JAX package: sb_x_glob and
sb_chunk_logits on one tiny level, and the whole-frame functions
(sb_forward_all_stages, sb_training_bits, sb_frame_loss) on it as a
one-level frame, float32 on both sides, the same parameters and geometry.
JAX runs its default XLA conv (a dense einsum over the 216-column halo),
the port its plane-blocked conv; the two sum the same products in another
order through ~11 stacked convs, hence the tolerance (rtol/atol 2e-4 on
logits of magnitude ~1-10).

The JAX functions are jitted here with the float32 geometry closed over
(one compile each instead of hundreds of eager op compiles); the codec's
own jitted producer is not used, since its dtype is fixed at import."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.data import synthetic_cloud
from linr_pcgc_tpu.models import ModelConfig as JaxConfig
from linr_pcgc_tpu.models import init_params as jax_init
from linr_pcgc_tpu.models import unflatten_params as jax_unflatten
from linr_pcgc_tpu.models import sb_network as jnet
from linr_pcgc_tpu.runtime import sb_overfit as jsbo
from linr_pcgc_tpu_torch.data import build_pyramid
from linr_pcgc_tpu_torch.models import ModelConfig, init_params, param_tree, params_to_flat
from linr_pcgc_tpu_torch.models import sb_network as tnet
from linr_pcgc_tpu_torch.ops.coords import coord_key
from linr_pcgc_tpu_torch.ops.superbricks import dev_brickify
from linr_pcgc_tpu_torch.runtime import sb_overfit as tsbo

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def level():
    """Level 1 of a small cloud: geometry, occupancy and both param sets."""
    pyr = build_pyramid(synthetic_cloud(1500, depth=6, seed=2), device="cpu")
    lev, scale = pyr.levels[1], 1
    coords = torch.as_tensor(lev.coords)
    keys = coord_key(coords, torch.arange(len(coords)) < lev.n)
    geo = dev_brickify(coords, keys, scale, 64)
    occ = np.zeros((64, 8, 64), np.float32)
    vb, vs = geo["vox_brick"][: lev.n].numpy(), geo["vox_slot"][: lev.n].numpy()
    occ[vb, :, vs] = lev.occ[: lev.n]
    cfg = ModelConfig(scale_num=pyr.scale_num)
    tparams = init_params(11, cfg)
    template = jax.eval_shape(lambda k: jax_init(k, JaxConfig(scale_num=pyr.scale_num)),
                              jax.random.PRNGKey(0))
    jparams = jax_unflatten(template, jnp.asarray(params_to_flat(tparams)))
    code, nbr = geo["code"], geo["nbr27"]
    tgeom = dict(nbr27=nbr, mask=(code >= 0).float()[:, None, None, :], code=code,
                 dtype=torch.float32)
    jgeom = dict(nbr27=jnp.asarray(nbr.numpy()), mask=jnp.asarray(tgeom["mask"].numpy()),
                 code=jnp.asarray(code.numpy()), dtype=jnp.float32)
    return dict(cfg=cfg, jcfg=JaxConfig(scale_num=pyr.scale_num), scale=scale, occ=occ,
                tparams=param_tree(tparams), jparams=jparams, tgeom=tgeom, jgeom=jgeom)


@pytest.fixture(scope="module")
def x_glob(level):
    lv = level
    slices = [(0, 64, lv["scale"])]
    got = tnet.sb_x_glob(lv["tparams"], lv["cfg"], lv["tgeom"], slices)
    want = jax.jit(lambda p: jnet.sb_x_glob(p, lv["jcfg"], lv["jgeom"], slices))(lv["jparams"])
    return got, want


@pytest.fixture(scope="module")
def jax_chunk_logits(level):
    """(cs, first) -> the jitted JAX sb_chunk_logits, compiled once each."""
    jitted = {}

    def get(cs, first):
        if (cs, first) not in jitted:
            jitted[cs, first] = jax.jit(lambda p, occ, base, xg: jnet.sb_chunk_logits(
                p, level["jcfg"], level["jgeom"], occ, base, cs, xg, first))
        return jitted[cs, first]

    return get


def test_sb_x_glob_matches_jax(x_glob):
    got, want = x_glob
    assert got.shape == (64, 1, 64 * 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("base,cs,first", [(0, 1, False), (0, 1, True), (5, 1, False),
                                           (2, 2, False), (0, 2, True), (6, 2, False)])
def test_sb_chunk_logits_matches_jax(level, x_glob, jax_chunk_logits, base, cs, first):
    """The stage windows the codec uses (cs 1 and 2, ``first`` True and
    False).  JAX's first statement normalises ``first`` to off below cs 3;
    it is handed the normalised flag so that each cs compiles once."""
    lv = level
    got = tnet.sb_chunk_logits(lv["tparams"], lv["cfg"], lv["tgeom"], torch.as_tensor(lv["occ"]),
                               base, cs, x_glob[0], first)
    want = jax_chunk_logits(cs, first and cs >= 3)(
        lv["jparams"], jnp.asarray(lv["occ"]), base, x_glob[1])
    assert got.shape == (64, cs, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # unoccupied slots stay exactly zero (the submanifold property)
    assert bool((got[lv["tgeom"]["code"][:, None, :].expand_as(got) < 0] == 0).all())


def _one_level_frame(level):
    """The level as a one-level frame: its slices, and its arrays as the
    GOP batch holds them (occupancy bit-packed)."""
    lv = level
    slices = ((0, 64, lv["scale"]),)
    fd = dict(nbr27=lv["tgeom"]["nbr27"], code=lv["tgeom"]["code"],
              occ=torch.as_tensor(np.packbits(lv["occ"].astype(np.uint8), axis=-1)),
              point_num=torch.tensor(float(lv["occ"].max(axis=1).sum())))
    return slices, fd


STAGES = (2, 5)  # a stage range that does not start at 0


@pytest.fixture(scope="module")
def stage_range_refs(level):
    """JAX's sb_forward_all_stages and sb_training_bits over STAGES on the
    one-level frame, in one jit (one network: XLA shares the forward)."""
    lv = level
    slices, _ = _one_level_frame(lv)
    want = jax.jit(lambda p, occ: (
        jnet.sb_forward_all_stages(p, lv["jcfg"], lv["jgeom"], occ, slices, STAGES),
        jnet.sb_training_bits(p, lv["jcfg"], lv["jgeom"], occ, slices, STAGES)))(
        lv["jparams"], jnp.asarray(lv["occ"]))
    return [np.asarray(v) for v in want]


def test_sb_forward_all_stages_and_bits_match_jax(level, stage_range_refs):
    """Whole-frame logits (Bb, 3, 64) of the stages 2-4 of the one-level
    frame, to the network tolerance; their masked bits to rtol/atol 1e-5
    (the chunk-bits tolerance of tests/test_torch_unfused.py)."""
    lv = level
    slices, _ = _one_level_frame(lv)
    want_logits, want_bits = stage_range_refs
    occ = torch.as_tensor(lv["occ"])
    logits = tnet.sb_forward_all_stages(lv["tparams"], lv["cfg"], lv["tgeom"], occ, slices, STAGES)
    assert logits.shape == (64, 3, 64)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    bits = tnet.sb_training_bits(lv["tparams"], lv["cfg"], lv["tgeom"], occ, slices, STAGES)
    assert bits.dtype == torch.float32 and float(bits) > 0
    np.testing.assert_allclose(float(bits), float(want_bits), rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_sb_frame_loss_matches_jax(level):
    """Bits per point of the one-level frame over all 8 stages, its slot
    mask from the code sentinel and its occupancy bit-packed, against JAX's
    sb_frame_loss: rtol/atol 1e-5.  Slow: a second JAX network compile
    (~15 s on the CPU)."""
    slices, fd = _one_level_frame(level)
    jfd = {k: jnp.asarray(v.numpy()) for k, v in fd.items()}
    want = jax.jit(lambda p, f: jsbo.sb_frame_loss(p, level["jcfg"], f, slices))(
        level["jparams"], jfd)
    got = tsbo.sb_frame_loss(level["tparams"], level["cfg"], fd, slices)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
