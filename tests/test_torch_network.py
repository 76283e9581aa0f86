"""The codec's probability producer against the JAX package: sb_x_glob and
sb_chunk_logits on one tiny level, float32 on both sides, the same
parameters and geometry.  JAX runs its default XLA conv (a dense einsum over
the 216-column halo), the port its plane-blocked conv; the two sum the same
products in another order through ~11 stacked convs, hence the tolerance
(rtol/atol 2e-4 on logits of magnitude ~1-10).

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
from linr_pcgc_tpu_torch.data import build_pyramid
from linr_pcgc_tpu_torch.models import ModelConfig, init_params, param_tree, params_to_flat
from linr_pcgc_tpu_torch.models import sb_network as tnet
from linr_pcgc_tpu_torch.ops.coords import coord_key
from linr_pcgc_tpu_torch.ops.superbricks import dev_brickify


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
