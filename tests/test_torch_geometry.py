"""The port's geometry against the JAX package: keys, octree down/up,
neighbour codes, pyramids and the codec's device brickify must be
integer-equal (the codec's shapes and symbol order rest on them)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.data import build_pyramid as jax_build_pyramid
from linr_pcgc_tpu.data import synthetic_cloud
from linr_pcgc_tpu.ops import coords as jc
from linr_pcgc_tpu.ops import octree as jo
from linr_pcgc_tpu.ops import superbricks as jsb
from linr_pcgc_tpu_torch.data import build_pyramid
from linr_pcgc_tpu_torch.ops import coords as tc
from linr_pcgc_tpu_torch.ops import octree as to
from linr_pcgc_tpu_torch.ops import superbricks as tsb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sorted_level(seed, n=3000, span=64, pad=37):
    """Canonically sorted unique coords with a pad tail, as numpy."""
    rng = np.random.default_rng(seed)
    pts = np.unique(rng.integers(0, span, (n, 3)).astype(np.int32), axis=0)
    key = jo.np_coord_key(pts)
    pts = pts[np.argsort(key)]
    out = np.zeros((len(pts) + pad, 3), np.int32)
    out[: len(pts)] = pts
    valid = np.arange(len(out)) < len(pts)
    return out, valid, len(pts)


def _both_keys(coords, valid):
    jk = jc.coord_key(jnp.asarray(coords), jnp.asarray(valid))
    tk = tc.coord_key(torch.as_tensor(coords), torch.as_tensor(valid))
    return jk, tk


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy() if torch.is_tensor(b) else b)


def test_keys_sort_and_lookup_equal_jax():
    rng = np.random.default_rng(0)
    coords = rng.integers(-2, 80, (500, 3)).astype(np.int32)
    valid = rng.uniform(size=500) < 0.9
    jk, tk = _both_keys(coords, valid)
    _eq(jk, tk)
    jcs, jks = jc.canonical_sort(jnp.asarray(coords), jnp.asarray(valid))
    tcs, tks = tc.canonical_sort(torch.as_tensor(coords), torch.as_tensor(valid))
    _eq(jcs, tcs)
    _eq(jks, tks)
    q = jnp.asarray(rng.integers(0, 80, (300, 3)).astype(np.int32))
    qk = jc.coord_key(q)
    _eq(jc.lookup(jks, qk), tc.lookup(tks, torch.as_tensor(np.array(qk))))
    _eq(jc.membership(jks, qk), tc.membership(tks, torch.as_tensor(np.array(qk))))
    _eq(jc.key_to_coord(jks[:400]), tc.key_to_coord(tks[:400]))


def test_octree_down_up_and_feature_code_equal_jax():
    coords, valid, n = _sorted_level(1)
    jk, tk = _both_keys(coords, valid)
    jd = jax.jit(jo.octree_down, static_argnums=2)(jnp.asarray(coords), jk, len(coords))
    td = to.octree_down(torch.as_tensor(coords), tk, len(coords))
    for a, b in zip(jd[:3], td[:3]):
        _eq(a, b)
    assert int(jd[3]) == td[3]

    ju = jax.jit(jo.octree_up_with_parent)(jd[0], jd[1], jd[2])
    tu = to.octree_up_with_parent(td[0], td[1], td[2])
    for i in (0, 1, 3):
        _eq(ju[i], tu[i])
    assert int(ju[2]) == tu[2] == n

    _eq(jax.jit(jo.neighbor_feature_code)(jnp.asarray(coords), jk),
        to.neighbor_feature_code(torch.as_tensor(coords), tk))
    _eq(jax.jit(jo.neighbor_map)(jnp.asarray(coords), jk), to.neighbor_map(torch.as_tensor(coords), tk))
    np.testing.assert_array_equal(to.np_feat_code(coords[:n]), jo.np_feat_code(coords[:n]))
    np.testing.assert_array_equal(to.conv_offsets(3), jo.conv_offsets(3))


def test_pyramid_equal_jax():
    pts = synthetic_cloud(1500, depth=6, seed=3)
    jp = jax_build_pyramid(pts)
    tp = build_pyramid(pts, device="cpu")
    assert tp.scale_num == jp.scale_num and tp.point_num == jp.point_num
    assert tp.low_bits_estimate == jp.low_bits_estimate
    np.testing.assert_array_equal(tp.coord_min, jp.coord_min)
    for a, b in zip(jp.levels, tp.levels):
        assert a.n == b.n
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.occ, b.occ)
        np.testing.assert_array_equal(a.feat_code, b.feat_code)


def _brickify_both(coords, valid, scale, cap):
    jk, tk = _both_keys(coords, valid)
    jout = jax.jit(jsb.dev_brickify, static_argnums=(3, 4))(jnp.asarray(coords), jk, scale, cap, 4)
    tout = tsb.dev_brickify(torch.as_tensor(coords), tk, scale, cap, 4)
    return jout, tout


def test_dev_brickify_equal_jax():
    coords, valid, n = _sorted_level(2, n=4000, span=48)
    jout, tout = _brickify_both(coords, valid, 3, 2048)
    assert int(jout["n_bricks"]) == tout["n_bricks"]
    for k in ("bkeys", "vox_brick", "vox_slot", "code", "nbr27"):
        _eq(jout[k], tout[k])


def test_dev_brickify_drops_bricks_beyond_cap_as_jax():
    """A brick cap below the brick count: JAX's scatters drop the excess
    bricks (mode="drop"); the port drops them too, with every output equal."""
    coords, valid, n = _sorted_level(2, n=4000, span=48)
    jout, tout = _brickify_both(coords, valid, 3, 2048)
    cap = int(jout["n_bricks"]) // 2
    jout, tout = _brickify_both(coords, valid, 3, cap)
    assert int(jout["n_bricks"]) == tout["n_bricks"] > cap
    for k in ("bkeys", "vox_brick", "vox_slot", "code", "nbr27"):
        _eq(jout[k], tout[k])


def test_dev_nbr27_from_parent_equal_jax_and_lookup():
    """Level-s brick neighbours read from level s+2's geometry equal the
    JAX twin and the key-search map of dev_brickify."""
    coords, valid, n = _sorted_level(4, n=6000, span=96, pad=0)
    p1, _ = to.np_octree_down(coords)
    p2, _ = to.np_octree_down(p1)
    cap_s = len(p2) + 9  # bricks of level s = voxels of level s+2
    _, geo_s = _brickify_both(coords, valid, 0, cap_s)
    pad2 = np.zeros((len(p2) + 7, 3), np.int32)
    pad2[: len(p2)] = p2
    cap2 = max(64, len(p2) // 8 + 16)
    _, geo_2 = _brickify_both(pad2, np.arange(len(pad2)) < len(p2), 0, cap2)

    vb2, sl2 = geo_2["vox_brick"].numpy(), geo_2["vox_slot"].numpy()
    grid = np.full(cap2 * 64, -1, np.int32)
    ok = vb2 >= 0
    grid[vb2[ok] * 64 + sl2[ok]] = np.flatnonzero(ok)
    nbr2 = geo_2["nbr27"].numpy()

    got = tsb.dev_nbr27_from_parent(torch.as_tensor(vb2), torch.as_tensor(sl2),
                                    torch.as_tensor(nbr2), torch.as_tensor(grid), cap_s, 4)
    want_jax = jax.jit(jsb.dev_nbr27_from_parent, static_argnums=(4, 5))(jnp.asarray(vb2), jnp.asarray(sl2), jnp.asarray(nbr2),
                                         jnp.asarray(grid), cap_s, 4)
    _eq(want_jax, got)
    _eq(geo_s["nbr27"][: len(p2)].numpy(), got[: len(p2)])
    assert bool((got[len(p2):] == -1).all())


def test_dev_brickify_geom_with_given_identity_equal_jax():
    """The grandparent-chain form: brick keys and voxel->brick map handed
    in (as the codec's search-free brickify does), nbr27 by key search."""
    coords, valid, n = _sorted_level(5, n=3000, span=40)
    jout, tout = _brickify_both(coords, valid, 2, 1024)
    jk, tk = _both_keys(coords, valid)
    jg = jax.jit(jsb.dev_brickify_geom, static_argnums=(3, 4))(
        jnp.asarray(coords), jk, 2, 1024, 4, jout["bkeys"],
                               jout["n_bricks"], jout["vox_brick"])
    tg = tsb.dev_brickify_geom(torch.as_tensor(coords), tk, 2, 1024, 4, tout["bkeys"],
                               tout["n_bricks"], tout["vox_brick"])
    for k in ("vox_slot", "code", "nbr27"):
        _eq(jg[k], tg[k])
