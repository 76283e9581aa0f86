"""K4's plain version against the JAX package, float32 on the CPU: the
dense windowed moment against JAX's plane_moment (the Pallas kernel in
interpret mode, as the JAX package's own tests run it), the tap map that
turns it into dw, and K4's 27-tap dw formula walked tap by tap in float64
from the table the kernel gets."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.ops import superbricks as jsb
from linr_pcgc_tpu.ops.pallas_conv import plane_moment as jax_plane_moment
from linr_pcgc_tpu_torch.ops import plane_conv, superbricks as tsb, taps

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
# K4 also takes the unfused pass's context-block conv on the 7 occupancy channels
DW_SHAPES = TRAIN_CONV_SHAPES + [(7, 8)]


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


@pytest.mark.parametrize("c,o", DW_SHAPES)
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


@pytest.mark.parametrize("c,o", DW_SHAPES)
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


def test_plane_moment_matches_pallas_and_refuses_the_card():
    """JAX's plane_moment entry: on the CPU the port's plane_moment is K4's
    plain version, held against JAX's plane_moment (Pallas interpret mode)
    at the first case's shapes and tolerance; on any other device it
    raises and names plane_moment_dw (K4), never running the plain version
    there."""
    kc, no, bb, s = 12, 8, 600, 2
    x = _rand((bb, s, 64 * kc), 22)
    g = _rand((bb, s, 216 * no), 23)
    want = np.asarray(jax_plane_moment(jnp.asarray(x), jnp.asarray(g), kc, no))
    got = plane_conv.plane_moment(torch.as_tensor(x), torch.as_tensor(g), kc, no)
    assert got.dtype == torch.float32 and tuple(got.shape) == (s, 4, 16 * kc, 108 * no)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="plane_moment_dw"):
        plane_conv.plane_moment(torch.empty((4, 1, 64 * 2), device="meta"),
                                torch.empty((4, 1, 216 * 2), device="meta"), 2, 2)
