"""The conv kernels' module: the plain versions against the JAX package
(K1 against the Pallas kernel run in interpret mode, K2 against the XLA
halo, bit for bit), and the convs with and without the epilogue with
their gradients.  The CUDA kernels against these plain versions, and
their launch plans and tables, are in tests/test_torch_kernels.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.ops import superbricks as jsb
from linr_pcgc_tpu.ops.pallas_conv import plane_matmul
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


@pytest.mark.parametrize("c,o", [(12, 8), (7, 8)])
def test_plane_matmul_bm_plain_matches_pallas(c, o):
    """Ragged Bb = 600, S = 2, f32: K1's plain version on the taps w
    against the Pallas kernel on the conv matrix JAX gathers from them (its
    entries outside the plane windows are structural zeros, which the JAX
    entry point's dense fallback reads where the Pallas blocks would not
    fit).  Tolerance 1e-5: the two sum the same products in another order."""
    bb, s = 600, 2
    h = _rand((bb, s, 216 * c), 0)
    w = _rand((s, 27, c, o), 1, 0.1)
    w2 = np.asarray(jsb.b4_conv_weight_matrix_sm(jnp.asarray(w)))
    bias = _rand((s, 64 * o), 2)
    mask = (np.random.default_rng(3).uniform(size=(bb, 64)) < 0.6).astype(np.float32)
    want = plane_matmul(jnp.asarray(h), jnp.asarray(w2), c, o,
                        bias=jnp.asarray(bias), mask=jnp.asarray(mask))
    got = plane_conv.plane_matmul_bm(torch.as_tensor(h), torch.as_tensor(w), c, o,
                                     torch.as_tensor(bias), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _tap_form(h, w, bias=None, mask=None):
    """The stencil as K1 and K3 compute it, from the tap table their
    wrappers pass to the kernel: slot u sums h's halo column T[u, k] times
    tap k over the 27 taps (f64), then (+ bias) * mask."""
    bb, s, hk = h.shape
    c, o = w.shape[-2], w.shape[-1]
    cols = torch.as_tensor(taps.tap_columns().astype(np.int64))  # (64, 27)
    y = torch.einsum("bsukc,skco->bsuo", h.double().reshape(bb, s, hk // c, c)[:, :, cols],
                     w.double())
    if bias is not None:
        y = (y + bias.double().reshape(s, 64, o)) * mask.double()[:, None, :, None]
    return y.reshape(bb, s, 64 * o)


@pytest.mark.parametrize("c,o", [(4, 4), (7, 8), (8, 8), (12, 8)])
def test_tap_form_matches_window_product(c, o):
    """The kernels' indexing without a card: the tap form through the exact
    table the wrappers hand to csrc/plane_conv.cu equals the plain versions'
    window products on the conv matrix (K1 with a partial mask, K3), f32 to
    1e-5; at C = 8 both also equal JAX's plane_matmul on
    b4_conv_weight_matrix_sm(w)."""
    bb, s = 50, 2
    h = torch.as_tensor(_rand((bb, s, 216 * c), 30 + c))
    w = torch.as_tensor(_rand((s, 27, c, o), 31 + c, 0.2))
    bias = torch.as_tensor(_rand((s, 64 * o), 32 + c))
    mask = torch.as_tensor((np.random.default_rng(c).uniform(size=(bb, 64)) < 0.6).astype(np.float32))
    tap_bm, tap = _tap_form(h, w, bias, mask), _tap_form(h, w)
    plain_bm = plane_conv.plane_matmul_bm_plain(h, w, c, o, bias, mask)
    plain = plane_conv.plane_matmul_plain(h, w, c, o)
    torch.testing.assert_close(plain_bm.double(), tap_bm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(plain.double(), tap, rtol=1e-5, atol=1e-5)
    if c == 8:
        w2 = jsb.b4_conv_weight_matrix_sm(jnp.asarray(w.numpy()))
        want_bm = plane_matmul(jnp.asarray(h.numpy()), w2, c, o, bias=jnp.asarray(bias.numpy()),
                               mask=jnp.asarray(mask.numpy()))
        want = plane_matmul(jnp.asarray(h.numpy()), w2, c, o)
        np.testing.assert_allclose(tap_bm.numpy(), np.asarray(want_bm), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tap.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_b4_halo_sm_plain_equals_jax_exactly():
    bb, s, c = 90, 2, 5
    x = _rand((bb, s, 64 * c), 4)
    nbr = _geometric_nbr(bb, 6, 5)
    want = jax.jit(jsb._b4_halo_sm_forward)(jnp.asarray(x), jnp.asarray(nbr))
    got = tsb.b4_halo_sm(torch.as_tensor(x), torch.as_tensor(nbr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv_weight_matrices_equal_jax():
    w = _rand((2, 27, 4, 3), 8)
    np.testing.assert_array_equal(
        tsb.b4_conv_weight_matrix_sm(torch.as_tensor(w)).numpy(),
        np.asarray(jsb.b4_conv_weight_matrix_sm(jnp.asarray(w))))
    np.testing.assert_array_equal(
        tsb.b4_conv_weight_matrix(torch.as_tensor(w)).numpy(),
        np.asarray(jsb.b4_conv_weight_matrix(jnp.asarray(w))))


def test_b4_convsm_bm_matches_jax():
    """Halo then plane product with the epilogue, on a sparse brick grid,
    against the JAX conv (Pallas interpret mode), f32 to 1e-5."""
    bb, s, c, o = 60, 2, 5, 4
    x = _rand((bb, s, 64 * c), 9)
    w = _rand((s, 27, c, o), 10, 0.3)
    b = _rand((s, o), 11)
    mask = (np.random.default_rng(12).uniform(size=(bb, 64)) < 0.7).astype(np.float32)
    nbr = _geometric_nbr(bb, 5, 13)
    want = jsb.b4_convsm_bm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            jnp.asarray(mask), jnp.asarray(nbr))
    got = tsb.b4_convsm_bm(*(torch.as_tensor(a) for a in (x, w, b, mask, nbr)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel or raises (here the meta device raises)."""
    h = torch.empty((4, 1, 216 * 2), device="meta")
    with pytest.raises(ValueError):
        plane_conv.plane_matmul_bm(h, torch.empty((1, 27, 2, 2), device="meta"), 2, 2,
                                   torch.empty((1, 128), device="meta"),
                                   torch.empty((4, 64), device="meta"))
    with pytest.raises(ValueError):
        plane_conv.plane_matmul(h, torch.empty((1, 27, 2, 2), device="meta"), 2, 2)
    with pytest.raises(ValueError):
        plane_conv.plane_moment_dw(torch.empty((4, 1, 64 * 2), device="meta"), h, 2, 2)
    with pytest.raises(ValueError):
        tsb.b4_halo_sm(torch.empty((4, 1, 128), device="meta"),
                       torch.empty((4, 27), dtype=torch.int32, device="meta"))


def test_b4_convsm_and_vjp_match_jax():
    """The conv without bias and mask (K2 then K3 forward; K2, K3 and K4
    backward) against JAX's custom-VJP b4_convsm on test_b4_convsm_bm's
    shapes and sparse grid, f32: the output to 1e-5, dx and dw at rtol
    1e-4 / atol 1e-5 (the brick sums run in another order)."""
    bb, s, c, o = 60, 2, 5, 4
    x = _rand((bb, s, 64 * c), 9)
    w = _rand((s, 27, c, o), 10, 0.3)
    nbr = _geometric_nbr(bb, 5, 13)
    dy = _rand((bb, s, 64 * o), 14)
    y, vjp = jax.vjp(lambda x_, w_: jsb.b4_convsm(x_, w_, jnp.asarray(nbr)), jnp.asarray(x),
                     jnp.asarray(w))
    jdx, jdw = (np.asarray(a) for a in vjp(jnp.asarray(dy)))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ty = tsb.b4_convsm(tx, tw, torch.as_tensor(nbr))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    ty.backward(torch.as_tensor(dy))
    np.testing.assert_allclose(tx.grad.numpy(), jdx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), jdw, rtol=1e-4, atol=1e-5)
