"""The conv kernels' module: the plain versions against the JAX package
(K1 against the Pallas kernel run in interpret mode, K2 against the XLA
halo, bit for bit).  The CUDA kernels against these plain versions are in
tests/test_torch_kernels.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.ops import superbricks as jsb
from linr_pcgc_tpu.ops.pallas_conv import plane_matmul
from linr_pcgc_tpu_torch.ops import plane_conv, superbricks as tsb, taps


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


def test_tap_columns_share_planes():
    """The kc = 8 kernel loads a 16-slot A half once per (halo x-plane q,
    yz offset) and feeds it to every output plane p that reads q through
    tap dx = q - p - 1: this holds only if T[p*16 + r, (dx+1)*9 + i] =
    (p + 1 + dx)*36 + T[r, 9 + i] - 36 for every plane, dx, offset i and
    slot r, which this checks on the table the kernel gets."""
    cols = taps.tap_columns().astype(np.int64)
    p, dx, i, r = np.meshgrid(np.arange(4), np.arange(-1, 2), np.arange(9), np.arange(16),
                              indexing="ij")
    np.testing.assert_array_equal(cols[p * 16 + r, (dx + 1) * 9 + i],
                                  (p + 1 + dx) * 36 + cols[r, 9 + i] - 36)
    # and the table is the one the conv matrices are gathered with
    tap = taps._tap_table()
    np.testing.assert_array_equal(tap[np.arange(64)[:, None], cols], np.arange(27)[None].repeat(64, 0))


def test_b4_halo_sm_plain_equals_jax_exactly():
    bb, s, c = 90, 2, 5
    x = _rand((bb, s, 64 * c), 4)
    nbr = _geometric_nbr(bb, 6, 5)
    want = jax.jit(jsb._b4_halo_sm_forward)(jnp.asarray(x), jnp.asarray(nbr))
    got = tsb.b4_halo_sm(torch.as_tensor(x), torch.as_tensor(nbr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_halo_source_table_reproduces_plain_halo():
    """The kernel's (column -> direction, slot) table, applied as a plain
    gather, gives the plain halo: the layout the kernel reads is the plain
    version's by construction."""
    bb, s, c = 40, 3, 2
    x = torch.as_tensor(_rand((bb, s, 64 * c), 6))
    nbr = torch.as_tensor(_geometric_nbr(bb, 4, 7))
    tab = torch.as_tensor(tsb.halo_source_table().astype(np.int64))
    d, v = tab // 64, tab % 64  # (216,)
    src = torch.where(d[None] == tsb._DIR_CENTER, torch.arange(bb)[:, None], nbr.long()[:, d])
    xv = x.reshape(bb, s, 64, c)
    got = xv[src.clamp(min=0)[:, None, :], torch.arange(s)[None, :, None], v[None, None, :]]
    got = torch.where((src >= 0)[:, None, :, None], got, torch.zeros(()))
    np.testing.assert_array_equal(got.reshape(bb, s, -1).numpy(),
                                  tsb.b4_halo_sm_plain(x, nbr).numpy())


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


def _halo_kernel_emulation(x, nbr, plan):
    """csrc/halo.cu's index arithmetic under ``plan``, in numpy, one copy
    unit at a time: block -> its bricks, thread t -> units t, t + threads,
    ... of every row, row r -> (brick, stage), the table -> (direction,
    source unit).  Returns the halo's bytes and how often each output unit
    was written."""
    bb, s, vc = x.shape
    c = vc // 64
    unit, upc = plan.unit_bytes, plan.unit_cols
    ru = 216 * upc
    xu = x.contiguous().view(torch.uint8).reshape(-1, unit).numpy()
    out = np.zeros((bb * s * ru, unit), np.uint8)
    hits = np.zeros(bb * s * ru, np.int64)
    tab = tsb.halo_source_table().astype(np.int64)
    u = (np.arange(plan.threads)[:, None] + plan.threads * np.arange(-(-ru // plan.threads))).ravel()
    u = u[u < ru]
    f = u // upc
    d, off = tab[f] >> 6, (tab[f] & 63) * upc + u - f * upc
    nbr = nbr.numpy()
    for blk in range(plan.blocks):
        b0 = blk * plan.bricks
        nb = min(plan.bricks, bb - b0)
        r = np.arange(nb * s)
        i, st = r // s, r % s
        src = np.where(d[None] == tsb._DIR_CENTER, b0 + i[:, None], nbr[b0 + i][:, d])
        dst = ((b0 * s + r)[:, None] * ru + u[None]).ravel()
        srcu = ((src * s + st[:, None]) * (64 * upc) + off[None]).ravel()
        np.add.at(hits, dst, 1)
        out[dst] = np.where((src >= 0).ravel()[:, None], xu[np.maximum(srcu, 0)], 0)
    return out.reshape(bb, s, 216 * c * x.element_size()), hits


def _assert_emulation_exact(x, nbr, plan):
    got, hits = _halo_kernel_emulation(x, nbr, plan)
    assert (hits == 1).all()
    want = tsb.b4_halo_sm_plain(x, nbr).contiguous().view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("s", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("c", [4, 7, 8, 12])
def test_halo_plan_covers_every_unit_once(c, esz, s):
    """K2's plan at every main-path (C, dtype, S): the unit is the widest
    of 16/8/4/2 bytes dividing a column's C * esz bytes (so it never
    straddles a 16-byte tile of x or h, whose rows are whole columns);
    at level 0 a block takes ceil(64 / S) bricks.  The kernel's index
    arithmetic, emulated, writes every output unit exactly once with the
    plain version's bytes, under the plan for 97 bricks (one brick a
    block) and under the same plan with level 0's bricks per block (a
    ragged last block)."""
    bb = 97
    plan = tsb.halo_plan(bb, s, c, esz)
    assert plan == tsb.halo_plan(bb, s, c, esz)
    assert plan.unit_bytes == max(u for u in (2, 4, 8, 16) if (c * esz) % u == 0)
    assert plan.unit_cols * plan.unit_bytes == c * esz
    assert plan.threads % 32 == 0 and plan.threads <= tsb.HALO_MAX_THREADS
    passes = -(-216 * plan.unit_cols // plan.threads)
    assert plan.threads * (passes - 1) < 216 * plan.unit_cols <= plan.threads * passes
    assert plan.bricks * (plan.blocks - 1) < bb <= plan.bricks * plan.blocks
    level0 = tsb.halo_plan(163_840, s, c, esz)
    assert level0.bricks == -(-64 // s) and level0.blocks == -(-163_840 // level0.bricks)
    dtype = torch.float32 if esz == 4 else torch.bfloat16
    x = torch.as_tensor(_rand((bb, s, 64 * c), 40 + c)).to(dtype)
    nbr = torch.as_tensor(_geometric_nbr(bb, 6, 41))
    _assert_emulation_exact(x, nbr, plan)
    _assert_emulation_exact(x, nbr, plan._replace(bricks=level0.bricks,
                                                  blocks=-(-bb // level0.bricks)))


def test_halo_plan_narrows_the_unit_to_x_alignment():
    """A view of x at an address aligned to fewer bytes than the widest
    unit takes the widest unit that address allows; the emulated copy is
    still exact."""
    assert [tsb.halo_plan(5, 2, 8, 2, align=a).unit_bytes for a in (16, 8, 4, 2)] == [16, 8, 4, 2]
    assert [tsb.halo_plan(5, 2, 12, 4, align=a).unit_bytes for a in (16, 8, 4)] == [16, 8, 4]
    x = torch.as_tensor(_rand((30, 2, 512), 42)).to(torch.bfloat16)
    nbr = torch.as_tensor(_geometric_nbr(30, 4, 43))
    _assert_emulation_exact(x, nbr, tsb.halo_plan(30, 2, 8, 2, align=2))


def test_halo_index_select_yardstick_equals_plain():
    """K2's library yardstick in chip_smoke.py (one torch.index_select over
    x's slot rows plus a zero row, by an index built from nbr27 and the
    halo table) is the halo, bit for bit, on a seeded sparse geometry."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    bb, s, c = 90, 3, 5
    x = torch.as_tensor(_rand((bb, s, 64 * c), 44))
    nbr = torch.as_tensor(_geometric_nbr(bb, 6, 45))
    rows, idx = smoke.halo_library_args(x, nbr)
    assert idx.dtype == torch.int32 and rows.shape == (bb * s * 64 + 1, c)
    got = torch.index_select(rows, 0, idx).view(bb, s, 216 * c)
    np.testing.assert_array_equal(got.numpy(), tsb.b4_halo_sm_plain(x, nbr).numpy())
