"""The gather backend's geometry and conv against the JAX package, float32
on the CPU: the padded levels' keys, feature codes and neighbour maps, the
GOP batch, and gather_conv3's forward and VJP (K10's plain version, and
K10's own summation order emulated) against JAX's _conv3.  The network,
its gradient and the trainer are in tests/test_torch_gather.py.

Inputs come from numpy seeds over ``synthetic_cloud(1500, depth=6)``
frames."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.data import dataset as jds
from linr_pcgc_tpu.models import network as jnet
from linr_pcgc_tpu.runtime import overfit as jov
from linr_pcgc_tpu_torch.data import PyramidDataset, synthetic_cloud
from linr_pcgc_tpu_torch.data.dataset import level_arrays_from_coords
from linr_pcgc_tpu_torch.ops import gather_conv as gc
from linr_pcgc_tpu_torch.runtime import overfit as tov

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)

FWD = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pyrs():
    ds = PyramidDataset([synthetic_cloud(1500, depth=6, seed=7, phase=0.08 * t)
                         for t in range(2)], device="cpu")
    return [ds[0], ds[1]]


# ------------------------------------------------- neighbour maps, batch --


@pytest.mark.parametrize("kernel_size,dilations", [(3, (1,)), (3, (1, 2)), (5, (1,))])
def test_level_arrays_equal_jax(pyrs, kernel_size, dilations):
    """Keys, feature codes and the stacked per-dilation maps of a padded
    level, bit for bit."""
    lev = pyrs[0].levels[1]
    mine = level_arrays_from_coords(lev.coords, lev.n, kernel_size, dilations, "cpu")
    theirs = jds.level_arrays_from_coords(lev.coords, lev.n, kernel_size, dilations)
    assert mine[3].shape == (lev.coords.shape[0], len(dilations) * kernel_size**3)
    for got, want in zip(mine, theirs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((mine[3][: lev.n] >= 0).sum()) > lev.n  # real neighbours, not only self


@pytest.mark.parametrize("kernel_size,dilations", [(3, (1,)), (3, (1, 2)), (5, (1,))])
def test_assemble_gop_equals_jax(pyrs, kernel_size, dilations):
    mine = tov.assemble_gop(pyrs, kernel_size, dilations, "cpu")
    theirs = jov.assemble_gop(pyrs, kernel_size, dilations)
    for name in ("scale_id", "feat_code", "nbr27", "occ", "mask", "point_num"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(), np.asarray(getattr(theirs, name)),
                                      err_msg=name)
    assert mine.nbr27.dtype == torch.int32 and mine.occ.dtype == torch.uint8
    assert mine.level_buckets == theirs.level_buckets
    assert mine.level_offsets == [int(v) for v in theirs.level_offsets]


# ------------------------------------------------------------- the conv --


def _conv_case(pyrs, k, d, cin, cout, seed):
    """Level-0 geometry of frame 0 (pad rows included: all taps absent)
    with a (k^3, N) map at dilation d, and seeded x, w, b, dy."""
    lev = pyrs[0].levels[0]
    idx = level_arrays_from_coords(lev.coords, lev.n, k, (d,), "cpu")[3].T.contiguous()
    n = idx.shape[1]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, cin)).astype(np.float32)
    w = (rng.standard_normal((k**3, cin, cout)) / np.sqrt(cin * k**3)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    dy = rng.standard_normal((n, cout)).astype(np.float32)
    return idx, x, w, b, dy


def _jax_conv_vjp(x, w, b, idx, dy):
    """JAX's _conv3 forward and VJP, feature-major, on the same inputs."""
    def f(x_t, w_, b_):
        return jnet._conv3(x_t, jnp.asarray(idx.numpy()), {"w": w_, "b": b_})
    y, vjp = jax.vjp(jax.jit(f), jnp.asarray(x.T), jnp.asarray(w), jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(dy.T))
    return np.asarray(y).T, np.asarray(dx).T, np.asarray(dw), np.asarray(db)


def _emulated_k10(x, idx, w, b=None):
    """K10's arithmetic: per output, the present taps in order and the
    channels in order, each an f32 FMA (the exact product plus the running
    sum, rounded once: f64 holds every f32 product exactly), then the bias."""
    n, cin = x.shape
    acc = torch.zeros((n, w.shape[2]), dtype=torch.float32)
    for t in range(w.shape[0]):
        present = (idx[t] >= 0)[:, None]
        rows = x[idx[t].clamp(min=0).long()].double()
        for c in range(cin):
            fma = (rows[:, c:c + 1] * w[t, c].double()[None] + acc.double()).float()
            acc = torch.where(present, fma, acc)
    return acc if b is None else acc + b


CONV_CASES = [(3, 1, 8, 8), (3, 1, 7, 8), (3, 1, 4, 4), (3, 2, 8, 8), (5, 1, 8, 8), (5, 1, 4, 4)]


@pytest.mark.parametrize("k,d,cin,cout", CONV_CASES,
                         ids=[f"k{k}d{d}_c{ci}o{co}" for k, d, ci, co in CONV_CASES])
def test_gather_conv_and_vjp_match_jax(pyrs, k, d, cin, cout):
    """gather_conv3's forward, dx (the same conv with w flipped and
    transposed) and db against JAX's _conv3 and its custom VJP, rtol/atol
    1e-5, and dw (gather + matmul) within 1e-5 of its L1 scale; K10's own
    summation order, emulated,
    against JAX's forward and dx to the same tolerance.  K 27 and 125, a
    dilation-2 map, absent taps (the level's pad rows have none)."""
    idx, x, w, b, dy = _conv_case(pyrs, k, d, cin, cout, 11 + k + d + cin)
    assert bool((idx[:, -1] < 0).all()) and bool((idx < 0).any())
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y = gc.gather_conv3(xt, idx, wt, bt)
    y.backward(torch.as_tensor(dy))
    jy, jdx, jdw, jdb = _jax_conv_vjp(x, w, b, idx, dy)
    np.testing.assert_allclose(y.detach().numpy(), jy, **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), jdx, **FWD)
    # dw sums N products per entry (JAX's dot_general and the port's matmul
    # in other orders): within 1e-5 of its L1 scale sum_n |x| |dy|, as K4's
    scale = gc.gather_conv_dw(torch.as_tensor(x).abs(), idx, torch.as_tensor(dy).abs()).numpy()
    assert np.all(np.abs(wt.grad.numpy() - jdw) <= 1e-5 * scale + 1e-6)
    np.testing.assert_allclose(bt.grad.numpy(), jdb, **FWD)
    x_, w_ = torch.as_tensor(x), torch.as_tensor(w)
    emu = _emulated_k10(x_, idx, w_, torch.as_tensor(b))
    np.testing.assert_allclose(emu.numpy(), jy, **FWD)
    emu_dx = _emulated_k10(torch.as_tensor(dy), idx, w_.flip(0).transpose(1, 2))
    np.testing.assert_allclose(emu_dx.numpy(), jdx, **FWD)


def test_gather_conv_skips_dx_and_cpu_wrapper_counts_nothing(pyrs, monkeypatch):
    """An input that needs no gradient gets no dx pass; on the CPU the
    wrapper runs the plain version, which launches nothing."""
    idx, x, w, b, dy = _conv_case(pyrs, 3, 1, 6, 8, 3)
    calls = []
    real = gc.gather_conv

    def spy(*args):
        calls.append(tuple(args[2].shape))
        return real(*args)

    launched = real.launches
    monkeypatch.setattr(gc, "gather_conv", spy)
    wt = torch.tensor(w, requires_grad=True)
    gc.gather_conv3(torch.as_tensor(x), idx, wt, torch.as_tensor(b)).sum().backward()
    assert calls == [(27, 6, 8)] and wt.grad.shape == (27, 6, 8)
    assert real.launches == launched
    np.testing.assert_array_equal(
        real(torch.as_tensor(x), idx, torch.as_tensor(w)).numpy(),
        gc.gather_conv_plain(torch.as_tensor(x), idx, torch.as_tensor(w)).numpy())
