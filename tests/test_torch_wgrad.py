"""K11 (the weight gradient of the skinny convs) and K10's widths, against
the JAX package on the CPU: the 1^3 convs' weight gradients of both
trainers (``sbconv1``, the gather backend's ``_conv1``) against jax.vjp of
JAX's, the products' forward and dx bit for bit as autograd gave them
before, K11's block plan and its fixed-order sums emulated, and the widths
K10 takes.

Inputs come from numpy seeds over ``synthetic_cloud(1500, depth=6)``
frames; each JAX reference is jitted once."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.models import ModelConfig as JaxConfig
from linr_pcgc_tpu.models import flatten_params as jax_flatten
from linr_pcgc_tpu.models import init_params as jax_init
from linr_pcgc_tpu.models import network as jnet
from linr_pcgc_tpu.models import sb_network as jsbn
from linr_pcgc_tpu.models import unflatten_params as jax_unflatten
from linr_pcgc_tpu_torch.data import PyramidDataset, synthetic_cloud
from linr_pcgc_tpu_torch.data.dataset import level_arrays_from_coords
from linr_pcgc_tpu_torch.models import ModelConfig, param_tree
from linr_pcgc_tpu_torch.models import network as tnet
from linr_pcgc_tpu_torch.models import sb_network as tsbn
from linr_pcgc_tpu_torch.ops import gather_conv as gc
from linr_pcgc_tpu_torch.ops import wgrad
from linr_pcgc_tpu_torch.runtime import overfit as tov
from linr_pcgc_tpu_torch.runtime import sb_overfit as tsbo

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


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


@pytest.fixture(scope="module")
def slot_mask(pyrs):
    """Frame 0's occupied slots over its bricks of every level, (Bb, 64)."""
    return (tsbo.assemble_gop_superbricks(pyrs, "cpu").code[0] >= 0).numpy()


@pytest.fixture(scope="module")
def level0(pyrs):
    """Frame 0's level-0 bucket: its rows and (27, N) neighbour map (the
    pad rows have every tap absent)."""
    lev = pyrs[0].levels[0]
    return level_arrays_from_coords(lev.coords, lev.n, 3, (1,), "cpu")[3].T.contiguous()


def _rng_f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _sb_case(slot_mask, s, c, o, seed):
    """x (Bb, S, 64*c) zero on empty slots, w (S, c, o), b (S, o), dy."""
    rng = np.random.default_rng(seed)
    bb = slot_mask.shape[0]
    m = slot_mask.astype(np.float32)
    x = (_rng_f32(rng, (bb, s, 64, c)) * m[:, None, :, None]).reshape(bb, s, 64 * c)
    return (x, _rng_f32(rng, (s, c, o), c ** -0.5), _rng_f32(rng, (s, o)),
            _rng_f32(rng, (bb, s, 64 * o)), m)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value's magnitude."""
    e = torch.floor(torch.log2(v.float().abs().clamp_min(2.0**-126)))
    return torch.exp2(e - 7)


# ------------------------------------------------ the 1^3 convs against JAX --


def _jax_sbconv1_dw(x, m, w, b, dy, jdt):
    """jax.vjp of JAX's sbconv1 (the block-diagonal product) in dtype jdt,
    w's cotangent in f32."""
    jgeom = dict(mask=jnp.asarray(m)[:, None, None, :].astype(jdt), dtype=jdt)
    xj, bj = jnp.asarray(x).astype(jdt), jnp.asarray(b)

    @jax.jit
    def jdw(w_, dy_):
        return jax.vjp(lambda v: jsbn.sbconv1(xj, jgeom, v, bj), w_)[1](dy_)[0]

    return torch.tensor(np.asarray(jdw(jnp.asarray(w), jnp.asarray(dy).astype(jdt)), np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sbconv1_weight_gradient_matches_jax(slot_mask, dtype):
    """dw of sbconv1 through K11's Function (its plain version here) against
    jax.vjp of JAX's sbconv1, at (C, O) = (8, 24), the inner MLP's first
    layer.  f32: within 1e-5 of the L1 scale sum |x| |dy| (sums in another
    order).  bf16: against JAX's f32 vjp of the same bf16 inputs, within one
    bf16 ulp plus 1e-5 of the L1 scale (the port rounds its f32 sum once);
    against JAX's bf16 vjp, within 2^-8 of the L1 scale (JAX rounds each of
    the 64 slots' blocks of the block-diagonal weight's cotangent to bf16
    before their sum)."""
    tdt, jdt = DTYPES[dtype]
    x, w, b, dy, m = _sb_case(slot_mask, 3, 8, 24, 5)
    xt, dyt = torch.as_tensor(x).to(tdt), torch.as_tensor(dy).to(tdt)
    wt = torch.tensor(w, requires_grad=True)
    geom = dict(mask=torch.as_tensor(m)[:, None, None, :].to(tdt), dtype=tdt)
    tsbn.sbconv1(xt, geom, wt, torch.as_tensor(b)).backward(dyt)
    got = wt.grad
    scale = wgrad.wgrad_sb_plain(xt.float().abs(), dyt.float().abs(), 8, 24)
    # the same inputs as tdt rounded them, in f32
    want = _jax_sbconv1_dw(xt.float().numpy(), m, w, b, dyt.float().numpy(), jnp.float32)
    tol = 1e-5 * scale + (0.0 if dtype == "float32" else _bf16_ulp(want))
    assert bool(((got - want).abs() <= tol).all()), (got - want).abs().max().item()
    if dtype == "bfloat16":
        want = _jax_sbconv1_dw(x, m, w, b, dy, jdt)
        assert bool(((got - want).abs() <= 2.0**-8 * scale).all())


@pytest.mark.parametrize("cin,cout", [(8, 24), (24, 2), (16, 8)])
def test_gather_conv1_weight_gradient_matches_jax(level0, cin, cout):
    """dw and db of the gather backend's _conv1 through K11's Function
    against jax.vjp of JAX's feature-major _conv1, within 1e-5 of the L1
    scale (sums in another order)."""
    rng = np.random.default_rng(cin + cout)
    n = level0.shape[1]
    x, w, b, dy = (_rng_f32(rng, (n, cin)), _rng_f32(rng, (cin, cout), cin ** -0.5),
                   _rng_f32(rng, (cout,)), _rng_f32(rng, (n, cout)))
    wt, bt = torch.tensor(w, requires_grad=True), torch.tensor(b, requires_grad=True)
    tnet._conv1(torch.as_tensor(x), {"w": wt, "b": bt}).backward(torch.as_tensor(dy))

    @jax.jit
    def jgrads(w_, b_, dy_):
        return jax.vjp(lambda v, c: jnet._conv1(jnp.asarray(x.T), {"w": v, "b": c}), w_, b_)[1](dy_)

    jdw, jdb = jgrads(jnp.asarray(w), jnp.asarray(b), jnp.asarray(dy.T))
    scale = np.abs(x).T @ np.abs(dy)
    assert np.all(np.abs(wt.grad.numpy() - np.asarray(jdw)) <= 1e-5 * scale + 1e-6)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jdb), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1_products_keep_forward_and_dx_bits(slot_mask, level0, dtype):
    """sbconv1 and _conv1 give the outputs and input gradients that plain
    autograd of their products gave before K11, bit for bit (the product
    runs on the weight detached and its own backward gives dx), and on the
    CPU the same dw bits too (K11's plain version is that backward's
    product)."""
    tdt = DTYPES[dtype][0]
    x, w, b, dy, m = _sb_case(slot_mask, 2, 8, 4, 9)
    geom = dict(mask=torch.as_tensor(m)[:, None, None, :].to(tdt), dtype=tdt)
    bb = x.shape[0]
    runs = []
    for new in (True, False):
        xt = torch.as_tensor(x).to(tdt).requires_grad_()
        wt = torch.tensor(w, requires_grad=True)
        if new:
            y = tsbn.sbconv1(xt, geom, wt, torch.as_tensor(b))
        else:  # sbconv1 before K11: autograd of the einsum alone
            y = torch.einsum("bsvc,sco->bsvo", xt.reshape(bb, 2, 64, 8), wt.to(tdt))
            y = y.reshape(bb, 2, 64 * 4) + torch.as_tensor(b).repeat(1, 64)[None].to(tdt)
            y = (y * geom["mask"][:, 0, 0, :].repeat_interleave(4, dim=-1)[:, None, :]).to(tdt)
        y.backward(torch.as_tensor(dy).to(tdt))
        runs.append((y.detach(), xt.grad, wt.grad))
    for got, want in zip(*runs):
        assert got.dtype == want.dtype and torch.equal(got, want)

    rng = np.random.default_rng(3)
    n = level0.shape[1]
    xg, wg, dyg = _rng_f32(rng, (n, 8)), _rng_f32(rng, (8, 24)), _rng_f32(rng, (n, 24))
    runs = []
    for new in (True, False):
        xt = torch.tensor(xg, requires_grad=True)
        wt = torch.tensor(wg, requires_grad=True)
        y = wgrad.gather_conv1_product(xt, wt) if new else xt @ wt
        y.backward(torch.as_tensor(dyg))
        runs.append((y.detach(), xt.grad, wt.grad))
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def test_gather_network_at_hidden_16_matches_jax(pyrs):
    """The slice as a whole on the CPU: the gather network at --outstage 4
    --hidden_channel_conv 16 (K10's and K11's new widths: convs out to 16
    and 8, 1^3 convs 16 -> 8 and 16 -> 24), its bits to rtol 1e-5 and its
    gradient over the flat parameter vector to rtol 1e-4 / atol 1e-5,
    against JAX's training_bits and jax.grad on frame 0."""
    kw = dict(scale_num=pyrs[0].scale_num, outstage=4, hidden_channel_conv=16)
    cfg, jcfg = ModelConfig(**kw), JaxConfig(**kw)
    fd = {k: v[0] for k, v in tov.batch_arrays(tov.assemble_gop(pyrs, 3, (1,), "cpu")).items()}
    n = sum(int(np.prod(shape)) for _, shape in tnet.param_spec(cfg))
    flat = np.random.default_rng(41).uniform(-0.1, 0.1, n).astype(np.float32)
    leaf = torch.tensor(flat, requires_grad=True)
    args = (fd["scale_id"], fd["feat_code"], fd["nbr27"], fd["occ"].float(), fd["mask"])
    bits = tnet.training_bits(param_tree(tnet.unflatten_params(cfg, leaf)), cfg, *args)
    bits.backward()
    template = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    jargs = [jnp.asarray(a.numpy()) for a in args]
    jbits, jgrad = jax.jit(jax.value_and_grad(lambda p: jnet.training_bits(p, jcfg, *jargs)))(
        jax_unflatten(template, jnp.asarray(flat)))
    np.testing.assert_allclose(float(bits.detach()), float(jbits), rtol=1e-5)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jax_flatten(jgrad)), rtol=1e-4,
                               atol=1e-5)


# --------------------------------------------------------- K11's block plan --


def _emulated_k11(x, dy, xrow, dyrow, groups, rows, c, o):
    """K11's arithmetic under its plan: for each group and range, thread t
    of 256 adds the products of rows r0 + t + 256 i in order with f32 FMAs
    (the exact product plus the running sum, rounded once: f64 holds every
    product of two f32 exactly), a warp's 32 sums by the shuffle butterfly
    (lane 0's value), the 8 warps in order, then the ranges in order.
    ``xrow(g)`` / ``dyrow(g)`` give a group's row indices (x's -1: no
    term)."""
    plan = wgrad.wgrad_plan(rows, groups, c, o)
    lanes = torch.arange(32)
    out = torch.zeros((groups, c, o))
    for g in range(groups):
        xr, dr = xrow(g), dyrow(g)
        total = torch.zeros((c, o))
        for p in range(plan.ranges):
            r0, r1 = p * plan.per_range, min(rows, (p + 1) * plan.per_range)
            acc = torch.zeros((256, c, o))
            for r in range(r0, r1, 256):
                rr = torch.arange(r, min(r + 256, r1))
                k = len(rr)
                on = xr[rr] >= 0
                prod = (x[xr[rr].clamp(min=0)].double()[:, :, None]
                        * dy[dr[rr]].double()[:, None, :])
                fma = (prod + acc[:k].double()).float()
                acc[:k] = torch.where(on[:, None, None], fma, acc[:k])
            warps = acc.view(8, 32, c, o)
            for off in (16, 8, 4, 2, 1):
                warps = warps + warps[:, lanes ^ off]
            block = torch.zeros((c, o))
            for wp in range(8):
                block = block + warps[wp, 0]
            total = total + block
        out[g] = total
    return out


def test_k11_emulated_block_plan_matches_plain(slot_mask, level0):
    """K11's partition and fixed-order sums, emulated, equal the plain
    versions within f32 rounding (1e-5 of the L1 scale): the superbrick
    form (ragged last ranges, empty slots) at (C, O) = (8, 4) over 3 stages
    and at the runtime tile (24, 1); the gather form at K 27 through the
    level-0 map (absent taps, pad rows) and at K 1 (x's own rows)."""
    rng = np.random.default_rng(12)
    bb = slot_mask.shape[0]
    rows = bb * 64
    for s, c, o in ((3, 8, 4), (2, 24, 1)):
        x, _, _, dy, _ = _sb_case(slot_mask, s, c, o, 13 + c)
        xt, dyt = torch.as_tensor(x), torch.as_tensor(dy)
        r = torch.arange(rows)
        row = lambda g: (r // 64 * s + g) * 64 + r % 64  # noqa: E731
        emu = _emulated_k11(xt.reshape(-1, c), dyt.reshape(-1, o), row, row, s, rows, c, o)
        want = wgrad.wgrad_sb_plain(xt, dyt, c, o)
        scale = wgrad.wgrad_sb_plain(xt.abs(), dyt.abs(), c, o)
        assert bool(((emu - want).abs() <= 1e-5 * scale + 1e-6).all())
    n = level0.shape[1] - 100  # a ragged cut of the bucket, pad rows kept
    idx = level0[:, :n].contiguous()
    assert bool((idx[:, -1] < 0).all()) and n % 512 != 0
    xg = torch.as_tensor(_rng_f32(rng, (level0.shape[1], 8)))
    dyg = torch.as_tensor(_rng_f32(rng, (n, 8)))
    for idx in (idx, None):
        k = 1 if idx is None else idx.shape[0]
        own = torch.arange(n)
        xs = xg[:n] if idx is None else xg
        xrow = (lambda g: own) if idx is None else (lambda g: idx[g].long())
        emu = _emulated_k11(xs, dyg, xrow, lambda g: own, k, n, 8, 8)
        want = wgrad.wgrad_gather_plain(xs, dyg, idx)
        scale = wgrad.wgrad_gather_plain(xs.abs(), dyg.abs(), idx)
        assert bool(((emu - want).abs() <= 1e-5 * scale + 1e-6).all())


def test_k11_plan_depends_on_shapes_only():
    """K11's plan is a function of the shapes alone (so are dw's bits):
    the ranges cover every row once, each a whole number of the kernel's
    512-row steps, the tiles cover C x O, and the trainers' shapes take the
    tiles meant for them."""
    for rows, g, c, o in [(81_920 * 64, 5, 8, 8), (81_920 * 64, 4, 24, 1), (27_264 * 64, 8, 8, 4),
                          (786_432, 27, 8, 8), (786_432, 125, 16, 16), (786_432, 1, 8, 24),
                          (1, 1, 1, 1), (333, 2, 15, 16), (5000, 3, 4, 4)]:
        p = wgrad.wgrad_plan(rows, g, c, o)
        assert p == wgrad.wgrad_plan(rows, g, c, o)
        assert (p.ct, p.ot) in wgrad.WGRAD_TILES
        assert p.tiles == -(-c // p.ct) * -(-o // p.ot)
        assert p.per_range % 512 == 0 and p.per_range >= 512
        assert (p.ranges - 1) * p.per_range < rows <= p.ranges * p.per_range
        assert p.ranges * g * p.tiles <= max(wgrad.WGRAD_BLOCKS, g * p.tiles)
    for (c, o), tile in (((8, 8), (8, 8)), ((8, 4), (8, 4)), ((4, 4), (4, 4)), ((8, 24), (8, 8)),
                         ((24, 1), (32, 2)), ((24, 2), (32, 2))):
        assert wgrad.wgrad_plan(81_920 * 64, 4, c, o)[:2] == tile
    assert wgrad.wgrad_plan(5_242_880, 5, 8, 8).ranges * 5 >= 0.9 * wgrad.WGRAD_BLOCKS
    with pytest.raises(ValueError):
        wgrad.wgrad_plan(0, 1, 8, 8)


# ------------------------------------------------------------ K10's widths --


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 8), (12, 6), (4, 2)])
def test_k10_takes_any_width(cin, cout):
    """K10's checks accept the gather network's widths at
    hidden_channel_conv 16 (and other ones) at K 27 and 125, with chunks of
    8 outputs from Cout 8 up and of 4 below; a chunk whose weights do not
    fit a block's shared memory raises."""
    for k in (27, 125):
        x = torch.zeros((10, cin))
        idx = torch.full((k, 10), -1, dtype=torch.int32)
        w = torch.zeros((k, cin, cout))
        plan = gc.check_gather_conv(x, idx, w, torch.zeros(cout))
        assert plan == gc.k10_plan(k, cin, cout)
        assert plan.chunk == (8 if cout >= 8 else 4)
        assert (plan.chunks - 1) * plan.chunk < cout <= plan.chunks * plan.chunk
        assert plan.smem == 4 * k * cin * plan.chunk <= gc.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        gc.k10_plan(125, 128, cout)
    with pytest.raises(ValueError):
        gc.k10_plan(27, cin, 0)
