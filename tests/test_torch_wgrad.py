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


def test_conv1_product_saves_its_input_without_a_copy():
    """The superbrick 1^3 product keeps its input for K11 as it came: the
    next 1^3 conv's input is the stage-major view the einsum leaves (x4 of
    (Bb, S, 64, C) laid out (S, Bb, 64, C)), and the saved tensor is that
    view, no contiguous copy (0.94 GiB at the trainer's level 0 for the
    inner MLP's 24 channels); dw is unchanged."""
    rng = np.random.default_rng(21)
    h = torch.as_tensor(_rng_f32(rng, (30, 3, 64, 8)))
    w0 = torch.as_tensor(_rng_f32(rng, (3, 8, 24)))
    x4 = torch.einsum("bsvc,sco->bsvo", h, w0)  # the layout sbconv1's output has
    assert not x4.is_contiguous() and x4.transpose(0, 1).is_contiguous()
    w = torch.tensor(_rng_f32(rng, (3, 24, 1)), requires_grad=True)
    y = wgrad.sb_conv1_product(x4, w)
    (saved,) = y.grad_fn.saved_tensors
    assert saved.data_ptr() == x4.data_ptr() and saved.stride() == x4.stride()
    dy = torch.as_tensor(_rng_f32(rng, (30, 3, 64, 1)))
    y.backward(dy)
    want = wgrad.wgrad_sb_plain(x4.contiguous().reshape(30, 3, -1), dy.reshape(30, 3, -1), 24, 1)
    assert torch.equal(w.grad, want)


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


def _fma(acc, a, b):
    """f32 FMAs, elementwise: the exact product plus acc, rounded once (f64
    holds every product of two f32 exactly)."""
    return (a.double() * b.double() + acc.double()).float()


def _butterfly(v):
    """A warp's shuffle butterfly over the row classes (dim 0): offsets from
    the highest down; row class 0's value."""
    n, off = v.shape[0], v.shape[0] // 2
    while off:
        v = v + v[torch.arange(n) ^ off]
        off //= 2
    return v[0]


def _lane_sums(x, dy, seqs, rgn, cs, os_):
    """Each lane's f32 FMA sum over its rows in order: ``seqs[p][l]`` the (x
    row, dy row) pairs of lane l of block p; returns (blocks, rgn, C, O)."""
    blocks = len(seqs)
    length = max([len(q) for lanes in seqs for q in lanes] + [0])
    xi = torch.zeros((blocks, rgn, max(length, 1)), dtype=torch.long)
    di = torch.zeros_like(xi)
    on = torch.zeros(xi.shape, dtype=torch.bool)
    for p, lanes in enumerate(seqs):
        for lane, q in enumerate(lanes):
            if q:
                xi[p, lane, : len(q)] = torch.tensor([r for r, _ in q])
                di[p, lane, : len(q)] = torch.tensor([r for _, r in q])
                on[p, lane, : len(q)] = True
    acc = torch.zeros((blocks, rgn, len(range(*cs)), len(range(*os_))))
    for step in range(length):
        xv = x[xi[:, :, step], cs[0]:cs[1]]
        dv = dy[di[:, :, step], os_[0]:os_[1]]
        new = _fma(acc, xv[..., :, None], dv[..., None, :])
        acc = torch.where(on[:, :, step, None, None], new, acc)
    return acc


def _emulated_ring(x, dy, rows, s, c, o, bf16=False):
    """K11's ring form under ``ring_plan``: x (rows / 64 * S * 64, C) and dy
    slot-major rows.  A block owns a brick range in tiles of ``tb``; warp
    (stage, kq) takes the bricks of each tile whose index in the tile is kq
    mod ``wps``, then (warp 0) the ragged last brick.  f32: lane class rg of
    an 8 x 8 lane tile adds rows rg, rg + rgn, ... of each brick by FMAs,
    the classes by the butterfly; bf16 (the tensor cores' partition): a
    brick's 64 products summed exactly, rounded to f32 and added to the
    warp's sum.  Then a stage's warps in order, the blocks in order."""
    plan = wgrad.ring_plan(rows, s, c, o, 2 if bf16 else 4)
    bricks, full = -(-rows // 64), rows // 64
    out = torch.zeros((s, c, o))
    for c0 in range(0, c, plan.cgrp):
        for o0 in range(0, o, plan.ogrp):
            cs, os_ = (c0, min(c, c0 + plan.cgrp)), (o0, min(o, o0 + plan.ogrp))
            rgn = 32 // wgrad._lane_tiles(cs[1] - c0, os_[1] - o0, 8)[1]
            for st in range(s):
                blk = torch.zeros((plan.blocks, cs[1] - c0, os_[1] - o0))
                for kq in range(plan.wps):
                    chunks = []
                    for p in range(plan.blocks):
                        b0 = p * plan.per_block
                        b1 = min(bricks, b0 + plan.per_block)
                        mine = [(b, 64) for b in range(b0, min(full, b1))
                                if (b - b0) % plan.tb % plan.wps == kq]
                        if kq == 0 and full < bricks and b0 <= full < b1:
                            mine.append((full, rows - full * 64))
                        chunks.append(mine)
                    if bf16:
                        acc = torch.zeros_like(blk)
                        for p, mine in enumerate(chunks):
                            for b, nr in mine:
                                base = (b * s + st) * 64
                                part = (x[base:base + nr, c0:cs[1]].double().T
                                        @ dy[base:base + nr, o0:os_[1]].double()).float()
                                acc[p] = acc[p] + part
                    else:
                        seqs = [[[((b * s + st) * 64 + r,) * 2 for b, nr in mine
                                  for r in range(rg, nr, rgn)] for rg in range(rgn)]
                                for mine in chunks]
                        acc = torch.stack([_butterfly(a) for a in _lane_sums(x, dy, seqs, rgn, cs, os_)])
                    blk = blk + acc
                total = torch.zeros_like(blk[0])
                for p in range(plan.blocks):
                    total = total + blk[p]
                out[st, c0:cs[1], o0:os_[1]] = total
    return out


def _emulated_gather(x, dy, idx, c, o):
    """K11's gather form under ``gather_plan``: a block owns a node range
    in tiles of 64; per tile and tap the present rows in node order, lane
    class rg of a 4 x 4 lane tile taking positions rg, rg + rgn, ... of them
    by FMAs; the classes by the butterfly; then the blocks in order."""
    n, k = dy.shape[0], idx.shape[0]
    plan = wgrad.gather_plan(n, k, c, o)
    ids = idx.numpy()
    out = torch.zeros((k, c, o))
    for c0 in range(0, c, plan.cgrp):
        for o0 in range(0, o, plan.ogrp):
            cs, os_ = (c0, min(c, c0 + plan.cgrp)), (o0, min(o, o0 + plan.ogrp))
            rgn = 32 // wgrad._lane_tiles(cs[1] - c0, os_[1] - o0, 4)[1]
            for kk in range(k):
                seqs = []
                for p in range(plan.blocks):
                    lanes = [[] for _ in range(rgn)]
                    for t0 in range(p * plan.per_block, min(n, (p + 1) * plan.per_block), 64):
                        nodes = np.arange(t0, min(n, t0 + 64, (p + 1) * plan.per_block))
                        pres = nodes[ids[kk, nodes] >= 0]
                        for q, node in enumerate(pres):
                            lanes[q % rgn].append((int(ids[kk, node]), int(node)))
                    seqs.append(lanes)
                acc = _lane_sums(x, dy, seqs, rgn, cs, os_)
                total = torch.zeros((cs[1] - c0, os_[1] - o0))
                for p in range(plan.blocks):
                    total = total + _butterfly(acc[p])
                out[kk, c0:cs[1], o0:os_[1]] = total
    return out


def _held_to_plain(emu, want, scale):
    assert bool(((emu - want).abs() <= 1e-5 * scale + 1e-6).all()), (emu - want).abs().max().item()


@pytest.mark.parametrize("form,s,c,o", [
    ("sb", 3, 8, 4), ("sb", 2, 24, 1), ("sb", 1, 15, 16), ("sb_bf16", 4, 8, 24), ("sb", 2, 40, 36),
    ("conv1", 1, 8, 8), ("conv1", 1, 16, 24), ("gather", 27, 8, 8), ("gather", 27, 3, 16),
    ("gather", 27, 20, 6)])
def test_k11_emulated_block_plan_matches_plain(slot_mask, level0, form, s, c, o):
    """K11's partitions and fixed-order sums, emulated, equal the plain
    versions within f32 rounding (1e-5 of the L1 scale).  Ring form: the
    superbrick layout over the bricks of every level (ragged last tiles and
    block ranges, empty slots), f32 lane tiles and the tensor cores'
    partition, output groups past 32 channels; the 1^3 conv at S = 1 over a
    ragged cut of the level-0 bucket (a last brick of N % 64 rows).  Gather
    form: the k^3 conv's dw through the level-0 map (absent taps, pad rows,
    a ragged last tile), output groups past 16 channels."""
    rng = np.random.default_rng(12 + c + o)
    if form.startswith("sb"):
        x, _, _, dy, _ = _sb_case(slot_mask, s, c, o, 13 + c)
        xt, dyt = torch.as_tensor(x), torch.as_tensor(dy)
        if form == "sb_bf16":  # values a bf16 product sees
            xt, dyt = xt.bfloat16().float(), dyt.bfloat16().float()
        rows = xt.shape[0] * 64
        emu = _emulated_ring(xt.reshape(-1, c), dyt.reshape(-1, o), rows, s, c, o,
                             bf16=form == "sb_bf16")
        want = wgrad.wgrad_sb_plain(xt, dyt, c, o)
        scale = wgrad.wgrad_sb_plain(xt.abs(), dyt.abs(), c, o)
        return _held_to_plain(emu, want, scale)
    n = level0.shape[1] - 100  # a ragged cut of the bucket, pad rows kept
    assert n % 64 != 0
    xg = torch.as_tensor(_rng_f32(rng, (level0.shape[1], c)))
    dyg = torch.as_tensor(_rng_f32(rng, (n, o)))
    if form == "conv1":
        emu = _emulated_ring(xg[:n], dyg, n, 1, c, o)
        want = wgrad.wgrad_gather_plain(xg[:n], dyg)
        scale = wgrad.wgrad_gather_plain(xg[:n].abs(), dyg.abs())
    else:
        idx = level0[:, :n].contiguous()
        assert bool((idx[:, -1] < 0).all()) and bool((idx < 0).any())
        emu = _emulated_gather(xg, dyg, idx, c, o)
        want = wgrad.wgrad_gather_plain(xg, dyg, idx)
        scale = wgrad.wgrad_gather_plain(xg.abs(), dyg.abs(), idx)
    _held_to_plain(emu, want, scale)


def test_k11_plan_depends_on_shapes_only():
    """K11's plans are functions of the shapes alone (so are dw's bits).
    Ring form: contiguous brick ranges that cover every brick once, one
    block an SM, stage groups of at most 16 warps' stages, a ring of 2-8
    slots of whole bricks in a block's shared memory, output groups of at
    most 32 channels (multiples of 8), warps a stage so that a block has
    8 where it can; the headline (8, 24) at S 4 takes a
    slot of two bricks (32 KB) and six slots.  Gather form: node ranges of
    whole 64-node tiles, two blocks an SM at the headline 8 -> 8, tap groups
    of 32, output groups of at most 16 (multiples of 4)."""
    for rows, s, c, o, esz in [(81_920 * 64, 4, 8, 24, 2), (81_920 * 64, 5, 8, 4, 2),
                               (27_264 * 64, 8, 8, 4, 2), (81_920 * 64, 9, 24, 1, 2),
                               (786_432, 1, 8, 24, 4), (5000, 1, 16, 24, 4), (64, 1, 1, 1, 4),
                               (333 * 64, 17, 15, 16, 4), (64 * 7, 3, 40, 70, 4)]:
        p = wgrad.ring_plan(rows, s, c, o, esz)
        assert p == wgrad.ring_plan(rows, s, c, o, esz)
        bricks = -(-rows // 64)
        assert (p.blocks - 1) * p.per_block < bricks <= p.blocks * p.per_block
        assert p.blocks * p.groups <= max(wgrad.SMS, p.groups)
        assert 1 <= p.sg <= min(s, wgrad.RING_MAX_WARPS) and p.sg * p.wps <= wgrad.RING_MAX_WARPS
        assert p.wps == max(1, 8 // p.sg)
        slot = p.tb * p.sg * 64 * (c + o) * esz
        assert 2 <= p.nst <= wgrad.RING_MAX_NST and p.nst * slot <= wgrad.RING_BYTES
        assert wgrad.RING_HDR + p.nst * slot <= p.smem <= wgrad.SMEM_MAX
        for n, g in ((c, p.cgrp), (o, p.ogrp)):
            assert g <= wgrad.RING_GROUP and (g == n or g % 8 == 0)
        assert p.groups == -(-s // p.sg) * -(-c // p.cgrp) * -(-o // p.ogrp)
    assert wgrad.ring_plan(81_920 * 64, 4, 8, 24, 2)[:4] == (4, 2, 2, 6)
    for n, k, c, o in [(786_432, 27, 8, 8), (786_432, 125, 16, 16), (786_432, 27, 3, 16),
                       (1, 27, 1, 1), (4000, 27, 20, 6), (786_430, 27, 8, 4)]:
        p = wgrad.gather_plan(n, k, c, o)
        assert p == wgrad.gather_plan(n, k, c, o)
        assert p.per_block % wgrad.G_TILE == 0 and p.smem <= wgrad.SMEM_MAX
        assert (p.blocks - 1) * p.per_block < n <= p.blocks * p.per_block
        for m, g in ((c, p.cgrp), (o, p.ogrp)):
            assert g <= wgrad.G_GROUP and (g == m or g % 4 == 0)
        assert p.groups == -(-k // wgrad.G_TAPS) * -(-c // p.cgrp) * -(-o // p.ogrp)
        assert p.smem <= wgrad.SMEM_MAX
    head = wgrad.gather_plan(786_432, 27, 8, 8)
    assert head.groups == 1 and 2 * (head.smem + 1024) <= wgrad.SMEM_SM
    assert head.blocks >= 0.9 * 2 * wgrad.SMS
    with pytest.raises(ValueError):
        wgrad.ring_plan(0, 1, 8, 8, 2)
    with pytest.raises(ValueError, match=r"C \+ O"):
        wgrad.ring_plan(64, 1, 600, 300, 4)
    with pytest.raises(ValueError):
        wgrad.gather_plan(10, 0, 8, 8)


# ------------------------------------------------------------ K10's widths --


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 8), (12, 6), (4, 2)])
def test_k10_takes_any_width(cin, cout):
    """K10's checks accept the gather network's widths at
    hidden_channel_conv 16 (and other ones) at K 27 and 125, with chunks of
    8 outputs from Cout 8 up and of 4 below, and a node tile from the
    shapes alone whose shared memory fits a block; a tile that fits no
    block raises."""
    for k in (27, 125):
        x = torch.zeros((10, cin))
        idx = torch.full((k, 10), -1, dtype=torch.int32)
        w = torch.zeros((k, cin, cout))
        plan = gc.check_gather_conv(x, idx, w, torch.zeros(cout))
        assert plan == gc.k10_plan(k, cin, cout)
        assert plan.chunk == (8 if cout >= 8 else 4)
        assert (plan.chunks - 1) * plan.chunk < cout <= plan.chunks * plan.chunk
        assert plan.smem == gc.k10_smem(k, cin, plan.chunk, plan.threads) <= gc.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        gc.k10_plan(125, 128, cout)
    with pytest.raises(ValueError):
        gc.k10_plan(27, cin, 0)


def test_k10_plan_tiles():
    """K10's node tile: 256 nodes wherever its index words, w's chunk and
    the ring fit a block's shared memory (the headline K 27, 8 -> 8, and K
    125 at Cin 8 and 16), 128 where they do not (K 125 at Cin 24)."""
    assert gc.k10_plan(27, 8, 8).threads == 256
    assert gc.k10_plan(125, 16, 16).threads == 256
    assert gc.k10_plan(125, 24, 8).threads == 128
    for k, cin, cout in ((27, 8, 8), (125, 24, 8), (27, 3, 16)):
        p = gc.k10_plan(k, cin, cout)
        assert p.smem == gc.k10_smem(k, cin, p.chunk, p.threads) <= gc.SMEM_MAX
        if p.threads == 128:
            assert gc.k10_smem(k, cin, p.chunk, 256) > gc.SMEM_MAX
