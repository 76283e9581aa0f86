"""The flat gather backend's network and trainer against the JAX package,
float32 on the CPU: the neighbour maps and the GOP batch bit for bit, the
gather conv (K10's plain version, and K10's own summation order emulated)
with JAX's scatter-free VJP, the network and its gradient at the
groupings, the dilated block and kernel size 5, and two epochs of the
trainer.

Inputs come from numpy seeds over ``synthetic_cloud(1500, depth=6)``
frames; both packages read one numpy-drawn flat parameter vector in their
flatten order.  Each JAX reference is jitted once per configuration."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.data import dataset as jds
from linr_pcgc_tpu.models import ModelConfig as JaxConfig
from linr_pcgc_tpu.models import flatten_params as jax_flatten
from linr_pcgc_tpu.models import init_params as jax_init
from linr_pcgc_tpu.models import network as jnet
from linr_pcgc_tpu.models import unflatten_params as jax_unflatten
from linr_pcgc_tpu.runtime import adam_init as jax_adam_init
from linr_pcgc_tpu.runtime import overfit as jov
from linr_pcgc_tpu_torch.data import PyramidDataset, synthetic_cloud
from linr_pcgc_tpu_torch.data.dataset import level_arrays_from_coords
from linr_pcgc_tpu_torch.models import ModelConfig, param_tree, params_from_flat
from linr_pcgc_tpu_torch.models import network as tnet
from linr_pcgc_tpu_torch.models.network import param_spec
from linr_pcgc_tpu_torch.ops import gather_conv as gc
from linr_pcgc_tpu_torch.runtime import overfit as tov

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
NETS = [{"outstage": 4}, {"outstage": 3}, {"outstage": 1}, {"block_type": "dilation"},
        {"kernel_size": 5}]
NET_IDS = ["outstage4", "outstage3", "outstage1", "dilation", "kernel5"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(cfg: ModelConfig, seed: int) -> np.ndarray:
    n = sum(int(np.prod(shape)) for _, shape in param_spec(cfg))
    return np.random.default_rng(seed).uniform(-0.1, 0.1, n).astype(np.float32)


def _jax_params(jcfg, flat):
    template = jax.eval_shape(lambda k: jax_init(k, jcfg), jax.random.PRNGKey(0))
    return jax_unflatten(template, jnp.asarray(flat))


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


# ---------------------------------------------------------- the network --


@pytest.fixture(scope="module")
def batch(pyrs):
    """The frame-0 arrays of the GOP batch at kernel 3 (dilations 1 and 2
    stacked) and at kernel 5."""
    out = {}
    for key, ks, dil in (("k3", 3, (1, 2)), ("k5", 5, (1,))):
        b = tov.assemble_gop(pyrs, ks, dil, "cpu")
        out[key] = {k: v[0] for k, v in tov.batch_arrays(b).items()}
    return out


def _frame(batch, cfg):
    return batch["k5" if cfg.kernel_size == 5 else "k3"]


@pytest.mark.parametrize("block_type", ["inception", "resnet", "dilation"])
def test_block_matches_jax(pyrs, batch, block_type):
    """_block (block_in) at one layer of each core kind and at two
    dilated layers: JAX's, feature-major, to rtol/atol 1e-5."""
    kw = {"block_type": block_type, "block_layers": 2 if block_type == "dilation" else 1}
    cfg, jcfg = ModelConfig(scale_num=pyrs[0].scale_num, **kw), JaxConfig(
        scale_num=pyrs[0].scale_num, **kw)
    flat = _flat(cfg, 21)
    fd = _frame(batch, cfg)
    x = np.random.default_rng(2).standard_normal((fd["nbr27"].shape[1], cfg.ch)).astype(np.float32)
    got = tnet._block(torch.as_tensor(x), fd["nbr27"], param_tree(params_from_flat(flat, cfg))[
        "block_in"])
    want = jax.jit(lambda p, xt: jnet._block(xt, jnp.asarray(fd["nbr27"].numpy()), p["block_in"]))(
        _jax_params(jcfg, flat), jnp.asarray(x.T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, **FWD)


def _jax_bits_and_logits(jcfg, fd):
    """jitted ((bits, logits), d(bits)/d(params)) of JAX's training_bits.
    JAX's forward_all_stages cannot run at outstage 1 (stack_outer_blocks
    of no blocks); there the reference is JAX's own pieces, the one stage
    on block_in's context (octant order is group order) and
    training_bits' loss."""
    args = [jnp.asarray(fd[k].numpy()) for k in ("scale_id", "feat_code", "nbr27")]
    occ, mask = jnp.asarray(fd["occ"].numpy()).astype(jnp.float32), jnp.asarray(fd["mask"].numpy())

    def bits_and_logits(p):
        if jcfg.outstage > 1:
            logits = jnet.forward_all_stages(p, jcfg, *args, occ)
            return jnet.training_bits(p, jcfg, *args, occ, mask), logits
        xg = jnet._block(jnet._input_features(p, jcfg, args[0] * 128 + args[1]), args[2],
                         p["block_in"])
        logits = jnet.stage_head_traced(p, jcfg, 0, xg, args[2])
        bce = jnp.maximum(logits, 0.0) - logits * occ + jnp.log1p(jnp.exp(-jnp.abs(logits)))
        return jnp.sum(jnp.where(mask[None, :], bce, 0.0)) / jnet.LN2, logits

    return jax.jit(jax.value_and_grad(bits_and_logits, has_aux=True))


@pytest.mark.parametrize("kw", NETS, ids=NET_IDS)
def test_network_and_gradient_match_jax(pyrs, batch, kw):
    """forward_all_stages' logits (8, N) to rtol/atol 1e-5, training_bits
    to rtol 1e-5, and its gradient over the flat parameter vector to rtol
    1e-4 / atol 1e-5, against JAX's training_bits and jax.grad, at the
    groupings 4 (2/2/2/2), 3 (2/2/4, ragged) and 1, a dilated block_in and
    kernel size 5."""
    cfg = ModelConfig(scale_num=pyrs[0].scale_num, **kw)
    jcfg = JaxConfig(scale_num=pyrs[0].scale_num, **kw)
    fd = _frame(batch, cfg)
    flat = _flat(cfg, 31)
    leaf = torch.tensor(flat, requires_grad=True)
    params = param_tree(tnet.unflatten_params(cfg, leaf))
    logits = tnet.forward_all_stages(params, cfg, fd["scale_id"], fd["feat_code"], fd["nbr27"],
                                     fd["occ"].float())
    bits = tnet.training_bits(params, cfg, fd["scale_id"], fd["feat_code"], fd["nbr27"],
                              fd["occ"].float(), fd["mask"])
    bits.backward()
    (jbits, jlogits), jgrad = _jax_bits_and_logits(jcfg, fd)(_jax_params(jcfg, flat))
    assert logits.shape == (8, fd["nbr27"].shape[1])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **FWD)
    np.testing.assert_allclose(float(bits.detach()), float(jbits), rtol=1e-5)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jax_flatten(jgrad)), **GRAD)
    assert float(leaf.grad.abs().max()) > 0


def test_level_context_is_block_in_feature_major(pyrs):
    cfg = ModelConfig(scale_num=pyrs[0].scale_num, outstage=4)
    jcfg = JaxConfig(scale_num=pyrs[0].scale_num, outstage=4)
    flat = _flat(cfg, 41)
    lev = pyrs[0].levels[0]
    _, _, code, nbr = level_arrays_from_coords(lev.coords, lev.n, device="cpu")
    idx = nbr.T.contiguous()
    got = tnet.level_context(param_tree(params_from_flat(flat, cfg)), cfg, 0, code, idx)
    want = jnet.level_context(_jax_params(jcfg, flat), jcfg, jnp.int32(0),
                              jnp.asarray(code.numpy()), jnp.asarray(idx.numpy()))
    assert got.shape == (cfg.ch, lev.coords.shape[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


# ---------------------------------------------------------- the trainer --


def test_two_epochs_match_jax_trainer(pyrs):
    """Two epochs of the port's gather trainer against JAX's make_epoch_fn
    at outstage 4, from one numpy parameter vector: per-frame losses
    rtol/atol 2e-4, final params rtol 1e-2 / atol 1e-4 (the fused
    trainer's tolerances), the schedule's step count and lr exactly."""
    tc = tov.TrainConfig(step_size=3)
    cfg = ModelConfig(scale_num=pyrs[0].scale_num, outstage=4)
    jcfg = JaxConfig(scale_num=pyrs[0].scale_num, outstage=4)
    flat = _flat(cfg, 5)
    tb = tov.batch_arrays(tov.assemble_gop(pyrs, device="cpu"))
    jb = jov.batch_arrays(jov.assemble_gop(pyrs))
    jfn, tfn = jov.make_epoch_fn(jcfg, tc), tov.make_epoch_fn(cfg, tc)
    jp = _jax_params(jcfg, flat)
    jo = jax_adam_init(jp)
    jlr, jk = jnp.asarray(tc.learning_rate, jnp.float32), jnp.zeros((), jnp.int32)
    tp = torch.as_tensor(flat)
    to, tlr, tk = tov.adam_init(tp), np.float32(tc.learning_rate), 0
    for _ in range(2):
        jp, jo, jlr, jk, jl = jfn(jp, jo, jlr, jk, jb)
        tp, to, tlr, tk, tl = tfn(tp, to, tlr, tk, tb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    assert tk == int(jk) == 4 and tlr == np.float32(jlr) < np.float32(tc.learning_rate)
    assert to["t"] == int(jo["t"])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jax_flatten(jp)), rtol=1e-2, atol=1e-4)
