"""The flat gather backend's network and trainer against the JAX package,
float32 on the CPU: the network and its gradient at the groupings, the
dilated block and kernel size 5, the static-stage stage_logits, and two
epochs of the trainer.  The neighbour maps, the GOP batch and the gather
conv are held against JAX in tests/test_torch_gather_conv.py.

Inputs come from numpy seeds over ``synthetic_cloud(1500, depth=6)``
frames; both packages read one numpy-drawn flat parameter vector in their
flatten order.  Each JAX reference is jitted once per configuration."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

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
from linr_pcgc_tpu_torch.runtime import overfit as tov

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)

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


def test_stage_logits_match_jax(pyrs):
    """The static-stage API stage_logits at the default config, stages 0
    (x_glob alone) and 4 (the context block over the 4 bits coded before
    it), on level 1 of frame 0, feature-major as JAX's (len(group), N):
    rtol/atol 1e-5.  Both stages in one jit of JAX's (one compile)."""
    cfg, jcfg = ModelConfig(scale_num=pyrs[0].scale_num), JaxConfig(scale_num=pyrs[0].scale_num)
    flat = _flat(cfg, 51)
    lev = pyrs[0].levels[1]
    _, _, _, nbr = level_arrays_from_coords(lev.coords, lev.n, device="cpu")
    idx = nbr.T.contiguous()
    n = idx.shape[1]
    rng = np.random.default_rng(52)
    x_glob = rng.standard_normal((cfg.ch, n)).astype(np.float32)
    occ = (rng.uniform(size=(4, n)) < 0.5).astype(np.float32)
    stages = {0: occ[:0], 4: occ}
    want = jax.jit(lambda p, xg, o, i: {s: jnet.stage_logits(p, jcfg, s, xg, o[:len(v)], i)
                                        for s, v in stages.items()})(
        _jax_params(jcfg, flat), jnp.asarray(x_glob), jnp.asarray(occ), jnp.asarray(idx.numpy()))
    params = param_tree(params_from_flat(flat, cfg))
    for s, o in stages.items():
        got = tnet.stage_logits(params, cfg, s, torch.as_tensor(x_glob), torch.as_tensor(o), idx)
        assert got.shape == (1, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want[s]), **FWD)
    assert not np.allclose(np.asarray(want[0]), np.asarray(want[4]))


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
