"""The parameter layout against the JAX package: the reference
architecture's size, and every leaf at JAX's flatten offset with JAX's
shape for each network configuration (JAX's side by ``jax.eval_shape``,
which compiles nothing)."""

import jax
import pytest
import torch

from linr_pcgc_tpu.models import ModelConfig as JaxConfig
from linr_pcgc_tpu.models import init_params as jax_init
from linr_pcgc_tpu_torch.models import ModelConfig, init_params, param_count

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_param_count_is_the_reference_architecture():
    assert param_count(init_params(0, ModelConfig())) == 54712


@pytest.mark.parametrize("kw", [{}, {"block_layers": 2}, {"block_type": "resnet"}, {"outstage": 4},
                                {"outstage": 3}, {"outstage": 1}, {"block_type": "dilation"},
                                {"kernel_size": 5}])
def test_flatten_order_and_shapes_match_jax(kw):
    """Every leaf lands at the JAX flatten offset with the JAX shape."""
    jp = jax.eval_shape(lambda k: jax_init(k, JaxConfig(**kw)), jax.random.PRNGKey(1))
    tp = init_params(1, ModelConfig(**kw))
    assert [tuple(t.shape) for t in tp.values()] == [
        tuple(v.shape) for v in jax.tree_util.tree_leaves(jp)]
