"""Parameters, checkpoints and the byte formats that carry them: the port
must read the JAX package's weights and write the same bytes."""

import json

import numpy as np
import jax
import pytest
import torch

from linr_pcgc_tpu.coding.weights import compress_params as jax_compress
from linr_pcgc_tpu.data import PyramidDataset as JaxDataset
from linr_pcgc_tpu.data import synthetic_cloud
from linr_pcgc_tpu.models import ModelConfig as JaxConfig
from linr_pcgc_tpu.models import flatten_params as jax_flatten
from linr_pcgc_tpu.models import init_params as jax_init
from linr_pcgc_tpu.runtime import adam_init as jax_adam_init
from linr_pcgc_tpu.runtime import save_checkpoint as jax_save_checkpoint
from linr_pcgc_tpu.runtime.codec import encode_low_all_frames as jax_encode_low
from linr_pcgc_tpu_torch.coding.weights import compress_params, decompress_params
from linr_pcgc_tpu_torch.data import PyramidDataset
from linr_pcgc_tpu_torch.models import (
    ModelConfig,
    init_params,
    param_count,
    param_tree,
    params_from_flat,
    params_to_flat,
)
from linr_pcgc_tpu_torch.models.network import stack_outer_blocks
from linr_pcgc_tpu_torch.runtime import load_checkpoint, save_checkpoint
from linr_pcgc_tpu_torch.runtime.codec import decode_low_all_frames, encode_low_all_frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    # an rbg key: JAX's default threefry costs ~3x the eager compile time here
    return jax_init(jax.random.key(5, impl="unsafe_rbg"), JaxConfig())


@pytest.fixture(scope="module")
def jax_flat(jax_params):
    return np.asarray(jax_flatten(jax_params))


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


def test_jax_flat_roundtrips_through_port(jax_flat):
    params = params_from_flat(jax_flat, ModelConfig())
    np.testing.assert_array_equal(params_to_flat(params), jax_flat)
    tree = param_tree(params)
    assert tree["outer"][6]["conv_in"]["w"].shape == (27, 7, 8)
    st = stack_outer_blocks(tree, ModelConfig())
    assert st["conv_in_w"].shape == (7, 27, 7, 8)
    assert bool((st["conv_in_w"][0, :, 1:] == 0).all())


def test_jax_checkpoint_loads_into_port(tmp_path, jax_params, jax_flat):
    path = str(tmp_path / "model.npz")
    jax_save_checkpoint(path, jax_params, jax_adam_init(jax_params), lr=0.007, epoch=3, loss=0.5, bitdepth=8)
    params, topt, meta = load_checkpoint(path, ModelConfig())
    np.testing.assert_array_equal(params_to_flat(params), jax_flat)
    assert meta == {"lr": pytest.approx(0.007), "epoch": 3, "loss": 0.5, "bitdepth": 8}
    assert topt["t"] == 0 and not any(bool(t.any()) for t in topt["m"].values())
    # and the port writes the same layout back
    path2 = str(tmp_path / "model2.npz")
    save_checkpoint(path2, params, None, 0.007, 3, 0.5, 8)
    with np.load(path) as a, np.load(path2) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("bitdepth", [8, 6, 12])
def test_weight_codec_bytes_equal_jax(jax_flat, bitdepth):
    mine, ref = compress_params(jax_flat, bitdepth), jax_compress(jax_flat, bitdepth)
    assert mine["final_bytes"] == ref["final_bytes"]
    assert json.dumps(mine["side_info"]) == json.dumps(ref["side_info"])
    np.testing.assert_array_equal(mine["recon"], ref["recon"])
    back = decompress_params(len(jax_flat), mine["side_info"], mine["final_bytes"])
    np.testing.assert_array_equal(back, ref["recon"])


def test_base_layer_bytes_equal_jax():
    frames = [synthetic_cloud(1500, depth=6, seed=s) for s in range(2)]
    jd, td = JaxDataset(frames), PyramidDataset(frames, device="cpu")
    blob = encode_low_all_frames([td[0], td[1]])
    assert blob == jax_encode_low([jd[0], jd[1]])
    lows, mins = decode_low_all_frames(blob)
    np.testing.assert_array_equal(lows[1], td[1].low_coords)
    np.testing.assert_array_equal(mins[0], td[0].coord_min)
    assert torch.as_tensor(mins).shape == (2, 3)
