"""The hand CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips without a card.  The
file imports no JAX (the machine with the card has none), and the
repository's conftest.py does, so on that machine run it as

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from linr_pcgc_tpu_torch.ops import plane_conv, superbricks as sb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, seed, scale=1.0):
    return torch.as_tensor(
        (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32))


def _geometric_nbr(bb, side, seed):
    """Bricks on random sites of a side^3 grid and their 27-neighbour map."""
    rng = np.random.default_rng(seed)
    sites = rng.choice(side**3, size=bb, replace=False)
    coords = np.stack([sites // side**2, (sites // side) % side, sites % side], axis=1)
    lut = {tuple(c): i for i, c in enumerate(coords)}
    nbr = np.full((bb, 27), -1, np.int32)
    for b in range(bb):
        for k, d in enumerate(sb._DIRS):
            nbr[b, k] = lut.get(tuple(coords[b] + np.asarray(d)), -1)
    return torch.as_tensor(nbr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,o", [(8, 8), (12, 8), (7, 8), (4, 4)])
def test_kernels_match_plain(cuda, dtype, c, o):
    """K2 bit for bit; K1 to 1e-5 in f32 (summation order) and, in bf16,
    to one bf16 rounding (2^-7 relative) of the same f32 sum."""
    bb, s = 777, 2
    x = _rand((bb, s, 64 * c), 14).to(cuda, dtype)
    nbr = _geometric_nbr(bb, 12, 15).to(cuda)
    launched = (plane_conv.plane_matmul_bm.launches, sb.b4_halo_sm.launches)
    h = sb.b4_halo_sm(x, nbr)
    torch.cuda.synchronize()
    assert torch.equal(h, sb.b4_halo_sm_plain(x, nbr))
    w2 = sb.b4_conv_weight_matrix_sm(_rand((s, 27, c, o), 16, 0.1)).to(cuda, dtype).contiguous()
    bias = _rand((s, 64 * o), 17).to(cuda, dtype)
    mask = (torch.rand((bb, 64), generator=torch.Generator().manual_seed(0)) < 0.6).to(cuda, dtype)
    got = plane_conv.plane_matmul_bm(h, w2, c, o, bias, mask).float()
    torch.cuda.synchronize()
    want = plane_conv.plane_matmul_bm_plain(h, w2, c, o, bias, mask).float()
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert (plane_conv.plane_matmul_bm.launches, sb.b4_halo_sm.launches) == (
        launched[0] + 1, launched[1] + 1)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((4, 1, 64 * 3), device=cuda, dtype=torch.float16)
    nbr = torch.full((4, 27), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # 2-byte, but a dtype K1 does not take
        plane_conv.plane_matmul_bm(torch.zeros((4, 1, 216 * 3), device=cuda, dtype=torch.float16),
                                   torch.zeros((1, 216 * 3, 64 * 2), device=cuda),
                                   3, 2, torch.zeros((1, 128), device=cuda),
                                   torch.zeros((4, 64), device=cuda))
    with pytest.raises(ValueError):  # int64 neighbour map
        sb.b4_halo_sm(x, nbr.long())
    with pytest.raises(ValueError):  # not contiguous
        sb.b4_halo_sm(torch.zeros((4, 1, 64 * 3 * 2), device=cuda)[..., ::2], nbr)


@pytest.mark.cuda
def test_codec_roundtrip_on_card(cuda, tmp_path):
    """A small GOP encodes and decodes losslessly on the card, through the
    kernels, with the CUDA backend tag."""
    import json

    from linr_pcgc_tpu_torch.data import PyramidDataset, synthetic_cloud
    from linr_pcgc_tpu_torch.models import ModelConfig, init_params
    from linr_pcgc_tpu_torch.runtime import decode_gop, encode_gop, save_checkpoint

    frames = [synthetic_cloud(6000, depth=7, seed=s) for s in range(2)]
    ds = PyramidDataset(frames, device=cuda)
    cfg = ModelConfig(scale_num=ds[0].scale_num)
    save_checkpoint(str(tmp_path / "m.npz"), init_params(1, cfg), None, 0.01, 0, 0.0, 8)
    before = sb.b4_halo_sm.launches
    encode_gop(str(tmp_path / "m.npz"), [ds[0], ds[1]], str(tmp_path / "enc"), cfg)
    out = decode_gop(str(tmp_path / "enc"), None, ground_truth=ds.raw_sorted_points)
    assert [len(o) for o in out] == [len(np.unique(f, axis=0)) for f in frames]
    assert sb.b4_halo_sm.launches > before
    with open(tmp_path / "enc" / "side_info.json") as f:
        assert json.load(f)["numerics"]["backend"].startswith("torch-cuda-sm")
