"""The hand CUDA kernels against their plain PyTorch versions, on a card:
K1 and K2 (the conv forward), K3 and K4 (its backward: dx, and dw as the
27-tap stencil reduced over the bricks), the conv's gradient and one epoch
of the trainer, K5 and K6 (the rANS coder), the probes K7-K9 and K10 (the
gather backend's neighbour-gather conv).

Every test that launches a kernel carries the ``cuda`` marker and skips
without a card; the tests at the end check the kernels' launch plans,
tables and index arithmetic on the CPU.  The file imports no JAX (the
machine with the card has none), and the repository's conftest.py does,
so on that machine run it as

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from linr_pcgc_tpu_torch.ops import gather_conv as gc
from linr_pcgc_tpu_torch.ops import plane_conv, probes, rans as tr, superbricks as sb, taps, wgrad


@pytest.fixture(autouse=True)
def _one_torch_thread_on_the_cpu(request):
    """The CPU checks (no ``cuda`` marker) take one intra-op thread: the
    suite runs several test processes at once."""
    if request.node.get_closest_marker("cuda"):
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    w = _rand((s, 27, c, o), 16, 0.1).to(cuda, dtype)
    bias = _rand((s, 64 * o), 17).to(cuda, dtype)
    mask = (torch.rand((bb, 64), generator=torch.Generator().manual_seed(0)) < 0.6).to(cuda, dtype)
    got = plane_conv.plane_matmul_bm(h, w, c, o, bias, mask).float()
    torch.cuda.synchronize()
    want = plane_conv.plane_matmul_bm_plain(h, w, c, o, bias, mask).float()
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert (plane_conv.plane_matmul_bm.launches, sb.b4_halo_sm.launches) == (
        launched[0] + 1, launched[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [7, 8, 12, 4])
@pytest.mark.parametrize("bb,s", [(1007, 1), (1007, 2), (333, 5), (333, 8), (20001, 2)])
def test_halo_kernel_bit_exact(cuda, dtype, c, bb, s):
    """K2 bit for bit against its plain version at every (C, dtype) of the
    main path, S up to 8, on a sparse geometry (absent neighbours), with a
    brick count that leaves the last block's range ragged; one launch per
    call."""
    x = _rand((bb, s, 64 * c), 70 + c).to(cuda, dtype)
    nbr = _geometric_nbr(bb, 12 if bb < 1728 else 30, 71).to(cuda)
    assert bb % sb.halo_plan(bb, s, c, x.element_size()).bricks
    launched = sb.b4_halo_sm.launches
    h = sb.b4_halo_sm(x, nbr)
    torch.cuda.synchronize()
    assert sb.b4_halo_sm.launches == launched + 1
    assert torch.equal(h, sb.b4_halo_sm_plain(x, nbr))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_halo_kernel_lone_bricks_and_narrow_alignment(cuda, dtype):
    """K2 where every neighbour is absent (each halo is the brick's own
    slots and zeros), and on an x whose address is aligned to one element
    only, where the plan takes a narrower copy unit: the plain version's
    bits."""
    bb, s, c = 300, 2, 8
    lone = torch.full((bb, 27), -1, dtype=torch.int32, device=cuda)
    x = _rand((bb, s, 64 * c), 72).to(cuda, dtype)
    assert torch.equal(sb.b4_halo_sm(x, lone), sb.b4_halo_sm_plain(x, lone))
    flat = torch.zeros(bb * s * 64 * c + 1, device=cuda, dtype=dtype)
    xs = flat[1:].view(bb, s, 64 * c)
    xs.copy_(x)
    nbr = _geometric_nbr(bb, 8, 73).to(cuda)
    assert sb.halo_plan(bb, s, c, x.element_size(), xs.data_ptr() & -xs.data_ptr()).unit_bytes \
        == x.element_size()
    assert torch.equal(sb.b4_halo_sm(xs, nbr), sb.b4_halo_sm_plain(x, nbr))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,o", [(8, 8), (12, 8), (4, 4)])
def test_backward_kernels_match_plain(cuda, dtype, c, o):
    """K3 (dx shapes: kc = O, no = C) to K1's tolerances; K4's dw to its
    plain version (dense moment, then the tap selection) within 1e-5 (f32)
    or 1e-4 (bf16) of dw's L1 scale (sum |x||g| over the same terms): the
    two sum the same products over the bricks in another order."""
    bb, s = 1777, 3
    g = _rand((bb, s, 216 * o), 18).to(cuda, dtype)
    wt = _rand((s, 27, o, c), 19, 0.1).to(cuda, dtype)
    x = _rand((bb, s, 64 * c), 20).to(cuda, dtype)
    launched = (plane_conv.plane_matmul.launches, plane_conv.plane_moment_dw.launches)
    dx = plane_conv.plane_matmul(g, wt, o, c).float()
    dw = plane_conv.plane_moment_dw(x, g, c, o)
    torch.cuda.synchronize()
    want = plane_conv.plane_matmul_plain(g, wt, o, c).float()
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(dx, want, rtol=tol, atol=tol)
    _assert_dw_close(dw, x, g, c, o, dtype)
    assert torch.equal(dw, plane_conv.plane_moment_dw(x, g, c, o))  # fixed sum order
    assert (plane_conv.plane_matmul.launches, plane_conv.plane_moment_dw.launches) == (
        launched[0] + 1, launched[1] + 2)


def _assert_dw_close(dw, x, g, c, o, dtype):
    """dw (S, 27, c, o) f32 against the plain version, within 1e-5 (f32) or
    1e-4 (bf16) of the L1 scale plane_moment_dw_plain(|x|, |g|)."""
    want = plane_conv.plane_moment_dw_plain(x, g, c, o)
    scale = plane_conv.plane_moment_dw_plain(x.abs(), g.abs(), c, o)
    rel = 1e-5 if dtype == torch.float32 else 1e-4
    assert dw.dtype == torch.float32 and dw.shape == want.shape
    assert bool(torch.isfinite(dw).all())
    err = (dw - want).abs()
    assert bool((err <= rel * scale).all()), f"max abs err {err.max().item()}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 4, 5, 8])
@pytest.mark.parametrize("c,o", [(8, 8), (12, 8), (4, 4), (7, 8)])
def test_moment_dw_training_shapes(cuda, dtype, s, c, o):
    """K4 at every (C, O) x S x dtype of the training paths (the fused
    pass: S = cs, 1 + cs at level 0 and 8 at levels 1-6; the unfused: x_glob
    at S = 1, chunks at S = cs, and C = 7 for the context blocks' first
    conv) on masked inputs, as the backward gives them: its plain version's
    values and the same bits from two launches."""
    bb = 2048
    mask = (torch.rand((bb, 64), generator=torch.Generator().manual_seed(s)) < 0.5).float()
    x = (_rand((bb, s, 64 * c), 40 + s) * mask.repeat_interleave(c, 1)[:, None]).to(cuda, dtype)
    g = _rand((bb, s, 216 * o), 50 + s).to(cuda, dtype)
    dw = plane_conv.plane_moment_dw(x, g, c, o)
    dw2 = plane_conv.plane_moment_dw(x, g, c, o)
    torch.cuda.synchronize()
    _assert_dw_close(dw, x, g, c, o, dtype)
    assert torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bb,s,c,o", [(1, 1, 8, 8), (63, 2, 12, 8), (1007, 12, 8, 8),
                                      (333, 2, 5, 3), (200, 3, 6, 10), (150, 2, 16, 16)])
def test_moment_dw_ragged_and_other_shapes(cuda, dtype, bb, s, c, o):
    """K4 with ragged brick ranges, more stages than one launch takes (S =
    12, two stage groups) and channel counts off the main path (the
    runtime-shaped form): its plain version's values."""
    x = _rand((bb, s, 64 * c), 60).to(cuda, dtype)
    g = _rand((bb, s, 216 * o), 61).to(cuda, dtype)
    dw = plane_conv.plane_moment_dw(x, g, c, o)
    torch.cuda.synchronize()
    _assert_dw_close(dw, x, g, c, o, dtype)


def _tap_case(seed, bb, s, c, o, dtype, dev, mask_p=0.6):
    """h, taps, bias and a slot mask with occupancy ``mask_p`` on ``dev``."""
    h = _rand((bb, s, 216 * c), seed).to(dev, dtype)
    w = _rand((s, 27, c, o), seed + 1, 0.1).to(dev, dtype)
    bias = _rand((s, 64 * o), seed + 2).to(dev, dtype)
    gen = torch.Generator().manual_seed(seed)
    mask = (torch.rand((bb, 64), generator=gen) < mask_p).to(dev, dtype)
    return h, w, bias, mask


def _assert_kernel_close(got, want, dtype):
    """f32: 1e-5 + 1e-5 |ref| (sums in another order); bf16: 1e-4 + 2^-7
    |ref| (one bf16 rounding of the same f32 sum)."""
    got, want = got.float(), want.float()
    tol = (1e-5 + 1e-5 * want.abs()) if dtype == torch.float32 else (1e-4 + 2.0**-7 * want.abs())
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert bool((err <= tol).all()), f"max abs err {err.max().item()}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("bb", [1, 63, 1007])
def test_tap_kernels_ragged_tiles_and_stages(cuda, dtype, s, bb):
    """K1 at C = O = 8 and K3 at (kc, no) = (8, 12) (the backward's dx of
    the (12, 8) conv) for brick counts that leave a ragged last tile and S
    from 1 to 5: the plain versions' values, and the same bits from a
    second launch."""
    h, w, bias, mask = _tap_case(100 + s, bb, s, 8, 8, dtype, cuda)
    y = plane_conv.plane_matmul_bm(h, w, 8, 8, bias, mask)
    y2 = plane_conv.plane_matmul_bm(h, w, 8, 8, bias, mask)
    g, wt, _, _ = _tap_case(200 + s, bb, s, 8, 12, dtype, cuda)
    dx = plane_conv.plane_matmul(g, wt, 8, 12)
    dx2 = plane_conv.plane_matmul(g, wt, 8, 12)
    torch.cuda.synchronize()
    _assert_kernel_close(y, plane_conv.plane_matmul_bm_plain(h, w, 8, 8, bias, mask), dtype)
    _assert_kernel_close(dx, plane_conv.plane_matmul_plain(g, wt, 8, 12), dtype)
    assert torch.equal(y, y2) and torch.equal(dx, dx2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,o", [(8, 8), (12, 8), (7, 8), (4, 4)])
def test_tap_kernels_at_the_bricks_trainers_stage_batch(cuda, dtype, c, o):
    """The bricks trainer runs every 3^3 conv at S = 1: K1 at each (C, O) of
    its convs and K3 at its dx, (kc, no) = (O, C) (the context blocks'
    conv_in, (7, 8), takes no dx, but K3 holds there too), against the
    plain versions, the same bits from a second launch."""
    h, w, bias, mask = _tap_case(500 + c, 1007, 1, c, o, dtype, cuda)
    y = plane_conv.plane_matmul_bm(h, w, c, o, bias, mask)
    y2 = plane_conv.plane_matmul_bm(h, w, c, o, bias, mask)
    g, wt, _, _ = _tap_case(600 + c, 1007, 1, o, c, dtype, cuda)
    dx = plane_conv.plane_matmul(g, wt, o, c)
    dx2 = plane_conv.plane_matmul(g, wt, o, c)
    torch.cuda.synchronize()
    _assert_kernel_close(y, plane_conv.plane_matmul_bm_plain(h, w, c, o, bias, mask), dtype)
    _assert_kernel_close(dx, plane_conv.plane_matmul_plain(g, wt, o, c), dtype)
    assert torch.equal(y, y2) and torch.equal(dx, dx2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,o", [(8, 8), (12, 8), (7, 8), (4, 4)])
def test_tap_kernel_masks(cuda, dtype, c, o):
    """K1 with an all-zero mask writes zeros everywhere; with a sparse one
    (10 % of the slots) it matches its plain version."""
    h, w, bias, _ = _tap_case(300 + c, 501, 2, c, o, dtype, cuda)
    zero = torch.zeros((501, 64), device=cuda, dtype=dtype)
    y = plane_conv.plane_matmul_bm(h, w, c, o, bias, zero)
    _, _, _, sparse = _tap_case(300 + c, 501, 2, c, o, dtype, cuda, mask_p=0.1)
    ys = plane_conv.plane_matmul_bm(h, w, c, o, bias, sparse)
    torch.cuda.synchronize()
    assert bool((y.float() == 0).all())
    _assert_kernel_close(ys, plane_conv.plane_matmul_bm_plain(h, w, c, o, bias, sparse), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,c,o", [(2, 5, 3), (3, 6, 10), (2, 16, 16), (8, 24, 16)])
def test_tap_kernels_other_shapes(cuda, dtype, s, c, o):
    """Channel counts off the main path take the kernel's runtime-shaped
    forms (odd and even C, O not a multiple of 8, and at S = 8 taps too
    large to stage in shared memory): K1 and K3 still match their plain
    versions."""
    h, w, bias, mask = _tap_case(400 + c, 333, s, c, o, dtype, cuda)
    y = plane_conv.plane_matmul_bm(h, w, c, o, bias, mask)
    dx = plane_conv.plane_matmul(h, w, c, o)
    torch.cuda.synchronize()
    _assert_kernel_close(y, plane_conv.plane_matmul_bm_plain(h, w, c, o, bias, mask), dtype)
    _assert_kernel_close(dx, plane_conv.plane_matmul_plain(h, w, c, o), dtype)


@pytest.mark.cuda
def test_conv_gradient_on_card_matches_cpu(cuda):
    """The conv's autograd Function through K2, K1, K3 and K4 against its
    plain path on the CPU, f32; the backward launches K4 once."""
    bb, s, c, o = 333, 2, 12, 8
    x = _rand((bb, s, 64 * c), 21)
    w = _rand((s, 27, c, o), 22, 0.1)
    b = _rand((s, o), 23)
    mask = (torch.rand((bb, 64), generator=torch.Generator().manual_seed(1)) < 0.6).float()
    nbr = _geometric_nbr(bb, 9, 24)
    dy = _rand((bb, s, 64 * o), 25)
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.to(dev, copy=True).requires_grad_() for t in (x, w, b)]
        y = sb.b4_convsm_bm(*leaves, mask.to(dev), nbr.to(dev))
        launched = plane_conv.plane_moment_dw.launches
        y.backward(dy.to(dev))
        # the backward's dw comes from one K4 launch on the card, none on the CPU
        assert plane_conv.plane_moment_dw.launches - launched == (0 if dev == "cpu" else 1)
        grads.append([y.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_convsm_on_card_matches_plain(cuda, dtype):
    """The conv without bias and mask (JAX's b4_convsm) forward and backward
    on the card at the trainer's level-0 shape (S 4, C = O = 8), on masked
    inputs over a sparse brick grid: y and dx against the plain versions of
    K2 and K3 on the same inputs at K3's tolerance, dw against K4's plain
    version on the halo of dy; the forward launches K2 and K3 once each,
    the backward K2, K3 and K4 once each."""
    bb, s, c, o = 2048, 4, 8, 8
    mask = (torch.rand((bb, 64), generator=torch.Generator().manual_seed(4)) < 0.5).float()
    x = (_rand((bb, s, 64 * c), 26) * mask.repeat_interleave(c, 1)[:, None]).to(cuda, dtype)
    w = _rand((s, 27, c, o), 27, 0.1).to(cuda)
    dy = (_rand((bb, s, 64 * o), 28) * mask.repeat_interleave(o, 1)[:, None]).to(cuda, dtype)
    nbr = _geometric_nbr(bb, 16, 29).to(cuda)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    counts = lambda: (sb.b4_halo_sm.launches, plane_conv.plane_matmul.launches,  # noqa: E731
                      plane_conv.plane_moment_dw.launches)
    before = counts()
    y = sb.b4_convsm(xl, wl, nbr)
    forward = counts()
    y.backward(dy)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(forward, before)] == [1, 1, 0]
    assert [a - b for a, b in zip(counts(), forward)] == [1, 1, 1]
    assert y.dtype == xl.grad.dtype == dtype and wl.grad.dtype == torch.float32
    _assert_kernel_close(y, plane_conv.plane_matmul_plain(
        sb.b4_halo_sm_plain(x, nbr), w.to(dtype).contiguous(), c, o), dtype)
    g = sb.b4_halo_sm_plain(dy, nbr)
    wt = w[:, sb._FLIP].transpose(-1, -2).to(dtype).contiguous()
    _assert_kernel_close(xl.grad, plane_conv.plane_matmul_plain(g, wt, o, c), dtype)
    _assert_dw_close(wl.grad, x, g, c, o, dtype)


@pytest.mark.cuda
def test_plane_moment_refuses_a_card_tensor(cuda):
    """JAX's dense moment has no kernel: on a CUDA tensor plane_moment
    raises, names K4's entry and launches nothing."""
    x = torch.zeros((4, 1, 64 * 2), device=cuda)
    g = torch.zeros((4, 1, 216 * 2), device=cuda)
    launched = plane_conv.plane_moment_dw.launches
    with pytest.raises(ValueError, match="plane_moment_dw"):
        plane_conv.plane_moment(x, g, 2, 2)
    assert plane_conv.plane_moment_dw.launches == launched


@pytest.mark.cuda
def test_one_epoch_on_card_matches_cpu(cuda):
    """The trainer on a small 2-frame GOP, f32: the first frame's loss and
    flat gradient and one epoch's per-frame losses on the card against the
    CPU's plain path.  The gradient is held to 1e-3 of its largest entry
    (sums in another order; a ReLU whose input rounds across zero moves a
    few entries); parameters after Adam are not compared, since Adam turns
    the sign of a near-zero gradient into a full lr step."""
    from linr_pcgc_tpu_torch.data import PyramidDataset, synthetic_cloud
    from linr_pcgc_tpu_torch.models import ModelConfig, flatten_params, init_params
    from linr_pcgc_tpu_torch.runtime import TrainConfig, adam_init
    from linr_pcgc_tpu_torch.runtime.sb_overfit import (
        assemble_gop_superbricks, make_epoch_fn_sb, make_frame_grads_sb)

    ds = PyramidDataset([synthetic_cloud(3000, depth=7, seed=s) for s in range(2)], device="cpu")
    pyrs = [ds[0], ds[1]]
    cfg = ModelConfig(scale_num=ds.scale_num)
    out = []
    for dev in ("cpu", cuda):
        batch = assemble_gop_superbricks(pyrs, dev)
        flat = flatten_params(init_params(3, cfg, dev))
        grads = make_frame_grads_sb(cfg, batch.level_slices, torch.float32, stage_chunk=4)
        loss, g = grads(flat, dict(nbr27=batch.nbr27[0], code=batch.code[0], occ=batch.occ[0],
                                   point_num=batch.point_num[0]))
        fn = make_epoch_fn_sb(cfg, TrainConfig(), batch.level_slices, torch.float32, stage_chunk=4)
        losses = fn(flat, adam_init(flat), np.float32(0.01), 0, batch)[4]
        out.append((loss.cpu(), g.cpu(), losses))
    (l0, g0, e0), (l1, g1, e1) = out
    torch.testing.assert_close(l1, l0, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(g1, g0, rtol=1e-3, atol=1e-3 * g0.abs().max().item())
    torch.testing.assert_close(e1, e0, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_bricks_frame_gradient_on_card_matches_cpu(cuda):
    """The bricks trainer on a small frame, f32: its loss and flat
    gradient on the card (K1-K4 and K11 at S = 1) against the CPU's plain
    path, the gradient to 1e-3 of its largest entry (as the superbrick
    trainer's card test); it launches K1, K3, K4 and K11."""
    from linr_pcgc_tpu_torch.data import PyramidDataset, synthetic_cloud
    from linr_pcgc_tpu_torch.models import ModelConfig, flatten_params, init_params
    from linr_pcgc_tpu_torch.ops import counters
    from linr_pcgc_tpu_torch.runtime.brick_overfit import (
        assemble_gop_bricks, brick_frames, make_frame_grads_bricks)

    ds = PyramidDataset([synthetic_cloud(3000, depth=7, seed=4)], device="cpu")
    cfg = ModelConfig(scale_num=ds[0].scale_num)
    out = []
    for dev in ("cpu", cuda):
        batch = assemble_gop_bricks([ds[0]], dev)
        grads = make_frame_grads_bricks(cfg, batch.level_slices, torch.float32)
        counters.reset_launches()
        loss, g = grads(flatten_params(init_params(3, cfg, dev)), next(brick_frames(batch)))
        out.append((loss.cpu(), g.cpu(), counters.launches()))
    (l0, g0, n0), (l1, g1, n1) = out
    assert not any(n0.values()) and all(n1[k] > 0 for k in ("K1", "K2", "K3", "K4", "K11"))
    torch.testing.assert_close(l1, l0, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(g1, g0, rtol=1e-3, atol=1e-3 * g0.abs().max().item())


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((4, 1, 64 * 3), device=cuda, dtype=torch.float16)
    nbr = torch.full((4, 27), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # 2-byte, but a dtype K1 does not take
        plane_conv.plane_matmul_bm(torch.zeros((4, 1, 216 * 3), device=cuda, dtype=torch.float16),
                                   torch.zeros((1, 27, 3, 2), device=cuda),
                                   3, 2, torch.zeros((1, 128), device=cuda),
                                   torch.zeros((4, 64), device=cuda))
    with pytest.raises(TypeError):  # float16 throughout
        plane_conv.plane_matmul(torch.zeros((4, 1, 216 * 3), device=cuda, dtype=torch.float16),
                                torch.zeros((1, 27, 3, 2), device=cuda, dtype=torch.float16), 3, 2)
    with pytest.raises(ValueError, match="aligned"):  # the bulk copy needs 16-byte rows
        h = torch.zeros(4 * 216 * 8 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(4, 1, 216 * 8)
        plane_conv.plane_matmul(h, torch.zeros((1, 27, 8, 8), device=cuda, dtype=torch.bfloat16),
                                8, 8)
    with pytest.raises(ValueError):  # taps of the wrong shape (a conv matrix)
        plane_conv.plane_matmul(torch.zeros((4, 1, 216 * 8), device=cuda),
                                torch.zeros((1, 216 * 8, 64 * 8), device=cuda), 8, 8)
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


def _rans_segments(seed, seg_steps, dev):
    """f16 probabilities (skewed, as the codec's), bits drawn from them and
    a ragged valid tail, on ``dev``; segments in decode order."""
    rng = np.random.default_rng(seed)
    out = []
    for steps in seg_steps:
        n = steps * tr.LANES
        p = rng.uniform(0.0, 1.0, n)
        p = np.where(rng.uniform(size=n) < 0.7, 0.02, p).astype(np.float16)
        v = np.arange(n) < n - 777
        b = np.where(v, rng.uniform(size=n) < p.astype(np.float32), 0).astype(np.uint8)
        out.append(tuple(torch.as_tensor(a).to(dev) for a in (p, b, v)))
    return out


def _rans_stream(emissions):
    """Per-segment (byts, mask) in decode order -> (flat lane-major stream
    with a zero tail, lane start offsets, lane lengths), as the codec lays
    out a blob."""
    byts = torch.cat([e[0] for e in emissions])
    mask = torch.cat([e[1] for e in emissions])
    lens, out = tr.rans_compact_emissions(byts, mask, 2 * byts.shape[0])
    payload = out[torch.arange(out.shape[1], device=out.device)[None] < lens[:, None]]
    stream = torch.cat([payload, payload.new_zeros(1)])
    return stream, torch.cumsum(lens, 0) - lens, lens


def _rans_encode(enc, segs, dev):
    states, emissions = tr.rans_initial_states(dev), []
    for p, b, v in reversed(segs):
        states, byts, mask = enc(states, p, b, v)
        emissions.append((byts, mask))
    return states, emissions[::-1]


def _rans_decode(dec, states, stream, offs, segs):
    cur, bits = offs, []
    for p, _, v in segs:
        states, cur, got = dec(states, cur, stream, p, v)
        bits.append(got)
    return states, cur, bits


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 7, 13])
def test_rans_kernels_match_plain(cuda, steps):
    """K5's bytes, masks and states and K6's bits, states and cursors equal
    their plain versions', over a chain of two segments with pads; each
    kernel decodes the other version's stream, and two runs give the same
    bytes."""
    segs = _rans_segments(30 + steps, [steps, 3], cuda)
    launched = (tr.rans_encode_segment.launches, tr.rans_decode_segment.launches)
    k_st, k_em = _rans_encode(tr.rans_encode_segment, segs, cuda)
    p_st, p_em = _rans_encode(tr.rans_encode_segment_plain, segs, cuda)
    torch.cuda.synchronize()
    assert torch.equal(k_st, p_st)
    for (kb, km), (pb, pm) in zip(k_em, p_em):
        assert kb.dtype == torch.uint8 and km.dtype == torch.bool
        assert torch.equal(kb, pb) and torch.equal(km, pm)
    again = _rans_encode(tr.rans_encode_segment, segs, cuda)[1]
    assert all(torch.equal(a[0], b[0]) for a, b in zip(again, k_em))
    k_stream, offs, lens = _rans_stream(k_em)
    p_stream = _rans_stream(p_em)[0]
    want_bits = [b for _, b, _ in segs]
    for dec, stream in ((tr.rans_decode_segment, p_stream),        # K6 on the plain encoder's bytes
                        (tr.rans_decode_segment_plain, k_stream),  # the plain decoder on K5's
                        (tr.rans_decode_segment, k_stream)):
        st, cur, bits = _rans_decode(dec, k_st, stream, offs, segs)
        torch.cuda.synchronize()
        assert torch.equal(st, tr.rans_initial_states(cuda))
        assert torch.equal(cur, offs + lens)
        for got, want in zip(bits, want_bits):
            assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert (tr.rans_encode_segment.launches, tr.rans_decode_segment.launches) == (
        launched[0] + 4, launched[1] + 4)


@pytest.mark.cuda
def test_rans_decode_kernel_matches_plain_on_garbage(cuda):
    """On a stream that is not the encoder's (random bytes, cursors near
    the end, so reads clamp to the last byte) K6 still gives the plain
    version's bits, states and cursors."""
    (p, _, v), = _rans_segments(40, [5], cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    stream = torch.randint(0, 256, (3000,), generator=gen, device=cuda, dtype=torch.uint8)
    states = torch.randint(1 << 23, 1 << 31, (tr.LANES,), generator=gen, device=cuda)
    cur = torch.randint(2900, 3000, (tr.LANES,), generator=gen, device=cuda)
    got = tr.rans_decode_segment(states, cur, stream, p, v)
    want = tr.rans_decode_segment_plain(states, cur, stream, p, v)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _stage_level(dev, n_points, depth, n_frames, seed):
    """Level 0 of a GOP of synthetic clouds through the codec's brickify on
    ``dev``: (geo, counts, cap, tv)."""
    from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud
    from linr_pcgc_tpu_torch.runtime import dev_codec as dc

    pyrs = [build_pyramid(synthetic_cloud(n_points, depth=depth, seed=seed, phase=0.08 * t),
                          device=dev) for t in range(n_frames)]
    s_num = pyrs[0].scale_num
    shapes = dc._LevelShapes(s_num, [p.low_coords for p in pyrs])
    for s in range(s_num):
        shapes.set_counts(s, [p.levels[s].n for p in pyrs])
    shapes.set_top_coords(s_num - 2, [p.levels[s_num - 2].coords[: p.levels[s_num - 2].n]
                                      for p in pyrs])
    bv, cap, tv = shapes.buckets(0)
    counts = shapes.n_vox[0]
    base = np.zeros((n_frames, bv, 3), np.int32)
    for i, p in enumerate(pyrs):
        base[i, : p.levels[0].n] = p.levels[0].coords[: p.levels[0].n]
    coords, keys = dc._init_level(torch.as_tensor(base, device=dev), counts, bv)
    return dc._brickify_level(coords, keys, counts, 0, cap, tv), counts, cap, tv


@pytest.mark.cuda
@pytest.mark.parametrize("n_points,depth,n_frames", [(6000, 7, 2), (40000, 9, 3)])
def test_rans_stage_tail_kernel_matches_plain(cuda, n_points, depth, n_frames):
    """K6's stage-tail entry against the plain stage tail over the 8 stages
    of one level (total not a multiple of 4096): states, cursors, bit rows,
    occupancy buffer and packed column bit for bit, the truth decoded, no
    host sync inside the kernel path, and the same bits from two runs."""
    from linr_pcgc_tpu_torch.runtime import dev_codec as dc

    geo, counts, cap, tv = _stage_level(cuda, n_points, depth, n_frames, 21)
    f, bv = geo["vox_brick"].shape
    total = sum(counts)
    assert total % tr.LANES
    rng = np.random.default_rng(n_points)
    pr = np.where(rng.uniform(size=(8, tv)) < 0.7, 0.02, rng.uniform(size=(8, tv)))
    pr = torch.as_tensor(pr.astype(np.float16)).to(cuda)
    truth = (torch.as_tensor(rng.uniform(size=(8, tv)), device=cuda) < pr.float())
    truth = (truth & (torch.arange(tv, device=cuda) < total)).to(torch.uint8)
    states, emissions = tr.rans_initial_states(cuda), []
    for stage in reversed(range(8)):
        states, byts, mask = tr.rans_encode_segment(states, pr[stage], truth[stage], total)
        emissions.append((byts, mask))
    stream, offs, lens = _rans_stream(emissions[::-1])
    plan = dc._stage_plan(geo["vox_fr"], geo["vox_j"], total, geo["vox_brick"], geo["vox_slot"],
                          cap)
    maps = (geo["vox_fr"], geo["vox_j"], total)
    runs = []
    for tail in ("plain", "kernel", "kernel"):
        st, cur = states, offs
        acc = torch.zeros((8, tv), dtype=torch.uint8, device=cuda)
        occ = torch.zeros((f * cap, 8, 64), dtype=torch.uint8, device=cuda)
        out = []
        for stage in range(8):
            args = (st, cur, stream, pr[stage], *maps, acc, occ, stage, geo["vox_brick"],
                    geo["vox_slot"])
            if tail == "plain":
                st, cur, occ, packed, acc = dc._rans_dec_stage_scatter_plain(*args)
            else:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    st, cur, occ, packed, acc = dc._rans_dec_stage_scatter(*args, plan)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            out.append((st.clone(), cur.clone(), packed, acc.clone(), occ.clone()))
        runs.append(out)
        torch.cuda.synchronize()
        assert torch.equal(acc, truth) and torch.equal(cur, offs + lens)
    for a, b, c in zip(*runs):
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y) and torch.equal(y, z)


@pytest.mark.cuda
def test_rans_kernels_on_garbage(cuda):
    """K5 from random states over extreme probabilities (0, 1, subnormal,
    0.5) and K6 on random bytes read through unaligned views, with cursors
    past their ends, in both valid forms: the plain versions' bytes,
    states, bits and cursors."""
    rng = np.random.default_rng(41)
    n = 6 * tr.LANES
    p = rng.choice(np.asarray([0.0, 1.0, 2.0**-24, 0.5, 0.999, 0.02], np.float16), n)
    p = torch.as_tensor(p).to(cuda)
    b = torch.as_tensor(rng.integers(0, 2, n).astype(np.uint8)).to(cuda)
    v = torch.arange(n, device=cuda) < n - 999
    states = torch.as_tensor(rng.integers(1 << 23, 1 << 31, tr.LANES)).to(cuda)
    for valid in (v, n - 999):
        got = tr.rans_encode_segment(states, p, b, valid)
        want = tr.rans_encode_segment_plain(states, p, b, valid)
        for a, c in zip(got, want):
            assert torch.equal(a, c)
    raw = torch.as_tensor(rng.integers(0, 256, 4099).astype(np.uint8)).to(cuda)
    cur = torch.as_tensor(rng.integers(0, 4200, tr.LANES)).to(cuda)
    for stream in (raw[3:], raw[1:18], raw[:1]):  # unaligned, short, one byte
        for valid in (v, n - 999):
            got = tr.rans_decode_segment(states, cur, stream, p, valid)
            want = tr.rans_decode_segment_plain(states, cur, stream, p, valid)
            for a, c in zip(got, want):
                assert torch.equal(a, c)


@pytest.mark.cuda
def test_rans_stage_wrapper_rejects_bad_inputs(cuda):
    tv = 2 * tr.LANES
    st = tr.rans_initial_states(cuda)
    cur = torch.zeros(tr.LANES, dtype=torch.int64, device=cuda)
    stream = torch.zeros(64, dtype=torch.uint8, device=cuda)
    p = torch.full((tv,), 0.5, dtype=torch.float16, device=cuda)
    bits = torch.empty(tv, dtype=torch.uint8, device=cuda)
    occ = torch.zeros((4, 8, 64), dtype=torch.uint8, device=cuda)
    dst = torch.full((tv,), -1, dtype=torch.int32, device=cuda)
    offs = torch.tensor([0, 5, 9], dtype=torch.int32, device=cuda)
    packed = torch.empty((2, 8), dtype=torch.uint8, device=cuda)
    good = (st, cur, stream, p, 9, bits, occ, 3, dst, offs, packed)
    tr.rans_decode_stage(*good)
    bad = {1: torch.zeros(tr.LANES, dtype=torch.int32, device=cuda),  # int32 cursors
           3: p.float(),                                              # float32 probabilities
           4: torch.arange(tv, device=cuda) < 9,                      # a mask, not a count
           5: bits[:-1],                                              # short bit row
           6: torch.zeros((4, 4, 64), dtype=torch.uint8, device=cuda),
           7: 8,                                                      # no column 8
           8: dst.long(),
           9: offs.long(),
           10: packed[:1]}
    for k, arg in bad.items():
        with pytest.raises((TypeError, ValueError)):
            tr.rans_decode_stage(*(arg if i == k else a for i, a in enumerate(good)))
    with pytest.raises(ValueError):  # an int32 stream
        tr.rans_decode_stage(st, cur, stream.int(), *good[3:])
    with pytest.raises(ValueError):  # not contiguous
        tr.rans_decode_segment(st, cur, stream, p.repeat(2)[::2], tv)


@pytest.mark.cuda
def test_probe_kernels_match_plain(cuda):
    """K7 and K9 bit for bit; K8 to the JAX probe's tolerance (rtol 2e-5,
    atol 2e-4: f32 sums in another order over K = 512), and the same bits
    in two runs."""
    rng = np.random.default_rng(50)
    x = torch.as_tensor(rng.standard_normal(1001).astype(np.float32) * 1e3).to(cuda)
    assert torch.equal(probes.probe_scale_shift(x), probes.probe_scale_shift_plain(x))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for m, k, n in ((512, 512, 512), (100, 70, 130)):
            a = torch.as_tensor(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
            b = torch.as_tensor(rng.standard_normal((k, n)).astype(np.float32)).to(cuda)
            c = probes.probe_matmul(a, b)
            torch.testing.assert_close(c, probes.probe_matmul_plain(a, b), rtol=2e-5, atol=2e-4)
            assert torch.equal(c, probes.probe_matmul(a, b))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for rows, d, nb in ((512, 256, 512), (37, 4, 100), (9, 8192, 20)):
        t = torch.as_tensor(rng.standard_normal((rows, d)).astype(np.float32)).to(cuda)
        idx = torch.as_tensor(rng.integers(0, rows, nb, dtype=np.int32)).to(cuda)
        assert torch.equal(probes.probe_row_gather(t, idx), probes.probe_row_gather_plain(t, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(512, 512, 512), (100, 70, 130), (96, 100, 64), (65, 8, 33),
                                   (1, 33, 1)])
def test_probe_matmul_3xtf32(cuda, m, k, n):
    """K8 on inputs scaled by 1e3 (products by 1e6) at 512^3, ragged m, k
    and n (k = 100 and 70: no multiple of the 32-deep chunk; k = 70 and n =
    130, 33, 1 take the 4-byte copies): within the JAX probe's tolerance
    scaled to the products (rtol 2e-5, atol 2e-4 * 1e6) of its plain
    version with TF32 off, the same bits from two launches, one launch a
    call."""
    rng = np.random.default_rng(m + k + n)
    a = torch.as_tensor(rng.standard_normal((m, k)).astype(np.float32) * 1e3).to(cuda)
    b = torch.as_tensor(rng.standard_normal((k, n)).astype(np.float32) * 1e3).to(cuda)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        launched = probes.probe_matmul.launches
        c = probes.probe_matmul(a, b)
        c2 = probes.probe_matmul(a, b)
        want = probes.probe_matmul_plain(a, b)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert probes.probe_matmul.launches == launched + 2
    assert torch.equal(c, c2)
    torch.testing.assert_close(c, want, rtol=2e-5, atol=2e-4 * 1e6)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,nb", [(512, 256, 1), (512, 256, 17), (300, 256, 1001),
                                       (4096, 4, 5000), (40, 8192, 77), (65536, 256, 65536)])
def test_row_gather_ring(cuda, rows, d, nb):
    """K9 bit for bit at row counts that are no multiple of the ring depth
    nor of the lanes (3 slots a lane at 1 KB rows, 4 at 16-byte rows, one
    lane of 2 at 32 KB rows), one row, and 65,536 rows (about 250 a block);
    one kernel launch per call."""
    rng = np.random.default_rng(rows + nb)
    t = torch.as_tensor(rng.standard_normal((rows, d)).astype(np.float32)).to(cuda)
    idx = torch.as_tensor(rng.integers(0, rows, nb, dtype=np.int32)).to(cuda)
    launched = probes.probe_row_gather.launches
    assert torch.equal(probes.probe_row_gather(t, idx), probes.probe_row_gather_plain(t, idx))
    assert probes.probe_row_gather.launches == launched + 1


@pytest.mark.cuda
def test_row_gather_launches_back_to_back(cuda):
    """K9's bare launches (the timing path of prof_probes) queue without a
    sync; the device's flag collects an out-of-range index of any of them
    and reads back clear afterwards."""
    table = torch.arange(64 * 256, dtype=torch.float32, device=cuda).view(64, 256)
    good = torch.tensor([5, 63, 0, 5], dtype=torch.int32, device=cuda)
    out = torch.empty((4, 256), device=cuda)
    assert probes.row_gather_flag(cuda) == 0
    for _ in range(3):
        probes.launch_row_gather(table, good, out)
    assert probes.row_gather_flag(cuda) == 0
    assert torch.equal(out, table[good.long()])
    probes.launch_row_gather(table, good + 1, out)  # 64 is out of range
    probes.launch_row_gather(table, good, out)
    assert probes.row_gather_flag(cuda) == 1
    assert probes.row_gather_flag(cuda) == 0
    assert torch.equal(probes.probe_row_gather(table, good), table[good.long()])


@pytest.mark.cuda
def test_probe_and_rans_wrappers_reject_bad_inputs(cuda):
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte units"):  # 255 * 4 bytes per row
        probes.probe_row_gather(torch.zeros((8, 255), device=cuda), idx)
    with pytest.raises(ValueError, match="aligned"):
        probes.probe_row_gather(torch.zeros(8 * 256 + 1, device=cuda)[1:].view(8, 256), idx)
    table = torch.arange(8 * 256, dtype=torch.float32, device=cuda).view(8, 256)
    for bad in (8, -1):
        with pytest.raises(IndexError):
            probes.probe_row_gather(table, idx + bad)
    # the kernel found them itself and left no sticky error: the next call works
    good = torch.tensor([7, 0, 3], dtype=torch.int32, device=cuda)
    assert torch.equal(probes.probe_row_gather(table, good), table[good.long()])
    torch.cuda.synchronize()
    with pytest.raises(TypeError):
        probes.probe_matmul(torch.zeros((4, 4), device=cuda, dtype=torch.float64),
                            torch.zeros((4, 4), device=cuda, dtype=torch.float64))
    (p, b, v), = _rans_segments(60, [1], cuda)
    st = tr.rans_initial_states(cuda)
    with pytest.raises(TypeError):  # bfloat16 probabilities
        tr.rans_encode_segment(st, p.to(torch.bfloat16), b, v)
    with pytest.raises(ValueError):  # not contiguous
        tr.rans_encode_segment(st, p.repeat(2)[::2], b, v)
    with pytest.raises(ValueError):  # int32 states
        tr.rans_decode_segment(st.int(), st, torch.zeros(4, dtype=torch.uint8, device=cuda), p, v)


# ---------------------------------------------------------------- K10 --


def _gather_map(cuda, n_points, depth, kernel_size, dilation, seed=80):
    """Level 0 of a synthetic cloud on the card (its bucket's pad rows have
    every tap absent) and its (k^3, N) neighbour map at ``dilation``."""
    from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud
    from linr_pcgc_tpu_torch.data.dataset import level_arrays_from_coords

    lev = build_pyramid(synthetic_cloud(n_points, depth=depth, seed=seed), device=cuda).levels[0]
    nbr = level_arrays_from_coords(lev.coords, lev.n, kernel_size, (dilation,), cuda)[3]
    return nbr.T.contiguous()


def _check_k10(idx, cin, cout, seed, bias=True):
    """K10 forward (and, with bias=False, as dx is called) against its plain
    version within 1e-5 of the L1 scale (the same products summed in
    another order), the same bits from a second launch, one launch a call."""
    k, n = idx.shape
    x = _rand((n, cin), seed).to(idx.device)
    w = _rand((k, cin, cout), seed + 1, (cin * k) ** -0.5).to(idx.device)
    b = _rand((cout,), seed + 2).to(idx.device) if bias else None
    launched = gc.gather_conv.launches
    y = gc.gather_conv(x, idx, w, b)
    assert gc.gather_conv.launches == launched + 1
    y_again = gc.gather_conv(x, idx, w, b)
    torch.cuda.synchronize()
    assert torch.equal(y, y_again)
    want = gc.gather_conv_plain(x, idx, w, b)
    scale = gc.gather_conv_plain(x.abs(), idx, w.abs(), None if b is None else b.abs())
    assert bool(torch.isfinite(y).all())
    assert bool(((y - want).abs() <= 1e-5 * scale + 1e-6).all()), (y - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,cin,cout,dx", [
    (3, 1, 8, 8, True), (3, 1, 8, 4, True), (3, 1, 4, 4, True), (3, 2, 8, 8, True),
    (5, 1, 8, 8, True), (5, 1, 4, 4, True), (3, 1, 7, 8, False), (3, 1, 6, 8, False),
    (3, 1, 2, 8, False), (3, 1, 1, 8, False), (5, 1, 16, 16, True), (5, 1, 16, 8, True)])
def test_gather_conv_kernel_matches_plain(cuda, k, d, cin, cout, dx):
    """K10 at the CPU tests' shapes (K 27 and 125, a dilation-2 map, the
    context blocks' conv_in at Cin 1-7, the dx form without bias where the
    network takes it, K 125 at Cin 16, where a block's shared memory
    takes the smaller node tile) on a small level 0."""
    idx = _gather_map(cuda, 6000, 7, k, d)
    assert bool((idx[:, -1] < 0).all())
    _check_k10(idx, cin, cout, 81)
    if dx:
        _check_k10(idx, cout, cin, 84, bias=False)


def _sub_map(idx, n):
    """The first n nodes of a map, taps to nodes past n made absent."""
    sub = idx[:, :n].clone()
    sub[sub >= n] = -1
    return sub.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 50, 300, 4001])
@pytest.mark.parametrize("k,cin,cout", [(3, 8, 8), (3, 3, 8), (5, 16, 16)])
def test_gather_conv_kernel_ragged_tiles(cuda, n, k, cin, cout):
    """K10 where the last node tile is not full (N not a multiple of 128 or
    256, one row, fewer rows than one tile), its index copies at any N,
    forward and dx."""
    idx = _sub_map(_gather_map(cuda, 6000, 7, k, 1), n)
    _check_k10(idx, cin, cout, 180 + n % 7)
    _check_k10(idx, cout, cin, 190 + n % 7, bias=False)


@pytest.mark.cuda
@pytest.mark.parametrize("k,cin,cout", [(3, 16, 16), (3, 8, 16), (3, 16, 8), (3, 7, 16),
                                        (3, 6, 6), (3, 4, 2), (3, 12, 6), (5, 16, 16)])
def test_gather_conv_kernel_other_widths(cuda, k, cin, cout):
    """K10 at output widths other than 4 and 8 (hidden_channel_conv 16's
    16 and 8, and 6, 2; chunks of 8 or 4 outputs, the last one masked),
    forward and dx."""
    idx = _gather_map(cuda, 6000, 7, k, 1)
    _check_k10(idx, cin, cout, 60 + cin + cout)
    _check_k10(idx, cout, cin, 70 + cin + cout, bias=False)


@pytest.mark.cuda
def test_gather_conv_kernel_at_a_level0_size(cuda):
    """K10 at a level 0 of ~0.3 M voxels, K 27 and 125."""
    for k in (3, 5):
        idx = _gather_map(cuda, 400_000, 9, k, 1)
        _check_k10(idx, 8, 8, 90 + k)


@pytest.mark.cuda
def test_gather_conv_grads_on_card_match_cpu(cuda):
    """gather_conv3's forward and gradients on the card (K10 forward and dx,
    dw by gather + matmul) against the CPU's plain path."""
    idx = _gather_map(cuda, 6000, 7, 3, 1)
    n = idx.shape[1]
    out = []
    for dev in (cuda, torch.device("cpu")):
        x = _rand((n, 8), 95).to(dev).requires_grad_()
        w = _rand((27, 8, 4), 96, 0.1).to(dev).requires_grad_()
        b = _rand((4,), 97).to(dev).requires_grad_()
        y = gc.gather_conv3(x, idx.to(dev), w, b)
        y.backward(_rand((n, 4), 98).to(dev))
        out.append([t.detach().cpu() for t in (y, x.grad, w.grad, b.grad)])
    for got, want in zip(*out):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_gather_conv_wrapper_rejects_bad_inputs(cuda):

    x = torch.zeros((10, 8), device=cuda)
    idx = torch.full((27, 10), -1, dtype=torch.int32, device=cuda)
    w = torch.zeros((27, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="one device"):  # a CPU map
        gc.gather_conv(x, idx.cpu(), w)
    with pytest.raises(TypeError):  # int64 map
        gc.gather_conv(x, idx.long(), w)
    with pytest.raises(TypeError):  # bf16 activations
        gc.gather_conv(x.bfloat16(), idx, w)
    with pytest.raises(ValueError):  # not contiguous
        gc.gather_conv(torch.zeros((10, 16), device=cuda)[:, ::2], idx, w)
    with pytest.raises(ValueError, match="shared memory"):  # a chunk's weights past a block's
        gc.gather_conv(torch.zeros((10, 300), device=cuda), idx, torch.zeros((27, 300, 8),
                                                                             device=cuda))
    with pytest.raises(ValueError):  # the map's K disagrees with w's
        gc.gather_conv(x, idx[:8].contiguous(), w)


@pytest.mark.cuda
def test_gather_codec_roundtrip_on_card(cuda, tmp_path):
    """A small GOP at outstage 4 encodes and decodes losslessly on the
    card through K10, with the gather numerics and the CUDA backend tag."""
    import json

    from linr_pcgc_tpu_torch.data import PyramidDataset, synthetic_cloud
    from linr_pcgc_tpu_torch.models import ModelConfig, init_params
    from linr_pcgc_tpu_torch.runtime import decode_gop, encode_gop, save_checkpoint

    frames = [synthetic_cloud(6000, depth=7, seed=s) for s in range(2)]
    ds = PyramidDataset(frames, device=cuda)
    cfg = ModelConfig(scale_num=ds[0].scale_num, outstage=4)
    save_checkpoint(str(tmp_path / "m.npz"), init_params(1, cfg), None, 0.01, 0, 0.0, 8)
    before = gc.gather_conv.launches
    encode_gop(str(tmp_path / "m.npz"), [ds[0], ds[1]], str(tmp_path / "enc"), cfg)
    out = decode_gop(str(tmp_path / "enc"), None, ground_truth=ds.raw_sorted_points)
    assert [len(o) for o in out] == [len(np.unique(f, axis=0)) for f in frames]
    assert gc.gather_conv.launches > before
    with open(tmp_path / "enc" / "side_info.json") as f:
        num = json.load(f)["numerics"]
    assert num["conv_kernel"] == "gather" and num["backend"].startswith("torch-cuda-sm")


# ---------------------------------------------------------------- K11 --


def _check_k11(launch, plain, args, dtype):
    """K11 against its plain version: f32 within 1e-5 of the L1 scale (the
    same products summed in another order), bf16 within one bf16 ulp of
    the plain result plus 1e-5 of the scale; the same bits from a second
    launch; one launch a call."""
    from linr_pcgc_tpu_torch.ops import counters

    before = counters.launches()["K11"]
    dw = launch(*args)
    assert counters.launches()["K11"] == before + 1
    dw_again = launch(*args)
    want = plain(*args)
    scale = plain(*[a.float().abs() if a is not None and a.is_floating_point() else a
                    for a in args])
    torch.cuda.synchronize()
    assert dw.dtype == want.dtype == dtype and torch.equal(dw, dw_again)
    tol = 1e-5 * scale.float() + 1e-6
    if dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0**-126))) - 7)
    err = (dw.float() - want.float()).abs()
    assert bool(torch.isfinite(dw).all()) and bool((err <= tol).all()), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bb,s,c,o", [(3000, 5, 8, 4), (3000, 5, 4, 4), (3000, 4, 8, 24),
                                      (3000, 4, 24, 1), (3000, 4, 24, 2), (777, 1, 15, 16),
                                      (777, 1, 16, 8), (1, 3, 8, 8), (5000, 9, 7, 5),
                                      (1, 4, 8, 24), (5, 4, 8, 24), (300, 17, 8, 4),
                                      (200, 2, 40, 36), (700, 6, 12, 8), (3000, 1, 8, 4),
                                      (3000, 1, 4, 4), (3000, 1, 8, 24), (3000, 1, 24, 1)])
def test_wgrad_sb_kernel_matches_plain(cuda, dtype, bb, s, c, o):
    """K11's superbrick form at the 1^3 convs' widths (the inception
    branch, the inner MLP, its heads, the scale MLP) and others: ragged
    block ranges and tiles, one brick, a ring shorter than its slot count
    (1 and 5 bricks), S 9 and 17 (stage groups), output groups past 32
    channels, and S 1 at every width (the bricks trainer's stage batch)."""
    x = _rand((bb, s, 64 * c), 110 + c).to(cuda, dtype)
    dy = _rand((bb, s, 64 * o), 111 + o).to(cuda, dtype)
    _check_k11(lambda x_, dy_: wgrad.wgrad_sb(x_, dy_, c, o),
               lambda x_, dy_: wgrad.wgrad_sb_plain(x_, dy_, c, o), (x, dy), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["x", "dy", "both"])
def test_wgrad_sb_kernel_reads_stage_major_views(cuda, dtype, layout):
    """K11's ring form reads a (Bb, S, 64*C) tensor laid out stage-major (a
    permuted view, as sbconv1's einsum leaves its output) as it is, with the
    same bits as from a contiguous copy, at S 4 and S 17 (stage groups)."""
    for bb, s, c, o in ((3000, 4, 24, 1), (700, 17, 8, 8)):
        x = _rand((s, bb, 64 * c), 150 + s).to(cuda, dtype).transpose(0, 1)
        dy = _rand((s, bb, 64 * o), 151 + s).to(cuda, dtype).transpose(0, 1)
        x = x if layout in ("x", "both") else x.contiguous()
        dy = dy if layout in ("dy", "both") else dy.contiguous()
        _check_k11(lambda x_, dy_: wgrad.wgrad_sb(x_, dy_, c, o),
                   lambda x_, dy_: wgrad.wgrad_sb_plain(x_, dy_, c, o), (x, dy), dtype)
        assert torch.equal(wgrad.wgrad_sb(x, dy, c, o),
                           wgrad.wgrad_sb(x.contiguous(), dy.contiguous(), c, o))


@pytest.mark.cuda
@pytest.mark.parametrize("k,cin,cout", [(1, 8, 8), (1, 8, 24), (1, 24, 2), (1, 16, 8), (3, 8, 8),
                                        (3, 8, 4), (3, 4, 4), (3, 5, 8), (3, 16, 16), (5, 8, 8),
                                        (5, 16, 16), (1, 40, 3), (3, 20, 20), (3, 7, 16)])
def test_wgrad_gather_kernel_matches_plain(cuda, k, cin, cout):
    """K11's gather form: the 1^3 conv (no map: the ring form at S = 1,
    its last brick ragged) and the k^3 conv's dw through a level-0
    neighbour map (absent taps, pad rows), K 1, 27, 125 (at Cin 16: four
    tap groups), output groups past 16 and 32 channels."""
    idx = _gather_map(cuda, 6000, 7, k, 1) if k > 1 else None
    n = 5000 if idx is None else idx.shape[1]
    x = _rand((n, cin), 120 + cin).to(cuda)
    dy = _rand((n, cout), 121 + cout).to(cuda)
    _check_k11(wgrad.wgrad_gather, wgrad.wgrad_gather_plain, (x, dy, idx), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 50, 130, 4001])
@pytest.mark.parametrize("k,cin,cout", [(1, 8, 24), (3, 8, 8), (3, 3, 16)])
def test_wgrad_gather_kernel_ragged_tiles(cuda, n, k, cin, cout):
    """K11's gather form where a node tile is not full: one row, fewer rows
    than one tile (and than one brick at K 1), N not a multiple of 4 (the
    index rows in 4-byte copies)."""
    idx = _sub_map(_gather_map(cuda, 6000, 7, k, 1), n) if k > 1 else None
    x = _rand((n, cin), 200 + n % 11).to(cuda)
    dy = _rand((n, cout), 201 + n % 11).to(cuda)
    _check_k11(wgrad.wgrad_gather, wgrad.wgrad_gather_plain, (x, dy, idx), torch.float32)


@pytest.mark.cuda
def test_k10_k11_two_launches_same_bits(cuda):
    """Every form of K10 and K11 gives the same bits from two launches at a
    level-0 size: K11's ring form (bf16 on the tensor cores, f32, the 1^3
    conv with a ragged last brick), its gather form, K10's float4 and
    runtime-Cin forms."""
    idx = _gather_map(cuda, 400_000, 9, 3, 1)
    n = idx.shape[1]
    runs = []
    for dtype in (torch.bfloat16, torch.float32):
        x = _rand((20_000, 4, 64 * 8), 210).to(cuda, dtype)
        dy = _rand((20_000, 4, 64 * 24), 211).to(cuda, dtype)
        runs.append(lambda x=x, dy=dy: wgrad.wgrad_sb(x, dy, 8, 24))
    xg, dyg = _rand((n, 8), 212).to(cuda), _rand((n, 8), 213).to(cuda)
    runs.append(lambda: wgrad.wgrad_gather(xg[:-3].contiguous(), dyg[:-3].contiguous()))
    runs.append(lambda: wgrad.wgrad_gather(xg, dyg, idx))
    w8, w3 = _rand((27, 8, 8), 214, 0.1).to(cuda), _rand((27, 3, 8), 215, 0.1).to(cuda)
    runs.append(lambda: gc.gather_conv(xg, idx, w8, dyg[0]))
    runs.append(lambda: gc.gather_conv(xg[:, :3].contiguous(), idx, w3, None))
    for run in runs:
        first, second = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_wgrad_kernels_at_level0_sizes(cuda):
    """K11 at the trainers' level-0 sizes: the superbrick form at 81,920
    bricks, S 5, bf16; the gather form at ~0.3 M voxels, K 27."""
    x = _rand((81_920, 5, 64 * 8), 130).to(cuda, torch.bfloat16)
    dy = _rand((81_920, 5, 64 * 4), 131).to(cuda, torch.bfloat16)
    _check_k11(lambda x_, dy_: wgrad.wgrad_sb(x_, dy_, 8, 4),
               lambda x_, dy_: wgrad.wgrad_sb_plain(x_, dy_, 8, 4), (x, dy), torch.bfloat16)
    del x, dy
    idx = _gather_map(cuda, 400_000, 9, 3, 1)
    n = idx.shape[1]
    _check_k11(wgrad.wgrad_gather, wgrad.wgrad_gather_plain,
               (_rand((n, 8), 132).to(cuda), _rand((n, 8), 133).to(cuda), idx), torch.float32)


@pytest.mark.cuda
def test_conv1_products_on_card_match_cpu(cuda):
    """sbconv1 (bf16) and the gather _conv1 (f32) on the card, dw by K11:
    forward, dx and dw against the CPU's plain path."""
    from linr_pcgc_tpu_torch.models import network as tnet, sb_network as tsbn

    out = []
    for dev in (cuda, torch.device("cpu")):
        x = _rand((500, 2, 64 * 8), 140).to(dev).requires_grad_()
        w = _rand((2, 8, 4), 141, 0.3).to(dev).requires_grad_()
        b = _rand((2, 4), 142).to(dev)
        mask = (_rand((500, 64), 143) > 0).to(dev)
        geom = dict(mask=mask[:, None, None, :].to(torch.bfloat16), dtype=torch.bfloat16)
        y = tsbn.sbconv1(x, geom, w, b)
        y.backward(_rand((500, 2, 64 * 4), 144).to(dev, torch.bfloat16))
        xg = _rand((3000, 8), 145).to(dev).requires_grad_()
        wg = _rand((8, 24), 146, 0.3).to(dev).requires_grad_()
        yg = tnet._conv1(xg, {"w": wg, "b": torch.zeros(24, device=dev)})
        yg.backward(_rand((3000, 24), 147).to(dev))
        out.append([t.detach().float().cpu() for t in (y, x.grad, w.grad, yg, xg.grad, wg.grad)])
    for got, want in zip(*out):
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_side8_sbconv3_on_card_matches_cpu(cuda):
    """sbconv3 on JAX's 8^3 superbricks (Bb, S, C, 512), f32: the
    sub-brick map, K2 -> K1 forward, K2, K3, K4 backward on the card,
    against the CPU's plain path; forward and dx, dw, db to 1e-4."""
    from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud
    from linr_pcgc_tpu_torch.models import sb_network as tsbn

    pyr = build_pyramid(synthetic_cloud(3000, depth=7, seed=8), device="cpu")
    lev = pyr.levels[0]
    sbl = sb.build_superbrick_level(lev.coords[: lev.n], lev.occ[: lev.n],
                                    lev.feat_code[: lev.n], 0, side=8)
    mask = torch.as_tensor((sbl.scale_code >= 0).astype(np.float32))
    bb, s, c, o = sbl.n_bricks, 2, 8, 8
    x = _rand((bb, s, c, 512), 90) * mask[:, None, None]
    w, b, dy = _rand((s, 27, c, o), 91, 0.1), _rand((s, o), 92), _rand((bb, s, o, 512), 93)
    launched = (plane_conv.plane_matmul_bm.launches, plane_conv.plane_matmul.launches)
    out = []
    for dev in ("cpu", cuda):
        geom = dict(nbr27=torch.as_tensor(sbl.nbr27).to(dev), mask=mask[:, None, None].to(dev),
                    code=torch.as_tensor(sbl.scale_code).to(dev), dtype=torch.float32)
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, w, b)]
        y = tsbn.sbconv3(*leaves[:1], geom, *leaves[1:])
        y.backward(dy.to(dev))
        out.append([y.detach().cpu()] + [t.grad.cpu() for t in leaves])
    assert (plane_conv.plane_matmul_bm.launches, plane_conv.plane_matmul.launches) > launched
    for got, want in zip(out[1], out[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("side", [4, 8])
def test_sb_codec_on_card_round_trips(cuda, side):
    """encode_gop_streams_sb -> decode_gop_streams_sb of a small 2-frame
    GOP on the card: lossless, through K1 and K2, and every stage's
    probabilities on the decoder's side equal the encoder's bit for bit."""
    from linr_pcgc_tpu_torch.data import PyramidDataset, synthetic_cloud
    from linr_pcgc_tpu_torch.models import ModelConfig, init_params, param_tree
    from linr_pcgc_tpu_torch.runtime import codec, sb_codec

    frames = [synthetic_cloud(3000, depth=7, seed=s) for s in range(2)]
    ds = PyramidDataset(frames, device="cpu")
    pyrs = [ds[0], ds[1]]
    cfg = ModelConfig(scale_num=ds.scale_num)
    params = param_tree(init_params(3, cfg, cuda))
    real, seen = sb_codec.sb_codec_stage_probs, []

    def keep(*args, **kwargs):
        pr = real(*args, **kwargs)
        seen.append(pr.cpu())
        return pr

    launched = (plane_conv.plane_matmul_bm.launches, sb.b4_halo_sm.launches)
    sb_codec.sb_codec_stage_probs = keep
    try:
        blobs, bits = codec.encode_gop_streams_sb(params, cfg, pyrs, cuda, side=side)
        n_enc = len(seen)
        dec = codec.decode_gop_streams_sb(params, cfg, blobs, [p.low_coords for p in pyrs],
                                          cuda, side=side)
    finally:
        sb_codec.sb_codec_stage_probs = real
    assert (plane_conv.plane_matmul_bm.launches, sb.b4_halo_sm.launches) > launched
    for d, p, pts in zip(dec, pyrs, frames):
        np.testing.assert_array_equal(d + p.coord_min, np.unique(pts, axis=0))
    # the encoder takes the levels fine to coarse, the decoder coarse to
    # fine; each takes a level's stages in order
    enc, dec_pr = seen[:n_enc], seen[n_enc:]
    s_num, st = ds.scale_num, cfg.outstage
    enc_by = {(s, k): enc[s * st + k] for s in range(s_num) for k in range(st)}
    dec_by = {(s_num - 1 - i, k): dec_pr[i * st + k] for i in range(s_num) for k in range(st)}
    for key in enc_by:
        assert torch.equal(enc_by[key], dec_by[key]), key
    assert bits > 0


# ------------------------------- launch plans and tables, on the CPU --


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


def test_halo_source_table_reproduces_plain_halo():
    """The kernel's (column -> direction, slot) table, applied as a plain
    gather, gives the plain halo: the layout the kernel reads is the plain
    version's by construction."""
    bb, s, c = 40, 3, 2
    x = torch.as_tensor(_rand((bb, s, 64 * c), 6))
    nbr = torch.as_tensor(_geometric_nbr(bb, 4, 7))
    tab = torch.as_tensor(sb.halo_source_table().astype(np.int64))
    d, v = tab // 64, tab % 64  # (216,)
    src = torch.where(d[None] == sb._DIR_CENTER, torch.arange(bb)[:, None], nbr.long()[:, d])
    xv = x.reshape(bb, s, 64, c)
    got = xv[src.clamp(min=0)[:, None, :], torch.arange(s)[None, :, None], v[None, None, :]]
    got = torch.where((src >= 0)[:, None, :, None], got, torch.zeros(()))
    np.testing.assert_array_equal(got.reshape(bb, s, -1).numpy(),
                                  sb.b4_halo_sm_plain(x, nbr).numpy())


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
    tab = sb.halo_source_table().astype(np.int64)
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
        src = np.where(d[None] == sb._DIR_CENTER, b0 + i[:, None], nbr[b0 + i][:, d])
        dst = ((b0 * s + r)[:, None] * ru + u[None]).ravel()
        srcu = ((src * s + st[:, None]) * (64 * upc) + off[None]).ravel()
        np.add.at(hits, dst, 1)
        out[dst] = np.where((src >= 0).ravel()[:, None], xu[np.maximum(srcu, 0)], 0)
    return out.reshape(bb, s, 216 * c * x.element_size()), hits


def _assert_emulation_exact(x, nbr, plan):
    got, hits = _halo_kernel_emulation(x, nbr, plan)
    assert (hits == 1).all()
    want = sb.b4_halo_sm_plain(x, nbr).contiguous().view(torch.uint8).numpy()
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
    plan = sb.halo_plan(bb, s, c, esz)
    assert plan == sb.halo_plan(bb, s, c, esz)
    assert plan.unit_bytes == max(u for u in (2, 4, 8, 16) if (c * esz) % u == 0)
    assert plan.unit_cols * plan.unit_bytes == c * esz
    assert plan.threads % 32 == 0 and plan.threads <= sb.HALO_MAX_THREADS
    passes = -(-216 * plan.unit_cols // plan.threads)
    assert plan.threads * (passes - 1) < 216 * plan.unit_cols <= plan.threads * passes
    assert plan.bricks * (plan.blocks - 1) < bb <= plan.bricks * plan.blocks
    level0 = sb.halo_plan(163_840, s, c, esz)
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
    assert [sb.halo_plan(5, 2, 8, 2, align=a).unit_bytes for a in (16, 8, 4, 2)] == [16, 8, 4, 2]
    assert [sb.halo_plan(5, 2, 12, 4, align=a).unit_bytes for a in (16, 8, 4)] == [16, 8, 4]
    x = torch.as_tensor(_rand((30, 2, 512), 42)).to(torch.bfloat16)
    nbr = torch.as_tensor(_geometric_nbr(30, 4, 43))
    _assert_emulation_exact(x, nbr, sb.halo_plan(30, 2, 8, 2, align=2))


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
    np.testing.assert_array_equal(got.numpy(), sb.b4_halo_sm_plain(x, nbr).numpy())


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moment_plan_depends_on_shapes_only(dtype):
    """K4's partition (tile, ring, blocks, brick ranges) is a function of
    the shapes alone, so are dw's bits; a block's range is a whole number of
    staged tiles, never less than one; the ranges cover the bricks; and the
    plan fits one block of the kernel."""
    for bb, s, c, o in [(81_920, 5, 8, 8), (81_920, 4, 12, 8), (81_920, 5, 4, 4),
                        (27_264, 8, 8, 8), (10, 1, 4, 4), (1, 12, 8, 8), (333, 2, 5, 3),
                        (81_920, 4, 7, 8), (81_920, 1, 8, 8)]:
        p = plane_conv.moment_plan(bb, s, c, o, dtype)
        assert p == plane_conv.moment_plan(bb, s, c, o, dtype)
        assert p.tile_bricks >= 1 and p.per_block % p.tile_bricks == 0
        assert (p.blocks - 1) * p.per_block < bb <= p.blocks * p.per_block
        assert p.blocks <= plane_conv.MOMENT_SMS and 2 <= p.nst <= 4
        assert p.warps_per_stage * p.stages_per_launch <= plane_conv.MOMENT_MAX_WARPS
        assert p.stages_per_launch == min(s, plane_conv.MOMENT_MAX_WARPS)
        assert p.smem <= 232448 - 1024
        esz = 4 if dtype == torch.float32 else 2
        assert p.slot_bytes % 128 == 0
        assert p.slot_bytes >= p.tile_bricks * s * (64 * c + 216 * o) * esz
        assert p.smem >= 3584 + p.nst * p.slot_bytes  # the ring after the tap table
        own = (c, o) in plane_conv.MOMENT_SHAPES
        assert p.path == (("tensor_cores" if dtype == torch.bfloat16 else "cuda_cores")
                          if own else "any_shape")
    big = plane_conv.moment_plan(81_920, 5, 8, 8, dtype)
    assert big.blocks == plane_conv.MOMENT_SMS  # the level-0 unit fills every SM
