"""K11's fixed-order sums, emulated on the CPU: the ring form's and the
gather form's block plans (csrc/wgrad.cu) walked in numpy/torch, each lane's
f32 FMAs and the warps' butterflies in the kernel's order, held to the
plain versions within f32 rounding.  No JAX: the plain versions are held
against the JAX package in tests/test_torch_wgrad.py.

Inputs come from numpy seeds over ``synthetic_cloud(1500, depth=6)``
frames."""

import numpy as np
import pytest
import torch

from linr_pcgc_tpu_torch.data import PyramidDataset, synthetic_cloud
from linr_pcgc_tpu_torch.data.dataset import level_arrays_from_coords
from linr_pcgc_tpu_torch.ops import wgrad
from linr_pcgc_tpu_torch.runtime import sb_overfit as tsbo


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
