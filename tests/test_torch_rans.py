"""The port's rANS against the JAX package: for the same f16 probabilities
the blob bytes are identical to the numpy reference coder and to the JAX
scan coder, and the decode returns the bits, states and lane cursors of the
numpy reference and of the JAX decoder.  On the CPU the wrappers run the
plain versions; the kernels (K5, K6) are held against those on the card in
tests/test_torch_kernels.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from linr_pcgc_tpu.ops import rans as jr
from linr_pcgc_tpu_torch.ops import rans as tr

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _segments(seed, seg_steps):
    """f16-valued probabilities (as the codec feeds them), bits drawn from
    them, and a ragged valid tail on every other segment."""
    rng = np.random.default_rng(seed)
    out = []
    for i, steps in enumerate(seg_steps):
        n = steps * tr.LANES
        p = rng.uniform(0.0, 1.0, n)
        p = np.where(rng.uniform(size=n) < 0.7, 0.03, p).astype(np.float16).astype(np.float32)
        v = np.arange(n) < (n - 1234 if i % 2 else n)
        b = np.where(v, rng.uniform(size=n) < p, 0).astype(np.uint8)
        out.append((p, b, v))
    return out


def _port_blob(segs):
    """Encode segments (decode order) with the port, the way the codec does:
    reverse order, emissions compacted per lane, lane-major payload."""
    states = tr.rans_initial_states(device="cpu")
    byts, masks = [], []
    for p, b, v in reversed(segs):
        states, by, m = tr.rans_encode_segment(states, torch.as_tensor(p), torch.as_tensor(b),
                                               torch.as_tensor(v))
        byts.append(by)
        masks.append(m)
    lens, out = tr.rans_compact_emissions(torch.cat(byts[::-1]), torch.cat(masks[::-1]), 64)
    lens, out = lens.numpy(), out.numpy()
    payload = np.concatenate([out[lane, : lens[lane]] for lane in range(tr.LANES)])
    return tr.pack_rans_blob_flat(states.numpy().astype(np.uint32), payload, lens)


def _jax_blob(segs):
    states = jr.rans_initial_states()
    byts, masks = [], []
    for p, b, v in reversed(segs):
        states, by, m = jr.rans_encode_segment(states, jnp.asarray(p), jnp.asarray(b),
                                               jnp.asarray(v))
        byts.append(by)
        masks.append(m)
    lens, out = jr.rans_compact_emissions(jnp.concatenate(byts[::-1]),
                                          jnp.concatenate(masks[::-1]), 64)
    lens, out = np.asarray(lens), np.asarray(out)
    payload = np.concatenate([out[lane, : lens[lane]] for lane in range(jr.LANES)])
    return jr.pack_rans_blob_flat(np.asarray(states), payload, lens)


@pytest.mark.parametrize("seed,steps", [(0, [3, 2]), (1, [1, 4, 1])])
def test_blob_bytes_equal_numpy_and_jax(seed, steps):
    segs = _segments(seed, steps)
    blob = _port_blob(segs)
    np_states, np_streams = jr.np_rans_encode(*zip(*segs))
    assert blob == jr.pack_rans_blob(np_states, np_streams)
    assert blob == _jax_blob(segs)
    assert tr.np_rans_encode(*zip(*segs))[1] == np_streams


def test_decode_returns_bits_and_reference_cursors():
    segs = _segments(2, [2, 3])
    blob = _port_blob(segs)
    states, flat, offs = tr.unpack_rans_blob(blob)
    x = torch.as_tensor(states.astype(np.int64))
    cur = torch.as_tensor(offs)
    stream = torch.as_tensor(flat)
    for p, b, v in segs:
        x, cur, bits = tr.rans_decode_segment(x, cur, stream, torch.as_tensor(p), torch.as_tensor(v))
        np.testing.assert_array_equal(bits.numpy(), b)
    # the numpy reference decoder's cursors, made absolute
    _, jstreams = jr.np_rans_encode(*zip(*segs))
    bits_np, final_np, cur_np = tr.np_rans_decode(states, jstreams, [s[0] for s in segs],
                                                  [s[2] for s in segs])
    np.testing.assert_array_equal(cur.numpy(), offs + cur_np)
    np.testing.assert_array_equal(cur_np, [len(s) for s in jstreams])
    np.testing.assert_array_equal(x.numpy().astype(np.uint32), final_np)
    for got, (_, b, _) in zip(bits_np, segs):
        np.testing.assert_array_equal(got, b)


def test_freq_and_blob_header_checks():
    p = torch.tensor([0.0, 1.0, 0.5, 3.0517578125e-05, 0.99998], dtype=torch.float16).float()
    v = torch.tensor([True, True, True, True, False])
    np.testing.assert_array_equal(
        tr.freq1_from_prob(p, v).numpy(),
        np.asarray(jr.freq1_from_prob(jnp.asarray(p.numpy()), jnp.asarray(v.numpy()))))
    blob = bytearray(_port_blob(_segments(3, [4])))
    head = 8 + 8 * tr.LANES
    assert len(blob) > head
    blob[head] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        tr.unpack_rans_blob(bytes(blob))
    blob[:4] = np.asarray([1024 | 0x80000000], np.uint32).tobytes()
    with pytest.raises(ValueError, match="lanes"):
        tr.unpack_rans_blob(bytes(blob))


def test_plain_decoder_equals_jax_decoder():
    """One blob decoded by JAX's rans_decode_segment (jitted, on the CPU)
    and by the port's plain decoder: bits, final states and cursors equal
    after every segment.  33 steps run JAX's windowed blocks, its leftover
    step pair and its odd tail."""
    segs = _segments(4, [33, 2])
    states, flat, offs = tr.unpack_rans_blob(_port_blob(segs))
    x, cur, stream = (torch.as_tensor(states.astype(np.int64)), torch.as_tensor(offs),
                      torch.as_tensor(flat))
    jx, jcur, jstream = jnp.asarray(states), jnp.asarray(offs.astype(np.int32)), jnp.asarray(flat)
    for p, b, v in segs:
        x, cur, bits = tr.rans_decode_segment_plain(x, cur, stream, torch.as_tensor(p),
                                                    torch.as_tensor(v))
        jx, jcur, jbits = jr.rans_decode_segment(jx, jcur, jstream, jnp.asarray(p), jnp.asarray(v))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        np.testing.assert_array_equal(bits.numpy(), b)
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx).astype(np.int64))
        np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur).astype(np.int64))


def test_wrappers_run_plain_on_cpu_and_raise_elsewhere():
    """On CPU tensors the wrappers are their plain versions; a tensor on
    another device (here ``meta``) raises instead of falling back."""
    (p, b, v), = _segments(5, [2])
    p, b, v = torch.as_tensor(p), torch.as_tensor(b), torch.as_tensor(v)
    st = tr.rans_initial_states(device="cpu")
    launched = (tr.rans_encode_segment.launches, tr.rans_decode_segment.launches)
    enc = tr.rans_encode_segment(st, p, b, v)
    for got, want in zip(enc, tr.rans_encode_segment_plain(st, p, b, v)):
        assert torch.equal(got, want)
    stream = torch.zeros(64, dtype=torch.uint8)
    cur = torch.zeros(tr.LANES, dtype=torch.int64)
    for got, want in zip(tr.rans_decode_segment(enc[0], cur, stream, p, v),
                         tr.rans_decode_segment_plain(enc[0], cur, stream, p, v)):
        assert torch.equal(got, want)
    assert (tr.rans_encode_segment.launches, tr.rans_decode_segment.launches) == launched
    meta = [t.to("meta") for t in (st, p, b, v)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tr.rans_encode_segment(*meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tr.rans_decode_segment(meta[0], cur.to("meta"), stream.to("meta"), meta[1], meta[3])
    with pytest.raises(ValueError, match="multiple of"):
        tr.rans_encode_segment_plain(st, p[:100], b[:100], v[:100])


def test_encoder_reciprocal_is_exact_for_every_frequency():
    """K5 divides by f through an exact reciprocal, rcp = ceil(2^(31+s) / f)
    with s = ceil(log2 f) and q = umulhi(x, rcp) >> (s - 1); f = 1 takes
    rcp 2^32 - 1, shift 0 and bias 2^16 - 1.  Numpy emulates the kernel's
    branch-free rcp (float estimate from an approximate 1 / f, one
    float-corrected step on the exact residual, two compare-and-fix steps)
    with 1 / f off by up to 3 ulp (the card's __fdividef is within 2):
    it is the exact ceiling for every f in [2, 2^16).  Then the new state
    equals (x // f << 16) + x % f for every f at x = k f - 1, k f (k spread
    over [1, 2^15]), f 2^15 - 1 and random x in [1, f 2^15)."""
    f = np.arange(1, 1 << 16, dtype=np.uint64)
    s = np.ceil(np.log2(f.astype(np.float64))).astype(np.uint64)
    assert all(int(v) == int(a - 1).bit_length() for a, v in zip(f[::97], s[::97]))
    want = ((np.uint64(1) << (np.uint64(31) + s)) + f - np.uint64(1)) // f
    g, sg = f[1:].astype(np.int64), s[1:].astype(np.int64)
    num = np.left_shift(np.int64(1), 31 + sg)
    scale = np.ldexp(np.float32(1), 31 + sg).astype(np.float32)
    rf0 = np.float32(1) / g.astype(np.float32)
    for ulps in range(-3, 4):
        rf = rf0
        for _ in range(abs(ulps)):
            rf = np.nextafter(rf, np.float32(np.inf if ulps > 0 else 0)).astype(np.float32)
        m = np.floor((rf * scale).astype(np.float32)).astype(np.int64)
        e = num - m * g
        assert (np.abs(e) < 1 << 27).all()
        d = np.floor((e.astype(np.float32) * rf).astype(np.float32)).astype(np.int64)
        m, e = m + d, e - d * g
        hi = e >= g
        m, e = m + hi, e - hi * g
        lo = e < 0
        m, e = m - lo, e + lo * g
        np.testing.assert_array_equal(m + (e != 0), want[1:].astype(np.int64), err_msg=f"{ulps}")
    one = f == 1
    rcp = np.where(one, np.uint64(0xFFFFFFFF), want)
    rsh = np.where(one, 0, s.astype(np.int64) - 1).astype(np.uint64)
    bias = np.where(one, np.uint64(tr.PROB_SCALE - 1), np.uint64(0))
    assert (rcp < 1 << 32).all()
    lim = f << np.uint64(15)
    rng = np.random.default_rng(11)
    xs = [lim - np.uint64(1)]
    for k in (1, 2, 3, 255, 256, 4097, 32767):
        xs += [np.uint64(k) * f - np.uint64(1), np.uint64(k) * f]
    xs += [rng.integers(1, 1 << 31, f.shape[0]).astype(np.uint64) % lim for _ in range(4)]
    for x in xs:
        x = np.clip(x, 1, lim - np.uint64(1))
        q = ((x * rcp) >> np.uint64(32)) >> rsh
        got = x + bias + q * (np.uint64(tr.PROB_SCALE) - f)
        np.testing.assert_array_equal(got, ((x // f) << np.uint64(16)) + x % f)


def test_blob_stream_sentinel_and_last_clamp():
    """unpack_rans_blob ends the stream with one zero sentinel, so a read
    past the lanes' bytes returns 0; on a garbage stream with cursors past
    its end a read at or past the last byte returns that byte (the stream
    decodes as itself extended with copies of its last byte), in both
    valid forms."""
    segs = _segments(6, [2])
    blob = _port_blob(segs)
    states, flat, offs = tr.unpack_rans_blob(blob)
    b = len(blob) - 8 - 8 * tr.LANES
    assert len(flat) == b + 1 and flat[b] == 0
    (p, bits, v), = segs
    p, v = torch.as_tensor(p), torch.as_tensor(v)
    got = tr.rans_decode_segment(torch.as_tensor(states.astype(np.int64)), torch.as_tensor(offs),
                                 torch.as_tensor(flat), p, v)
    np.testing.assert_array_equal(got[2].numpy(), bits)
    rng = np.random.default_rng(7)
    garbage = torch.as_tensor(rng.integers(0, 256, 3000).astype(np.uint8))
    gx = torch.as_tensor(rng.integers(1 << 23, 1 << 31, tr.LANES))
    gcur = torch.as_tensor(rng.integers(2950, 3040, tr.LANES))
    want = tr.rans_decode_segment(gx, gcur, garbage, p, v)
    assert (want[1] > 3000).any()
    extended = torch.cat([garbage, garbage[-1:].repeat(64)])  # past every read
    for got in (tr.rans_decode_segment(gx, gcur, extended, p, v),
                tr.rans_decode_segment(gx, gcur, garbage, p, int(v.sum()))):
        for a, c in zip(got, want):
            assert torch.equal(a, c)


def _level0_geometry(drop: bool):
    """Level 0 of a two-frame GOP of synthetic_cloud(1500, depth=6) through
    the port's brickify: (geo, counts, cap, tv).  With ``drop`` the brick
    cap is the first frame's brick count and the second frame has more,
    so its bricks past the cap fall outside the buffer (dropped)."""
    from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud
    from linr_pcgc_tpu_torch.runtime import dev_codec as dc

    pyrs = [build_pyramid(synthetic_cloud(1500, depth=6, seed=7, phase=0.08 * t), device="cpu")
            for t in range(2)]
    s_num = pyrs[0].scale_num
    shapes = dc._LevelShapes(s_num, [p.low_coords for p in pyrs])
    for s in range(s_num):
        shapes.set_counts(s, [p.levels[s].n for p in pyrs])
    shapes.set_top_coords(s_num - 2, [p.levels[s_num - 2].coords[: p.levels[s_num - 2].n]
                                      for p in pyrs])
    if drop and shapes.bricks(0)[0] > shapes.bricks(0)[1]:
        pyrs = pyrs[::-1]
        shapes.set_counts(0, [p.levels[0].n for p in pyrs])
        shapes.set_counts(2, [p.levels[2].n for p in pyrs])
    bv, cap, tv = shapes.buckets(0)
    if drop:
        assert shapes.bricks(0)[0] < shapes.bricks(0)[1]
        cap = shapes.bricks(0)[0]
    counts = shapes.n_vox[0]
    base = np.zeros((2, bv, 3), np.int32)
    for i, p in enumerate(pyrs):
        base[i, : p.levels[0].n] = p.levels[0].coords[: p.levels[0].n]
    coords, keys = dc._init_level(torch.as_tensor(base), counts, bv)
    geo = dc._brickify_level(coords, keys, counts, 0, cap, tv)
    return geo, counts, cap, tv


@pytest.mark.parametrize("drop", [False, True])
def test_stage_tail_equals_jax_stage_scatter(drop):
    """The decoder's stage tail, stage by stage over one level: the plain
    version (``_rans_dec_stage_scatter`` on the CPU) and K6's stage-tail
    form (``rans_decode_stage`` with the level's ``_stage_plan``: one store
    per covered voxel, the packed column from the frames' symbol offsets)
    give the JAX function's states, cursors, bit rows, occupancy buffer and
    packed column exactly, with pad voxels (vox_brick < 0) and, with
    ``drop``, bricks past the cap."""
    from linr_pcgc_tpu.runtime import dev_codec as jdc
    from linr_pcgc_tpu_torch.runtime import dev_codec as dc

    geo, counts, cap, tv = _level0_geometry(drop)
    f, bv = geo["vox_brick"].shape
    total = sum(counts)
    assert (geo["vox_brick"] < 0).any()
    if drop:
        assert (geo["vox_brick"][1] >= cap).any()
    rng = np.random.default_rng(12 + drop)
    pr = np.where(rng.uniform(size=(8, tv)) < 0.6, 0.05, rng.uniform(size=(8, tv)))
    pr = pr.astype(np.float16)
    truth = np.where(np.arange(tv) < total, rng.uniform(size=(8, tv)) < pr, 0).astype(np.uint8)
    states = tr.rans_initial_states(device="cpu")
    byts, masks = [], []
    for stage in reversed(range(8)):
        states, by, m = tr.rans_encode_segment(states, torch.as_tensor(pr[stage]),
                                               torch.as_tensor(truth[stage]), total)
        byts.append(by)
        masks.append(m)
    lens, out = tr.rans_compact_emissions(torch.cat(byts[::-1]), torch.cat(masks[::-1]), 64)
    payload = np.concatenate([out[lane, : lens[lane]].numpy() for lane in range(tr.LANES)])
    st, flat, offs = tr.unpack_rans_blob(
        tr.pack_rans_blob_flat(states.numpy().astype(np.uint32), payload, lens.numpy()))

    j = dict(st=jnp.asarray(st), cur=jnp.asarray(offs.astype(np.int32)),
             acc=jnp.zeros((8, tv), np.uint8), occ=jnp.zeros((f * cap, 8, 64), np.uint8))
    words = jdc.build_words_table(jnp.asarray(flat))
    maps = [jnp.asarray(geo[k].numpy().astype(np.int32))
            for k in ("vox_fr", "vox_j", "vox_brick", "vox_slot")]
    plain = dict(st=torch.as_tensor(st.astype(np.int64)), cur=torch.as_tensor(offs),
                 acc=torch.zeros((8, tv), dtype=torch.uint8),
                 occ=torch.zeros((f * cap, 8, 64), dtype=torch.uint8))
    fused = {k: v.clone() for k, v in plain.items()}
    dst, soffs = dc._stage_plan(geo["vox_fr"], geo["vox_j"], total, geo["vox_brick"],
                                geo["vox_slot"], cap)
    stream = torch.as_tensor(flat)
    for stage in range(8):
        p = torch.as_tensor(pr[stage])
        j["st"], j["cur"], j["occ"], jpacked, j["acc"] = jdc._rans_dec_stage_scatter(
            j["st"], j["cur"], words, jnp.asarray(pr[stage]), maps[0], maps[1], total,
            j["acc"], j["occ"], stage, maps[2], maps[3])
        plain["st"], plain["cur"], plain["occ"], packed, plain["acc"] = dc._rans_dec_stage_scatter(
            plain["st"], plain["cur"], stream, p, geo["vox_fr"], geo["vox_j"], total,
            plain["acc"], plain["occ"], stage, geo["vox_brick"], geo["vox_slot"])
        fpacked = torch.empty((f, bv // 8), dtype=torch.uint8)
        fused["st"], fused["cur"] = tr.rans_decode_stage(
            fused["st"], fused["cur"], stream, p, total, fused["acc"][stage], fused["occ"], stage,
            dst, soffs, fpacked)
        want = dict(st=np.asarray(j["st"]).astype(np.int64), cur=np.asarray(j["cur"]),
                    acc=np.asarray(j["acc"]), occ=np.asarray(j["occ"]))
        for got in (plain, fused):
            for k, v in want.items():
                np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{k} at stage {stage}")
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
        np.testing.assert_array_equal(fpacked.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(plain["acc"].numpy(), truth)
