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
