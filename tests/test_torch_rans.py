"""The port's rANS against the JAX package: for the same f16 probabilities
the blob bytes are identical to the numpy reference coder and to the JAX
scan coder, and the decode returns the bits and the reference lane cursors."""

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
    states = tr.rans_initial_states()
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
