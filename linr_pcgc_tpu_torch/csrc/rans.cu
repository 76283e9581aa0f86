// K5 and K6: the interleaved binary rANS coder over 4096 lanes (rans-v2).
//
// K5 (rans_encode) replaces linr_pcgc_tpu/ops/rans.py::rans_encode_segment,
// the lax.scan(reverse=True) over the steps of one segment; K6 (rans_decode)
// replaces the decode scan _decode_core (through rans_decode_segment_tbl),
// which the JAX codec drives per stage from
// runtime/dev_codec.py::_rans_dec_stage_scatter.  Symbol i of a segment
// belongs to lane i % LANES and step i / LANES.  RANS_L = 2^23, byte
// renormalisation (at most two bytes per symbol), 16-bit frequencies
// f1 = clamp(rint(p * 2^16), 1, 2^16 - 1) from the probabilities, bit 0 on
// [0, f0); invalid (pad) symbols are coded as bit 0 with f1 = 1.
//
// Design: one thread per lane, 4096 threads in all, each walking the steps
// of the segment with its state (and, decoding, its cursor) in registers —
// the scan's carry.  Step t of all lanes reads probs[t * LANES + l] and
// friends: neighbouring threads read neighbouring addresses, so every load
// is coalesced across a warp.  The encoder writes byts/mask[t, l, 0..1] in
// the JAX slot order (slot 0 = the byte of the second renormalisation, the
// first one the decoder reads back); the decoder reads each lane's bytes
// from the flat stream at its cursor, clamped to the last byte, and writes
// bits[t * LANES + l].  No atomics; the launch shape depends on LANES only.
//
// Numerics: states stay below 2^31 after renormalisation, and the
// intermediates (x / f) << 16 and (x << 8) | byte stay below 2^31 too, so
// the coder runs in uint32 (x / f and x % f unsigned, no signed shift) and
// reproduces the plain int64 version byte for byte.  p * 65536 is exact in
// f32 (a power of two); rintf rounds half to even, like torch.round.
//
// What bounds it on an H100: a chain of `steps` dependent iterations per
// lane (a few hundred at level 0 of a GOP), each decode step with a
// dependent global read of the stream at the lane's cursor.  The bytes it
// must move (per symbol: probability, valid, bit, two slot bytes and two
// mask bytes, plus the stream) take a few microseconds at 3.35 TB/s, far
// below the chain's latency: the kernel is latency-bound, and only 128
// warps exist to hide it.  One warp per block spreads them over the SMs.
// Later work: a per-thread read-ahead of the stream in registers, and the
// decoder fused with the stage scatter.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 4096;
constexpr uint32_t RANS_L = 1u << 23;
constexpr uint32_t PROB_SCALE = 1u << 16;
constexpr int THREADS = 32;  // one warp per block: 128 blocks over the SMs

// freq1_from_prob: f32 round-half-even of p * 2^16, clamped to [1, 2^16 - 1];
// invalid symbols get 1.
__device__ __forceinline__ uint32_t freq1(__half p, bool valid) {
  if (!valid) return 1u;
  const float r = rintf(__half2float(p) * 65536.0f);
  return (uint32_t)fminf(fmaxf(r, 1.0f), 65535.0f);
}

__global__ void __launch_bounds__(THREADS) rans_encode_kernel(
    const __half* __restrict__ probs, const uint8_t* __restrict__ bits,
    const uint8_t* __restrict__ valid, const long long* __restrict__ states_in,
    long long* __restrict__ states_out, uint8_t* __restrict__ byts,
    uint8_t* __restrict__ mask, int steps) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= LANES) return;
  uint32_t x = (uint32_t)states_in[l];
  for (int t = steps - 1; t >= 0; --t) {
    const long long i = (long long)t * LANES + l;
    const bool v = valid[i] != 0;
    const uint32_t f1 = freq1(probs[i], v);
    const uint32_t f0 = PROB_SCALE - f1;
    const bool bit = v && bits[i] != 0;
    const uint32_t f = bit ? f1 : f0;
    const uint32_t c = bit ? f0 : 0u;
    const uint32_t lim = f << 15;
    const bool e0 = x >= lim;
    const uint8_t b0 = (uint8_t)(x & 0xFFu);
    if (e0) x >>= 8;
    const bool e1 = x >= lim;
    const uint8_t b1 = (uint8_t)(x & 0xFFu);
    if (e1) x >>= 8;
    x = ((x / f) << 16) + (x % f) + c;
    byts[2 * i] = b1;  // slot 0: read first by the decoder
    byts[2 * i + 1] = b0;
    mask[2 * i] = e1;
    mask[2 * i + 1] = e0;
  }
  states_out[l] = (long long)x;
}

__global__ void __launch_bounds__(THREADS) rans_decode_kernel(
    const __half* __restrict__ probs, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ stream, long long last,
    const long long* __restrict__ states_in, const long long* __restrict__ cursors_in,
    long long* __restrict__ states_out, long long* __restrict__ cursors_out,
    uint8_t* __restrict__ bits, int steps) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= LANES) return;
  uint32_t x = (uint32_t)states_in[l];
  long long cur = cursors_in[l];
  for (int t = 0; t < steps; ++t) {
    const long long i = (long long)t * LANES + l;
    const bool v = valid[i] != 0;
    const uint32_t f1 = freq1(probs[i], v);
    const uint32_t f0 = PROB_SCALE - f1;
    const uint32_t slot = x & (PROB_SCALE - 1u);
    const bool bit = slot >= f0;
    const uint32_t f = bit ? f1 : f0;
    const uint32_t c = bit ? f0 : 0u;
    x = f * (x >> 16) + slot - c;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (x < RANS_L) {
        x = (x << 8) | (uint32_t)stream[cur < last ? cur : last];
        ++cur;
      }
    }
    bits[i] = (uint8_t)(bit && v);
  }
  states_out[l] = (long long)x;
  cursors_out[l] = cur;
}

constexpr int BLOCKS = LANES / THREADS;

}  // namespace

// probs (steps * LANES,) f16; bits and valid (steps * LANES,) one byte
// each; states_in/out (LANES,) int64; byts/mask (steps, LANES, 2) one byte
// each; all contiguous.  Returns the launch's cudaGetLastError().
extern "C" int rans_encode(const void* probs, const void* bits, const void* valid,
                           const void* states_in, void* states_out, void* byts, void* mask,
                           int steps, void* stream) {
  rans_encode_kernel<<<BLOCKS, THREADS, 0, (cudaStream_t)stream>>>(
      (const __half*)probs, (const uint8_t*)bits, (const uint8_t*)valid,
      (const long long*)states_in, (long long*)states_out, (uint8_t*)byts, (uint8_t*)mask,
      steps);
  return (int)cudaGetLastError();
}

// probs and valid as above; stream_bytes (last + 1,) uint8; states and
// cursors (LANES,) int64 in and out; bits (steps * LANES,) uint8.
extern "C" int rans_decode(const void* probs, const void* valid, const void* stream_bytes,
                           long long last, const void* states_in, const void* cursors_in,
                           void* states_out, void* cursors_out, void* bits, int steps,
                           void* stream) {
  rans_decode_kernel<<<BLOCKS, THREADS, 0, (cudaStream_t)stream>>>(
      (const __half*)probs, (const uint8_t*)valid, (const uint8_t*)stream_bytes, last,
      (const long long*)states_in, (const long long*)cursors_in, (long long*)states_out,
      (long long*)cursors_out, (uint8_t*)bits, steps);
  return (int)cudaGetLastError();
}
