// K5 and K6: the interleaved binary rANS coder over 4096 lanes (rans-v2).
//
// K5 (rans_encode) replaces linr_pcgc_tpu/ops/rans.py::rans_encode_segment,
// the lax.scan(reverse=True) over the steps of one segment; K6 replaces the
// decode scan _decode_core (through rans_decode_segment_tbl), which the JAX
// codec drives per stage from runtime/dev_codec.py::_rans_dec_stage_scatter.
// K6 has two entries: rans_decode (one segment's bits, given a valid tensor
// or a count of leading valid symbols) and rans_decode_stage, the codec's
// stage tail in one launch: the decode, the bits into their row of the
// level's bit buffer, and each decoded bit stored into its voxel's slot of
// occupancy column `stage` of the brick buffer; a small second kernel then
// packs the stage's per-voxel column (numpy packbits order).
//
// Symbol i of a segment belongs to lane i % LANES and step i / LANES.
// RANS_L = 2^23, byte renormalisation (at most two bytes per symbol),
// 16-bit frequencies f1 = clamp(rint(p * 2^16), 1, 2^16 - 1), bit 0 on
// [0, f0); invalid (pad) symbols are coded as bit 0 with f1 = 1.
//
// What bounds it on an H100: each lane is a chain of `steps` dependent
// updates of its state (384 at the smoke's level 0), and there are only
// 4096 lanes: 128 warps, one per SM, so one warp scheduler of each SM does
// all the work and every instruction of a step is issued by it.  The bytes
// the coder must move take a few microseconds at 3.35 TB/s; what costs is
// the instructions a lane's warp issues per step, and the latency of its
// loads.  So the design is warp specialised: a block holds the 32 lanes'
// chain warp and producer warps on the SM's other schedulers (three for
// K6; seven for K5, whose reciprocals cost more).  The producers walk the
// steps in chunks of C, load the probabilities (and bits, valid flags,
// scatter targets) coalesced, one chunk ahead, and compute everything that
// does not depend on the state: K6's frequency f1, K5's frequency f, the
// exact reciprocal of f, its shift and bias.  They write each chunk into a
// ring of NS chunks in shared memory, handed over by named barriers (full
// / empty per slot).  The chain warp reads one 8- or 16-byte word per step
// and issues only the chain, the decoder's byte reads and the stores.
//   * K5 divides by f with an exact reciprocal (Alverson; the ryg_rans form
//     for states below 2^31): rcp = ceil(2^(31 + s) / f), s = ceil(log2 f),
//     x / f = umulhi(x, rcp) >> (s - 1); f = 1 takes rcp = 2^32 - 1, shift 0
//     and a bias of 2^16 - 1 (then q = x - 1).  The new state x + bias +
//     q * (2^16 - f) equals (x / f << 16) + x % f + c for every f in [1,
//     2^16) and 1 <= x < f * 2^15.  rcp is computed without a branch (a
//     float estimate, one correction on the exact 64-bit residual, two
//     compare-and-fix steps); tests/test_torch_rans.py emulates both
//     formulas over every f.
//   * K6 reads its lane's bytes at the cursor, each read clamped to `last`
//     (a read at or past it returns stream[last], as the plain version's
//     clamp), so the stream needs no padding and no read leaves it.
// The stage tail's stores (the bit row, one occupancy byte per covered
// voxel) are plain stores to distinct addresses: the codec's occupancy
// column is zero when its stage is decoded, so writing only the voxels a
// symbol covers equals the reference's scatter of the whole column.  No
// atomics; the launch shape depends on LANES and the shapes only.
//
// Numerics: states stay below 2^31 after renormalisation, and the
// intermediates (x / f) << 16 and (x << 8) | byte stay below 2^31 too, so
// the coder runs in uint32 and reproduces the plain int64 version byte for
// byte.  p * 65536 is exact in f32 (a power of two); rintf rounds half to
// even, like torch.round.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 4096;
constexpr uint32_t RANS_L = 1u << 23;
constexpr uint32_t PROB_SCALE = 1u << 16;
constexpr int CHAIN = 32;             // lanes of a block: its chain warp
constexpr int BLOCKS = LANES / CHAIN;  // 128, one per SM
// Producer threads of a block: K6's three warps (the SM's other three
// schedulers) keep up with its chain; K5's reciprocals need seven.
constexpr int DEC_PRODUCERS = 96, ENC_PRODUCERS = 224;
constexpr int C = 32;                  // steps per chunk
constexpr int NS = 2;                  // chunks in the ring
// a producer's words per chunk
constexpr int words_per_producer(int producers) { return (C * CHAIN + producers - 1) / producers; }
constexpr int OCC_SLOTS = 64;          // occupancy buffer (F * cap, 8, 64)

// Named barriers 1..NS: slot s is full; NS + 1..2 NS: slot s is empty; the
// whole block (n threads) takes part in each.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// freq1_from_prob: f32 round-half-even of p * 2^16, clamped to [1, 2^16 - 1];
// invalid symbols get 1.
__device__ __forceinline__ uint32_t freq1(uint16_t p, bool valid) {
  if (!valid) return 1u;
  const float r = rintf(__half2float(__ushort_as_half(p)) * 65536.0f);
  return (uint32_t)fminf(fmaxf(r, 1.0f), 65535.0f);
}

// ceil(2^(31 + s) / f) for f in [2, 2^16), s = ceil(log2 f), exactly and
// without a branch: a float estimate within 2^10 of the quotient
// (__fdividef is within 2 ulp), one float-corrected step on the exact
// residual (then within one of the floor), two compare-and-fix steps.
__device__ __forceinline__ uint32_t rcp_ceil(uint32_t f, uint32_t s) {
  const float rf = __fdividef(1.0f, (float)f);
  const float scale = __uint_as_float((127u + 31u + s) << 23);  // 2^(31 + s)
  uint32_t m = __float2uint_rz(rf * scale);
  const unsigned long long num = 1ull << (31 + s);
  int e = (int)(uint32_t)(num - (unsigned long long)m * f);  // |e| < 2^27
  const int d = __float2int_rd((float)e * rf);
  m += (uint32_t)d;
  e -= d * (int)f;
  const bool hi = e >= (int)f;
  m += hi ? 1u : 0u;
  e -= hi ? (int)f : 0;
  const bool lo = e < 0;
  m -= lo ? 1u : 0u;
  e += lo ? (int)f : 0;
  return m + (e != 0 ? 1u : 0u);
}

// ----------------------------------------------------------------- encode --

// Chunk n holds the steps t = steps - 1 - (n C + k), k < C (reverse order);
// its word for (k, lane): rcp, lim = f << 15, bias, (2^16 - f) | shift << 16.
// A producer's inputs of chunk n + 1 are loaded while it computes chunk n.
constexpr int ENC_J = words_per_producer(ENC_PRODUCERS);
constexpr int ENC_THREADS = CHAIN + ENC_PRODUCERS;

struct EncRaw {
  uint16_t p[ENC_J];
  uint8_t b[ENC_J], v[ENC_J];
};

template <bool kValidTensor>
__device__ __forceinline__ void load_enc(EncRaw& r, const uint16_t* __restrict__ probs,
                                         const uint8_t* __restrict__ bits,
                                         const uint8_t* __restrict__ valid, int steps, int n) {
  const int h = threadIdx.x - CHAIN;
#pragma unroll
  for (int j = 0; j < ENC_J; ++j) {
    const int idx = h + j * ENC_PRODUCERS;
    const int t = steps - 1 - (n * C + idx / CHAIN);
    if (idx < C * CHAIN && t >= 0) {
      const uint32_t i = (uint32_t)t * LANES + blockIdx.x * CHAIN + idx % CHAIN;
      r.p[j] = __ldg(probs + i);
      r.b[j] = __ldg(bits + i);
      if (kValidTensor) r.v[j] = __ldg(valid + i);
    }
  }
}

template <bool kValidTensor>
__device__ void produce_enc(uint4 (*ring)[C][CHAIN], const uint16_t* __restrict__ probs,
                            const uint8_t* __restrict__ bits, const uint8_t* __restrict__ valid,
                            uint32_t total, int steps, int nchunks) {
  const int h = threadIdx.x - CHAIN;
  EncRaw cur, nxt;
  load_enc<kValidTensor>(cur, probs, bits, valid, steps, 0);
  for (int n = 0; n < nchunks; ++n) {
    const int s = n % NS;
    load_enc<kValidTensor>(nxt, probs, bits, valid, steps, n + 1);
    if (n >= NS) bar_sync(1 + NS + s, ENC_THREADS);
#pragma unroll
    for (int j = 0; j < ENC_J; ++j) {
      const int idx = h + j * ENC_PRODUCERS;
      const int t = steps - 1 - (n * C + idx / CHAIN);
      if (idx < C * CHAIN) {
        const uint32_t i = (uint32_t)(t < 0 ? 0 : t) * LANES + blockIdx.x * CHAIN + idx % CHAIN;
        const bool v = t >= 0 && (kValidTensor ? cur.v[j] != 0 : i < total);
        const uint32_t f1 = freq1(cur.p[j], v);
        const bool bit = v && cur.b[j] != 0;
        const uint32_t f = bit ? f1 : PROB_SCALE - f1;
        const uint32_t c = bit ? PROB_SCALE - f1 : 0u;
        const uint32_t sh = 32u - __clz(f - 1u);  // ceil(log2 f): 1..16, 0 for f = 1
        const bool one = f < 2u;
        ring[s][idx / CHAIN][idx % CHAIN] =
            make_uint4(one ? 0xFFFFFFFFu : rcp_ceil(f, sh), f << 15,
                       one ? c + PROB_SCALE - 1u : c,
                       (PROB_SCALE - f) | ((one ? 0u : sh - 1u) << 16));
      }
    }
    bar_arrive(1 + s, ENC_THREADS);
    cur = nxt;
  }
}

template <bool kTail>
__device__ __forceinline__ void chain_enc(const uint4 (*words)[CHAIN], uint32_t& x,
                                          uint16_t* byts, uint16_t* mask, int steps, int r0) {
  const int l = blockIdx.x * CHAIN + threadIdx.x;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int t = steps - 1 - (r0 + k);
    if (!kTail || t >= 0) {
      const uint4 w = words[k][threadIdx.x];
      const size_t i = (size_t)t * LANES + l;
      const bool e0 = x >= w.y;
      const uint32_t b0 = x & 0xFFu;
      if (e0) x >>= 8;
      const bool e1 = x >= w.y;
      const uint32_t b1 = x & 0xFFu;
      if (e1) x >>= 8;
      const uint32_t q = __umulhi(x, w.x) >> (w.w >> 16);
      x = x + w.z + q * (w.w & 0xFFFFu);
      // slot 0 (the low byte) is the one the decoder reads first
      byts[i] = (uint16_t)(b1 | (b0 << 8));
      mask[i] = (uint16_t)((uint32_t)e1 | ((uint32_t)e0 << 8));
    }
  }
}

template <bool kValidTensor>
__global__ void __launch_bounds__(ENC_THREADS) rans_encode_kernel(
    const uint16_t* __restrict__ probs, const uint8_t* __restrict__ bits,
    const uint8_t* __restrict__ valid, uint32_t total, const long long* __restrict__ states_in,
    long long* __restrict__ states_out, uint16_t* __restrict__ byts, uint16_t* __restrict__ mask,
    int steps) {
  __shared__ uint4 ring[NS][C][CHAIN];
  const int nchunks = (steps + C - 1) / C;
  if (threadIdx.x >= CHAIN) {
    produce_enc<kValidTensor>(ring, probs, bits, valid, total, steps, nchunks);
    return;
  }
  const int l = blockIdx.x * CHAIN + threadIdx.x;
  uint32_t x = (uint32_t)states_in[l];
  for (int n = 0; n < nchunks; ++n) {
    const int s = n % NS;
    bar_sync(1 + s, ENC_THREADS);
    if ((n + 1) * C <= steps)
      chain_enc<false>(ring[s], x, byts, mask, steps, n * C);
    else
      chain_enc<true>(ring[s], x, byts, mask, steps, n * C);
    if (n + NS < nchunks) bar_arrive(1 + NS + s, ENC_THREADS);
  }
  states_out[l] = (long long)x;
}

// ----------------------------------------------------------------- decode --

// Chunk n holds the steps n C + k, k < C; its word for (k, lane): f1 | valid
// << 16, and the stage tail's scatter target (or -1).
constexpr int DEC_J = words_per_producer(DEC_PRODUCERS);
constexpr int DEC_THREADS = CHAIN + DEC_PRODUCERS;

struct DecRaw {
  uint16_t p[DEC_J];
  int32_t aux[DEC_J];  // valid flag (valid tensor) or scatter target (stage tail)
};

template <bool kFused, bool kValidTensor>
__device__ __forceinline__ void load_dec(DecRaw& r, const uint16_t* __restrict__ probs,
                                         const uint8_t* __restrict__ valid,
                                         const int32_t* __restrict__ dst, int steps, int n) {
  const int h = threadIdx.x - CHAIN;
#pragma unroll
  for (int j = 0; j < DEC_J; ++j) {
    const int idx = h + j * DEC_PRODUCERS;
    const int t = n * C + idx / CHAIN;
    if (idx < C * CHAIN && t < steps) {
      const uint32_t i = (uint32_t)t * LANES + blockIdx.x * CHAIN + idx % CHAIN;
      r.p[j] = __ldg(probs + i);
      if (kValidTensor) r.aux[j] = __ldg(valid + i);
      if (kFused) r.aux[j] = __ldg(dst + i);
    }
  }
}

template <bool kFused, bool kValidTensor>
__device__ void produce_dec(uint2 (*ring)[C][CHAIN], const uint16_t* __restrict__ probs,
                            const uint8_t* __restrict__ valid, uint32_t total,
                            const int32_t* __restrict__ dst, int steps, int nchunks) {
  const int h = threadIdx.x - CHAIN;
  DecRaw cur, nxt;
  load_dec<kFused, kValidTensor>(cur, probs, valid, dst, steps, 0);
  for (int n = 0; n < nchunks; ++n) {
    const int s = n % NS;
    load_dec<kFused, kValidTensor>(nxt, probs, valid, dst, steps, n + 1);
    if (n >= NS) bar_sync(1 + NS + s, DEC_THREADS);
#pragma unroll
    for (int j = 0; j < DEC_J; ++j) {
      const int idx = h + j * DEC_PRODUCERS;
      const int t = n * C + idx / CHAIN;
      if (idx < C * CHAIN) {
        const uint32_t i = (uint32_t)t * LANES + blockIdx.x * CHAIN + idx % CHAIN;
        const bool in = t < steps;
        const bool v = in && (kValidTensor ? cur.aux[j] != 0 : i < total);
        ring[s][idx / CHAIN][idx % CHAIN] =
            make_uint2(freq1(cur.p[j], v) | ((uint32_t)v << 16),
                       kFused && in ? (uint32_t)cur.aux[j] : 0xFFFFFFFFu);
      }
    }
    bar_arrive(1 + s, DEC_THREADS);
    cur = nxt;
  }
}

template <bool kFused, bool kTail>
__device__ __forceinline__ void chain_dec(const uint2 (*words)[CHAIN], uint32_t& x, uint32_t& rp,
                                          const uint8_t* __restrict__ stream, uint32_t last,
                                          uint8_t* bits, uint8_t* occ, int steps, int t0) {
  const int l = blockIdx.x * CHAIN + threadIdx.x;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int t = t0 + k;
    if (!kTail || t < steps) {
      const uint2 w = words[k][threadIdx.x];
      const size_t i = (size_t)t * LANES + l;
      const uint32_t b0 = __ldg(stream + min(rp, last)), b1 = __ldg(stream + min(rp + 1u, last));
      const uint32_t f1 = w.x & 0xFFFFu, f0 = PROB_SCALE - f1;
      // the chain: both candidates of the decode step, then renormalise;
      // a second byte is read only if the first one was (n2 implies n1)
      const uint32_t slot = x & (PROB_SCALE - 1u);
      const uint32_t hi = x >> 16;
      const bool bit = slot >= f0;
      x = bit ? f1 * hi + (slot - f0) : f0 * hi + slot;
      const bool n1 = x < RANS_L;
      if (n1) x = (x << 8) | b0;
      const bool n2 = x < RANS_L;
      if (n2) x = (x << 8) | b1;
      rp += (uint32_t)n1 + (uint32_t)n2;
      const uint8_t out = (uint8_t)(bit && (w.x >> 16) != 0);
      bits[i] = out;
      if (kFused && (int)w.y >= 0) occ[w.y] = out;
    }
  }
}

// Standalone: bits (steps * LANES,).  Stage tail (kFused): bits is the
// level's bit row of this stage and occ the brick buffer offset to column
// `stage`; dst[i] is symbol i's slot in it, or -1.
template <bool kFused, bool kValidTensor>
__global__ void __launch_bounds__(DEC_THREADS) rans_decode_kernel(
    const uint16_t* __restrict__ probs, const uint8_t* __restrict__ valid, uint32_t total,
    const int32_t* __restrict__ dst, uint8_t* __restrict__ occ,
    const uint8_t* __restrict__ stream, uint32_t last,
    const long long* __restrict__ states_in, const long long* __restrict__ cursors_in,
    long long* __restrict__ states_out, long long* __restrict__ cursors_out,
    uint8_t* __restrict__ bits, int steps) {
  __shared__ uint2 ring[NS][C][CHAIN];
  const int nchunks = (steps + C - 1) / C;
  if (threadIdx.x >= CHAIN) {
    produce_dec<kFused, kValidTensor>(ring, probs, valid, total, dst, steps, nchunks);
    return;
  }
  const int l = blockIdx.x * CHAIN + threadIdx.x;
  uint32_t x = (uint32_t)states_in[l];
  const long long cur = cursors_in[l];
  // the read position: the cursor (clamped to last) plus the bytes read
  const uint32_t rp0 = (uint32_t)(cur < (long long)last ? cur : (long long)last);
  uint32_t rp = rp0;
  for (int n = 0; n < nchunks; ++n) {
    const int s = n % NS;
    bar_sync(1 + s, DEC_THREADS);
    if ((n + 1) * C <= steps)
      chain_dec<kFused, false>(ring[s], x, rp, stream, last, bits, occ, steps, n * C);
    else
      chain_dec<kFused, true>(ring[s], x, rp, stream, last, bits, occ, steps, n * C);
    if (n + NS < nchunks) bar_arrive(1 + NS + s, DEC_THREADS);
  }
  states_out[l] = (long long)x;
  cursors_out[l] = cur + (long long)(rp - rp0);
}

// The stage's packed per-voxel column (F, bv8): voxel j < count of frame
// fr is symbol offs[fr] + j; the rest are 0.  Bit 7 of a byte is its
// first voxel (numpy packbits).
__global__ void stage_pack_kernel(const uint8_t* __restrict__ bits,
                                  const int32_t* __restrict__ offs, uint8_t* __restrict__ packed,
                                  int f, int bv8) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= f * bv8) return;
  const int fr = idx / bv8, j0 = 8 * (idx - fr * bv8);
  const int o = offs[fr], n = offs[fr + 1] - o;
  uint32_t byte = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (j0 + k < n) byte |= (uint32_t)bits[o + j0 + k] << (7 - k);
  packed[idx] = (uint8_t)byte;
}

}  // namespace

// probs (steps * LANES,) f16; bits (steps * LANES,) one byte each; valid
// likewise, or NULL: then the first `total` symbols are valid;
// states_in/out (LANES,) int64; byts/mask (steps, LANES, 2) one byte each;
// all contiguous.  Returns the launch's cudaGetLastError().
extern "C" int rans_encode(const void* probs, const void* bits, const void* valid, int total,
                           const void* states_in, void* states_out, void* byts, void* mask,
                           int steps, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (valid)
    rans_encode_kernel<true><<<BLOCKS, ENC_THREADS, 0, s>>>(
        (const uint16_t*)probs, (const uint8_t*)bits, (const uint8_t*)valid, 0u,
        (const long long*)states_in, (long long*)states_out, (uint16_t*)byts, (uint16_t*)mask,
        steps);
  else
    rans_encode_kernel<false><<<BLOCKS, ENC_THREADS, 0, s>>>(
        (const uint16_t*)probs, (const uint8_t*)bits, nullptr, (uint32_t)total,
        (const long long*)states_in, (long long*)states_out, (uint16_t*)byts, (uint16_t*)mask,
        steps);
  return (int)cudaGetLastError();
}

// probs and valid (or NULL and total) as above; stream_bytes holds at least
// last + 1 bytes; states and cursors (LANES,) int64 in and out; bits
// (steps * LANES,) uint8.
extern "C" int rans_decode(const void* probs, const void* valid, int total,
                           const void* stream_bytes, long long last, const void* states_in,
                           const void* cursors_in, void* states_out, void* cursors_out, void* bits,
                           int steps, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (valid)
    rans_decode_kernel<false, true><<<BLOCKS, DEC_THREADS, 0, s>>>(
        (const uint16_t*)probs, (const uint8_t*)valid, 0u, nullptr, nullptr,
        (const uint8_t*)stream_bytes, last, (const long long*)states_in,
        (const long long*)cursors_in, (long long*)states_out, (long long*)cursors_out,
        (uint8_t*)bits, steps);
  else
    rans_decode_kernel<false, false><<<BLOCKS, DEC_THREADS, 0, s>>>(
        (const uint16_t*)probs, nullptr, (uint32_t)total, nullptr, nullptr,
        (const uint8_t*)stream_bytes, last, (const long long*)states_in,
        (const long long*)cursors_in, (long long*)states_out, (long long*)cursors_out,
        (uint8_t*)bits, steps);
  return (int)cudaGetLastError();
}

// The codec's stage tail: decode with the first `total` symbols valid into
// bits_row (steps * LANES,), store each bit at occ[dst[i] + stage * 64] of
// the (F * cap, 8, 64) occupancy buffer where dst[i] >= 0, then pack the
// stage's column into packed (f, bv8) from the frames' symbol offsets offs
// (f + 1,) int32.
extern "C" int rans_decode_stage(const void* probs, int total, const void* dst, void* occ,
                                 int stage, const void* stream_bytes, long long last,
                                 const void* states_in, const void* cursors_in, void* states_out,
                                 void* cursors_out, void* bits_row, const void* offs, void* packed,
                                 int f, int bv8, int steps, void* stream) {
  const auto s = (cudaStream_t)stream;
  rans_decode_kernel<true, false><<<BLOCKS, DEC_THREADS, 0, s>>>(
      (const uint16_t*)probs, nullptr, (uint32_t)total, (const int32_t*)dst,
      (uint8_t*)occ + (size_t)stage * OCC_SLOTS, (const uint8_t*)stream_bytes, last,
      (const long long*)states_in, (const long long*)cursors_in, (long long*)states_out,
      (long long*)cursors_out, (uint8_t*)bits_row, steps);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int n = f * bv8, threads = 256;
  if (n > 0)
    stage_pack_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
        (const uint8_t*)bits_row, (const int32_t*)offs, (uint8_t*)packed, f, bv8);
  return (int)cudaGetLastError();
}
