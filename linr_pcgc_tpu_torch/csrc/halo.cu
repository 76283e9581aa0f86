// K2: slot-major 4^3-brick halo gather, as a coalesced vector copy.
//
// Replaces linr_pcgc_tpu/ops/superbricks.py::_b4_halo_sm_forward, which
// ran as XLA gathers + concatenations on the TPU (no Pallas twin).  Maps
// x (bb, s, 64*C) and nbr27 (bb, 27) to h (bb, s, 216*C) in column order
// (plane*36 + group)*C + c: halo column f of brick b holds channel c of
// slot v of the brick in direction d, zero where that neighbour is absent
// (nbr27 < 0); the centre direction (13) is the brick itself.
//
// The (f -> d, v) table is not written here: the Python wrapper derives it
// from the plain version by pushing an index tensor through it and passes
// it by value (it lands in the constant bank), so kernel and plain version
// cannot disagree on the layout.  The gather copies raw bytes, so it is
// bit-exact in every dtype.
//
// What bounds it on an H100: it is pure data movement, so HBM bytes: x read
// once and the 216/64 = 3.4x larger halo written once (0.44 ms at Bb
// 163,840, S 2, C 8, bf16).  Each brick's x is read again by up to 26
// neighbours; those re-reads cost no HBM bytes only while they hit L2.
// What the design does about it:
//
//  * The copy unit is the widest of 16/8/4/2 bytes that divides a halo
//    column's C * esz bytes and the alignment of x (16 B at bf16 C = 8 and
//    f32 C = 4; 8 B at bf16 C = 4 and 12; 2 B at bf16 C = 7).  A column is
//    a whole number of units on both sides, so each unit is one load and
//    one store.  Thread t of a block copies units t, t + T, ... of every
//    output row of the block, so a warp's store instruction writes one
//    contiguous run of 32 units.
//  * The index work is done once, not per element: each thread looks up
//    its units' (direction, source offset) in the table once, and a block
//    loads the 27 neighbour indices of its bricks into shared memory once.
//    Inside a row the arithmetic is 32-bit; a row's stage and brick follow
//    by increment.  Eight rows' loads (four of 2-byte units) are issued
//    before their stores.
//  * h is written with streaming stores (st.global.cs): at level 0 it is
//    far larger than the 50 MB L2, which should keep x instead.
//  * Bricks are numbered in key order (x, then y, then z of the brick), so
//    a brick's neighbours lie within about one yz-plane of bricks of it
//    (some hundreds).  A block takes a contiguous brick range (about 64
//    rows) and blocks run roughly in index order, so the bricks in flight
//    at once span tens of thousands of indices: a neighbour's x is read
//    while it is still in L2 (and a +-z neighbour's, often in the same
//    block, in L1).
//
// The launch plan (unit, threads, passes, bricks per block, blocks) comes
// from the shapes alone: ops/superbricks.py::halo_plan, tested on the CPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HALO_COLS = 216;
constexpr int CENTRE = 13;
constexpr int MAX_BRICKS = 64;  // bricks a block takes (their neighbour rows in shared)
constexpr int MAX_THREADS = 768;
// rows whose loads are in flight before their stores (measured on the H100:
// 8 for 4- to 16-byte units; 2-byte units are bound by their load and store
// instructions, and deeper unrolling only costs registers)
template <typename U>
constexpr int ROWS_UNROLL = sizeof(U) == 2 ? 4 : 8;

struct HaloTable {
  uint16_t src[HALO_COLS];  // d * 64 + v
};

template <typename U>
__device__ __forceinline__ U zero_unit() {
  return U(0);
}
template <>
__device__ __forceinline__ uint2 zero_unit<uint2>() {
  return make_uint2(0u, 0u);
}
template <>
__device__ __forceinline__ uint4 zero_unit<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// One block: bricks [b0, b0 + nb), all their stages.  upc = units per halo
// column, so an output row is 216 * upc units and an input row 64 * upc.
template <typename U>
__global__ void __launch_bounds__(MAX_THREADS) b4_halo_sm_kernel(const U* __restrict__ x,
                                                          const int* __restrict__ nbr27,
                                                          U* __restrict__ h, int bb, int s_num,
                                                          int upc, int bricks, HaloTable tab) {
  __shared__ int nbr_s[MAX_BRICKS * 27];
  const int b0 = blockIdx.x * bricks;
  const int nb = min(bricks, bb - b0);
  const int* nsrc = nbr27 + (long long)b0 * 27;
  for (int e = threadIdx.x; e < nb * 27; e += blockDim.x) nbr_s[e] = __ldg(nsrc + e);
  __syncthreads();
  const int ru = HALO_COLS * upc;
  const int rux = 64 * upc;
  const int rows = nb * s_num;
  U* hb = h + (long long)b0 * s_num * ru;
  for (int u = threadIdx.x; u < ru; u += blockDim.x) {
    const int f = u / upc;
    const int d = tab.src[f] >> 6;
    const int off = (tab.src[f] & 63) * upc + (u - f * upc);
    int i = 0, s = 0;  // brick (in the block) and stage of row r
    for (int r = 0; r < rows; r += ROWS_UNROLL<U>) {
      U val[ROWS_UNROLL<U>];
#pragma unroll
      for (int q = 0; q < ROWS_UNROLL<U>; ++q) {
        val[q] = zero_unit<U>();
        if (r + q < rows) {
          const int src = d == CENTRE ? b0 + i : nbr_s[i * 27 + d];
          if (src >= 0) val[q] = __ldg(x + (long long)(src * s_num + s) * rux + off);
        }
        if (++s == s_num) {
          s = 0;
          ++i;
        }
      }
#pragma unroll
      for (int q = 0; q < ROWS_UNROLL<U>; ++q)
        if (r + q < rows) __stcs(hb + (r + q) * ru + u, val[q]);
    }
  }
}

template <typename U>
int launch(const void* x, const void* nbr27, void* h, int bb, int s_num, int upc, int bricks,
           int threads, int blocks, const HaloTable& tab, cudaStream_t st) {
  b4_halo_sm_kernel<U><<<blocks, threads, 0, st>>>((const U*)x, (const int*)nbr27, (U*)h, bb,
                                                   s_num, upc, bricks, tab);
  return (int)cudaGetLastError();
}

}  // namespace

// x (bb, s, 64*c), nbr27 (bb, 27) int32, h (bb, s, 216*c), contiguous, x
// and h aligned to unit_bytes (2, 4, 8 or 16), which divides c * esz;
// upc = c * esz / unit_bytes.  bricks (<= 64), threads (a multiple of 32,
// <= 768) and blocks = ceil(bb / bricks) come from halo_plan.  table
// points to 216 uint16 entries in host memory.  Returns the launch's
// cudaGetLastError().
extern "C" int b4_halo_sm(const void* x, const void* nbr27, void* h, int bb, int s_num,
                          int upc, int unit_bytes, int bricks, int threads, int blocks,
                          const void* table, void* stream) {
  if (bb <= 0 || s_num <= 0) return 0;
  if (bricks < 1 || bricks > MAX_BRICKS || threads < 32 || threads > MAX_THREADS || threads % 32 ||
      (long long)blocks * bricks < bb)
    return (int)cudaErrorInvalidValue;
  HaloTable tab;
  const uint16_t* t = (const uint16_t*)table;
  for (int i = 0; i < HALO_COLS; ++i) tab.src[i] = t[i];
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit_bytes) {
    case 2: return launch<uint16_t>(x, nbr27, h, bb, s_num, upc, bricks, threads, blocks, tab, st);
    case 4: return launch<uint32_t>(x, nbr27, h, bb, s_num, upc, bricks, threads, blocks, tab, st);
    case 8: return launch<uint2>(x, nbr27, h, bb, s_num, upc, bricks, threads, blocks, tab, st);
    case 16: return launch<uint4>(x, nbr27, h, bb, s_num, upc, bricks, threads, blocks, tab, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
