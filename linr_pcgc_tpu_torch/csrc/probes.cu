// K7, K8 and K9: the card's own probes of the three mechanisms a fused
// halo + matmul kernel needs — a kernel that builds and runs, a gridded
// tiled product, and a row fetch by index through an asynchronous copy.
//
// K7 probe_scale_shift replaces scripts/prof_pallas.py::probe_basic.kernel
// (y = x * 2 + 1 on one VMEM block).  One thread per element; x * 2 is exact,
// so the result is one f32 rounding of x * 2 + 1 with or without an FMA.
// Bound: bytes (read x, write y), a few hundred nanoseconds of launch at the
// probe's (8, 128).
//
// K8 probe_matmul replaces probe_matmul_grid.kernel (a grid of 128 x 128
// output blocks of a @ b on the MXU, whose f32 product runs as several bf16
// passes).  Its Hopper counterpart is 3xTF32 on the tensor cores
// (mma.sync m16n8k8, f32 accumulators): each operand splits into a big and
// a small TF32 part, big = tf32(x) and small = tf32(x - big) (rounded to
// nearest onto 10 mantissa bits, ties away from zero), and each K step of 8
// adds a_small b_big, then a_big b_small, into a correction accumulator and
// a_big b_big into the main one.  The dropped a_small b_small term is about
// 2^-22 of a product: f32 accuracy at the tensor cores' rate.  (A SIMT
// kernel with 64 x 64 tiles, a 4 x 4 f32 micro-tile on the CUDA cores and
// no overlap of loads and FMAs ran at 12 % of the f32 CUDA-core bound, 2.6x
// behind torch.matmul.)  Bound: the three products' operations over the
// TF32 peak (3 x 2 M N K / 495 TFLOP/s, 1.6 us at 512^3), above the bytes
// (3 MiB, 0.9 us).  What the design does about it:
//
//  * 64 x 32 output tiles, 128 blocks at 512^3 (one on each of 128 of the
//    132 SMs).  4 warps a block: warp w owns rows 32 (w % 2).. + 31 and all
//    32 columns (2 m16 x 4 n8 tiles) for the K steps of half w / 2 of every
//    chunk, so each loaded and split fragment feeds 2-4 mma.
//  * The a_big b_big products go into their own accumulator: its sum sees
//    one f32 rounding per K step instead of three (the tensor cores'
//    accumulation truncates), and a warp has 16 independent mma chains.
//  * K chunks of 64 come through a 3-stage ring of cp.async copies (16 B
//    where k and n are multiples of 4 and the operands 16-byte aligned,
//    else 4 B; dynamic shared memory, 83 KB), zero-filled past the ragged
//    edges, so the next chunks load while the tensor cores work on this one.
//  * Tile rows are padded (A 68, B 40 floats) so that every fragment load
//    of a warp hits 32 distinct banks.
//  * Fixed summation order: each warp sums its K steps in ascending order,
//    adds main + correction, and the two halves' parts are added in warp
//    order through shared memory: the same bits from every launch.
//
// What bounds it in practice is the mma.sync issue rate for TF32, well
// below the 495 TFLOP/s that wgmma reaches, with the operands' L2 stream
// (each A tile read by 16 column blocks, each B tile by 8) partly on top;
// wgmma with B split into shared memory is the way to the bound.

// K9 probe_row_gather replaces probe_scalar_prefetch_gather.kernel (indices
// prefetched as scalars, one DMA per row behind a semaphore).  It is the
// producer loop the fused halo of ROADMAP B.4 needs: rows fetched by index
// with bulk asynchronous copies behind a ring of mbarriers, several in
// flight ahead of the row being written.  Persistent one-warp blocks (two
// per SM, or one per row for fewer rows) each take a contiguous range of
// output rows, and every lane is a producer of its own: lane l takes rows
// l, l + L, l + 2L, ... of the range through a ring of NSL row slots, each
// with its mbarrier.  A lane loads its
// row's index and checks its range in the kernel: an index outside [0,
// rows) sets a flag word (the wrapper reads it after the stream syncs and
// raises) and its row is neither fetched nor written, so a bad index leaves
// no sticky CUDA error behind.  Otherwise the lane arms the slot's barrier
// with the row's bytes and issues one cp.async.bulk (global -> shared,
// completing on that barrier); it writes each landed row out by one bulk
// store (shared -> global) and refills a slot once the store of its
// previous row has read it (bulk_group accounting, one group per row).  So a
// warp keeps up to L * (NSL - 1) row fetches in flight.  Rows too large for
// 32 lanes' rings use fewer lanes.  The copies need 16-byte-aligned source,
// destination and size: the wrapper checks the row width and the alignment.
// Bound: bytes (each gathered row read once and written once, plus the
// indices).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ K7 ----

__global__ void probe_scale_shift_kernel(const float* __restrict__ x, float* __restrict__ y,
                                         long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    y[i] = x[i] * 2.0f + 1.0f;
}

// ------------------------------------------------------------------ K8 ----

constexpr int MM_BM = 64;     // output tile rows
constexpr int MM_BN = 32;     // output tile columns: 4 n8 tiles
constexpr int MM_BK = 64;     // K chunk of one ring stage
constexpr int MM_STAGES = 3;
constexpr int MM_WM = 32;     // rows of a warp's tile: MM_WM / 16 m16 tiles
constexpr int MM_RG = MM_BM / MM_WM;  // row groups
constexpr int MM_KSPLIT = 2;  // warps sharing a row group, each a part of every chunk
constexpr int MM_THREADS = 32 * MM_RG * MM_KSPLIT;
static_assert(MM_BK % (8 * MM_KSPLIT) == 0, "a warp's part of a chunk is whole K steps");
constexpr int MM_AS = MM_BK + 4;  // A tile row stride (floats): bank = 4 row + col
constexpr int MM_BS = MM_BN + 8;  // B tile row stride (floats): bank = 8 row + col

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of BYTES (4 or 16): read from src if valid, else zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const float* src, bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}

// round to nearest onto TF32's 10 mantissa bits, ties away from zero (the
// rounding of cvt.rna.tf32.f32), low 13 bits cleared
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct MatmulSmem {
  float a[MM_STAGES][MM_BM][MM_AS];
  float b[MM_STAGES][MM_BK][MM_BS];
};
static_assert((MM_KSPLIT - 1) * MM_BM * MM_BN * sizeof(float) <= sizeof(MatmulSmem),
              "the K split's parts reuse the ring");

// Stage K chunk kt of A (rows m0.., cols k0..) and B (rows k0.., cols n0..)
// into ring slot st; everything past m, k or n lands as zeros.
template <int VEC>
__device__ __forceinline__ void load_chunk(MatmulSmem& sm, int st, int kt,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b, int m, int k, int n,
                                           int m0, int n0) {
  const int k0 = kt * MM_BK;
  constexpr int APR = MM_BK / VEC, BPR = MM_BN / VEC;  // copies per tile row
#pragma unroll
  for (int e = 0; e < MM_BM * APR / MM_THREADS; ++e) {
    const int c = threadIdx.x + MM_THREADS * e;
    const int r = c / APR, q = (c % APR) * VEC;
    const bool ok = m0 + r < m && k0 + q < k;
    cp_async<4 * VEC>(&sm.a[st][r][q], ok ? a + (long long)(m0 + r) * k + k0 + q : a, ok);
  }
#pragma unroll
  for (int e = 0; e < MM_BK * BPR / MM_THREADS; ++e) {
    const int c = threadIdx.x + MM_THREADS * e;
    const int r = c / BPR, q = (c % BPR) * VEC;
    const bool ok = k0 + r < k && n0 + q < n;
    cp_async<4 * VEC>(&sm.b[st][r][q], ok ? b + (long long)(k0 + r) * n + n0 + q : b, ok);
  }
}

template <int VEC>
__global__ void __launch_bounds__(MM_THREADS) probe_matmul_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c, int m,
    int k, int n) {
  extern __shared__ __align__(16) unsigned char mm_smem[];
  MatmulSmem& sm = *reinterpret_cast<MatmulSmem*>(mm_smem);
  constexpr int MT = MM_WM / 16, NT = MM_BN / 8;
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // the fragments' group and thread in group
  const int wr = MM_WM * (warp % MM_RG);  // the warp's first row
  const int ks = warp / MM_RG;            // its part of each chunk
  float big[MT][NT][4] = {}, corr[MT][NT][4] = {};
  const int kts = (k + MM_BK - 1) / MM_BK;
#pragma unroll
  for (int st = 0; st < MM_STAGES - 1; ++st) {
    if (st < kts) load_chunk<VEC>(sm, st, st, a, b, m, k, n, m0, n0);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int kt = 0; kt < kts; ++kt) {
    // chunk kt has landed; every warp is done with the slot refilled next
    asm volatile("cp.async.wait_group %0;" ::"n"(MM_STAGES - 2) : "memory");
    __syncthreads();
    const int nxt = kt + MM_STAGES - 1;
    if (nxt < kts) load_chunk<VEC>(sm, nxt % MM_STAGES, nxt, a, b, m, k, n, m0, n0);
    asm volatile("cp.async.commit_group;" ::: "memory");
    const int st = kt % MM_STAGES;
#pragma unroll
    for (int kq = 0; kq < MM_BK / MM_KSPLIT; kq += 8) {
      const int kk = ks * (MM_BK / MM_KSPLIT) + kq;
      uint32_t a_big[MT][4], a_small[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wr + 16 * mt + g;
        split_tf32(sm.a[st][r][kk + t], a_big[mt][0], a_small[mt][0]);
        split_tf32(sm.a[st][r + 8][kk + t], a_big[mt][1], a_small[mt][1]);
        split_tf32(sm.a[st][r][kk + t + 4], a_big[mt][2], a_small[mt][2]);
        split_tf32(sm.a[st][r + 8][kk + t + 4], a_big[mt][3], a_small[mt][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b_big[2], b_small[2];
        split_tf32(sm.b[st][kk + t][8 * j + g], b_big[0], b_small[0]);
        split_tf32(sm.b[st][kk + t + 4][8 * j + g], b_big[1], b_small[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_tf32(corr[mt][j], a_small[mt], b_big);
          mma_tf32(corr[mt][j], a_big[mt], b_small);
          mma_tf32(big[mt][j], a_big[mt], b_big);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  // each warp's part: big + corr; then the parts of a row group in warp order
  float(*part)[MM_BM][MM_BN] = reinterpret_cast<float(*)[MM_BM][MM_BN]>(&sm.a[0][0][0]);
  __syncthreads();  // the ring is free
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        big[mt][j][i] += corr[mt][j][i];
        if (ks > 0)
          part[ks - 1][wr + 16 * mt + g + 8 * (i / 2)][8 * j + 2 * t + (i % 2)] = big[mt][j][i];
      }
  __syncthreads();
  if (ks > 0) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wr + 16 * mt + g + 8 * (i / 2), q = 8 * j + 2 * t + (i % 2);
        float v = big[mt][j][i];
#pragma unroll
        for (int p = 0; p < MM_KSPLIT - 1; ++p) v += part[p][r][q];
        if (m0 + r < m && n0 + q < n) c[(long long)(m0 + r) * n + n0 + q] = v;
      }
}

// ------------------------------------------------------------------ K9 ----

constexpr int GATHER_MAX_NSL = 4;      // row slots of one lane's ring
constexpr int GATHER_RING_BYTES = 98304;  // rings of one block: two blocks per SM
constexpr int GATHER_OFF_RING = 32 * GATHER_MAX_NSL * 8;  // the lanes' mbarriers first

__global__ void __launch_bounds__(32) probe_row_gather_kernel(
    const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out,
    int* __restrict__ bad, int nb, int rows, int d, int lanes, int nsl, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * per;
  const int n = min(nb, r0 + per) - r0;
  if (lane >= lanes || n <= lane) return;
  const uint32_t bytes = (uint32_t)d * 4u;
  const uint32_t bar0 = smem_u32(smem) + lane * nsl * 8;
  const uint32_t ring = smem_u32(smem + GATHER_OFF_RING) + lane * nsl * bytes;
  for (int i = 0; i < nsl; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * i) : "memory");
  // make the initialised barriers visible to the async proxy (the copy engine)
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  const int cnt = (n - lane + lanes - 1) / lanes;  // this lane's rows: lane + k * lanes
  uint32_t live = 0, phase = 0;  // bits per slot: a fetch in flight; the parity it completes
  bool any_bad = false;
  auto issue = [&](int k) {
    const int v = idx[r0 + lane + k * lanes];
    if (v < 0 || v >= rows) {
      any_bad = true;
      return;
    }
    const int slot = k % nsl;
    const uint32_t bar = bar0 + 8 * slot;
    live |= 1u << slot;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(ring + slot * bytes), "l"(x + (long long)v * d), "r"(bytes), "r"(bar)
        : "memory");
  };
  for (int k = 0; k < min(nsl, cnt); ++k) issue(k);
  for (int k = 0; k < cnt; ++k) {
    const int slot = k % nsl;
    if ((live >> slot) & 1u) {
      const uint32_t bar = bar0 + 8 * slot, par = (phase >> slot) & 1u;
      uint32_t done = 0;
      while (!done) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(bar), "r"(par)
            : "memory");
      }
      phase ^= 1u << slot;
      live &= ~(1u << slot);
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   ::"l"(out + (long long)(r0 + lane + k * lanes) * d), "r"(ring + slot * bytes),
                   "r"(bytes)
                   : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");  // one group per row, maybe empty
    // refill the slot of row k - 1 once its store has read it (row k's may still be reading)
    if (k >= 1 && k - 1 + nsl < cnt) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      issue(k - 1 + nsl);
    }
  }
  // the stores must have read shared memory before the block exits; their
  // writes are visible once the kernel has completed
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  if (any_bad) *bad = 1;
}

}  // namespace

// x, y (n,) f32.  Returns the launch's cudaGetLastError().
extern "C" int probe_scale_shift(const void* x, void* y, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  probe_scale_shift_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n);
  return (int)cudaGetLastError();
}

// a (m, k), b (k, n), c (m, n) f32, row-major and contiguous.  16-byte
// copies where k and n are multiples of 4 and a, b 16-byte aligned.
// Returns the launch's cudaGetLastError().
extern "C" int probe_matmul(const void* a, const void* b, void* c, int m, int k, int n,
                            void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((n + MM_BN - 1) / MM_BN, (m + MM_BM - 1) / MM_BM);
  const bool vec = k % 4 == 0 && n % 4 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
  auto kernel = vec ? probe_matmul_kernel<4> : probe_matmul_kernel<1>;
  const int smem = (int)sizeof(MatmulSmem);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, MM_THREADS, smem, (cudaStream_t)stream>>>((const float*)a, (const float*)b,
                                                           (float*)c, m, k, n);
  return (int)cudaGetLastError();
}

// x (rows, d) f32 with d * 4 a multiple of 16 and at most 32768, x and out
// 16-byte aligned; idx (nb,) int32; out (nb, d) f32; bad: a device-visible
// int the kernel sets to 1 if an index lies outside [0, rows) (its row is
// then skipped).  Returns the launch's cudaGetLastError().
extern "C" int probe_row_gather(const void* x, const void* idx, void* out, void* bad, int nb,
                                int rows, int d, void* stream) {
  if (nb <= 0) return 0;
  const int bytes = d * 4;
  int nsl = GATHER_RING_BYTES / (32 * bytes);
  nsl = nsl < 2 ? 2 : (nsl > GATHER_MAX_NSL ? GATHER_MAX_NSL : nsl);
  int lanes = GATHER_RING_BYTES / (nsl * bytes);
  lanes = lanes < 1 ? 1 : (lanes > 32 ? 32 : lanes);
  // rows spread over every block first (a short call is latency-bound),
  // then over the lanes of each
  int blocks = nb < 2 * 132 ? nb : 2 * 132;
  const int per = (nb + blocks - 1) / blocks;
  blocks = (nb + per - 1) / per;
  const int smem = GATHER_OFF_RING + lanes * nsl * bytes;
  cudaError_t err = cudaFuncSetAttribute(probe_row_gather_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  probe_row_gather_kernel<<<blocks, 32, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)idx, (float*)out, (int*)bad, nb, rows, d, lanes, nsl, per);
  return (int)cudaGetLastError();
}
