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
// output blocks of a @ b on the MXU).  On the H100 a 4 x 4 grid of 128 x 128
// tiles would occupy 16 of 132 SMs, so the tile is 64 x 64 (64 blocks at
// 512^3).  Each block stages 16-deep K chunks of A (transposed, padded: no
// bank conflicts) and B through shared memory; each of its 256 threads keeps
// a 4 x 4 micro-tile of f32 accumulators in registers, with its rows and
// columns 16 apart so that a warp's stores are coalesced.  Every output is
// one thread's f32 sum in ascending k: deterministic.  Bound: f32 operations
// on the CUDA cores (2 M N K flops over 67 TFLOP/s) — a few microseconds at
// 512^3, where the 3 MiB of operands take one.
//
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

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int MM_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(MM_THREADS) probe_matmul_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c, int m,
    int k, int n) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int e = 0; e < BM * BK / MM_THREADS; ++e) {
      const int lin = threadIdx.x + MM_THREADS * e;
      const int r = lin / BK, q = lin % BK;  // A tile row, column
      As[q][r] = (m0 + r < m && k0 + q < k) ? a[(long long)(m0 + r) * k + k0 + q] : 0.0f;
      const int rb = lin / BN, qb = lin % BN;  // B tile row, column
      Bs[rb][qb] = (k0 + rb < k && n0 + qb < n) ? b[(long long)(k0 + rb) * n + n0 + qb] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (row < m && col < n) c[(long long)row * n + col] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------ K9 ----

constexpr int GATHER_MAX_NSL = 4;      // row slots of one lane's ring
constexpr int GATHER_RING_BYTES = 98304;  // rings of one block: two blocks per SM
constexpr int GATHER_OFF_RING = 32 * GATHER_MAX_NSL * 8;  // the lanes' mbarriers first

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

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

// a (m, k), b (k, n), c (m, n) f32, row-major and contiguous.
extern "C" int probe_matmul(const void* a, const void* b, void* c, int m, int k, int n,
                            void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  probe_matmul_kernel<<<grid, MM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)c, m, k, n);
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
