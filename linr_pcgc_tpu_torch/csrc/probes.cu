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
// prefetched as scalars, one DMA per row behind a semaphore).  The Hopper
// form: one block per output row loads its own index; one thread arms an
// mbarrier in shared memory with the row's byte count (expect_tx) and issues
// one bulk asynchronous copy (cp.async.bulk, the TMA's linear form) of the
// row x[idx[i]] from global to shared memory, completing on that barrier;
// the block waits on the barrier's phase and writes the row out.  The copy
// needs 16-byte-aligned source, destination and size: the wrapper checks the
// row width and the alignment and raises otherwise, and checks idx's range
// before launch.  Bound: bytes (each gathered row read once, written once).

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

constexpr int GATHER_THREADS = 256;

__global__ void __launch_bounds__(GATHER_THREADS) probe_row_gather_kernel(
    const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out, int d) {
  __shared__ __align__(8) uint64_t bar;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* buf = reinterpret_cast<const float*>(smem);
  const int row = blockIdx.x;
  const uint32_t bytes = (uint32_t)d * 4u;
  const uint32_t bar_addr = (uint32_t)__cvta_generic_to_shared(&bar);
  const uint32_t buf_addr = (uint32_t)__cvta_generic_to_shared(smem);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_addr) : "memory");
    // make the initialised barrier visible to the async proxy (the copy engine)
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float* src = x + (long long)idx[row] * d;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar_addr), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(buf_addr), "l"(src), "r"(bytes), "r"(bar_addr)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {  // phase 0 completes when the arrival and all the bytes are in
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar_addr), "r"(0u)
        : "memory");
  }
  float* dst = out + (long long)row * d;
  for (int j = threadIdx.x; j < d; j += GATHER_THREADS) dst[j] = buf[j];
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

// x (rows, d) f32 with d * 4 a multiple of 16 and x 16-byte aligned; idx
// (nb,) int32, every entry in [0, rows); out (nb, d) f32.
extern "C" int probe_row_gather(const void* x, const void* idx, void* out, int nb, int d,
                                void* stream) {
  if (nb <= 0) return 0;
  probe_row_gather_kernel<<<nb, GATHER_THREADS, (size_t)d * 4, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)idx, (float*)out, d);
  return (int)cudaGetLastError();
}
