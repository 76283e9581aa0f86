// K4: the compact windowed brick moment of the conv's weight gradient.
//
// Replaces the TPU kernel linr_pcgc_tpu/ops/pallas_conv.py::_moment_kernel
// (entry plane_moment(x, g, kc, no)).  For every stage s and x-plane p in
// 0..3:
//
//   m[s, p, u, j] = sum_b x[b, s, p*16*C + u] * g[b, s, p*36*O + j]
//
// with u < 16*C (plane p's slots of the activation) and j < 108*O (plane
// p's window of the halo of dy * mask), in f32.  superbricks.moment_taps
// turns m into dw.
//
// It is a GEMM with M = 16*C, N = 108*O per (stage, plane) and a long
// K = Bb (81,920 bricks at level 0 of one frame).  What bounds it on an
// H100: per brick and stage it does 2 * 4 * 16*C * 108*O flops against
// 64*C + 216*O elements read, ~395 flops per element at C = O = 8, so it is
// bound by operations; this version runs f32 FMAs on the CUDA cores (67
// TFLOP/s peak).
//
// Design.  The TPU kernel carried the sum across a sequential grid in a
// VMEM-resident accumulator; Hopper blocks run in no order, so the brick
// axis is split across blocks instead.  A block owns one (64-row M tile,
// 64-column N tile, stage, plane, brick split) and walks its bricks in
// 32-brick chunks, staging the A (x) and B (g) tiles through shared memory
// and keeping a 4 x 4 f32 accumulator per thread in registers, as K1 does.
// Each split writes its partial moment to a workspace that the caller
// allocates; a second kernel sums the partials in split order.  No atomics,
// and the split count depends on shapes only, so two runs on one input give
// the same bits.  Bricks beyond bb, rows beyond M and columns beyond N are
// read as zeros.  wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;        // moment rows (slot-channels) per block
constexpr int BN = 64;        // moment columns (window halo-channels) per block
constexpr int BK = 32;        // bricks per staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS) plane_moment_kernel(
    const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ ws, int bb,
    int s_num, int kc, int no, int rows_per_split) {
  const int M = 16 * kc;    // plane rows of x
  const int N = 108 * no;   // window columns of g
  const int UK = 64 * kc;   // x width of one stage row
  const int GK = 216 * no;  // g width of one stage row
  const int n_tiles = (N + BN - 1) / BN;
  const int mt = blockIdx.x / n_tiles;
  const int nt = blockIdx.x % n_tiles;
  const int sp = blockIdx.y;  // s * 4 + p
  const int s = sp / 4, p = sp % 4;
  const int split = blockIdx.z;
  const int m0 = mt * BM, n0 = nt * BN;
  const int b_begin = split * rows_per_split;
  const int b_end = min(bb, b_begin + rows_per_split);

  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const size_t x_stride = (size_t)s_num * UK;
  const size_t g_stride = (size_t)s_num * GK;
  const T* a_base = x + (size_t)s * UK + (size_t)p * 16 * kc + m0;
  const T* b_base = g + (size_t)s * GK + (size_t)p * 36 * no + n0;

  for (int k0 = b_begin; k0 < b_end; k0 += BK) {
    for (int i = threadIdx.x; i < BK * BM; i += THREADS) {
      const int k = i / BM, m = i % BM;
      const int row = k0 + k;
      As[k][m] = (row < b_end && m0 + m < M) ? to_f(a_base[(size_t)row * x_stride + m]) : 0.f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN;
      const int row = k0 + k;
      Bs[k][n] = (row < b_end && n0 + n < N) ? to_f(b_base[(size_t)row * g_stride + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = ws + ((size_t)split * s_num * 4 + sp) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// m[i] = sum over splits, in split order, of ws[split * total + i].
__global__ void split_sum_kernel(const float* __restrict__ ws, float* __restrict__ m,
                                 long long total, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int k = 0; k < splits; ++k) v += ws[(size_t)k * total + i];
    m[i] = v;
  }
}

template <typename T>
int launch(const void* x, const void* g, void* ws, void* m, int bb, int s_num, int kc, int no,
           int splits, void* stream) {
  const long long total = (long long)s_num * 4 * 16 * kc * 108 * no;
  if (s_num <= 0 || total <= 0) return 0;
  if (splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows_per_split = ((bb + splits - 1) / splits + BK - 1) / BK * BK;
  const int m_tiles = (16 * kc + BM - 1) / BM;
  const int n_tiles = (108 * no + BN - 1) / BN;
  dim3 grid(m_tiles * n_tiles, s_num * 4, splits);
  plane_moment_kernel<T><<<grid, THREADS, 0, st>>>((const T*)x, (const T*)g, (float*)ws, bb,
                                                   s_num, kc, no, rows_per_split);
  int err = (int)cudaGetLastError();
  if (err) return err;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  split_sum_kernel<<<(unsigned)blocks, 256, 0, st>>>((const float*)ws, (float*)m, total, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x (bb, s, 64*kc), g (bb, s, 216*no) of one dtype, contiguous; ws
// (splits, s, 4, 16*kc, 108*no) f32 scratch; m (s, 4, 16*kc, 108*no) f32.
// Returns the first failing launch's cudaGetLastError().
extern "C" int plane_moment_f32(const void* x, const void* g, void* ws, void* m, int bb,
                                int s_num, int kc, int no, int splits, void* stream) {
  return launch<float>(x, g, ws, m, bb, s_num, kc, no, splits, stream);
}

extern "C" int plane_moment_bf16(const void* x, const void* g, void* ws, void* m, int bb,
                                 int s_num, int kc, int no, int splits, void* stream) {
  return launch<__nv_bfloat16>(x, g, ws, m, bb, s_num, kc, no, splits, stream);
}
