// K1 and K3: the plane-blocked slot-major 3^3 brick conv product.
//
// K1 (EPI = true) replaces the TPU kernel
// linr_pcgc_tpu/ops/pallas_conv.py::_fwd_bm_kernel (entry
// plane_matmul(h, w2, kc, no, bias, mask)), the conv forward with the bias +
// slot-mask epilogue fused.  K3 (EPI = false) replaces _fwd_kernel (entry
// plane_matmul(h, w2, kc, no)), the same product with no epilogue, which the
// conv's backward runs for dx = halo(dy * mask) @ Wt (flipped taps, C and O
// swapped, so there kc = O and no = C).  For every brick row b, stage s and
// output x-plane p in 0..3:
//
//   acc = sum_k h[b, s, p*36*C + k] * w2[s, p*36*C + k, p*16*O + n]
//   y[b, s, p*16*O + n] = EPI ? (acc + bias[s, p*16*O + n]) * mask[b, p*16 + n / O]
//                             : acc
//
// with k < 108*C (the halo planes p, p+1, p+2) and n < 16*O: four products
// of depth 108*C instead of the dense 216*C x 64*O one.
//
// What bounds it on an H100: per (row, stage) the windowed product does
// 13824*C*O flops against 216*C + 64*O elements moved.  At C = 12, O = 8 in
// bf16 that is ~214 flops per byte, under the ~295 at which the bf16 tensor
// cores stop being the limit, so a tensor-core kernel would be bound by the
// halo's HBM bytes.  This version runs on the CUDA cores (f32 FMA, 67 TFLOP/s
// peak), where the same work is bound by operations.
//
// This first version is simple and right: a tiled GEMM per
// (row tile, stage, plane, 64-column tile) with the A (halo window) and B
// (weight window) tiles staged through shared memory over K chunks, f32
// accumulation in registers on the CUDA cores, and the epilogue applied in
// registers with one write of y.  It re-reads each A tile once per column
// tile and computes the 75% structural zeros inside each window; wgmma, TMA
// and skipping those zeros are later work.
//
// Determinism: every output is one thread's f32 sum in a fixed k order; no
// atomics, and the launch configuration depends on shapes only, so the
// encoder and decoder produce identical bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;        // brick rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // K chunk staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, bool EPI>
__global__ void __launch_bounds__(THREADS) plane_matmul_bm_kernel(
    const T* __restrict__ h, const T* __restrict__ w2, const T* __restrict__ bias,
    const T* __restrict__ mask, T* __restrict__ y, int bb, int s_num, int kc, int no) {
  const int K = 108 * kc;   // window depth
  const int N = 16 * no;    // columns of one output plane
  const int HK = 216 * kc;  // halo width of one stage row
  const int NN = 64 * no;   // output width of one stage row
  const int n_tiles = (N + BN - 1) / BN;
  int z = blockIdx.y;
  const int nt = z % n_tiles;
  z /= n_tiles;
  const int p = z % 4;
  const int s = z / 4;
  const int row0 = blockIdx.x * BM;
  const int n0 = nt * BN;

  __shared__ float As[BK][BM + 1];  // transposed A tile, padded: no bank conflicts
  __shared__ float Bs[BK][BN];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const size_t row_stride = (size_t)s_num * HK;
  const T* a_base = h + (size_t)s * HK + (size_t)p * 36 * kc;
  const T* b_base = w2 + (size_t)s * HK * NN + (size_t)p * 36 * kc * NN + (size_t)p * N;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK;
      const int row = row0 + m, kk = k0 + k;
      As[k][m] = (row < bb && kk < K) ? to_f(a_base[(size_t)row * row_stride + kk]) : 0.f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN;
      const int kk = k0 + k, nn = n0 + n;
      Bs[k][n] = (kk < K && nn < N) ? to_f(b_base[(size_t)kk * NN + nn]) : 0.f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= bb) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const int col = p * N + n;
      float v = acc[i][j];
      if (EPI) {
        const float bv = to_f(bias[(size_t)s * NN + col]);
        const float mv = to_f(mask[(size_t)row * 64 + p * 16 + n / no]);
        v = (v + bv) * mv;
      }
      y[((size_t)row * s_num + s) * NN + col] = from_f<T>(v);
    }
  }
}

template <typename T, bool EPI>
int launch(const void* h, const void* w2, const void* bias, const void* mask, void* y,
           int bb, int s_num, int kc, int no, void* stream) {
  if (bb <= 0 || s_num <= 0) return 0;
  const int n_tiles = (16 * no + BN - 1) / BN;
  dim3 grid((bb + BM - 1) / BM, s_num * 4 * n_tiles);
  plane_matmul_bm_kernel<T, EPI><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)h, (const T*)w2, (const T*)bias, (const T*)mask, (T*)y, bb, s_num, kc, no);
  return (int)cudaGetLastError();
}

}  // namespace

// h (bb, s, 216*kc), w2 (s, 216*kc, 64*no), bias (s, 64*no), mask (bb, 64),
// y (bb, s, 64*no), all contiguous and of one dtype.  Returns the launch's
// cudaGetLastError().
extern "C" int plane_matmul_bm_f32(const void* h, const void* w2, const void* bias,
                                   const void* mask, void* y, int bb, int s_num, int kc,
                                   int no, void* stream) {
  return launch<float, true>(h, w2, bias, mask, y, bb, s_num, kc, no, stream);
}

extern "C" int plane_matmul_bm_bf16(const void* h, const void* w2, const void* bias,
                                    const void* mask, void* y, int bb, int s_num, int kc,
                                    int no, void* stream) {
  return launch<__nv_bfloat16, true>(h, w2, bias, mask, y, bb, s_num, kc, no, stream);
}

// K3: h (bb, s, 216*kc), w2 (s, 216*kc, 64*no), y (bb, s, 64*no), all
// contiguous and of one dtype; no epilogue.
extern "C" int plane_matmul_f32(const void* h, const void* w2, void* y, int bb, int s_num,
                                int kc, int no, void* stream) {
  return launch<float, false>(h, w2, nullptr, nullptr, y, bb, s_num, kc, no, stream);
}

extern "C" int plane_matmul_bf16(const void* h, const void* w2, void* y, int bb, int s_num,
                                 int kc, int no, void* stream) {
  return launch<__nv_bfloat16, false>(h, w2, nullptr, nullptr, y, bb, s_num, kc, no, stream);
}
