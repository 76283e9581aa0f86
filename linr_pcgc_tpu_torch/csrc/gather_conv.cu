// K10: the neighbour-gather conv of the flat gather backend.
//
// Replaces linr_pcgc_tpu/models/network.py::_conv3_apply (with
// _gather_nbrs), which ran as XLA gathers + a dot_general on the TPU (no
// Pallas twin).  Computes
//
//     y[n, o] = b[o] + sum_k sum_c w[k, c, o] * x[idx[k, n], c]
//
// for x (N, Cin) f32 node-major, idx (K, N) int32 (-1: the tap is absent
// and contributes nothing), w (K, Cin, Cout) f32, b (Cout,) f32 or null,
// y (N, Cout) f32, at any Cin and Cout.  The same kernel computes the
// conv's dx (w flipped along K and transposed, no bias), as JAX's
// scatter-free VJP does; the conv's dw is K11 (csrc/wgrad.cu).
//
// What bounds it on an H100: the bytes of idx (4 K N), x (4 Cin N, each row
// read by up to K neighbours, from L2 after the first) and y (4 Cout N),
// beside 2 Cin Cout FMA operations per present tap on the CUDA cores (f32,
// 67 TFLOP/s); at K 27, Cin = Cout = 8 the two are about equal.  The plain
// version's gathered (K, N, Cin) tensor, 1.1 GB at N 1.25 M, never exists.
//
// Design, simple and right first:
//  * one thread per node, 256 nodes a block; the block copies its chunk's
//    columns of w into shared memory once (32 KB at K 125, Cin = 8 and a
//    chunk of 8); a warp reads one weight at a time, the same word in every
//    lane: a broadcast;
//  * a thread walks the taps in order and the channels in order and
//    accumulates its chunk's outputs in registers with explicit FMAs, then
//    adds the bias: a fixed order per output, whatever the chunking, so two
//    launches give the same bits, with no atomics (the codec's encoder and
//    decoder must agree);
//  * a tap's index words of the 32 nodes of a warp are contiguous; a
//    present neighbour's row is read as float4s where Cin is 4, 8 or 16;
//  * the outputs come in chunks of CH = 4 or 8 channels, a template
//    parameter, so the accumulators stay in registers: grid.y walks the
//    chunks of Cout, the last one masked (zero weights in shared memory,
//    its missing outputs never stored).  Cout 4 and 8 are one chunk; the
//    gather network at hidden_channel_conv 16 has Cout 16 and 8, its dx
//    Cin.  Cin is a template parameter at 4, 8 and 16 (float4 row reads)
//    and a runtime loop otherwise (the context blocks' conv_in reads the
//    1-7 bits coded so far); the channels are summed in the same order
//    either way.
//
// The launch plan (blocks of 256 nodes, chunks of CH outputs, shared memory
// 4 K Cin CH bytes) comes from the shapes alone
// (ops/gather_conv.py::k10_plan).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 227 * 1024;  // a block's most shared memory, after opting in

// chunk blockIdx.y: outputs [o0, o0 + CH) of the cout, the missing ones of
// the last chunk computed on zero weights and never stored
template <int CIN, int CH>
__global__ void __launch_bounds__(THREADS)
gather_conv_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   const float* __restrict__ w, const float* __restrict__ b,
                   float* __restrict__ y, int n, int k, int cin_rt, int cout) {
  extern __shared__ float w_s[];
  const int cin = CIN > 0 ? CIN : cin_rt;
  const int o0 = blockIdx.y * CH;
  const int wn = k * cin * CH;
  for (int i = threadIdx.x; i < wn; i += THREADS) {
    const int o = o0 + i % CH;
    w_s[i] = o < cout ? w[(size_t)(i / CH) * cout + o] : 0.0f;
  }
  __syncthreads();

  const int node = blockIdx.x * THREADS + threadIdx.x;
  if (node >= n) return;
  float acc[CH];
#pragma unroll
  for (int o = 0; o < CH; ++o) acc[o] = 0.0f;

  const int* col = idx + node;
  for (int t = 0; t < k; ++t) {
    const int j = __ldg(col + (size_t)t * n);
    if (j < 0) continue;
    const float* xr = x + (size_t)j * cin;
    const float* wt = w_s + t * cin * CH;
    if constexpr (CIN > 0 && CIN % 4 == 0) {
#pragma unroll
      for (int c4 = 0; c4 < CIN; c4 += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xr + c4));
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int o = 0; o < CH; ++o) acc[o] = fmaf(xv[q], wt[(c4 + q) * CH + o], acc[o]);
        }
      }
    } else {
      for (int c = 0; c < cin; ++c) {
        const float xv = __ldg(xr + c);
#pragma unroll
        for (int o = 0; o < CH; ++o) acc[o] = fmaf(xv, wt[c * CH + o], acc[o]);
      }
    }
  }
  const int nv = min(CH, cout - o0);
  if (b != nullptr) {
#pragma unroll
    for (int o = 0; o < CH; ++o)
      if (o < nv) acc[o] += __ldg(b + o0 + o);
  }
  float* yr = y + (size_t)node * cout + o0;
  if (nv == CH && cout % 4 == 0) {  // whole chunk, 16-byte aligned rows
#pragma unroll
    for (int o = 0; o < CH; o += 4)
      *reinterpret_cast<float4*>(yr + o) = make_float4(acc[o], acc[o + 1], acc[o + 2], acc[o + 3]);
  } else {
#pragma unroll
    for (int o = 0; o < CH; ++o)
      if (o < nv) yr[o] = acc[o];
  }
}

template <int CIN, int CH>
int launch(const float* x, const int* idx, const float* w, const float* b, float* y, int n,
           int k, int cin, int cout, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)k * cin * CH;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_conv_kernel<CIN, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n + THREADS - 1) / THREADS, (cout + CH - 1) / CH);
  gather_conv_kernel<CIN, CH><<<grid, THREADS, smem, stream>>>(x, idx, w, b, y, n, k, cin, cout);
  return (int)cudaGetLastError();
}

template <int CH>
int launch_cin(const float* x, const int* idx, const float* w, const float* b, float* y, int n,
               int k, int cin, int cout, cudaStream_t stream) {
  // x rows are float4-aligned only if the base is: torch's allocations are
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (cin == 16 && aligned) return launch<16, CH>(x, idx, w, b, y, n, k, cin, cout, stream);
  if (cin == 8 && aligned) return launch<8, CH>(x, idx, w, b, y, n, k, cin, cout, stream);
  if (cin == 4 && aligned) return launch<4, CH>(x, idx, w, b, y, n, k, cin, cout, stream);
  return launch<0, CH>(x, idx, w, b, y, n, k, cin, cout, stream);
}

}  // namespace

// chunk: the outputs a block computes, 4 or 8 (ops/gather_conv.py::k10_plan);
// returns cudaErrorInvalidValue for a shape the kernel does not take (a
// chunk's weights past a block's shared memory, no channels)
extern "C" int gather_conv_f32(const void* x, const void* idx, const void* w, const void* b,
                               void* y, int n, int k, int cin, int cout, int chunk,
                               void* stream) {
  const float* xf = static_cast<const float*>(x);
  const int* ix = static_cast<const int*>(idx);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1 || cin < 1 || cout < 1) return (int)cudaErrorInvalidValue;
  switch (chunk) {
    case 4: return launch_cin<4>(xf, ix, wf, bf, yf, n, k, cin, cout, s);
    case 8: return launch_cin<8>(xf, ix, wf, bf, yf, n, k, cin, cout, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
