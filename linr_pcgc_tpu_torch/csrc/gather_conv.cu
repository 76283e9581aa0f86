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
// read by up to K neighbours, from L2 after the first) and y (4 Cout N):
// 0.040 ms at N 786,432, K 27, Cin = Cout = 8, against 2 Cin Cout FMA
// operations per present tap (~7.4 taps a voxel of a surface, 0.012 ms on
// the f32 CUDA cores).  Measured (tools/probe_k10_k11.py, the design before
// this one, 0.137 ms): without its FMAs 0.063 ms, without its x loads
// 0.096, its index loads alone 0.047.  The FMAs cost the most because a
// warp walks the taps in step: a tap present at one lane issues the 64
// FMAs and 16 weight reads for all 32, and 99 % of a surface's warp-taps
// have a lane present, so the issue of 27 taps buys 7.4.  The plain
// version's gathered (K, N, Cin) tensor, 1.1 GB at N 1.25 M, never exists.
//
// Design: the index and x latency off the chain, the FMAs and their order
// kept.
//  * one thread a node, a tile of NT (256, or 128 where shared memory is
//    short) nodes a block; the thread first issues its node's K index words
//    as cp.async copies into the tile's (K, NT) index block in shared
//    memory, all in flight together (a thread reads only its own column,
//    so no barrier and no alignment are needed), while the block copies its
//    chunk's columns of w into shared memory;
//  * a ring of R = 2 x rows per thread in shared memory: at tap t the
//    thread issues tap t + 1's row as cp.async (16-byte pieces where Cin is
//    4, 8 or 16; nothing for an absent tap), each tap its own commit group;
//    the ring is laid out (slot, channel group, thread), so a warp's reads
//    of it are contiguous;
//  * the warp walks the taps in step, so each read of w is one 16-byte
//    broadcast (a float4 of four outputs) to the warp;
//  * a thread accumulates its chunk's outputs in registers, taps in order,
//    channels in order, f32 FMAs, then adds the bias: the order of the
//    design before, so the outputs keep their bits (the codec's encoder and
//    decoder must agree; tools/k10_digest.py compares two checkouts), and
//    two launches give the same bits, with no atomics;
//  * the outputs come in chunks of CH = 4 or 8 channels (grid.y, the last
//    one masked: zero weights, its missing outputs never stored); Cin is a
//    template parameter at 4, 8 and 16 (float4 rows) and a runtime loop
//    otherwise (the context blocks' conv_in reads the 1-7 bits coded so
//    far); the channels are summed in the same order either way.
// It runs at the design before's time (0.13 ms at K 27): the latency it
// takes off was hidden by the FMA issue.  Tried and measured slower or no
// faster (PERF.md): deeper rings (4, 8), persistent blocks with a producer
// warp streaming the next tile's index block behind mbarriers, and each
// thread walking only its own present taps (per-lane weight reads: 0.16 ms).
//
// The launch plan (the chunk, NT, the shared memory) comes from the shapes
// alone (ops/gather_conv.py::k10_plan).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 227 * 1024;  // a block's most shared memory, after opting in

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// bytes of the index block, rounded up to 16
__host__ __device__ __forceinline__ size_t idx_bytes(int k, int nt) {
  return ((size_t)k * nt * 4 + 15) / 16 * 16;
}

// blockIdx.x: a tile of NT nodes, one a thread; blockIdx.y: outputs [o0, o0
// + CH) of the cout, the missing ones of the last chunk computed on zero
// weights and never stored.  Shared memory: the (K, NT) index block, the
// chunk's w (K, cin, CH), the ring (R, cin, NT) (as float4 (R, cin / 4, NT)
// where CIN > 0).
template <int CIN, int CH, int R, int NT>
__global__ void __launch_bounds__(NT)
gather_conv_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   const float* __restrict__ w, const float* __restrict__ b,
                   float* __restrict__ y, int n, int k, int cin_rt, int cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cin = CIN > 0 ? CIN : cin_rt;
  int* idx_s = reinterpret_cast<int*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + idx_bytes(k, NT));
  float* ring = w_s + (size_t)k * cin * CH;
  const int tid = threadIdx.x;
  const int node = blockIdx.x * NT + tid;
  const bool live = node < n;

  // the node's K index words, all in flight together (a thread reads only
  // its own column: no barrier, no alignment needed)
  if (live)
    for (int t = 0; t < k; ++t) cp4(idx_s + t * NT + tid, idx + (size_t)t * n + node);
  cp_commit();
  // the chunk's columns of w, meanwhile
  const int o0 = blockIdx.y * CH;
  const int wn = k * cin * CH;
  for (int i = tid; i < wn; i += NT) {
    const int o = o0 + i % CH;
    w_s[i] = o < cout ? w[(size_t)(i / CH) * cout + o] : 0.0f;
  }
  cp_wait<0>();
  __syncthreads();
  if (!live) return;

  // tap t's x row into ring slot t % R (nothing for an absent tap); one
  // commit group a tap, empty or not, so that wait_group counts taps
  auto issue = [&](int t) {
    if (t < k) {
      const int j = idx_s[t * NT + tid];
      if (j >= 0) {
        const float* src = x + (size_t)j * cin;
        float* dst = ring + (size_t)(t % R) * cin * NT;
        if constexpr (CIN > 0 && CIN % 4 == 0) {
#pragma unroll
          for (int c4 = 0; c4 < CIN / 4; ++c4) cp16(dst + (c4 * NT + tid) * 4, src + 4 * c4);
        } else {
          for (int c = 0; c < cin; ++c) cp4(dst + c * NT + tid, src + c);
        }
      }
    }
    cp_commit();
  };

  float acc[CH];
#pragma unroll
  for (int o = 0; o < CH; ++o) acc[o] = 0.0f;
#pragma unroll
  for (int t = 0; t < R - 1; ++t) issue(t);
  for (int t = 0; t < k; ++t) {
    issue(t + R - 1);  // refills the slot of tap t - 1, read in the step before
    cp_wait<R - 1>();  // tap t's group has landed
    if (idx_s[t * NT + tid] < 0) continue;
    const float* xr = ring + (size_t)(t % R) * cin * NT;
    const float* wt = w_s + (size_t)t * cin * CH;
    if constexpr (CIN > 0 && CIN % 4 == 0) {
#pragma unroll
      for (int c4 = 0; c4 < CIN / 4; ++c4) {
        const float4 v = *reinterpret_cast<const float4*>(xr + (c4 * NT + tid) * 4);
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* wr = wt + (4 * c4 + q) * CH;
#pragma unroll
          for (int o4 = 0; o4 < CH; o4 += 4) {
            const float4 wv = *reinterpret_cast<const float4*>(wr + o4);
            acc[o4] = fmaf(xv[q], wv.x, acc[o4]);
            acc[o4 + 1] = fmaf(xv[q], wv.y, acc[o4 + 1]);
            acc[o4 + 2] = fmaf(xv[q], wv.z, acc[o4 + 2]);
            acc[o4 + 3] = fmaf(xv[q], wv.w, acc[o4 + 3]);
          }
        }
      }
    } else {
      for (int c = 0; c < cin; ++c) {
        const float xv = xr[c * NT + tid];
        const float* wr = wt + c * CH;
#pragma unroll
        for (int o4 = 0; o4 < CH; o4 += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(wr + o4);
          acc[o4] = fmaf(xv, wv.x, acc[o4]);
          acc[o4 + 1] = fmaf(xv, wv.y, acc[o4 + 1]);
          acc[o4 + 2] = fmaf(xv, wv.z, acc[o4 + 2]);
          acc[o4 + 3] = fmaf(xv, wv.w, acc[o4 + 3]);
        }
      }
    }
  }
  cp_wait<0>();  // no copy outlives the thread

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

template <int CIN, int CH, int R, int NT>
int launch(const float* x, const int* idx, const float* w, const float* b, float* y, int n,
           int k, int cin, int cout, cudaStream_t stream) {
  const size_t smem = idx_bytes(k, NT) + sizeof(float) * ((size_t)k * cin * CH + (size_t)R * cin * NT);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(gather_conv_kernel<CIN, CH, R, NT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n + NT - 1) / NT, (cout + CH - 1) / CH);
  gather_conv_kernel<CIN, CH, R, NT><<<grid, NT, smem, stream>>>(x, idx, w, b, y, n, k, cin, cout);
  return (int)cudaGetLastError();
}

template <int CH, int R, int NT>
int launch_cin(const float* x, const int* idx, const float* w, const float* b, float* y, int n,
               int k, int cin, int cout, cudaStream_t stream) {
  // 16-byte row copies need x's base aligned: torch's allocations are
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (cin == 16 && aligned) return launch<16, CH, R, NT>(x, idx, w, b, y, n, k, cin, cout, stream);
  if (cin == 8 && aligned) return launch<8, CH, R, NT>(x, idx, w, b, y, n, k, cin, cout, stream);
  if (cin == 4 && aligned) return launch<4, CH, R, NT>(x, idx, w, b, y, n, k, cin, cout, stream);
  return launch<0, CH, R, NT>(x, idx, w, b, y, n, k, cin, cout, stream);
}

// the ring holds 2 rows a thread: one tap's row in flight ahead of the
// FMAs (deeper rings, 4 and 8, measured no faster: the kernel is bound by
// its FMA issue, see the head note)
template <int CH>
int launch_plan(const float* x, const int* idx, const float* w, const float* b, float* y, int n,
                int k, int cin, int cout, int threads, cudaStream_t s) {
  if (threads == 256) return launch_cin<CH, 2, 256>(x, idx, w, b, y, n, k, cin, cout, s);
  if (threads == 128) return launch_cin<CH, 2, 128>(x, idx, w, b, y, n, k, cin, cout, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// chunk: the outputs a block computes, 4 or 8; threads: nodes a block, 256
// or 128 (ops/gather_conv.py::k10_plan).  Returns cudaErrorInvalidValue for
// a shape or plan the kernel does not take (a block's shared memory past
// the card's, no channels).
extern "C" int gather_conv_f32(const void* x, const void* idx, const void* w, const void* b,
                               void* y, int n, int k, int cin, int cout, int chunk, int threads,
                               void* stream) {
  const float* xf = static_cast<const float*>(x);
  const int* ix = static_cast<const int*>(idx);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1 || cin < 1 || cout < 1) return (int)cudaErrorInvalidValue;
  switch (chunk) {
    case 4: return launch_plan<4>(xf, ix, wf, bf, yf, n, k, cin, cout, threads, s);
    case 8: return launch_plan<8>(xf, ix, wf, bf, yf, n, k, cin, cout, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
