// K11: the weight gradient of the skinny convs, on both trainers.
//
// Replaces XLA work on the TPU (no Pallas twin): the weight gradient of
// linr_pcgc_tpu/models/sb_network.py:205 sbconv1 (the superbrick trainer's
// 1^3 convs), of models/network.py:375 _conv1 (the gather backend's 1^3
// convs and MLP heads) and of models/network.py:412 _conv3_op_bwd (its
// dot_general :431 over _gather_nbrs: the gather conv's dw).  One function
// covers the three:
//
//     dw[g, c, o] = sum_r x[xrow_g(r), c] * dy[dyrow_g(r), o]
//
//  * superbrick form (wgrad_sb_f32, wgrad_sb_bf16): x (Bb, S, 64*C) and dy
//    (Bb, S, 64*O) slot-major, one dtype; the group g is the stage s, r runs
//    over the Bb*64 slot rows of stage s (row (r / 64, s, r % 64) of both);
//    dw (S, C, O) in x's dtype, rounded once from the f32 sum;
//  * gather form (wgrad_gather_f32): x (N, Cin) and dy (N, Cout) f32
//    node-major, idx (K, N) int32 or null; the group g is the tap k, r the
//    node, x's row idx[k, r] (-1: absent, no term) or r itself (null: K = 1,
//    the 1^3 conv); dw (K, Cin, Cout) f32.
//
// What bounds it on an H100: the bytes.  x and dy are read once at 2-12
// flop a byte, under the f32 CUDA cores' 67 TFLOP/s over 3.35 TB/s (20): at
// the superbrick trainer's level 0 (Bb 81,920, S 4-5, C, O <= 24, bf16)
// 0.1-0.4 ms a call.  In the gather form idx is most of the bytes; x's rows
// come through the map from L2, as K10 reads them.  The library's product
// of the same function has a (C, O) <= 24 output, so few tiles and few CTAs
// (cuBLAS's few-tile GEMMs, ~45 ms a call at the superbrick level 0), and
// the plain gather form materialises the gathered (K, N, Cin) tensor.
//
// Design, simple and near the bytes:
//  * persistent blocks: each group's rows are cut into `ranges` contiguous
//    ranges of per_range rows (a multiple of 512); block (p, g, t) walks
//    range p of group g for output tile t, with t fastest, then g, so the
//    blocks that share a range run side by side and a range's dy rows (and,
//    in the gather form, x's rows through the map) come from L2 after the
//    first read; about two blocks of 256 threads an SM, the plan from the
//    shapes alone (ops/wgrad.py::wgrad_plan);
//  * a thread owns rows r0 + tid + 256 i of its block's range and a CT x OT
//    output tile (8x8, 8x4, 4x4 or 32x2) in registers: it reads its rows'
//    tile columns of x and dy (16-byte loads where the rows allow, bf16
//    widened exactly to f32) and adds the CT x OT products with f32 FMAs,
//    rows in order, two rows' loads in flight (one at 32x2); no shared
//    memory in the loop;
//  * any (C, O): the tiles cover C x O, the last ones masked (zero inputs,
//    outputs never stored);
//  * fixed-order sums, no atomics (K4's pattern, csrc/plane_moment.cu):
//    each thread's sum in row order, then a warp's 32 by a shuffle butterfly
//    (lane 0's value), the warps in warp order through shared memory into a
//    per-block partial (ranges, G, C, O) f32, then a second kernel sums the
//    ranges in range order and rounds once to dw's dtype.  The plan comes
//    from the shapes alone, so two launches give the same bits, and two
//    trainings of one GOP the same checkpoint.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Args {
  const void* x;
  const void* dy;
  const int* idx;       // gather form: the (G, rows) map, or null; superbrick form: null
  float* part;          // (ranges, G, C, O) per-block partial sums
  long long rows;       // rows of each group: Bb * 64, or N
  long long per_range;  // rows of each block's range
  int groups, c, o;     // G (S or K), x's and dy's channels
  int tiles_o, tiles;   // output tiles along O, and in all
};

// element storage: f32 as itself, bf16 as its 16 bits
template <bool BF16>
struct Elem {
  using S = float;
};
template <>
struct Elem<true> {
  using S = uint16_t;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }

// bytes of the vector chunks in which N elements of S are read
template <typename S, int N>
struct Chunk {
  static constexpr int ESZ = (int)sizeof(S);
  static constexpr int VB = N * ESZ >= 16 ? 16 : N * ESZ;
  static constexpr int PER = VB / ESZ;  // elements of one chunk
  static constexpr int WORDS = VB / 4;  // its 32-bit words (0: a lone bf16)
};

// rows of `width` elements from `base` can be read in whole chunks
template <typename S, int N>
__device__ __forceinline__ bool can_vec(const S* base, int width) {
  using K = Chunk<S, N>;
  return K::WORDS > 0 && reinterpret_cast<uintptr_t>(base) % K::VB == 0 &&
         ((long long)width * K::ESZ) % K::VB == 0;
}

// v[e] = p[e] for e < valid, 0 beyond; whole chunks by vector loads where
// `vec` says the row allows them
template <typename S, int N>
__device__ __forceinline__ void load_row(const S* __restrict__ p, int valid, bool vec,
                                         float (&v)[N]) {
  using K = Chunk<S, N>;
#pragma unroll
  for (int q = 0; q < N / K::PER; ++q) {
    if (K::WORDS > 0 && vec && (q + 1) * K::PER <= valid) {
      uint32_t w[K::WORDS > 0 ? K::WORDS : 1];
      const S* src = p + q * K::PER;
      if constexpr (K::VB == 16) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
        w[0] = u.x;
        w[1] = u.y;
        w[2] = u.z;
        w[3] = u.w;
      } else if constexpr (K::VB == 8) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
        w[0] = u.x;
        w[1] = u.y;
      } else if constexpr (K::VB == 4) {
        w[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
      }
#pragma unroll
      for (int j = 0; j < K::WORDS; ++j) {
        if constexpr (K::ESZ == 4) {
          v[q * K::PER + j] = __uint_as_float(w[j]);
        } else {
          v[q * K::PER + 2 * j] = __uint_as_float(w[j] << 16);
          v[q * K::PER + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < K::PER; ++i) {
        const int e = q * K::PER + i;
        v[e] = e < valid ? widen(__ldg(p + e)) : 0.0f;
      }
    }
  }
}

template <bool BF16, bool GATHER, int CT, int OT>
__global__ void __launch_bounds__(THREADS, 2) wgrad_kernel(const Args a) {
  using S = typename Elem<BF16>::S;
  // rows whose loads are in flight together, within ~100 live registers
  constexpr int U = 2 * (CT + OT) + CT * OT <= 100 ? 2 : 1;
  int bid = blockIdx.x;
  const int t = bid % a.tiles;
  bid /= a.tiles;
  const int g = bid % a.groups;
  const int p = bid / a.groups;
  const int c0 = (t / a.tiles_o) * CT, o0 = (t % a.tiles_o) * OT;
  const int cv = min(CT, a.c - c0), ov = min(OT, a.o - o0);
  const S* __restrict__ x = static_cast<const S*>(a.x);
  const S* __restrict__ dy = static_cast<const S*>(a.dy);
  const bool vx = can_vec<S, CT>(x, a.c), vd = can_vec<S, OT>(dy, a.o);

  float acc[CT][OT];
#pragma unroll
  for (int i = 0; i < CT; ++i)
#pragma unroll
    for (int j = 0; j < OT; ++j) acc[i][j] = 0.0f;

  const long long r_end = min(a.rows, (long long)(p + 1) * a.per_range);
  for (long long r = (long long)p * a.per_range + threadIdx.x; r < r_end;
       r += (long long)U * THREADS) {
    float xv[U][CT], dv[U][OT];
    bool on[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long ru = r + (long long)u * THREADS;
      long long xr = -1, dr = ru;
      if (ru < r_end) {
        if constexpr (GATHER) {
          xr = a.idx != nullptr ? (long long)__ldg(a.idx + (size_t)g * a.rows + ru) : ru;
        } else {
          xr = ((ru >> 6) * a.groups + g) * 64 + (ru & 63);
          dr = xr;
        }
      }
      on[u] = xr >= 0;
      if (on[u]) {
        load_row<S, CT>(x + xr * a.c + c0, cv, vx, xv[u]);
        load_row<S, OT>(dy + dr * a.o + o0, ov, vd, dv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!on[u]) continue;
#pragma unroll
      for (int i = 0; i < CT; ++i)
#pragma unroll
        for (int j = 0; j < OT; ++j) acc[i][j] = fmaf(xv[u][i], dv[u][j], acc[i][j]);
    }
  }

  // a warp's sums by a butterfly (lane 0's value), then the warps in order
  __shared__ float red[WARPS][CT * OT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < CT; ++i)
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      float v = acc[i][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][i * OT + j] = v;
    }
  __syncthreads();
  for (int e = threadIdx.x; e < CT * OT; e += THREADS) {
    const int i = e / OT, j = e % OT;
    if (i >= cv || j >= ov) continue;
    float v = 0.0f;
    for (int w = 0; w < WARPS; ++w) v += red[w][e];
    a.part[(((size_t)p * a.groups + g) * a.c + c0 + i) * a.o + o0 + j] = v;
  }
}

// dw[i] = the sum over the ranges, in range order, of part[p * n + i],
// rounded once to dw's dtype
template <bool BF16>
__global__ void part_sum_kernel(const float* __restrict__ part, void* __restrict__ dw, int n,
                                int ranges) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int p = 0; p < ranges; ++p) v += part[(size_t)p * n + i];
    if constexpr (BF16) {
      static_cast<__nv_bfloat16*>(dw)[i] = __float2bfloat16_rn(v);
    } else {
      static_cast<float*>(dw)[i] = v;
    }
  }
}

template <bool BF16, bool GATHER, int CT, int OT>
int launch_tile(const Args& a, int ranges, cudaStream_t st) {
  const long long blocks = (long long)ranges * a.groups * a.tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  wgrad_kernel<BF16, GATHER, CT, OT><<<(unsigned)blocks, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool BF16, bool GATHER>
int launch(const void* x, const void* dy, const void* idx, void* part, void* dw, long long rows,
           int groups, int c, int o, int ct, int ot, int ranges, long long per_range,
           void* stream) {
  if (rows < 1 || groups < 1 || c < 1 || o < 1 || ranges < 1 || per_range < 1 ||
      (long long)ranges * per_range < rows || (long long)(ranges - 1) * per_range >= rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = {};
  a.x = x;
  a.dy = dy;
  a.idx = static_cast<const int*>(idx);
  a.part = static_cast<float*>(part);
  a.rows = rows;
  a.per_range = per_range;
  a.groups = groups;
  a.c = c;
  a.o = o;
  int err = (int)cudaErrorInvalidValue;
  if (ct > 0 && ot > 0) {
    a.tiles_o = (o + ot - 1) / ot;
    a.tiles = ((c + ct - 1) / ct) * a.tiles_o;
    if (ct == 8 && ot == 8) err = launch_tile<BF16, GATHER, 8, 8>(a, ranges, st);
    if (ct == 8 && ot == 4) err = launch_tile<BF16, GATHER, 8, 4>(a, ranges, st);
    if (ct == 4 && ot == 4) err = launch_tile<BF16, GATHER, 4, 4>(a, ranges, st);
    if (ct == 32 && ot == 2) err = launch_tile<BF16, GATHER, 32, 2>(a, ranges, st);
  }
  if (err) return err;
  const int n = groups * c * o;
  part_sum_kernel<BF16><<<(n + 255) / 256, 256, 0, st>>>(a.part, dw, n, ranges);
  return (int)cudaGetLastError();
}

}  // namespace

// Superbrick form: x (bb, S, 64*c), dy (bb, S, 64*o), contiguous, of one
// dtype; rows = bb * 64, groups = S; part (ranges, S, c, o) f32 scratch; dw
// (S, c, o) in x's dtype.  Plan (ops/wgrad.py::wgrad_plan): the register
// tile (ct, ot) in (8, 8), (8, 4), (4, 4), (32, 2), and the rows' cut into
// `ranges` ranges of per_range.  Returns the first failing launch's
// cudaGetLastError() (cudaErrorInvalidValue for a shape or plan it does not
// take).
extern "C" int wgrad_sb_f32(const void* x, const void* dy, void* part, void* dw, long long rows,
                            int groups, int c, int o, int ct, int ot, int ranges,
                            long long per_range, void* stream) {
  return launch<false, false>(x, dy, nullptr, part, dw, rows, groups, c, o, ct, ot, ranges,
                              per_range, stream);
}

extern "C" int wgrad_sb_bf16(const void* x, const void* dy, void* part, void* dw, long long rows,
                             int groups, int c, int o, int ct, int ot, int ranges,
                             long long per_range, void* stream) {
  return launch<true, false>(x, dy, nullptr, part, dw, rows, groups, c, o, ct, ot, ranges,
                             per_range, stream);
}

// Gather form: x (N, c), dy (N, o) f32 contiguous, idx (groups, N) int32 or
// null (groups = 1); rows = N; part (ranges, groups, c, o); dw (groups, c,
// o) f32.
extern "C" int wgrad_gather_f32(const void* x, const void* dy, const void* idx, void* part,
                                void* dw, long long rows, int groups, int c, int o, int ct,
                                int ot, int ranges, long long per_range, void* stream) {
  if (idx == nullptr && groups != 1) return (int)cudaErrorInvalidValue;
  return launch<false, true>(x, dy, idx, part, dw, rows, groups, c, o, ct, ot, ranges,
                             per_range, stream);
}
