// K4: the 3^3 brick conv's weight gradient dw, as the 27-tap stencil
// reduced over the bricks.
//
// Replaces the TPU kernel linr_pcgc_tpu/ops/pallas_conv.py::_moment_kernel
// (entry plane_moment(x, g, kc, no)), which builds the compact windowed
// moment (S, 4, 16*C, 108*O) that taps.moment_taps then reduces to dw
// through a 0/1 tap selection.  Each slot's row meets all 108 window columns
// of its plane there, and only 27 of them are its taps: 75 % of that moment
// is thrown away.  This kernel computes dw alone: for stage s, tap k < 27,
// channels c < C and o < O,
//
//   dw[s, k, c, o] = sum_b sum_{u < 64} x[b, s, u*C + c] * g[b, s, T[u][flip(k)]*O + o]
//
// with x (Bb, S, 64*C) the conv's input, g (Bb, S, 216*O) the slot-major
// halo of its masked output cotangent, T (64 x 27) the halo column that tap
// k of slot u reads (ops/taps.py::tap_columns, the table K1 and K3 read) and
// flip(k) = 26 - k, the tap of the opposite offset (taps in _DIRS order, k =
// (dx+1)*9 + (dy+1)*3 + (dz+1)): tap k pairs x at voxel u with dy at u -
// off_k (taps._sel_windows).  The kernel computes D[t] = sum x[u] *
// g[T[u][t]] and stores it as dw[26 - t].
//
// What bounds it on an H100: per (brick, stage) it reads 64*C + 216*O
// elements and does 2*64*27*C*O flops, ~50 flops per byte at C = O = 8 in
// bf16, far below the ~295 where the tensor cores become the limit: the
// bound is the bytes of x and g (0.55 ms at Bb 81,920, S 5, C = O = 8).
// Meeting it takes ~160 TFLOP/s, more than the CUDA cores give, so bf16 runs
// on the tensor cores.  The stencil's gather reads shared memory ~8 times
// per halo element, which is the second limit.  The design:
//
//   * Bytes.  Rows (brick, stage) are contiguous, stages fastest, so a tile
//     of R bricks is one contiguous range of x and one of g, each fetched by
//     one cp.async.bulk completing on the tile's mbarrier, into a ring of 2-4
//     tiles in dynamic shared memory.  Persistent blocks (at most one per SM)
//     each walk one fixed contiguous brick range, tile by tile.  Each element
//     of x and g crosses HBM once.
//   * Work split.  A warp owns one stage (all 27 taps of it) and a residue
//     class of the tile's bricks, so its accumulators are the whole dw[s]:
//     W = stages x warps-per-stage <= 10 warps per block.  More than 10
//     stages are taken in groups, one launch per group.
//   * bf16 on the tensor cores: mma.sync m16n8k16, bf16 in, f32 sums.  K =
//     the 16 in-plane slots r of one x-plane p of the brick (four k-steps a
//     row), N = C (x's channels, padded to 8), M = the 27*O (tap, channel)
//     pairs.  Tap (dx, i) of plane p reads halo x-plane q = p + 1 + dx at
//     the in-plane column of (r, i), T[p*16 + r][(dx+1)*9 + i] = (p+1+dx)*36
//     + T[r][9 + i] - 36 (tests/test_torch_conv.py checks it on the table).
//     So an A half (8 (offset, channel) pairs of one dx, 16 slots) loaded
//     from halo plane q serves the three (p, dx) with p + dx = q - 1: for
//     each half h the six planes are loaded once and feed the m16 tiles
//     (dx = -1 | dx = 0) of half h at all four planes, then the dx = +1
//     halves pair among themselves (the K1/K3 share pattern with M and K
//     swapped): 14 m-tiles at O = 8, 8 at O = 4.  At O = 8 a half is
//     16-byte halo rows, loaded by ldmatrix.x4.trans from per-lane row
//     addresses off the table (two planes per instruction); at C = 8 the x
//     fragments come by ldmatrix.x4.trans too.  Other O and C (the 8-byte
//     and 24-byte rows of (4, 4) and (12, 8)) load 16-bit elements from
//     per-lane offsets.  One warp holds all 27 taps of its stage: 56 f32
//     accumulators at C = O = 8, 112 at C = 12 (two n-tiles).
//   * f32 stays on the CUDA cores (TF32 would miss the 1e-5 tolerance): a
//     lane owns channel o = lane % O and every (32/O)-th tap, all C input
//     channels, and walks the 64 slots with FFMA.
//   * Any other (C, O), in either dtype, runs a runtime-shaped CUDA-core
//     form over chunks of 512 outputs (grid.y), each chunk re-reading the
//     data: for shapes off the main path.
//
// Determinism: no floating-point atomics.  Each warp's sums run in a fixed
// row order; the warps of one stage are summed in warp order through shared
// memory into a per-block partial (blocks, S, 27*C*O); a second kernel sums
// the partials in block order.  The plan (tile, ring, blocks, ranges) comes
// from the shapes alone (ops/plane_conv.py::moment_plan), so two launches
// give the same bits and two trainings of one GOP the same checkpoint.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 64;
constexpr int TAPS = 27;
constexpr int MAX_WARPS = 10;
constexpr int MAX_THREADS = MAX_WARPS * 32;
constexpr int SMEM_BLOCK = 232448 - 1024;  // one block per SM, less the runtime's reserve
constexpr int OFF_TAB = 128;               // mbarriers at the front, then the table
constexpr int OFF_RING = 3584;             // 128 + 64*27*2, rounded up to 128
constexpr int CHUNK = 512;                 // outputs per chunk of the runtime-shaped form

enum Path { TC = 0, F32 = 1, GENERIC = 2 };

struct TapTable {
  uint8_t f[SLOTS * TAPS];  // T[u][k]: halo column read by tap k of slot u
};

struct Args {
  const void* x;
  const void* g;
  float* part;             // (blocks, s_num, total) per-block partial dw
  int bb, s_num, kc, no, total;  // total = 27 * kc * no
  int s_lo, s_n, wps;      // stages [s_lo, s_lo + s_n) of this launch; warps per stage
  int tile_bricks, nst, per_block;
  int xrow, grow;          // bytes of one (brick, stage) row of x, of g
  int slot_bytes, nout;    // ring slot bytes; outputs per warp (reduction stride)
};

// ------------------------------------------------------------ PTX helpers --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                             uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += A (16 x 16) * B (16 x 8), bf16 in, f32 sum.  Fragments (g = lane / 4,
// t = lane % 4): a0 rows g, k 2t..2t+1; a1 rows g + 8, same k; a2, a3 the
// same rows at k + 8; b0 k 2t..2t+1, column g; b1 k + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// ------------------------------------------------------ bf16 tensor cores --

// Halves: the 9*O (offset i, channel o) pairs of one dx, flat f = i*O + o,
// cut into NH = ceil(9*O / 8) halves of 8 M-rows.  Tiles j < NH: rows 0-7
// half j at dx = -1, rows 8-15 half j at dx = 0; tiles NH + jj: rows 0-7
// half 2*jj at dx = +1, rows 8-15 half 2*jj + 1 at dx = +1 (padding past
// NH).  A thread's register v[kh] of half h holds M-row g of the half, slots
// r = 2t + 8*kh and r + 1.
template <int C, int O>
struct TcOp {
  static constexpr int NH = (9 * O + 7) / 8;
  static constexpr int NTILE = NH + (NH + 1) / 2;
  static constexpr int NT = (C + 7) / 8;
  static constexpr int PLANE = 36 * O * 2;  // bytes of one halo x-plane of g
  static constexpr uint32_t NONE = 0xffffffffu;
  float acc[NTILE][NT][4];
  // O == 8: aoff[h][0][0] is this lane's ldmatrix row address in a plane
  // pair (plane q + lane / 16, slot lane % 16).  Otherwise the byte offset in
  // halo plane q of element e of register kh of half h (NONE: padding).
  uint32_t aoff[NH][2][2];
  int lane, g, t;
  int out0 = 0, nvalid = TAPS * C * O;

  __device__ __forceinline__ TcOp(const Args&, const TapTable& tab) {
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
#pragma unroll
    for (int i = 0; i < NTILE; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (O == 8) {
            aoff[h][kh][e] = (uint32_t)((lane >> 4) * 36 + tab.f[(lane & 15) * TAPS + 9 + h] - 36) * 16u;
            continue;
          }
          const int f = 8 * h + g, r = 2 * t + 8 * kh + e;
          aoff[h][kh][e] = f < 9 * O
              ? (uint32_t)((tab.f[r * TAPS + 9 + f / O] - 36) * O + f % O) * 2u : NONE;
        }
  }

  __device__ __forceinline__ void stage(unsigned char*) {}

  // half h of the six halo planes: hq[q][kh]
  __device__ __forceinline__ void load_half(const unsigned char* gr, int h,
                                            uint32_t (&hq)[6][2]) const {
    if (O == 8) {
      const uint32_t base = smem_u32(gr) + aoff[h][0][0];
#pragma unroll
      for (int qq = 0; qq < 3; ++qq)
        ldm_x4_trans(base + qq * 2 * PLANE, hq[2 * qq][0], hq[2 * qq][1], hq[2 * qq + 1][0],
                     hq[2 * qq + 1][1]);
      return;
    }
#pragma unroll
    for (int q = 0; q < 6; ++q)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const uint32_t lo = aoff[h][kh][0] != NONE ? ld16(gr + q * PLANE + aoff[h][kh][0]) : 0u;
        const uint32_t hi = aoff[h][kh][1] != NONE ? ld16(gr + q * PLANE + aoff[h][kh][1]) : 0u;
        hq[q][kh] = lo | (hi << 16);
      }
  }

  // x fragments of the four planes: bx[p][n][kh], column c = 8n + g
  __device__ __forceinline__ void load_x(const unsigned char* xr, uint32_t (&bx)[4][NT][2]) const {
    if (C == 8) {
#pragma unroll
      for (int p = 0; p < 4; p += 2)
        ldm_x4_trans(smem_u32(xr) + (p * 16 + lane) * 16, bx[p][0][0], bx[p][0][1],
                     bx[p + 1][0][0], bx[p + 1][0][1]);
      return;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const int c = 8 * n + g, r = p * 16 + 2 * t + 8 * kh;
          bx[p][n][kh] = c < C ? ld16(xr + (r * C + c) * 2) | (ld16(xr + ((r + 1) * C + c) * 2) << 16)
                               : 0u;
        }
  }

  __device__ __forceinline__ void row(const unsigned char* xr, const unsigned char* gr) {
    uint32_t bx[4][NT][2];
    load_x(xr, bx);
    uint32_t prev[4][2];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      uint32_t hq[6][2];
      load_half(gr, h, hq);
#pragma unroll
      for (int p = 0; p < 4; ++p)  // dx = -1 reads plane p, dx = 0 plane p + 1
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma_bf16(acc[h][n], hq[p][0], hq[p + 1][0], hq[p][1], hq[p + 1][1], bx[p][n][0],
                   bx[p][n][1]);
      if (h & 1) {  // dx = +1 at halves h - 1 and h (plane p + 2)
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_bf16(acc[NH + h / 2][n], prev[p][0], hq[p + 2][0], prev[p][1], hq[p + 2][1],
                     bx[p][n][0], bx[p][n][1]);
      } else if (h == NH - 1) {  // dx = +1 at the last half, alone
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_bf16(acc[NH + h / 2][n], hq[p + 2][0], 0u, hq[p + 2][1], 0u, bx[p][n][0],
                     bx[p][n][1]);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        prev[p][0] = hq[p + 2][0];
        prev[p][1] = hq[p + 2][1];
      }
    }
  }

  // the accumulators, in dw order (k, c, o)
  __device__ __forceinline__ void store(float* red) const {
#pragma unroll
    for (int j = 0; j < NTILE; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = g + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
          int h, dx;
          if (j < NH) {
            h = j;
            dx = m < 8 ? -1 : 0;
          } else {
            h = 2 * (j - NH) + (m >> 3);
            dx = 1;
          }
          const int f = 8 * h + (m & 7);
          if (c >= C || h >= NH || f >= 9 * O) continue;
          const int k = TAPS - 1 - ((dx + 1) * 9 + f / O);
          red[(k * C + c) * O + f % O] = acc[j][n][e];
        }
  }
};

// ------------------------------------------------------- f32, CUDA cores --

// A lane owns channel o = lane % O and taps tg, tg + TG, ... (tg = lane /
// O), all C input channels.
template <int C, int O>
struct F32Op {
  static constexpr int TG = 32 / O;
  static constexpr int NTG = (TAPS + TG - 1) / TG;
  static constexpr int V = C % 4 == 0 ? 4 : 1;
  float acc[NTG][C];
  const uint16_t* toff = nullptr;  // (64, 27) halo element offsets T*O
  const TapTable& tab;
  int o, tg;
  int out0 = 0, nvalid = TAPS * C * O;

  __device__ __forceinline__ F32Op(const Args&, const TapTable& t) : tab(t) {
    const int lane = threadIdx.x & 31;
    o = lane % O;
    tg = lane / O;
#pragma unroll
    for (int j = 0; j < NTG; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[j][c] = 0.f;
  }

  __device__ __forceinline__ void stage(unsigned char* smem) {
    uint16_t* tt = reinterpret_cast<uint16_t*>(smem + OFF_TAB);
    for (int e = threadIdx.x; e < SLOTS * TAPS; e += blockDim.x) tt[e] = (uint16_t)(tab.f[e] * O);
    toff = tt;
  }

  __device__ __forceinline__ void row(const unsigned char* xb, const unsigned char* gb) {
    const float* x = reinterpret_cast<const float*>(xb);
    const float* g = reinterpret_cast<const float*>(gb) + o;
#pragma unroll 2
    for (int u = 0; u < SLOTS; ++u) {
      float xv[C];
#pragma unroll
      for (int c = 0; c < C; c += V) {
        if (V == 4) {
          const float4 v = *reinterpret_cast<const float4*>(x + u * C + c);
          xv[c] = v.x;
          xv[c + 1] = v.y;
          xv[c + 2] = v.z;
          xv[c + 3] = v.w;
        } else {
          xv[c] = x[u * C + c];
        }
      }
#pragma unroll
      for (int j = 0; j < NTG; ++j) {
        const int tap = tg + TG * j;
        if (tap >= TAPS) continue;
        const float gv = g[toff[u * TAPS + tap]];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[j][c] = fmaf(xv[c], gv, acc[j][c]);
      }
    }
  }

  __device__ __forceinline__ void store(float* red) const {
#pragma unroll
    for (int j = 0; j < NTG; ++j) {
      const int tap = tg + TG * j;
      if (tap >= TAPS) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) red[((TAPS - 1 - tap) * C + c) * O + o] = acc[j][c];
    }
  }
};

// ------------------------------------------------ any shape, CUDA cores --

// Outputs [out0, out0 + CHUNK) of dw[s] in (k, c, o) order, chunk
// blockIdx.y; lane owns out0 + lane + 32 * i.
template <typename T>
struct GenericOp {
  static constexpr int NACC = CHUNK / 32;
  float acc[NACC];
  const uint16_t* toff = nullptr;
  const TapTable& tab;
  int lane, kc, no, total;
  int out0, nvalid;

  __device__ __forceinline__ GenericOp(const Args& a, const TapTable& t) : tab(t) {
    lane = threadIdx.x & 31;
    kc = a.kc;
    no = a.no;
    total = a.total;
    out0 = blockIdx.y * CHUNK;
    nvalid = min(CHUNK, total - out0);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  }

  __device__ __forceinline__ void stage(unsigned char* smem) {
    uint16_t* tt = reinterpret_cast<uint16_t*>(smem + OFF_TAB);
    for (int e = threadIdx.x; e < SLOTS * TAPS; e += blockDim.x) tt[e] = (uint16_t)(tab.f[e] * no);
    toff = tt;
  }

  __device__ __forceinline__ void row(const unsigned char* xb, const unsigned char* gb) {
    const T* x = reinterpret_cast<const T*>(xb);
    const T* g = reinterpret_cast<const T*>(gb);
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = out0 + lane + 32 * i;
      if (e >= total) break;
      const int tap = TAPS - 1 - e / (kc * no), c = (e / no) % kc, o = e % no;
      float s = acc[i];
      for (int u = 0; u < SLOTS; ++u)
        s = fmaf(to_f(x[u * kc + c]), to_f(g[toff[u * TAPS + tap] + o]), s);
      acc[i] = s;
    }
  }

  __device__ __forceinline__ void store(float* red) const {
#pragma unroll
    for (int i = 0; i < NACC; ++i) red[lane + 32 * i] = acc[i];
  }
};

// ------------------------------------------------------------ the kernel --

template <class Op>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    moment_kernel(const __grid_constant__ Args a, const __grid_constant__ TapTable tab) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int sl = warp / a.wps, kq = warp % a.wps;  // the warp's stage (of this launch), residue
  const int s = a.s_lo + sl;
  Op op(a, tab);
  const uint32_t bar0 = smem_u32(smem);
  if (tid == 0) {
    for (int i = 0; i < a.nst; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * i) : "memory");
    // make the initialised barriers visible to the async proxy (the copy engine)
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  op.stage(smem);
  __syncthreads();

  const long long b_begin = (long long)blockIdx.x * a.per_block;
  const long long b_end = min((long long)a.bb, b_begin + a.per_block);
  const int n_my = b_end > b_begin ? (int)((b_end - b_begin + a.tile_bricks - 1) / a.tile_bricks) : 0;
  const size_t x_tile = (size_t)a.tile_bricks * a.s_num * a.xrow;
  unsigned char* ring = smem + OFF_RING;
  auto issue = [&](int i) {
    const long long b0 = b_begin + (long long)i * a.tile_bricks;
    const long long nb = min((long long)a.tile_bricks, b_end - b0);
    const int slot = i % a.nst;
    const uint32_t bar = bar0 + 8 * slot;
    const uint32_t xb = (uint32_t)(nb * a.s_num * a.xrow), gb = (uint32_t)(nb * a.s_num * a.grow);
    unsigned char* dst = ring + (size_t)slot * a.slot_bytes;
    expect_tx(bar, xb + gb);
    bulk_load(smem_u32(dst), (const unsigned char*)a.x + b0 * a.s_num * a.xrow, xb, bar);
    bulk_load(smem_u32(dst + x_tile), (const unsigned char*)a.g + b0 * a.s_num * a.grow, gb, bar);
  };
  if (tid == 0)
    for (int i = 0; i < min(a.nst, n_my); ++i) issue(i);

  for (int i = 0; i < n_my; ++i) {
    const int slot = i % a.nst;
    const int nb = (int)min((long long)a.tile_bricks, b_end - (b_begin + (long long)i * a.tile_bricks));
    mbar_wait(bar0 + 8 * slot, (uint32_t)((i / a.nst) & 1));
    const unsigned char* xt = ring + (size_t)slot * a.slot_bytes;
    const unsigned char* gt = xt + x_tile;
    for (int bi = kq; bi < nb; bi += a.wps) {
      const size_t r = (size_t)bi * a.s_num + s;
      op.row(xt + r * a.xrow, gt + r * a.grow);
    }
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && i + a.nst < n_my) issue(i + a.nst);
  }

  // every copy has landed and been read: the ring becomes the reduction
  // buffer, one row of nout outputs per warp
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  op.store(red + (size_t)warp * a.nout);
  __syncthreads();
  for (int e = tid; e < a.s_n * op.nvalid; e += blockDim.x) {
    const int l = e / op.nvalid, j = e % op.nvalid;
    float v = 0.f;
    for (int k = 0; k < a.wps; ++k) v += red[(size_t)(l * a.wps + k) * a.nout + j];
    a.part[((size_t)blockIdx.x * a.s_num + a.s_lo + l) * a.total + op.out0 + j] = v;
  }
}

// dw[i] = sum over blocks, in block order, of part[block * n + i]
__global__ void part_sum_kernel(const float* __restrict__ part, float* __restrict__ dw, int n,
                                int blocks) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int b = 0; b < blocks; ++b) v += part[(size_t)b * n + i];
    dw[i] = v;
  }
}

// ------------------------------------------------------------ the launch --

template <class Op>
int launch_op(const void* x, const void* g, float* part, int bb, int s_num, int kc, int no,
              int esz, int nout, int chunks, const int* plan, const TapTable& tab,
              cudaStream_t st) {
  Args a = {};
  a.x = x;
  a.g = g;
  a.part = part;
  a.bb = bb;
  a.s_num = s_num;
  a.kc = kc;
  a.no = no;
  a.total = TAPS * kc * no;
  a.tile_bricks = plan[0];
  a.nst = plan[1];
  a.per_block = plan[2];
  const int blocks = plan[3], wps = plan[4], sg = plan[5];
  a.slot_bytes = plan[6];
  const int smem = plan[7];
  a.xrow = SLOTS * kc * esz;
  a.grow = 216 * no * esz;
  a.nout = nout;
  a.wps = wps;
  if (smem > SMEM_BLOCK || a.nst < 1 || a.nst > 4 || sg * wps > MAX_WARPS || a.tile_bricks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(moment_kernel<Op>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  for (int s_lo = 0; s_lo < s_num; s_lo += sg) {
    a.s_lo = s_lo;
    a.s_n = s_num - s_lo < sg ? s_num - s_lo : sg;
    moment_kernel<Op><<<dim3(blocks, chunks), a.s_n * wps * 32, smem, st>>>(a, tab);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int launch(bool bf16, const void* x, const void* g, void* part, void* dw, int bb, int s_num,
           int kc, int no, int path, const int* plan, const void* table, void* stream) {
  if (bb <= 0 || s_num <= 0 || kc <= 0 || no <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  TapTable tab;
  const uint8_t* tb = (const uint8_t*)table;
  for (int i = 0; i < SLOTS * TAPS; ++i) tab.f[i] = tb[i];
  float* pf = (float*)part;
  const int total = TAPS * kc * no;
  int err = (int)cudaErrorInvalidValue;
  if (path == TC && bf16) {
    if (kc == 8 && no == 8) err = launch_op<TcOp<8, 8>>(x, g, pf, bb, s_num, kc, no, 2, total, 1, plan, tab, st);
    if (kc == 12 && no == 8) err = launch_op<TcOp<12, 8>>(x, g, pf, bb, s_num, kc, no, 2, total, 1, plan, tab, st);
    if (kc == 4 && no == 4) err = launch_op<TcOp<4, 4>>(x, g, pf, bb, s_num, kc, no, 2, total, 1, plan, tab, st);
  } else if (path == F32 && !bf16) {
    if (kc == 8 && no == 8) err = launch_op<F32Op<8, 8>>(x, g, pf, bb, s_num, kc, no, 4, total, 1, plan, tab, st);
    if (kc == 12 && no == 8) err = launch_op<F32Op<12, 8>>(x, g, pf, bb, s_num, kc, no, 4, total, 1, plan, tab, st);
    if (kc == 4 && no == 4) err = launch_op<F32Op<4, 4>>(x, g, pf, bb, s_num, kc, no, 4, total, 1, plan, tab, st);
  } else if (path == GENERIC) {
    const int chunks = (total + CHUNK - 1) / CHUNK;
    err = bf16 ? launch_op<GenericOp<__nv_bfloat16>>(x, g, pf, bb, s_num, kc, no, 2, CHUNK, chunks, plan, tab, st)
               : launch_op<GenericOp<float>>(x, g, pf, bb, s_num, kc, no, 4, CHUNK, chunks, plan, tab, st);
  }
  if (err) return err;
  const int n = s_num * total;
  part_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(pf, (float*)dw, n, plan[3]);
  return (int)cudaGetLastError();
}

}  // namespace

// x (bb, s, 64*kc), g (bb, s, 216*no), of one dtype, contiguous and 16-byte
// aligned; part (blocks, s, 27*kc*no) f32 scratch; dw (s, 27, kc, no) f32.
// path: 0 tensor cores (bf16, (kc, no) in (8, 8), (12, 8), (4, 4)), 1 CUDA
// cores (f32, the same shapes), 2 any shape.  plan: tile bricks, ring
// depth, bricks per block, blocks, warps per stage, stages per launch, ring
// slot bytes, dynamic shared memory bytes (ops/plane_conv.py::moment_plan
// owns the layout: OFF_RING, then the ring or the warps' reduction).  table: the 64 x 27 uint8 tap table in
// host memory.  Returns the first failing launch's cudaGetLastError()
// (cudaErrorInvalidValue for a plan or shape the kernel does not take).
extern "C" int plane_moment_dw_f32(const void* x, const void* g, void* part, void* dw, int bb,
                                   int s_num, int kc, int no, int path, const int* plan,
                                   const void* table, void* stream) {
  return launch(false, x, g, part, dw, bb, s_num, kc, no, path, plan, table, stream);
}

extern "C" int plane_moment_dw_bf16(const void* x, const void* g, void* part, void* dw, int bb,
                                    int s_num, int kc, int no, int path, const int* plan,
                                    const void* table, void* stream) {
  return launch(true, x, g, part, dw, bb, s_num, kc, no, path, plan, table, stream);
}
