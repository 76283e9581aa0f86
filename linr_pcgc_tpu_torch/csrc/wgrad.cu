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
//  * ring form (wgrad_ring): x (Bb, S, 64*C) and dy (Bb, S, 64*O)
//    slot-major, one dtype; the group g is the stage s, r runs over the
//    Bb*64 slot rows of stage s (row (r / 64, s, r % 64) of both); dw (S,
//    C, O) in x's dtype, rounded once from the f32 sum.  The gather
//    backend's 1^3 conv (x (N, Cin), dy (N, Cout) f32, no map) is the same
//    form at S = 1 with a ragged last brick of N % 64 rows;
//  * gather form (wgrad_gather_f32): x (N, Cin) and dy (N, Cout) f32
//    node-major, idx (K, N) int32; the group g is the tap k, r the node, x's
//    row idx[k, r] (-1: absent, no term); dw (K, Cin, Cout) f32.
//
// What bounds it on an H100: the bytes.  x and dy are read once at 2-12
// flop a byte, under the f32 CUDA cores' 67 TFLOP/s over 3.35 TB/s (20): at
// the superbrick trainer's level 0 (Bb 81,920, S 4, (C, O) = (8, 24),
// bf16) 1.34 GB, 0.40 ms.  In the gather form idx is most of the bytes
// (85 MB of 135 MB at N 786,432, K 27, 8 -> 8: 0.040 ms) and x's rows come
// through the map, ~7.4 present taps a voxel, mostly from L2.  The design
// before this one held a (CT, OT) register tile of dw a block, so at (8, 24)
// three blocks read the same x rows, each read dy at a third of a sector,
// and a thread kept two rows' loads in flight (~32 KB a SM, HBM's latency
// with no margin): 38 % of the bound; its gather form walked a node range
// for one tap a block, so x's rows and dy crossed L2 27 times (1.4 GB): 15 %.
//
// Ring form (one pass of x and dy through L2 for the whole (C, O)):
//  * persistent blocks, one an SM (~200 KB of shared memory), each owning
//    a contiguous brick range; a tile of TB whole bricks comes by
//    cp.async.bulk copies (one of x and one of dy a tile where the block
//    takes every stage, else one a brick or a stage) into a ring of NST
//    slots behind mbarriers, NST - 1 tiles ahead of the products (~160 KB
//    in flight an SM against the ~25-50 KB that HBM's latency needs), the
//    pattern of K4 (csrc/plane_moment.cu).  x and dy may each be
//    brick-major (contiguous) or stage-major (the permuted view an einsum
//    leaves), so the trainer's saved input is read as it is;
//  * a warp owns one stage and a residue class of the tile's bricks, and
//    holds the whole (C, O) of that stage (at most 32 x 32, wider shapes
//    take output groups on grid.y): every x and dy element crosses HBM and
//    L2 once;
//  * bf16 on the tensor cores: mma.sync m16n8k16, bf16 in, f32 sums, dw^T =
//    dy^T x with M = O (padded to 16), N = C (in 8s), K = the 64 rows of a
//    (brick, stage) in four steps; operands by ldmatrix.trans where the
//    channels come in whole 16-byte rows (C, O multiples of 8), else by
//    16-bit shared loads (zeros past the edge); the tile counts are
//    template parameters.  bf16 x bf16 is exact in f32.  Measured: the
//    copies alone run at the bytes bound, the products alone at a third of
//    it;
//  * f32 on the CUDA cores: a lane holds an 8 x 8 tile of (C, O) and a row
//    residue class of the brick's 64 rows, FMAs in row order; the 1^3
//    conv's ragged last brick is read from global memory by warp 0.
//
// Gather form (the taps inside a block, over one node tile):
//  * persistent blocks (two an SM at Cin <= 8), each owning a node range in
//    tiles of 64 nodes; a warp owns taps w, w + 8, w + 16, w + 24 of the
//    tile (32 a tap group, grid.y), a lane a 4 x 4 tile of (Cin, Cout) (at
//    most 16 x 16, wider shapes take output groups) and a row residue class;
//  * the tile's K index rows and dy rows come by cp.async into a ring of
//    three slots, two tiles ahead of the products; per tap the warp compacts the
//    present rows (ballot), and each present row of x, Cin floats, comes by
//    cp.async (16-byte pieces where Cin % 4 == 0) into the warp's slots: idx
//    and dy cross HBM once, x's rows once a present tap, from L2;
//  * FMAs over the compacted rows only, in node order.
//  What holds it (K 27, 8 -> 8: 0.21 ms against 0.04) is not measured yet:
//  not the index and dy copies (two tiles ahead instead of one: the same
//  time), nor the staging of x (its rows loaded straight from L2 by the
//  lanes: 0.26 ms); deeper versions measured slower too: index and dy
//  rows five tiles ahead behind mbarriers with a producer warp (0.30 ms),
//  a per-warp pipeline of 32-node chunks six deep (0.30-0.42 ms).  See
//  PERF.md.

// Fixed-order sums, no atomics: a lane sums its rows in order, a warp's
// lanes by a shuffle butterfly, a stage's warps in warp order (ring form),
// into a per-block partial (blocks, G, C, O) f32; a second kernel sums the
// blocks in block order and rounds once to dw's dtype.  The plans come from
// the shapes alone (ops/wgrad.py::ring_plan, gather_plan), so two launches
// give the same bits, and two trainings of one GOP the same checkpoint.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 64;
constexpr int SMEM_MAX = 232448;      // a block's most dynamic shared memory, after opting in
constexpr int RING_HDR = 256;         // mbarriers at 0, 16 zero bytes at OFF_ZERO, then the ring
constexpr int OFF_ZERO = 128;
constexpr int RING_MAX_NST = 8;
constexpr int RING_MAX_WARPS = 16;
constexpr int RING_GROUP = 32;        // widest output group of the ring form, both ways

constexpr int G_TILE = 64;            // nodes of a gather-form tile
constexpr int G_WARPS = 8;
constexpr int G_TPW = 4;              // taps a warp owns in a tap group
constexpr int G_TAPS = G_WARPS * G_TPW;
constexpr int G_GROUP = 16;           // widest output group of the gather form, both ways
constexpr int G_NS = 3;               // tile slots of index and dy rows, two tiles ahead
constexpr int G_OFF_DY = G_NS * G_TAPS * G_TILE * 4;
constexpr int G_OFF_LST = G_OFF_DY + G_NS * G_TILE * G_GROUP * 4;
constexpr int G_OFF_X = G_OFF_LST + G_WARPS * G_TPW * G_TILE;

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

__device__ __forceinline__ void ldm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldm_x2_trans(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += A (16 x 16) * B (16 x 8), bf16 in, f32 sum.  Fragments (g = lane / 4,
// t = lane % 4): a0 row g, k 2t..2t+1; a1 row g + 8; a2, a3 the same rows at
// k + 8; b0 k 2t..2t+1, column g; b1 k + 8; d0, d1 row g, columns 2t, 2t+1;
// d2, d3 row g + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack(uint32_t lo, uint32_t hi) { return lo | (hi << 16); }

// ------------------------------------------------------------- ring form --

struct RingArgs {
  const unsigned char* x;
  const unsigned char* dy;
  float* part;           // (blocks, S, C, O) per-block partial sums
  long long rows;        // rows of a stage: Bb * 64, or N (a ragged last brick)
  long long per_block;   // bricks of each block's contiguous range
  int s_num, c, o, esz;
  int sg, wps, tb, nst;  // stages a block, warps a stage, bricks a tile, ring slots
  int cgrp, ogrp, n_cg, n_og;
  int x_slot, slot;      // bytes of a slot's x rows, of a slot
  int xsm, dsm;          // x, dy stage-major: (S, Bb, 64, C) in memory, not (Bb, S, 64, C)
};

// the block's output group: channels [c0, c0 + cw) of x, [o0, o0 + ow) of dy
struct Group {
  int c0, cw, o0, ow;
};

// bf16: a warp's dw^T of its stage in mma fragments, M = the group's O in
// MT (1 or 2) 16-row tiles, N = its C in NT (1-4) 8-column tiles; the tile
// counts are template parameters (predicated at run time, the unrolled
// fragment code ran at half the speed)
template <bool ALDM, bool BLDM, int MT, int NT>
struct MmaOp {
  float d[MT][NT][4];
  int lane, g, t, c, o;
  Group gr;
  uint32_t zero;

  __device__ __forceinline__ MmaOp(const RingArgs& a, const Group& gr_, uint32_t zero_)
      : c(a.c), o(a.o), gr(gr_), zero(zero_) {
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
  }

  __device__ __forceinline__ uint32_t dv(const uint16_t* dc, int r, int m) const {
    return m < gr.o0 + gr.ow ? (uint32_t)dc[r * o + m] : 0u;
  }
  __device__ __forceinline__ uint32_t xv(const uint16_t* xc, int r, int n) const {
    return n < gr.c0 + gr.cw ? (uint32_t)xc[r * c + n] : 0u;
  }

  // the 64 rows of one (brick, stage) in shared memory
  __device__ __forceinline__ void chunk(const unsigned char* xc_, const unsigned char* dc_,
                                        int) {
    const uint16_t* xc = reinterpret_cast<const uint16_t*>(xc_);
    const uint16_t* dc = reinterpret_cast<const uint16_t*>(dc_);
#pragma unroll
    for (int kk = 0; kk < SLOTS / 16; ++kk) {
      const int r0 = kk * 16;
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m0 = gr.o0 + 16 * mt;
        if constexpr (ALDM) {
          const int q = lane >> 3, i = lane & 7;
          const int mc = m0 + 8 * (q & 1);
          ldm_x4_trans(mc < gr.o0 + gr.ow ? smem_u32(dc + (r0 + i + 8 * (q >> 1)) * o + mc) : zero,
                       af[mt]);
        } else {
          const int ra = r0 + 2 * t, ml = m0 + g, mh = ml + 8;
          af[mt][0] = pack(dv(dc, ra, ml), dv(dc, ra + 1, ml));
          af[mt][1] = pack(dv(dc, ra, mh), dv(dc, ra + 1, mh));
          af[mt][2] = pack(dv(dc, ra + 8, ml), dv(dc, ra + 9, ml));
          af[mt][3] = pack(dv(dc, ra + 8, mh), dv(dc, ra + 9, mh));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n0 = gr.c0 + 8 * nt;
        if constexpr (BLDM) {
          const int q = (lane >> 3) & 1, i = lane & 7;
          ldm_x2_trans(n0 < gr.c0 + gr.cw ? smem_u32(xc + (r0 + i + 8 * q) * c + n0) : zero, bf[nt]);
        } else {
          const int ra = r0 + 2 * t, n = n0 + g;
          bf[nt][0] = pack(xv(xc, ra, n), xv(xc, ra + 1, n));
          bf[nt][1] = pack(xv(xc, ra + 8, n), xv(xc, ra + 9, n));
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(d[mt][nt], af[mt], bf[nt]);
    }
  }

  // the warp's (cw, ow) sums into red, c-major
  __device__ __forceinline__ void store(float* red) const {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 16 * mt + g + 8 * (e >> 1), n = 8 * nt + 2 * t + (e & 1);
          if (m < gr.ow && n < gr.cw) red[n * gr.ow + m] = d[mt][nt][e];
        }
  }
};

// v[e] = p[e] for e < valid, 0 beyond; 16-byte loads where vec allows
__device__ __forceinline__ void load8(const float* p, int valid, bool vec, float (&v)[8]) {
  if (vec && valid >= 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
    if (valid == 8) {
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      v[4] = b.x;
      v[5] = b.y;
      v[6] = b.z;
      v[7] = b.w;
    } else {
#pragma unroll
      for (int e = 4; e < 8; ++e) v[e] = e < valid ? p[e] : 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < valid ? p[e] : 0.f;
  }
}

// f32: lane = rg * nob2 + ob holds the 8 x 8 tile ob of the group's (C, O)
// and adds rows rg, rg + rg_n, ... of each chunk in order (neighbouring
// lanes read neighbouring rows: no bank conflicts)
struct FmaOp {
  float acc[8][8];
  int c, o, rg, nob2, cc, oc, cv, ov;
  bool on, vx, vd;
  Group gr;

  __device__ __forceinline__ FmaOp(const RingArgs& a, const Group& gr_, uint32_t)
      : c(a.c), o(a.o), gr(gr_) {
    const int lane = threadIdx.x & 31;
    const int nobo = (gr.ow + 7) / 8, nob = ((gr.cw + 7) / 8) * nobo;
    nob2 = 1;
    while (nob2 < nob) nob2 <<= 1;
    const int ob = lane % nob2;
    rg = lane / nob2;
    on = ob < nob;
    cc = 8 * (ob / nobo);
    oc = 8 * (ob % nobo);
    cv = min(8, gr.cw - cc);
    ov = min(8, gr.ow - oc);
    vx = c % 4 == 0;
    vd = o % 4 == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void chunk(const unsigned char* xc_, const unsigned char* dc_,
                                        int nrows) {
    if (!on) return;
    const float* xc = reinterpret_cast<const float*>(xc_) + gr.c0 + cc;
    const float* dc = reinterpret_cast<const float*>(dc_) + gr.o0 + oc;
    const int rg_n = 32 / nob2;
    for (int r = rg; r < nrows; r += rg_n) {
      float xv[8], dv[8];
      load8(xc + r * c, cv, vx, xv);
      load8(dc + r * o, ov, vd, dv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], dv[j], acc[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* red) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = acc[i][j];
        for (int off = 16; off >= nob2; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (on && rg == 0 && i < cv && j < ov) red[(cc + i) * gr.ow + oc + j] = v;
      }
  }
};

template <class Op>
__global__ void __launch_bounds__(RING_MAX_WARPS * 32, 1) ring_kernel(const __grid_constant__ RingArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int gy = blockIdx.y;
  const int ogi = gy % a.n_og;
  gy /= a.n_og;
  const int cgi = gy % a.n_cg, sgi = gy / a.n_cg;
  const int s0 = sgi * a.sg, sn = min(a.sg, a.s_num - s0);
  Group gr;
  gr.c0 = cgi * a.cgrp;
  gr.cw = min(a.cgrp, a.c - gr.c0);
  gr.o0 = ogi * a.ogrp;
  gr.ow = min(a.ogrp, a.o - gr.o0);
  const int sl = warp / a.wps, kq = warp % a.wps;  // the warp's stage in the group, residue
  const bool active = sl < sn;

  const long long full = a.rows / SLOTS;  // whole bricks, through the ring
  const long long bricks = (a.rows + SLOTS - 1) / SLOTS;
  const long long b_begin = (long long)blockIdx.x * a.per_block;
  const long long b_end = min(bricks, b_begin + a.per_block);
  const long long r_end = min(full, b_end);
  const int n_my = r_end > b_begin ? (int)((r_end - b_begin + a.tb - 1) / a.tb) : 0;
  const int xb = sn * SLOTS * a.c * a.esz, db = sn * SLOTS * a.o * a.esz;  // a brick's bytes
  const int xc = SLOTS * a.c * a.esz, dc = SLOTS * a.o * a.esz;            // a chunk's bytes

  const uint32_t bar0 = smem_u32(smem);
  if (tid == 0) {
    for (int i = 0; i < a.nst; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * i) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  if (tid < 4) reinterpret_cast<uint32_t*>(smem + OFF_ZERO)[tid] = 0u;
  __syncthreads();

  Op op(a, gr, smem_u32(smem + OFF_ZERO));
  unsigned char* ring = smem + RING_HDR;
  // warp 0: tile i's bricks into slot i % nst, one bulk copy of x and one of
  // dy a brick (its stage group's rows), the lanes in parallel
  auto issue = [&](int i) {
    const long long b0 = b_begin + (long long)i * a.tb;
    const int nb = (int)min((long long)a.tb, r_end - b0);
    const int slot = i % a.nst;
    const uint32_t bar = bar0 + 8 * slot;
    unsigned char* dst = ring + (size_t)slot * a.slot;
    if (lane == 0) expect_tx(bar, (uint32_t)nb * (uint32_t)(xb + db));
    __syncwarp();
    // one tensor's rows of the tile: brick-major, one copy where the block
    // takes every stage, else one a brick (slot order brick, stage);
    // stage-major, one copy a stage (slot order stage, brick)
    auto tile = [&](const unsigned char* src, unsigned char* to, int chunk, int brick, int sm) {
      const long long bricks_all = a.rows / SLOTS;
      if (sm) {
        for (int l = lane; l < sn; l += 32)
          bulk_load(smem_u32(to + (size_t)l * a.tb * chunk),
                    src + ((size_t)(s0 + l) * bricks_all + b0) * chunk, (uint32_t)nb * chunk, bar);
      } else if (sn == a.s_num) {
        if (lane == 0) bulk_load(smem_u32(to), src + (size_t)b0 * brick, (uint32_t)nb * brick, bar);
      } else {
        for (int b = lane; b < nb; b += 32)
          bulk_load(smem_u32(to + (size_t)b * brick),
                    src + ((size_t)(b0 + b) * a.s_num + s0) * chunk, (uint32_t)brick, bar);
      }
    };
    tile(a.x, dst, xc, xb, a.xsm);
    tile(a.dy, dst + a.x_slot, dc, db, a.dsm);
  };
  if (warp == 0)
    for (int i = 0; i < min(a.nst, n_my); ++i) issue(i);

  for (int i = 0; i < n_my; ++i) {
    const int slot = i % a.nst;
    const int nb = (int)min((long long)a.tb, r_end - (b_begin + (long long)i * a.tb));
    mbar_wait(bar0 + 8 * slot, (uint32_t)((i / a.nst) & 1));
    const unsigned char* xt = ring + (size_t)slot * a.slot;
    const unsigned char* dt = xt + a.x_slot;
    if (active)
      for (int bi = kq; bi < nb; bi += a.wps) {
        const size_t bs = (size_t)bi * sn + sl, sb = (size_t)sl * a.tb + bi;
        op.chunk(xt + (a.xsm ? sb : bs) * xc, dt + (a.dsm ? sb : bs) * dc, SLOTS);
      }
    __syncthreads();  // every warp is done with the slot
    if (warp == 0 && i + a.nst < n_my) issue(i + a.nst);
  }
  // the ragged last brick (the 1^3 conv's N % 64 rows, S = 1), from global
  // memory, by the first warp of the block that owns it
  if (full < bricks && full >= b_begin && full < b_end && warp == 0)
    op.chunk(a.x + (size_t)full * SLOTS * a.c * a.esz, a.dy + (size_t)full * SLOTS * a.o * a.esz,
             (int)(a.rows - full * SLOTS));

  // every copy has landed and been read: the ring becomes the reduction
  // buffer, one (cw, ow) block a warp, then a stage's warps in warp order
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  const int nout = gr.cw * gr.ow;
  if (active) op.store(red + (size_t)warp * nout);
  __syncthreads();
  for (int e = tid; e < sn * nout; e += blockDim.x) {
    const int l = e / nout, j = e % nout;
    float v = 0.f;
    for (int k = 0; k < a.wps; ++k) v += red[(size_t)(l * a.wps + k) * nout + j];
    a.part[(((size_t)blockIdx.x * a.s_num + s0 + l) * a.c + gr.c0 + j / gr.ow) * a.o + gr.o0 +
           j % gr.ow] = v;
  }
}

// ----------------------------------------------------------- gather form --

struct GatherArgs {
  const float* x;
  const float* dy;
  const int* idx;
  float* part;        // (blocks, K, C, O) per-block partial sums
  int n, k, c, o;
  int cgrp, ogrp, n_cg, n_og;
  int per_block;      // nodes of each block's range, whole tiles
  int cw4;            // floats of a gathered x row in shared memory (cgrp rounded up to 4)
  int vx, vi, vd;     // x rows, idx rows, dy rows may go in 16-byte pieces
};

__global__ void __launch_bounds__(G_WARPS * 32, 2) gather_kernel(const __grid_constant__ GatherArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* idx_s = reinterpret_cast<int*>(smem);                  // [G_NS][G_TAPS][G_TILE]
  float* dy_s = reinterpret_cast<float*>(smem + G_OFF_DY);    // [G_NS][G_TILE][G_GROUP]
  uint8_t* lst = smem + G_OFF_LST;                            // [warp][tap][G_TILE]
  float* xbuf = reinterpret_cast<float*>(smem + G_OFF_X);     // [warp][tap][G_TILE][cw4]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int gy = blockIdx.y;
  const int ogi = gy % a.n_og;
  gy /= a.n_og;
  const int cgi = gy % a.n_cg, tgi = gy / a.n_cg;
  const int kg0 = tgi * G_TAPS, tg = min(G_TAPS, a.k - kg0);
  const int c0 = cgi * a.cgrp, cw = min(a.cgrp, a.c - c0);
  const int o0 = ogi * a.ogrp, ow = min(a.ogrp, a.o - o0);
  const long long nb0 = (long long)blockIdx.x * a.per_block;
  const long long nb1 = min((long long)a.n, nb0 + a.per_block);
  const int ntiles = nb1 > nb0 ? (int)((nb1 - nb0 + G_TILE - 1) / G_TILE) : 0;

  // the lane's 4 x 4 tile of the group's (C, O) and its row residue class:
  // lane = rg * nob2 + ob
  const int nobo = (ow + 3) / 4, nob = ((cw + 3) / 4) * nobo;
  int nob2 = 1;
  while (nob2 < nob) nob2 <<= 1;
  const int rg_n = 32 / nob2, ob = lane % nob2, rg = lane / nob2;
  const bool on = ob < nob;
  const int xc = 4 * (ob / nobo), oc = 4 * (ob % nobo);

  float acc[G_TPW][4][4];
#pragma unroll
  for (int j = 0; j < G_TPW; ++j)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][p][q] = 0.f;

  // tile i's index rows (the group's taps) and dy rows (the group's
  // columns) into slot buf
  auto load_tile = [&](int i, int buf) {
    const long long n0 = nb0 + (long long)i * G_TILE;
    const int nv = (int)min((long long)G_TILE, nb1 - n0);
    int* is = idx_s + buf * G_TAPS * G_TILE;
    if (a.vi) {
      const int pc = nv / 4;
      for (int p = tid; p < tg * pc; p += blockDim.x) {
        const int kl = p / pc, q = 4 * (p % pc);
        cp16(is + kl * G_TILE + q, a.idx + (size_t)(kg0 + kl) * a.n + n0 + q);
      }
    } else {
      for (int p = tid; p < tg * nv; p += blockDim.x) {
        const int kl = p / nv, q = p % nv;
        cp4(is + kl * G_TILE + q, a.idx + (size_t)(kg0 + kl) * a.n + n0 + q);
      }
    }
    float* ds = dy_s + buf * G_TILE * G_GROUP;
    if (a.vd) {
      const int pc = ow / 4;
      for (int p = tid; p < nv * pc; p += blockDim.x) {
        const int r = p / pc, q = 4 * (p % pc);
        cp16(ds + r * G_GROUP + q, a.dy + (size_t)(n0 + r) * a.o + o0 + q);
      }
    } else {
      for (int p = tid; p < nv * ow; p += blockDim.x) {
        const int r = p / ow, q = p % ow;
        cp4(ds + r * G_GROUP + q, a.dy + (size_t)(n0 + r) * a.o + o0 + q);
      }
    }
  };

  for (int i = 0; i < 2; ++i) {
    if (i < ntiles) load_tile(i, i);
    cp_commit();
  }
  cp_wait<1>();
  __syncthreads();
  for (int i = 0; i < ntiles; ++i) {
    const int buf = i % G_NS;
    const int nv = (int)min((long long)G_TILE, nb1 - (nb0 + (long long)i * G_TILE));
    const int* is = idx_s + buf * G_TAPS * G_TILE;
    // the warp's taps: compact the present rows, in node order, and gather
    // their x rows into the warp's slots
    int cnt[G_TPW];
#pragma unroll
    for (int j = 0; j < G_TPW; ++j) {
      cnt[j] = 0;
      const int kl = warp + G_WARPS * j;
      if (kl >= tg) continue;
      float* xd = xbuf + (size_t)(warp * G_TPW + j) * G_TILE * a.cw4;
      uint8_t* ld = lst + (warp * G_TPW + j) * G_TILE;
      for (int r0 = 0; r0 < nv; r0 += 32) {
        const int r = r0 + lane;
        const int id = r < nv ? is[kl * G_TILE + r] : -1;
        const unsigned m = __ballot_sync(0xffffffffu, id >= 0);
        if (id >= 0) {
          const int pos = cnt[j] + __popc(m & ((1u << lane) - 1u));
          ld[pos] = (uint8_t)r;
          const float* src = a.x + (size_t)id * a.c + c0;
          float* dst = xd + (size_t)pos * a.cw4;
          if (a.vx) {
            for (int q = 0; q < cw; q += 4) cp16(dst + q, src + q);
          } else {
            for (int q = 0; q < cw; ++q) cp4(dst + q, src + q);
          }
        }
        cnt[j] += __popc(m);
      }
    }
    cp_commit();  // the gathers
    if (i + 2 < ntiles) load_tile(i + 2, (i + 2) % G_NS);
    cp_commit();  // the tile after next, in flight under the products
    cp_wait<1>();  // the gathers, and the next tile's rows (committed a tile ago)
    __syncwarp();
    const float* ds = dy_s + buf * G_TILE * G_GROUP;
#pragma unroll
    for (int j = 0; j < G_TPW; ++j) {
      const int kl = warp + G_WARPS * j;
      if (kl >= tg || !on) continue;
      const float* xd = xbuf + (size_t)(warp * G_TPW + j) * G_TILE * a.cw4 + xc;
      const uint8_t* ld = lst + (warp * G_TPW + j) * G_TILE;
      for (int q = rg; q < cnt[j]; q += rg_n) {
        const float4 xv4 = *reinterpret_cast<const float4*>(xd + (size_t)q * a.cw4);
        const float4 dv4 = *reinterpret_cast<const float4*>(ds + ld[q] * G_GROUP + oc);
        const float xv[4] = {xc < cw ? xv4.x : 0.f, xc + 1 < cw ? xv4.y : 0.f,
                             xc + 2 < cw ? xv4.z : 0.f, xc + 3 < cw ? xv4.w : 0.f};
        const float dv[4] = {oc < ow ? dv4.x : 0.f, oc + 1 < ow ? dv4.y : 0.f,
                             oc + 2 < ow ? dv4.z : 0.f, oc + 3 < ow ? dv4.w : 0.f};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[j][p][u] = fmaf(xv[p], dv[u], acc[j][p][u]);
      }
    }
    __syncthreads();  // the next tile's rows are in; tile i's slot and buffers are free
  }
  cp_wait<0>();

  // a tap's sums: the row residues by a butterfly (rg 0's value)
#pragma unroll
  for (int j = 0; j < G_TPW; ++j) {
    const int kl = warp + G_WARPS * j;
    if (kl >= tg) continue;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v = acc[j][p][u];
        for (int off = 16; off >= nob2; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (on && rg == 0 && xc + p < cw && oc + u < ow)
          a.part[(((size_t)blockIdx.x * a.k + kg0 + kl) * a.c + c0 + xc + p) * a.o + o0 + oc + u] = v;
      }
  }
}

// ------------------------------------------------------------ second pass --

// dw[i] = the sum over the blocks, in block order, of part[p * n + i],
// rounded once to dw's dtype
template <bool BF16>
__global__ void part_sum_kernel(const float* __restrict__ part, void* __restrict__ dw, int n,
                                int blocks) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int p = 0; p < blocks; ++p) v += part[(size_t)p * n + i];
    if constexpr (BF16) {
      static_cast<__nv_bfloat16*>(dw)[i] = __float2bfloat16_rn(v);
    } else {
      static_cast<float*>(dw)[i] = v;
    }
  }
}

template <class Op>
int launch_ring(const RingArgs& a, int blocks, int groups, int threads, int smem,
                cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(ring_kernel<Op>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ring_kernel<Op><<<dim3(blocks, groups), threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool ALDM, bool BLDM, int MT>
int launch_mma_nt(int nt, const RingArgs& a, int blocks, int groups, int threads, int smem,
                  cudaStream_t st) {
  switch (nt) {
    case 1: return launch_ring<MmaOp<ALDM, BLDM, MT, 1>>(a, blocks, groups, threads, smem, st);
    case 2: return launch_ring<MmaOp<ALDM, BLDM, MT, 2>>(a, blocks, groups, threads, smem, st);
    case 3: return launch_ring<MmaOp<ALDM, BLDM, MT, 3>>(a, blocks, groups, threads, smem, st);
    case 4: return launch_ring<MmaOp<ALDM, BLDM, MT, 4>>(a, blocks, groups, threads, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool ALDM, bool BLDM>
int launch_mma_mt(int mt, int nt, const RingArgs& a, int blocks, int groups, int threads,
                  int smem, cudaStream_t st) {
  if (mt == 1) return launch_mma_nt<ALDM, BLDM, 1>(nt, a, blocks, groups, threads, smem, st);
  if (mt == 2) return launch_mma_nt<ALDM, BLDM, 2>(nt, a, blocks, groups, threads, smem, st);
  return (int)cudaErrorInvalidValue;
}

// the bf16 consumer for the channel alignments (ldmatrix where the rows are
// whole 16-byte pieces) and tile counts of the plan
int launch_mma(bool aldm, bool bldm, int mt, int nt, const RingArgs& a, int blocks, int groups,
               int threads, int smem, cudaStream_t st) {
  if (aldm && bldm) return launch_mma_mt<true, true>(mt, nt, a, blocks, groups, threads, smem, st);
  if (aldm) return launch_mma_mt<true, false>(mt, nt, a, blocks, groups, threads, smem, st);
  if (bldm) return launch_mma_mt<false, true>(mt, nt, a, blocks, groups, threads, smem, st);
  return launch_mma_mt<false, false>(mt, nt, a, blocks, groups, threads, smem, st);
}

int part_sum(const float* part, void* dw, int n, int blocks, bool bf16, cudaStream_t st) {
  const int grid = (n + 255) / 256;
  if (bf16)
    part_sum_kernel<true><<<grid, 256, 0, st>>>(part, dw, n, blocks);
  else
    part_sum_kernel<false><<<grid, 256, 0, st>>>(part, dw, n, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Ring form: x (rows / 64 bricks, S, 64*c) and dy (.., S, 64*o), 16-byte
// aligned, of one dtype (bf16: whole bricks), each brick-major (contiguous)
// or stage-major (xsm, dsm: laid out (S, bricks, 64*c), a permuted view, as
// an einsum leaves its output); rows = Bb * 64 (or N at S = 1, the last
// brick ragged, f32); part (blocks, S, c, o) f32 scratch; dw (S, c, o) in
// x's dtype.  plan (ops/wgrad.py::ring_plan): stages a block,
// warps a stage, bricks a tile, ring slots, bricks a block, blocks, output
// group widths (channels of x, of dy), dynamic shared memory bytes.
// Returns the first failing launch's cudaGetLastError()
// (cudaErrorInvalidValue for a shape or plan it does not take).
extern "C" int wgrad_ring(const void* x, const void* dy, void* part, void* dw, int bf16,
                          long long rows, int s, int c, int o, int xsm, int dsm,
                          const long long* plan, void* stream) {
  const int esz = bf16 ? 2 : 4;
  RingArgs a = {};
  a.x = static_cast<const unsigned char*>(x);
  a.dy = static_cast<const unsigned char*>(dy);
  a.part = static_cast<float*>(part);
  a.rows = rows;
  a.s_num = s;
  a.c = c;
  a.o = o;
  a.esz = esz;
  a.xsm = xsm && s > 1;
  a.dsm = dsm && s > 1;
  a.sg = (int)plan[0];
  a.wps = (int)plan[1];
  a.tb = (int)plan[2];
  a.nst = (int)plan[3];
  a.per_block = plan[4];
  const long long blocks = plan[5];
  a.cgrp = (int)plan[6];
  a.ogrp = (int)plan[7];
  const long long smem = plan[8];
  if (rows < 1 || s < 1 || c < 1 || o < 1 || a.sg < 1 || a.wps < 1 || a.tb < 1 || a.nst < 2 ||
      a.nst > RING_MAX_NST || a.sg * a.wps > RING_MAX_WARPS || a.cgrp < 1 || a.ogrp < 1 ||
      a.cgrp > RING_GROUP || a.ogrp > RING_GROUP || a.per_block < 1 || blocks < 1 ||
      blocks > 0x7fffffffLL || smem > SMEM_MAX || ((bf16 || a.xsm || a.dsm) && rows % SLOTS != 0))
    return (int)cudaErrorInvalidValue;
  const long long bricks = (rows + SLOTS - 1) / SLOTS;
  if (blocks * a.per_block < bricks || (blocks - 1) * a.per_block >= bricks)
    return (int)cudaErrorInvalidValue;
  a.n_cg = (c + a.cgrp - 1) / a.cgrp;
  a.n_og = (o + a.ogrp - 1) / a.ogrp;
  const int n_sg = (s + a.sg - 1) / a.sg;
  a.x_slot = a.tb * a.sg * SLOTS * c * esz;
  a.slot = a.x_slot + a.tb * a.sg * SLOTS * o * esz;
  const int warps = a.sg * a.wps;
  if ((long long)RING_HDR + (long long)a.nst * a.slot > smem ||
      (long long)RING_HDR + (long long)warps * a.cgrp * a.ogrp * 4 > smem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = n_sg * a.n_cg * a.n_og;
  int err;
  if (bf16) {
    // every output group has the tile counts of the first (the widest):
    // narrower last groups mask their edge
    const int mt = (a.ogrp + 15) / 16, nt = (a.cgrp + 7) / 8;
    err = launch_mma(o % 8 == 0, c % 8 == 0, mt, nt, a, (int)blocks, groups, warps * 32,
                     (int)smem, st);
  } else {
    err = launch_ring<FmaOp>(a, (int)blocks, groups, warps * 32, (int)smem, st);
  }
  if (err) return err;
  return part_sum(a.part, dw, s * c * o, (int)blocks, bf16 != 0, st);
}

// Gather form: x (n, c), dy (n, o) f32 contiguous, idx (k, n) int32; part
// (blocks, k, c, o) f32 scratch; dw (k, c, o) f32.  plan
// (ops/wgrad.py::gather_plan): output group widths (channels of x, of dy),
// nodes a block (whole tiles of 64), blocks, dynamic shared memory bytes.
extern "C" int wgrad_gather_f32(const void* x, const void* dy, const void* idx, void* part,
                                void* dw, int n, int k, int c, int o, const long long* plan,
                                void* stream) {
  GatherArgs a = {};
  a.x = static_cast<const float*>(x);
  a.dy = static_cast<const float*>(dy);
  a.idx = static_cast<const int*>(idx);
  a.part = static_cast<float*>(part);
  a.n = n;
  a.k = k;
  a.c = c;
  a.o = o;
  a.cgrp = (int)plan[0];
  a.ogrp = (int)plan[1];
  a.per_block = (int)plan[2];
  const long long blocks = plan[3];
  const long long smem = plan[4];
  a.cw4 = (a.cgrp + 3) / 4 * 4;
  if (n < 1 || k < 1 || c < 1 || o < 1 || idx == nullptr || a.cgrp < 1 || a.ogrp < 1 ||
      a.cgrp > G_GROUP || a.ogrp > G_GROUP || (a.cgrp % 4 != 0 && a.cgrp < c) ||
      (a.ogrp % 4 != 0 && a.ogrp < o) || a.per_block < 1 || a.per_block % G_TILE != 0 ||
      blocks < 1 || blocks * a.per_block < n || (blocks - 1) * a.per_block >= n ||
      smem > SMEM_MAX || smem < (long long)G_OFF_X + (long long)G_WARPS * G_TPW * G_TILE * a.cw4 * 4)
    return (int)cudaErrorInvalidValue;
  a.n_cg = (c + a.cgrp - 1) / a.cgrp;
  a.n_og = (o + a.ogrp - 1) / a.ogrp;
  const int n_tg = (k + G_TAPS - 1) / G_TAPS;
  a.vx = c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vi = n % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  a.vd = o % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  gather_kernel<<<dim3((unsigned)blocks, n_tg * a.n_cg * a.n_og), G_WARPS * 32, smem, st>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return part_sum(a.part, dw, k * c * o, (int)blocks, false, st);
}
