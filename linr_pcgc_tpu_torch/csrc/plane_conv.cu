// K1 and K3: the slot-major 3^3 brick conv as a 27-tap product over a
// halo streamed through shared memory.
//
// K1 (EPI = true) replaces the TPU kernel
// linr_pcgc_tpu/ops/pallas_conv.py::_fwd_bm_kernel (entry
// plane_matmul(h, w2, kc, no, bias, mask)), the conv forward with the bias +
// slot-mask epilogue fused.  K3 (EPI = false) replaces _fwd_kernel (entry
// plane_matmul(h, w2, kc, no)), the same product with no epilogue, which the
// conv's backward runs for dx = halo(dy * mask) @ Wt (flipped taps, C and O
// swapped, so there kc = O and no = C).  Both compute what those compute on
// the conv matrix w2, but from the taps w (s, 27, kc, no) that w2 is
// gathered from: for brick row b, stage s, slot u < 64 and channel o < no,
//
//   acc = sum_{k < 27} sum_{c < kc} h[b, s, T[u][k]*kc + c] * w[s, k, c, o]
//   y[b, s, u*no + o] = EPI ? (acc + bias[s, u*no + o]) * mask[b, u] : acc
//
// where T (64 x 27, the halo column that tap k of slot u reads) comes from
// the Python wrapper, derived from the same table that builds w2, and is
// passed by value (it lands in the constant bank).  Each slot reads 27 of
// the 108 halo columns of its plane window: w2's window product is 75 %
// structural zeros, and none of them is computed here.
//
// What bounds it on an H100: per (row, stage) the stencil does 3456*kc*no
// flops against 216*kc + 64*no elements moved: at kc = no = 8 in bf16 about
// 49 flops per byte, far under the ~295 at which the bf16 tensor cores become
// the limit, so the kernel is bound by the halo's HBM bytes.  Reaching that
// bound takes ~160 TFLOP/s, more than the CUDA cores give, so bf16 runs on
// the tensor cores; and the gather of A from the halo reads shared memory
// several times over, which is the second limit.  The design:
//
//   * Bytes.  h is Bb*S contiguous rows of 216*kc elements; a tile of R
//     rows is one contiguous range, fetched with one cp.async.bulk (the TMA's
//     linear form) that completes on an mbarrier, K1's mask rows of the
//     tile's bricks with a second one on the same barrier.  Persistent blocks
//     (one or two per SM) walk the tiles in a fixed order through a ring of
//     3-4 tiles in dynamic shared memory; the last tile is ragged.  y's rows
//     are contiguous too: each tile is staged in shared memory and written
//     with one bulk store.  Each halo element crosses HBM once.
//   * bf16 on the tensor cores: mma.sync m16n8k16 bf16 -> f32.  One warp
//     computes one row: M = the 16 slots of one output plane, N = no padded
//     to 8, K = the 27*kc stencil padded to 16.  Plane p's tap (dx, dy, dz)
//     reads halo x-plane p + 1 + dx at the in-plane column of (dy, dz), so a
//     16 x 8 A half (8 consecutive (yz offset, channel) pairs of one halo
//     x-plane) serves the three output planes that read that x-plane: it is
//     loaded once per row, not once per plane.  Halves pair as (dx = -1,
//     dx = 0), then the dx = +1 halves among themselves, which takes as many
//     k-steps as 27*kc in flat order (share_halves below).  At kc = 8 a half
//     is 16-byte rows, loaded with ldmatrix from per-lane row addresses;
//     other kc load 32-bit channel pairs (even kc) or 16-bit elements (odd
//     kc; C = 7 is on the codec path) from per-lane offsets.
//   * f32 stays off the tensor cores (TF32 would break the f32 tolerance):
//     the same ring and tap form, each thread two slots x 8 outputs of FFMA.
//   * The taps (mma B fragments, or f32 rows padded to 8 outputs) and K1's
//     bias are staged in shared memory once per block; shapes whose taps do
//     not fit leave them in global memory (L1/L2 resident) instead.  Shapes
//     off the main path run a runtime-shaped gather through T in flat order.
//
// Determinism: every output is one warp's chain of mma (or one thread's
// FMAs) in a fixed k order; no atomics, no split-K, and the tile size, ring
// depth and grid come from the shapes alone, so the encoder and decoder
// produce identical bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 64;
constexpr int TAPS = 27;
constexpr int HALO = 216;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SMS = 132;              // H100 SXM
constexpr int SMEM_SM = 232448;       // shared memory one SM gives its blocks
constexpr int SMEM_RESERVED = 1024;   // per block, kept by the runtime
constexpr int HDR = 128;              // mbarriers at the front of the dynamic region
constexpr int MAX_NST = 4;
constexpr int MAX_TILE_ROWS = 32;

struct TapTable {
  uint8_t f[SLOTS * TAPS];  // T[u][k]: halo column read by tap k of slot u
};

enum Path { SHARE = 0, GATHER = 1, F32 = 2 };

struct Args {
  const void* h;
  const void* w;
  const void* bias;
  const void* mask;
  void* y;
  long long rows;     // bb * s_num
  long long n_tiles;
  int s_num, kc, no;
  int tile_rows, nst, params_smem;
  int row_in, row_out, mask_row;           // bytes (mask_row 0: no mask)
  int off_ring, off_mask, off_out, off_w, off_bias, off_tab;  // shared-memory byte offsets
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

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void ldm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += A (16 x 16, rows g / g + 8, k pairs) * B (16 x 8), bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }


// ---------------------------------------------------------- tap layouts --

// The plane-sharing form (SHARE) cuts the (yz offset i < 9, channel c < kc)
// pairs of one halo x-plane into NH = ceil(9*kc / 8) halves of 8, flat index
// f = i*kc + c.  A 16 x 8 A half (slots r < 16 of plane 0, one half) is the
// same for every output plane p and tap dx, moved by whole x-planes: plane
// p's tap (dx, i) reads halo plane p + 1 + dx (see the header).  K-steps j <
// NH pair the dx = -1 and dx = 0 halves of half j; then the dx = +1 halves
// pair among themselves (the last alone when NH is odd): NH + ceil(NH/2)
// k-steps, as many as 27*kc in flat order takes.
__host__ __device__ constexpr int share_halves(int kc) { return (9 * kc + 7) / 8; }
__host__ __device__ constexpr int share_steps(int kc) {
  return share_halves(kc) + (share_halves(kc) + 1) / 2;
}

// Flat tap index k' = tap*kc + c of row kk < 16 of k-step j, or -1 (padding).
// GATHER takes K in flat order.
template <int PATH>
__device__ __forceinline__ int kflat(int j, int kk, int kc) {
  if (PATH == SHARE) {
    const int nh = share_halves(kc), hb = kk >> 3;
    int dx, h;
    if (j < nh) {
      dx = hb - 1;
      h = j;
    } else {
      dx = 1;
      h = 2 * (j - nh) + hb;
    }
    const int f = 8 * h + (kk & 7);
    if (h >= nh || f >= 9 * kc) return -1;
    return ((dx + 1) * 9 + f / kc) * kc + f % kc;
  }
  const int k = 16 * j + kk;
  return k < TAPS * kc ? k : -1;
}

// The B fragment of k-step j, n-tile nt for ``lane``, from w (s, 27, kc, no)
// in global memory: rows k = 2*tig (+1), 2*tig + 8 (+1), column 8*nt + g.
template <int PATH>
__device__ __forceinline__ uint2 b_frag_global(const uint16_t* __restrict__ w, int s, int j,
                                               int nt, int lane, int kc, int no) {
  const int g = lane >> 2, tig = lane & 3, n = nt * 8 + g;
  const uint16_t* ws = w + (size_t)s * TAPS * kc * no;
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = kflat<PATH>(j, 2 * tig + (i & 1) + (i >> 1) * 8, kc);
    e[i] = (kp >= 0 && n < no) ? (uint32_t)__ldg(ws + (size_t)kp * no + n) : 0u;
  }
  return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}

// ----------------------------------------------------------- the pipeline --

// Runs the ring over this block's tiles and calls op.row(in, out, grow,
// mask, b0) for every row of a tile, rows dealt to the warps in turn (mask:
// the staged mask rows of the tile's bricks from brick b0 on).
template <class Op>
__device__ __forceinline__ void pipeline(const Args& a, Op& op, unsigned char* smem) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const uint32_t bar0 = smem_u32(smem);
  if (tid == 0) {
    for (int i = 0; i < a.nst; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * i) : "memory");
    // make the initialised barriers visible to the async proxy (the copy engine)
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_proxy_async();
  }
  op.stage(smem);
  __syncthreads();

  const long long n_my = (a.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const size_t tile_in = (size_t)a.tile_rows * a.row_in;
  const size_t tile_out = (size_t)a.tile_rows * a.row_out;
  const size_t mask_slot = (size_t)(a.tile_rows + 1) * a.mask_row;
  auto issue = [&](long long i) {
    const long long row0 = (blockIdx.x + i * gridDim.x) * a.tile_rows;
    const long long nrows = min((long long)a.tile_rows, a.rows - row0);
    const int slot = (int)(i % a.nst);
    const uint32_t bar = bar0 + 8 * slot, in_bytes = (uint32_t)(nrows * a.row_in);
    // K1's mask rows of the bricks the tile's rows belong to ride along
    const long long b0 = row0 / a.s_num, b1 = (row0 + nrows - 1) / a.s_num;
    const uint32_t m_bytes = a.mask_row ? (uint32_t)((b1 - b0 + 1) * a.mask_row) : 0u;
    expect_tx(bar, in_bytes + m_bytes);
    bulk_load(smem_u32(smem + a.off_ring + slot * tile_in),
              (const unsigned char*)a.h + row0 * a.row_in, in_bytes, bar);
    if (m_bytes)
      bulk_load(smem_u32(smem + a.off_mask + slot * mask_slot),
                (const unsigned char*)a.mask + b0 * a.mask_row, m_bytes, bar);
  };
  if (tid == 0)
    for (long long i = 0; i < min((long long)a.nst, n_my); ++i) issue(i);

  for (long long i = 0; i < n_my; ++i) {
    const int slot = (int)(i % a.nst);
    const long long row0 = (blockIdx.x + i * gridDim.x) * a.tile_rows;
    const int nrows = (int)min((long long)a.tile_rows, a.rows - row0);
    mbar_wait(bar0 + 8 * slot, (uint32_t)((i / a.nst) & 1));
    // the bulk store of tile i - 2 has read the staging buffer we refill
    if (tid == 0 && i >= 2) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    __syncthreads();
    const unsigned char* in = smem + a.off_ring + slot * tile_in;
    const unsigned char* mask = smem + a.off_mask + slot * mask_slot;
    unsigned char* out = smem + a.off_out + (i & 1) * tile_out;
    for (int r = warp; r < nrows; r += WARPS)
      op.row(in + (size_t)r * a.row_in, out + (size_t)r * a.row_out, row0 + r, mask,
             row0 / a.s_num);
    fence_proxy_async();  // the staged rows, visible to the bulk store
    __syncthreads();      // ... and the ring slot free for the next load
    if (tid == 0) {
      bulk_store((unsigned char*)a.y + row0 * a.row_out, smem_u32(out),
                 (uint32_t)((size_t)nrows * a.row_out));
      if (i + a.nst < n_my) issue(i + a.nst);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ------------------------------------------------------------- bf16 ops --

// What the bf16 paths share: staged taps (B fragments in k-step order) and
// bias, and the epilogue from the mma accumulators into the staged y row.
template <int PATH, int KC, int NO, bool EPI>
struct Bf16Base {
  const Args a;
  const TapTable& tab;
  const uint2* wf = nullptr;   // (s, nch, nt, 32 lanes) B fragments
  const float* bsm = nullptr;  // (s, 64 * no) bias
  int lane, g, tig, kc, no, nch, nt_n;

  __device__ __forceinline__ Bf16Base(const Args& a_, const TapTable& t) : a(a_), tab(t) {
    lane = threadIdx.x & 31;
    g = lane >> 2;
    tig = lane & 3;
    kc = KC ? KC : a.kc;
    no = NO ? NO : a.no;
    nch = PATH == SHARE ? share_steps(kc) : (TAPS * kc + 15) / 16;
    nt_n = (no + 7) / 8;
  }

  __device__ __forceinline__ void stage_params(unsigned char* smem) {
    if (!a.params_smem) return;
    uint2* wfs = reinterpret_cast<uint2*>(smem + a.off_w);
    const int per_stage = nch * nt_n * 32;
    for (int e = threadIdx.x; e < a.s_num * per_stage; e += THREADS) {
      const int s = e / per_stage, r = e % per_stage;
      wfs[e] = b_frag_global<PATH>((const uint16_t*)a.w, s, r / (nt_n * 32),
                                   (r / 32) % nt_n, r % 32, kc, no);
    }
    wf = wfs;
    if (EPI) {
      float* b = reinterpret_cast<float*>(smem + a.off_bias);
      const __nv_bfloat16* bg = (const __nv_bfloat16*)a.bias;
      for (int e = threadIdx.x; e < a.s_num * SLOTS * no; e += THREADS) b[e] = to_f(bg[e]);
      bsm = b;
    }
  }

  __device__ __forceinline__ uint2 load_b(int s, int j, int nt) const {
    if (a.params_smem) return wf[((s * nch + j) * nt_n + nt) * 32 + lane];
    return b_frag_global<PATH>((const uint16_t*)a.w, s, j, nt, lane, kc, no);
  }

  __device__ __forceinline__ float bias_at(int s, int col) const {
    return a.params_smem ? bsm[s * SLOTS * no + col]
                         : to_f(((const __nv_bfloat16*)a.bias)[(size_t)s * SLOTS * no + col]);
  }

  // acc of plane p, n-tile nt -> (+ bias) * mask -> bf16 into the staged
  // row; mrow is this row's brick's mask row in shared memory
  __device__ __forceinline__ void epilogue(const float (&acc)[4], int p, int nt, int s,
                                           const __nv_bfloat16* mrow,
                                           __nv_bfloat16* out) const {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int u = p * 16 + g + 8 * hh;
      const int o = nt * 8 + 2 * tig;
      float v0 = acc[2 * hh], v1 = acc[2 * hh + 1];
      if (EPI) {
        const float m = to_f(mrow[u]);
        if (o < no) v0 = (v0 + bias_at(s, u * no + o)) * m;
        if (o + 1 < no) v1 = (v1 + bias_at(s, u * no + o + 1)) * m;
      }
      if (o + 1 < no && (no & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + u * no + o) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (o < no) out[u * no + o] = __float2bfloat16(v0);
        if (o + 1 < no) out[u * no + o + 1] = __float2bfloat16(v1);
      }
    }
  }
};

// The plane-sharing form (see share_halves): each A half is loaded once per
// row and feeds the three output planes that read its halo x-plane.  kc = 8:
// a half is one (yz offset) x 8 channels, 16 bytes, loaded by ldmatrix.x2
// from per-lane row addresses.  Other kc: 32-bit channel pairs (even kc) or
// 16-bit elements (odd kc) from per-lane offsets.  Offsets are read off T
// for plane 0, dx = 0 (T[r][9 + i] - 36 is slot r's column at yz offset i).
template <int KC, int NO, bool EPI>
struct ShareOp : Bf16Base<SHARE, KC, NO, EPI> {
  using Base = Bf16Base<SHARE, KC, NO, EPI>;
  static constexpr int NT = (NO + 7) / 8;
  static constexpr int NH = share_halves(KC);
  static constexpr int PLANE_BYTES = 36 * KC * 2;
  static constexpr int NE = KC % 2 ? 2 : 1;  // loads per A register
  static constexpr uint32_t NONE = 0xffffffffu;
  // byte offset in a halo plane of element e of this lane's A register for
  // rows g + 8*hh of half h (NONE: padding); kc = 8 keeps the ldmatrix row
  // address of slot lane & 15 in [h][0][0]
  uint32_t off[NH][2][NE];

  __device__ __forceinline__ ShareOp(const Args& a_, const TapTable& t) : Base(a_, t) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          if (KC == 8) {
            off[h][hh][e] = (uint32_t)(t.f[(this->lane & 15) * TAPS + 9 + h] - 36) * 16u;
            continue;
          }
          const int r = this->g + 8 * hh, f = 8 * h + 2 * this->tig + e;
          off[h][hh][e] = f < 9 * KC ? (uint32_t)((t.f[r * TAPS + 9 + f / KC] - 36) * KC + f % KC) * 2u
                                     : NONE;
        }
  }

  __device__ __forceinline__ void stage(unsigned char* smem) { this->stage_params(smem); }

  // A half h of halo plane q (base: the plane's first byte): rows g, g + 8
  __device__ __forceinline__ void load_half(const unsigned char* base, int h,
                                            uint32_t (&v)[2]) const {
    if (KC == 8) {
      ldm_x2(smem_u32(base) + off[h][0][0], v[0], v[1]);
      return;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (NE == 1) {
        v[hh] = off[h][hh][0] != NONE ? *reinterpret_cast<const uint32_t*>(base + off[h][hh][0]) : 0u;
      } else {
        const uint32_t lo = off[h][hh][0] != NONE ? *reinterpret_cast<const uint16_t*>(base + off[h][hh][0]) : 0u;
        const uint32_t hi = off[h][hh][1] != NONE ? *reinterpret_cast<const uint16_t*>(base + off[h][hh][1]) : 0u;
        v[hh] = lo | (hi << 16);
      }
    }
  }

  __device__ __forceinline__ void row(const unsigned char* in, unsigned char* outb,
                                      long long grow, const unsigned char* mask,
                                      long long b0) const {
    const int s = (int)(grow % this->a.s_num);
    const long long b = grow / this->a.s_num;
    float acc[4][NT][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.f;
    uint32_t prev[4][2];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      uint32_t hq[6][2];  // half h of halo plane q: rows g and g + 8
#pragma unroll
      for (int q = 0; q < 6; ++q) load_half(in + q * PLANE_BYTES, h, hq[q]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {  // dx = -1 and dx = 0
        const uint2 bf = this->load_b(s, h, nt);
#pragma unroll
        for (int p = 0; p < 4; ++p)
          mma_bf16(acc[p][nt], hq[p][0], hq[p][1], hq[p + 1][0], hq[p + 1][1], bf.x, bf.y);
      }
      if (h & 1) {  // dx = +1 at halves h - 1 and h
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 bf = this->load_b(s, NH + h / 2, nt);
#pragma unroll
          for (int p = 0; p < 4; ++p)
            mma_bf16(acc[p][nt], prev[p][0], prev[p][1], hq[p + 2][0], hq[p + 2][1], bf.x, bf.y);
        }
      } else if (h == NH - 1) {  // dx = +1 at the last half, alone
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 bf = this->load_b(s, NH + h / 2, nt);
#pragma unroll
          for (int p = 0; p < 4; ++p)
            mma_bf16(acc[p][nt], hq[p + 2][0], hq[p + 2][1], 0u, 0u, bf.x, bf.y);
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        prev[p][0] = hq[p + 2][0];
        prev[p][1] = hq[p + 2][1];
      }
    }
    const __nv_bfloat16* mrow = reinterpret_cast<const __nv_bfloat16*>(mask) + (b - b0) * SLOTS;
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(outb);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) this->epilogue(acc[p][nt], p, nt, s, mrow, out);
  }
};

// Any kc and no at run time: A gathered through T in flat k order, 16-bit
// elements.  For the shapes off the main path.
template <bool EPI>
struct GatherOp : Bf16Base<GATHER, 0, 0, EPI> {
  using Base = Bf16Base<GATHER, 0, 0, EPI>;
  const uint16_t* toff = nullptr;  // (64, 27): T * kc, in elements

  __device__ __forceinline__ GatherOp(const Args& a_, const TapTable& t) : Base(a_, t) {}

  __device__ __forceinline__ void stage(unsigned char* smem) {
    this->stage_params(smem);
    uint16_t* tt = reinterpret_cast<uint16_t*>(smem + this->a.off_tab);
    for (int e = threadIdx.x; e < SLOTS * TAPS; e += THREADS)
      tt[e] = (uint16_t)(this->tab.f[e] * this->kc);
    toff = tt;
  }

  __device__ __forceinline__ uint32_t elem(const uint16_t* in, int u, int k) const {
    const int kc = this->kc;
    if (k >= TAPS * kc) return 0u;
    const int tap = k / kc;
    return in[toff[u * TAPS + tap] + k - tap * kc];
  }

  // A elements (u, k) and (u, k + 1), packed low / high
  __device__ __forceinline__ uint32_t pair(const uint16_t* in, int u, int k) const {
    return elem(in, u, k) | (elem(in, u, k + 1) << 16);
  }

  __device__ __forceinline__ void row(const unsigned char* inb, unsigned char* outb,
                                      long long grow, const unsigned char* mask,
                                      long long b0) const {
    const int s = (int)(grow % this->a.s_num);
    const long long b = grow / this->a.s_num;
    const uint16_t* in = reinterpret_cast<const uint16_t*>(inb);
    const __nv_bfloat16* mrow = reinterpret_cast<const __nv_bfloat16*>(mask) + (b - b0) * SLOTS;
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(outb);
    const int g = this->g, k0 = 2 * this->tig;
    for (int nt = 0; nt < this->nt_n; ++nt) {
      float acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][e] = 0.f;
      for (int j = 0; j < this->nch; ++j) {
        const uint2 bf = this->load_b(s, j, nt);
        const int k = 16 * j + k0;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int u = p * 16 + g;
          mma_bf16(acc[p], pair(in, u, k), pair(in, u + 8, k), pair(in, u, k + 8),
                   pair(in, u + 8, k + 8), bf.x, bf.y);
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) this->epilogue(acc[p], p, nt, s, mrow, out);
    }
  }
};

// -------------------------------------------------------------- f32 op --

// One thread: slots u = lane and lane + 32, eight outputs at a time, FFMA
// over taps then channels.  KC = 0 takes kc at run time; kc % 4 == 0 reads
// four channels per shared-memory load.
template <int KC, bool EPI>
struct F32Op {
  static constexpr int V = KC > 0 && KC % 4 == 0 ? 4 : 1;
  const Args a;
  const TapTable& tab;
  const float* wsm = nullptr;   // (s, 27, kc, no8), zero beyond no
  const float* bsm = nullptr;   // (s, 64 * no)
  const uint16_t* toff = nullptr;
  int lane, kc, no, no8;

  __device__ __forceinline__ F32Op(const Args& a_, const TapTable& t) : a(a_), tab(t) {
    lane = threadIdx.x & 31;
    kc = KC ? KC : a.kc;
    no = a.no;
    no8 = (no + 7) / 8 * 8;
  }

  __device__ __forceinline__ void stage(unsigned char* smem) {
    uint16_t* tt = reinterpret_cast<uint16_t*>(smem + a.off_tab);
    for (int e = threadIdx.x; e < SLOTS * TAPS; e += THREADS) tt[e] = (uint16_t)(tab.f[e] * kc);
    toff = tt;
    if (!a.params_smem) return;
    float* ws = reinterpret_cast<float*>(smem + a.off_w);
    const float* wg = (const float*)a.w;
    for (int e = threadIdx.x; e < a.s_num * TAPS * kc * no8; e += THREADS) {
      const int o = e % no8;
      ws[e] = o < no ? wg[(size_t)(e / no8) * no + o] : 0.f;
    }
    wsm = ws;
    if (EPI) {
      float* b = reinterpret_cast<float*>(smem + a.off_bias);
      for (int e = threadIdx.x; e < a.s_num * SLOTS * no; e += THREADS) b[e] = ((const float*)a.bias)[e];
      bsm = b;
    }
  }

  __device__ __forceinline__ void w8(int s, int kp, int ob, float (&w)[8]) const {
    if (a.params_smem) {
      const float4* p = reinterpret_cast<const float4*>(wsm + ((size_t)s * TAPS * kc + kp) * no8 + ob * 8);
      const float4 x = p[0], y = p[1];
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
      w[4] = y.x; w[5] = y.y; w[6] = y.z; w[7] = y.w;
    } else {
      const float* p = (const float*)a.w + ((size_t)s * TAPS * kc + kp) * no;
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = ob * 8 + e < no ? __ldg(p + ob * 8 + e) : 0.f;
    }
  }

  __device__ __forceinline__ void row(const unsigned char* inb, unsigned char* outb,
                                      long long grow, const unsigned char* mask,
                                      long long b0) const {
    const int s = (int)(grow % a.s_num);
    const long long b = grow / a.s_num;
    const float* in = reinterpret_cast<const float*>(inb);
    const float* mrow = reinterpret_cast<const float*>(mask) + (b - b0) * SLOTS;
    float* out = reinterpret_cast<float*>(outb);
    const int u0 = lane, u1 = lane + 32;
    for (int ob = 0; ob < no8 / 8; ++ob) {
      float acc[2][8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[0][e] = acc[1][e] = 0.f;
      for (int tap = 0; tap < TAPS; ++tap) {
        const float* p0 = in + toff[u0 * TAPS + tap];
        const float* p1 = in + toff[u1 * TAPS + tap];
#pragma unroll
        for (int c = 0; c < kc; c += V) {
          float x0[V], x1[V];
          if (V == 4) {
            const float4 v0 = *reinterpret_cast<const float4*>(p0 + c);
            const float4 v1 = *reinterpret_cast<const float4*>(p1 + c);
            x0[0] = v0.x; x0[1] = v0.y; x0[2] = v0.z; x0[3] = v0.w;
            x1[0] = v1.x; x1[1] = v1.y; x1[2] = v1.z; x1[3] = v1.w;
          } else {
            x0[0] = p0[c];
            x1[0] = p1[c];
          }
#pragma unroll
          for (int cc = 0; cc < V; ++cc) {
            float w[8];
            w8(s, tap * kc + c + cc, ob, w);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              acc[0][e] = fmaf(x0[cc], w[e], acc[0][e]);
              acc[1][e] = fmaf(x1[cc], w[e], acc[1][e]);
            }
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int u = hh ? u1 : u0;
        const float m = EPI ? mrow[u] : 1.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int o = ob * 8 + e;
          if (o >= no) continue;
          float v = acc[hh][e];
          if (EPI) {
            const float bv = a.params_smem ? bsm[s * SLOTS * no + u * no + o]
                                           : ((const float*)a.bias)[(size_t)s * SLOTS * no + u * no + o];
            v = (v + bv) * m;
          }
          out[u * no + o] = v;
        }
      }
    }
  }
};

template <class Op>
__global__ void __launch_bounds__(THREADS, 2)
    conv_taps_kernel(const __grid_constant__ Args a, const __grid_constant__ TapTable tab) {
  extern __shared__ __align__(128) unsigned char smem[];
  Op op(a, tab);
  pipeline(op.a, op, smem);
}

// ------------------------------------------------------------ the launch --

// Shared-memory plan from the shapes alone: taps (+ bias) staged if they
// fit; then the (blocks per SM, ring depth, tile rows) that keeps the most
// warps busy, preferring two blocks per SM and the deeper ring.  A ring slot
// holds a tile's halo rows and, for K1, the mask rows of its bricks.
int plan(int path, int kc_steps, int esz, bool epi, int s_num, int kc, int no, long long rows,
         Args& a, int& grid) {
  const int nt_n = (no + 7) / 8;
  const long long w_bytes = path == F32 ? (long long)s_num * TAPS * kc * nt_n * 8 * 4
                                        : (long long)s_num * kc_steps * nt_n * 32 * 8;
  const long long b_bytes = epi ? (long long)s_num * SLOTS * no * 4 : 0;
  const int tab_bytes = path == SHARE ? 0 : SLOTS * TAPS * 2;
  a.row_in = HALO * kc * esz;
  a.row_out = SLOTS * no * esz;
  a.mask_row = epi ? SLOTS * esz : 0;
  for (int params_smem = 1; params_smem >= 0; --params_smem) {
    const long long fixed = HDR + tab_bytes + (params_smem ? w_bytes + b_bytes + 16 : 0);
    int best_score = 0, best_bps = 0, best_nst = 0, best_rows = 0;
    for (int bps = 2; bps >= 1; --bps) {
      for (int nst = MAX_NST; nst >= 3; --nst) {
        const long long avail = SMEM_SM / bps - SMEM_RESERVED - fixed - (long long)nst * a.mask_row;
        long long r = avail / ((long long)nst * (a.row_in + a.mask_row) + 2LL * a.row_out);
        if (r < 1) continue;
        if (r > MAX_TILE_ROWS) r = MAX_TILE_ROWS;
        if (r >= WARPS) r = r / WARPS * WARPS;
        const int score = bps * (int)(r < WARPS ? r : WARPS);
        if (score > best_score) {
          best_score = score;
          best_bps = bps;
          best_nst = nst;
          best_rows = (int)r;
        }
      }
    }
    if (best_score == 0) continue;
    const int r = best_rows;
    a.params_smem = params_smem;
    a.nst = best_nst;
    a.tile_rows = r;
    a.off_ring = HDR;
    a.off_mask = a.off_ring + best_nst * r * a.row_in;
    a.off_out = a.off_mask + best_nst * (r + 1) * a.mask_row;
    a.off_tab = a.off_out + 2 * r * a.row_out;
    a.off_w = a.off_tab + tab_bytes;
    a.off_bias = a.off_w + (params_smem ? (int)w_bytes : 0);
    a.rows = rows;
    a.n_tiles = (rows + r - 1) / r;
    grid = (int)(a.n_tiles < (long long)SMS * best_bps ? a.n_tiles : SMS * best_bps);
    return a.off_bias + (params_smem ? (int)b_bytes : 0);
  }
  return -1;
}

template <class Op>
int launch_op(int path, int kc_steps, int esz, bool epi, const void* h, const void* w,
              const void* bias, const void* mask, void* y, int bb, int s_num, int kc, int no,
              const void* table, void* stream) {
  if (bb <= 0 || s_num <= 0) return 0;
  Args a = {};
  int grid = 0;
  const int smem = plan(path, kc_steps, esz, epi, s_num, kc, no, (long long)bb * s_num, a, grid);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  a.h = h;
  a.w = w;
  a.bias = bias;
  a.mask = mask;
  a.y = y;
  a.s_num = s_num;
  a.kc = kc;
  a.no = no;
  TapTable tab;
  const uint8_t* t = (const uint8_t*)table;
  for (int i = 0; i < SLOTS * TAPS; ++i) tab.f[i] = t[i];
  cudaError_t err = cudaFuncSetAttribute(conv_taps_kernel<Op>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv_taps_kernel<Op><<<grid, THREADS, smem, (cudaStream_t)stream>>>(a, tab);
  return (int)cudaGetLastError();
}

template <int KC, int NO, bool EPI>
int launch_share(const void* h, const void* w, const void* bias, const void* mask, void* y,
                 int bb, int s, const void* table, void* stream) {
  return launch_op<ShareOp<KC, NO, EPI>>(SHARE, share_steps(KC), 2, EPI, h, w, bias, mask, y,
                                         bb, s, KC, NO, table, stream);
}

// The plane-sharing form is instantiated for the main path's shapes (K1:
// (7, 8), (8, 8), (12, 8), (4, 4); K3: (8, 8), (8, 12), (4, 4)); any other
// kc, no runs the runtime-shaped gather.
template <bool EPI>
int launch_bf16(const void* h, const void* w, const void* bias, const void* mask, void* y,
                int bb, int s, int kc, int no, const void* table, void* stream) {
  if (kc == 8 && no == 8) return launch_share<8, 8, EPI>(h, w, bias, mask, y, bb, s, table, stream);
  if (kc == 8 && no == 12) return launch_share<8, 12, EPI>(h, w, bias, mask, y, bb, s, table, stream);
  if (kc == 4 && no == 4) return launch_share<4, 4, EPI>(h, w, bias, mask, y, bb, s, table, stream);
  if (EPI && kc == 7 && no == 8) return launch_share<7, 8, EPI>(h, w, bias, mask, y, bb, s, table, stream);
  if (EPI && kc == 12 && no == 8) return launch_share<12, 8, EPI>(h, w, bias, mask, y, bb, s, table, stream);
  return launch_op<GatherOp<EPI>>(GATHER, (TAPS * kc + 15) / 16, 2, EPI, h, w, bias, mask, y, bb,
                                  s, kc, no, table, stream);
}

template <bool EPI>
int launch_f32(const void* h, const void* w, const void* bias, const void* mask, void* y,
               int bb, int s, int kc, int no, const void* table, void* stream) {
#define F32_KC(KC)                                                                         \
  if (kc == KC)                                                                            \
    return launch_op<F32Op<KC, EPI>>(F32, 0, 4, EPI, h, w, bias, mask, y, bb, s, kc, no, table, \
                                     stream);
  F32_KC(4)
  F32_KC(7)
  F32_KC(8)
  F32_KC(12)
#undef F32_KC
  return launch_op<F32Op<0, EPI>>(F32, 0, 4, EPI, h, w, bias, mask, y, bb, s, kc, no, table, stream);
}

}  // namespace

// K1: h (bb, s, 216*kc), w (s, 27, kc, no), bias (s, 64*no), mask (bb, 64),
// y (bb, s, 64*no), all contiguous and of one dtype, h, mask and y 16-byte
// aligned; table points to the 64 x 27 uint8 tap table in host memory.
// Returns the launch's cudaGetLastError() (cudaErrorInvalidValue if one
// halo row is too large for the ring).
extern "C" int plane_matmul_bm_f32(const void* h, const void* w, const void* bias,
                                   const void* mask, void* y, int bb, int s_num, int kc,
                                   int no, const void* table, void* stream) {
  return launch_f32<true>(h, w, bias, mask, y, bb, s_num, kc, no, table, stream);
}

extern "C" int plane_matmul_bm_bf16(const void* h, const void* w, const void* bias,
                                    const void* mask, void* y, int bb, int s_num, int kc,
                                    int no, const void* table, void* stream) {
  return launch_bf16<true>(h, w, bias, mask, y, bb, s_num, kc, no, table, stream);
}

// K3: h (bb, s, 216*kc), w (s, 27, kc, no), y (bb, s, 64*no); no epilogue.
extern "C" int plane_matmul_f32(const void* h, const void* w, void* y, int bb, int s_num,
                                int kc, int no, const void* table, void* stream) {
  return launch_f32<false>(h, w, nullptr, nullptr, y, bb, s_num, kc, no, table, stream);
}

extern "C" int plane_matmul_bf16(const void* h, const void* w, void* y, int bb, int s_num,
                                 int kc, int no, const void* table, void* stream) {
  return launch_bf16<false>(h, w, nullptr, nullptr, y, bb, s_num, kc, no, table, stream);
}
