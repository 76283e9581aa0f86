// K2: slot-major 4^3-brick halo gather.
//
// Replaces linr_pcgc_tpu/ops/superbricks.py::_b4_halo_sm_forward, which
// ran as XLA gathers + concatenations on the TPU (no Pallas twin).  Maps
// x (bb, s, 64*C) and nbr27 (bb, 27) to h (bb, s, 216*C) in column order
// (plane*36 + group)*C + c: halo column f of brick b holds channel c of
// slot v of the brick in direction d, zero where that neighbour is absent
// (nbr27 < 0); the centre direction (13) is the brick itself.
//
// The (f -> d, v) table is not written here: the Python wrapper derives it
// from the plain version by pushing an index tensor through it and passes
// it by value (it lands in the constant bank), so kernel and plain version
// cannot disagree on the layout.  The gather copies raw 2- or 4-byte words,
// so it is bit-exact in every dtype.
//
// What bounds it on an H100: it is pure data movement — read x once (plus
// its re-reads by up to 26 neighbours, mostly from L2) and write the 3.4x
// larger halo once — so HBM bytes.  One thread per (brick, stage, column)
// copies the C contiguous channels of one slot; neighbouring threads write
// neighbouring runs.  Later work: keep the halo out of HBM altogether by
// gathering the neighbour rows into shared memory inside K1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HALO_COLS = 216;
constexpr int CENTRE = 13;

struct HaloTable {
  uint16_t src[HALO_COLS];  // d * 64 + v
};

template <typename W>
__global__ void b4_halo_sm_kernel(const W* __restrict__ x, const int* __restrict__ nbr27,
                                  W* __restrict__ h, long long n_cols, int s_num, int c,
                                  HaloTable tab) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < n_cols;
       j += (long long)gridDim.x * blockDim.x) {
    const int f = (int)(j % HALO_COLS);
    const long long bs = j / HALO_COLS;  // b * s_num + s
    const int s = (int)(bs % s_num);
    const long long b = bs / s_num;
    const int d = tab.src[f] >> 6;
    const int v = tab.src[f] & 63;
    const long long src = d == CENTRE ? b : (long long)nbr27[b * 27 + d];
    W* out = h + j * c;
    if (src < 0) {
      for (int ch = 0; ch < c; ++ch) out[ch] = 0;
    } else {
      const W* in = x + ((src * s_num + s) * 64 + v) * c;
      for (int ch = 0; ch < c; ++ch) out[ch] = in[ch];
    }
  }
}

}  // namespace

// x (bb, s, 64*c), nbr27 (bb, 27) int32, h (bb, s, 216*c), contiguous;
// elem_bytes is 2 or 4; table points to 216 uint16 entries in host memory.
// Returns the launch's cudaGetLastError().
extern "C" int b4_halo_sm(const void* x, const void* nbr27, void* h, long long bb,
                          int s_num, int c, int elem_bytes, const void* table,
                          void* stream) {
  const long long n_cols = bb * s_num * HALO_COLS;
  if (n_cols <= 0) return 0;
  HaloTable tab;
  const uint16_t* t = (const uint16_t*)table;
  for (int i = 0; i < HALO_COLS; ++i) tab.src[i] = t[i];
  const int threads = 256;
  long long blocks = (n_cols + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond a few waves
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 2) {
    b4_halo_sm_kernel<uint16_t><<<(unsigned)blocks, threads, 0, st>>>(
        (const uint16_t*)x, (const int*)nbr27, (uint16_t*)h, n_cols, s_num, c, tab);
  } else if (elem_bytes == 4) {
    b4_halo_sm_kernel<uint32_t><<<(unsigned)blocks, threads, 0, st>>>(
        (const uint32_t*)x, (const int*)nbr27, (uint32_t*)h, n_cols, s_num, c, tab);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
