"""What holds K10 and K11 back: variants of a kernel timed on the card.

    python -m linr_pcgc_tpu_torch.tools.probe_k10_k11

Builds a small CUDA source of its own (``PROBE_SRC``, with nvcc into the
git-ignored build directory) that holds the neighbour-gather conv's loop
as K10 ran it before its redesign (one thread a node: per tap, load
idx[t, n], then the x row it names, then the FMAs, Cin = Cout = 8) in four
variants, and two streaming reads:

* ``full``: the loop as it was;
* ``no_x``: the x-row loads removed (a register value in their place; the
  index loads, the branch and the FMAs stay);
* ``no_fma``: the FMAs removed (the x rows summed into one accumulator);
* ``idx_only``: only the index loads;
* ``stream_hbm``: 16-byte loads over a 1 GiB buffer, several in flight a
  thread: the card's practical HBM read rate;
* ``stream_l2``: the same over a 16 MiB buffer read 64 times: its L2 rate.

Each runs on frame 0's level-0 map of the smoke's training cell
(``synthetic_cloud(800_000, depth=10, seed=7)``, N 786,432, K 27) and is
timed by profiler device time; the resident blocks an SM come from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.  The tool prints one
line a variant and, last, one JSON object with the times, the achieved
bytes/s (the kernel's unique bytes over its time) and the bytes in flight
an SM that the old loop allows (resident threads x one index word and one
x row).  Without a card it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess

import torch

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// the neighbour-gather conv's loop before its redesign, Cin = Cout = 8:
// MODE 0 as it was, 1 no x loads, 2 no FMAs, 3 index loads only
template <int MODE>
__global__ void __launch_bounds__(256) old_k10(const float* __restrict__ x,
                                                const int* __restrict__ idx,
                                                const float* __restrict__ w,
                                                float* __restrict__ y, int n, int k) {
  extern __shared__ float w_s[];
  for (int i = threadIdx.x; i < k * 64; i += 256) w_s[i] = w[i];
  __syncthreads();
  const int node = blockIdx.x * 256 + threadIdx.x;
  if (node >= n) return;
  float acc[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) acc[o] = 0.0f;
  const int* col = idx + node;
  for (int t = 0; t < k; ++t) {
    const int j = __ldg(col + (size_t)t * n);
    if (j < 0) continue;
    if (MODE == 3) {
      acc[0] += (float)j;
      continue;
    }
    const float* xr = x + (size_t)j * 8;
    const float* wt = w_s + t * 64;
#pragma unroll
    for (int c4 = 0; c4 < 8; c4 += 4) {
      float4 v;
      if (MODE == 1) {
        v = make_float4((float)(j & 7), 1.0f, 2.0f, 3.0f);
      } else {
        v = __ldg(reinterpret_cast<const float4*>(xr + c4));
      }
      if (MODE == 2) {
        acc[c4] += v.x + v.y + v.z + v.w;
        continue;
      }
      const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int o = 0; o < 8; ++o) acc[o] = fmaf(xv[q], wt[(c4 + q) * 8 + o], acc[o]);
    }
  }
  float* yr = y + (size_t)node * 8;
#pragma unroll
  for (int o = 0; o < 8; ++o) yr[o] = acc[o];
}

// 16-byte loads, 4 in flight a thread, summed into one word a block
__global__ void __launch_bounds__(256) stream_read(const uint4* __restrict__ p, long long n16,
                                                   int reps, unsigned* out) {
  unsigned s = 0;
  for (int r = 0; r < reps; ++r)
    for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n16; i += 4LL * gridDim.x * 256) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long j = i + (long long)u * gridDim.x * 256;
        v[u] = j < n16 ? __ldg(p + j) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) s ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
    }
  if (s == 0x9e3779b9u) out[blockIdx.x] = s;  // keeps the loads
}

template <int MODE>
int run_old(const void* x, const void* idx, const void* w, void* y, int n, int k, void* st) {
  old_k10<MODE><<<(n + 255) / 256, 256, k * 64 * 4, (cudaStream_t)st>>>(
      (const float*)x, (const int*)idx, (const float*)w, (float*)y, n, k);
  return (int)cudaGetLastError();
}

extern "C" int probe_old_k10(int mode, const void* x, const void* idx, const void* w, void* y,
                             int n, int k, void* st) {
  switch (mode) {
    case 0: return run_old<0>(x, idx, w, y, n, k, st);
    case 1: return run_old<1>(x, idx, w, y, n, k, st);
    case 2: return run_old<2>(x, idx, w, y, n, k, st);
    case 3: return run_old<3>(x, idx, w, y, n, k, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int probe_old_k10_blocks(int mode, int k) {
  int b = 0;
  const void* f = mode == 0 ? (const void*)old_k10<0> : mode == 1 ? (const void*)old_k10<1>
                : mode == 2 ? (const void*)old_k10<2> : (const void*)old_k10<3>;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, f, 256, k * 64 * 4);
  return b;
}

extern "C" int probe_stream(const void* p, long long n16, int reps, void* out, int blocks,
                            void* st) {
  stream_read<<<blocks, 256, 0, (cudaStream_t)st>>>((const uint4*)p, n16, reps, (unsigned*)out);
  return (int)cudaGetLastError();
}
"""

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
MODES = {"full": 0, "no_x": 1, "no_fma": 2, "idx_only": 3}


def _lib():
    from linr_pcgc_tpu_torch.ops import cuda_build

    tag = hashlib.sha256(PROBE_SRC.encode()).hexdigest()[:16]
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(cuda_build.BUILD_DIR, f"libprobe_k10_k11_{tag}.so")
    if not os.path.exists(so):
        src = so[:-3] + ".cu"
        with open(src, "w") as f:
            f.write(PROBE_SRC)
        subprocess.run([cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so, src],
                       check=True)
    lib = ctypes.CDLL(so)
    lib.probe_old_k10.argtypes = [_I, _P, _P, _P, _P, _I, _I, _P]
    lib.probe_old_k10_blocks.argtypes = [_I, _I]
    lib.probe_stream.argtypes = [_P, _L, _I, _P, _I, _P]
    for fn in (lib.probe_old_k10, lib.probe_old_k10_blocks, lib.probe_stream):
        fn.restype = ctypes.c_int
    return lib


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_k10_k11 runs on the card: torch.cuda.is_available() is False")
    from linr_pcgc_tpu_torch.data import build_pyramid, synthetic_cloud
    from linr_pcgc_tpu_torch.data.dataset import level_arrays_from_coords
    from linr_pcgc_tpu_torch.tools.prof_probes import device_ms

    dev = torch.device("cuda")
    lib = _lib()
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    lev = build_pyramid(synthetic_cloud(800_000, depth=10, seed=7), 7, device=dev).levels[0]
    idx = level_arrays_from_coords(lev.coords, lev.n, 3, (1,), dev)[3].T.contiguous()
    k, n = idx.shape
    present = int((idx >= 0).sum())
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((n, 8), generator=gen, device=dev)
    w = torch.randn((k, 8, 8), generator=gen, device=dev) * (8 * k) ** -0.5
    y = torch.empty((n, 8), device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"device": torch.cuda.get_device_name(0), "n": n, "k": k, "present": present}
    unique = 4 * (idx.numel() + x.numel() + y.numel())
    for name, mode in MODES.items():
        call = lambda m=mode: lib.probe_old_k10(m, x.data_ptr(), idx.data_ptr(), w.data_ptr(),  # noqa: E731
                                                y.data_ptr(), n, k, st())
        if call():
            raise RuntimeError(f"probe {name} failed to launch")
        ms = device_ms(call)
        blocks = lib.probe_old_k10_blocks(mode, k)
        out[f"k10_{name}_ms"] = ms
        out[f"k10_{name}_blocks_per_sm"] = blocks
        print(f"old K10 {name}: {ms:.4f} ms device, {blocks} blocks of 256 an SM, unique bytes "
              f"{unique / ms / 1e6:.0f} GB/s", flush=True)
    # the old loop keeps one index word and at most one x row (32 B) in
    # flight a thread
    threads = out["k10_full_blocks_per_sm"] * 256
    out["k10_full_inflight_bytes_per_sm"] = threads * (4 + 32)
    out["k10_full_unique_GBps"] = unique / out["k10_full_ms"] / 1e6
    # streaming reads: HBM (1 GiB once) and L2 (16 MiB 64 times)
    sink = torch.zeros(4 * sms, dtype=torch.int32, device=dev)
    for name, nbytes, reps in (("stream_hbm", 1 << 30, 1), ("stream_l2", 16 << 20, 64)):
        buf = torch.ones(nbytes // 4, dtype=torch.int32, device=dev)
        call = lambda b=buf, r=reps, nb=nbytes: lib.probe_stream(  # noqa: E731
            b.data_ptr(), nb // 16, r, sink.data_ptr(), 4 * sms, st())
        if call():
            raise RuntimeError(f"probe {name} failed to launch")
        ms = device_ms(call, 10)
        out[f"{name}_ms"] = ms
        out[f"{name}_GBps"] = nbytes * reps / ms / 1e6
        print(f"{name}: {nbytes * reps / 2**20:.0f} MiB in {ms:.4f} ms, "
              f"{out[f'{name}_GBps']:.0f} GB/s", flush=True)
        del buf
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
