"""linr_pcgc_tpu_torch — the PyTorch/CUDA port of linr_pcgc_tpu.

The same codec (a tiny multiscale occupancy network overfit per GOP, its
quantized weights and rANS-coded octree occupancy as the bitstream) in
PyTorch, with every TPU kernel of the serving path replaced by a kernel
written by hand for Hopper (``csrc/``).  The sub-layout mirrors the JAX
package so each module has an obvious counterpart:

  * ``ops``      — voxel geometry (int64 keys, octree down/up), the slot-major
                   brick layout, the plane-blocked conv and its halo gather
                   (CUDA kernels K1/K2 beside their plain versions), the
                   gather backend's neighbour-gather conv (K10), rANS.
  * ``models``   — parameters (flat dict in the JAX flatten order), the
                   slot-major superbrick forward and the flat gather
                   network.
  * ``coding``   — containers, the weight codec, the native AC loader.
  * ``data``     — PLY IO, synthetic clouds, octree pyramids.
  * ``runtime``  — checkpoints, both trainers, the device codec, the gather
                   codec, encode_gop/decode_gop, the mid-training test.
  * ``cli``      — the flag-compatible command line, plus ``--device``.

Entry points run on the card unless the caller passes ``device="cpu"``;
a CUDA tensor always goes through the kernels (no fallback).  The package
imports torch and numpy only, never jax or linr_pcgc_tpu.
"""

import os as _os

# cuBLAS is deterministic only with a fixed workspace; the codec runs with
# torch.use_deterministic_algorithms(True), which requires this setting
# before the first cuBLAS handle is created.
_os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

__version__ = "0.1.0"
