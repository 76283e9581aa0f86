"""Build and load the hand-written CUDA kernels (``linr_pcgc_tpu_torch/csrc``).

Each source has a plain C interface and is compiled on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/linr_pcgc_tpu_torch/`` (keyed by a hash of the source), then
loaded with ctypes: seconds per source, where a build through PyTorch's
extension headers takes minutes.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "linr_pcgc_tpu_torch")

# library name -> (source file, {C function: argtypes})
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBS = {
    "plane_conv": (
        "plane_conv.cu",
        {
            "plane_matmul_bm_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
            "plane_matmul_bm_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
            "plane_matmul_f32": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
            "plane_matmul_bf16": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
        },
    ),
    "plane_moment": (
        "plane_moment.cu",
        {
            "plane_moment_dw_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
            "plane_moment_dw_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
        },
    ),
    "halo": (
        "halo.cu",
        {"b4_halo_sm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]},
    ),
    "rans": (
        "rans.cu",
        {
            "rans_encode": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P],
            "rans_decode": [_P, _P, _I, _P, _L, _P, _P, _P, _P, _P, _I, _P],
            "rans_decode_stage": [_P, _I, _P, _P, _I, _P, _L, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _P],
        },
    ),
    "gather_conv": (
        "gather_conv.cu",
        {"gather_conv_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]},
    ),
    "wgrad": (
        "wgrad.cu",
        {
            "wgrad_ring": [_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _P, _P],
            "wgrad_gather_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
        },
    ),
    "probes": (
        "probes.cu",
        {
            "probe_scale_shift": [_P, _P, _L, _P],
            "probe_empty": [_P],
            "probe_matmul": [_P, _P, _P, _I, _I, _I, _P],
            "probe_row_gather": [_P, _P, _P, _P, _I, _I, _I, _P],
        },
    ),
}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _so_path(name: str) -> str:
    src = os.path.join(CSRC, LIBS[name][0])
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build_all(names=None, verbose: bool = False) -> dict:
    """Compile every missing library, one nvcc per source, all started
    together.  Returns {name: ptxas report} (empty unless ``verbose``);
    raises with the compiler's output if any build fails."""
    names = list(LIBS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            continue
        tmp = so + f".tmp{os.getpid()}"
        cmd = [
            nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp,
            os.path.join(CSRC, LIBS[name][0]),
        ]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, so)
    reports, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, so)
        if verbose:
            reports[name] = out
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            so = _so_path(name)
            if not os.path.exists(so):
                build_all([name])
            lib = ctypes.CDLL(so)
            for fn, argtypes in LIBS[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib
