"""ctypes binding to the native arithmetic coder (csrc/ac.cpp at the repo
root), shared-CDF calls only: the weight codec's Laplace mode.

Same build recipe as linr_pcgc_tpu/coding/ac.py — g++ -O3 on first use,
cached by a hash of the source — into the port's own build directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "csrc", "ac.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "linr_pcgc_tpu_torch")

_lib = None
_lib_lock = threading.Lock()


def _build_and_load() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"libac_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except subprocess.CalledProcessError:
            cmd.remove("-fopenmp")  # serial batches, same streams
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.ac_encode_shared_cdf.restype = i64
    lib.ac_encode_shared_cdf.argtypes = [f32p, i32, i16p, i64, u8p, i64]
    lib.ac_decode_shared_cdf.restype = i32
    lib.ac_decode_shared_cdf.argtypes = [f32p, i32, i64, u8p, i64, i16p]
    return lib


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _build_and_load()
    return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def shared_cdf_encode(cdf, syms) -> bytes:
    """Encode int16 symbols under one shared float CDF row."""
    c = np.ascontiguousarray(np.asarray(cdf, np.float32).reshape(-1))
    s = np.ascontiguousarray(np.asarray(syms, np.int16).reshape(-1))
    n = s.shape[0]
    out = np.empty(3 * n + 64, np.uint8)
    size = _get_lib().ac_encode_shared_cdf(
        _ptr(c, ctypes.c_float), c.shape[0], _ptr(s, ctypes.c_int16), n,
        _ptr(out, ctypes.c_uint8), out.shape[0],
    )
    if size == -2:
        raise ValueError("symbol out of range for CDF")
    if size < 0:
        raise RuntimeError("arithmetic encoder overflow")
    return out[:size].tobytes()


def shared_cdf_decode(cdf, n: int, stream: bytes) -> np.ndarray:
    """Inverse of :func:`shared_cdf_encode`; returns int16 symbols."""
    c = np.ascontiguousarray(np.asarray(cdf, np.float32).reshape(-1))
    src = np.frombuffer(stream, np.uint8)
    out = np.empty(n, np.int16)
    _get_lib().ac_decode_shared_cdf(
        _ptr(c, ctypes.c_float), c.shape[0], n, _ptr(src, ctypes.c_uint8),
        src.shape[0], _ptr(out, ctypes.c_int16),
    )
    return out
