"""ctypes binding to the native arithmetic coder (csrc/ac.cpp at the repo
root): the binary coder of the occupancy bits (the AC wire,
``LINR_CODEC_ENTROPY=ac``, and the mid-training test) and the shared-CDF
calls of the weight codec's Laplace mode.

Same build recipe as linr_pcgc_tpu/coding/ac.py — g++ -O3 on first use,
cached by a hash of the source — into the port's own build directory.  The
coder runs on the host in both packages, so for the same probabilities and
bits the port's streams are the JAX package's byte for byte.
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
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.bac_encode.restype = i64
    lib.bac_encode.argtypes = [f32p, u8p, i64, u8p, i64]
    lib.bac_decode.restype = i32
    lib.bac_decode.argtypes = [f32p, i64, u8p, i64, u8p]
    lib.bac_estimate_bits.restype = ctypes.c_double
    lib.bac_estimate_bits.argtypes = [f32p, u8p, i64]
    lib.bac_encode_batch.restype = None
    lib.bac_encode_batch.argtypes = [f32p, u8p, i64p, i32, u8p, i64p, i64p]
    lib.bac_decode_batch.restype = None
    lib.bac_decode_batch.argtypes = [f32p, i64p, i32, u8p, i64p, u8p]
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


def _as_prob(prob) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(prob, dtype=np.float32).reshape(-1))


def _as_bits(bits) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(bits).reshape(-1).astype(np.uint8))


def binary_encode(prob, bits) -> bytes:
    """Arithmetic-code occupancy ``bits`` under per-symbol P(bit=1)."""
    p, b = _as_prob(prob), _as_bits(bits)
    if p.shape != b.shape:
        raise ValueError(f"{p.shape[0]} probabilities for {b.shape[0]} bits")
    out = np.empty(3 * p.shape[0] + 64, np.uint8)
    size = _get_lib().bac_encode(_ptr(p, ctypes.c_float), _ptr(b, ctypes.c_uint8), p.shape[0],
                                 _ptr(out, ctypes.c_uint8), out.shape[0])
    if size < 0:
        raise RuntimeError("arithmetic encoder overflow")
    return out[:size].tobytes()


def binary_decode(prob, stream: bytes) -> np.ndarray:
    """Inverse of :func:`binary_encode`; returns uint8 bits."""
    p = _as_prob(prob)
    src = np.frombuffer(stream, np.uint8)
    out = np.empty(p.shape[0], np.uint8)
    _get_lib().bac_decode(_ptr(p, ctypes.c_float), p.shape[0], _ptr(src, ctypes.c_uint8),
                          src.shape[0], _ptr(out, ctypes.c_uint8))
    return out


def binary_estimate_bits(prob, bits) -> float:
    """Cross-entropy estimate of the code length in bits."""
    p, b = _as_prob(prob), _as_bits(bits)
    return float(_get_lib().bac_estimate_bits(_ptr(p, ctypes.c_float), _ptr(b, ctypes.c_uint8),
                                              p.shape[0]))


def _cat(arrays, dtype) -> np.ndarray:
    return np.concatenate(arrays) if arrays and sum(len(a) for a in arrays) else np.zeros(0, dtype)


def binary_encode_batch(probs: list, bits: list) -> list[bytes]:
    """Encode many independent streams with one (multithreaded) native
    call; stream k codes bits[k] under probs[k]."""
    m = len(probs)
    if m == 0:
        return []
    ps = [_as_prob(p) for p in probs]
    bs = [_as_bits(b) for b in bits]
    offsets = np.cumsum([0] + [len(p) for p in ps]).astype(np.int64)
    out_offsets = np.cumsum([0] + [3 * len(p) + 64 for p in ps]).astype(np.int64)
    out = np.empty(int(out_offsets[-1]), np.uint8)
    sizes = np.empty(m, np.int64)
    pcat, bcat = _cat(ps, np.float32), _cat(bs, np.uint8)
    _get_lib().bac_encode_batch(
        _ptr(pcat, ctypes.c_float), _ptr(bcat, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), m,
        _ptr(out, ctypes.c_uint8), _ptr(out_offsets, ctypes.c_int64), _ptr(sizes, ctypes.c_int64),
    )
    if np.any(sizes < 0):
        raise RuntimeError("arithmetic encoder overflow in batch")
    return [out[out_offsets[k]: out_offsets[k] + sizes[k]].tobytes() for k in range(m)]


def binary_decode_batch(probs: list, streams: list) -> list[np.ndarray]:
    """Decode many independent streams with one (multithreaded) native call."""
    m = len(probs)
    if m == 0:
        return []
    ps = [_as_prob(p) for p in probs]
    offsets = np.cumsum([0] + [len(p) for p in ps]).astype(np.int64)
    in_offsets = np.cumsum([0] + [len(s) for s in streams]).astype(np.int64)
    scat = np.frombuffer(b"".join(bytes(s) for s in streams), np.uint8)
    pcat = _cat(ps, np.float32)
    out = np.empty(int(offsets[-1]), np.uint8)
    _get_lib().bac_decode_batch(
        _ptr(pcat, ctypes.c_float), _ptr(offsets, ctypes.c_int64), m, _ptr(scat, ctypes.c_uint8),
        _ptr(in_offsets, ctypes.c_int64), _ptr(out, ctypes.c_uint8),
    )
    return [out[offsets[k]: offsets[k + 1]].copy() for k in range(m)]


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
