"""Weight codec: uniform quantization + 3-mode entropy coding of the model.

Port of linr_pcgc_tpu/coding/weights.py (compress/decompress only); the
bytes and side info are identical for the same flat parameter vector:

  * q = round((p - min) / range * (2^bd - 1)) in f32, round-half-even;
    the reconstruction q / (2^bd - 1) * range + min is what both codec
    sides use for probability prediction;
  * Laplace fit on the symbols: mu = round(mean(q)), b = round(mean|q-mu|);
  * mode 0 raw bytes, 1 zlib, 2 arithmetic coding under the sampled
    Laplace CDF, chosen by real size.
"""

from __future__ import annotations

import zlib

import numpy as np

from .ac import shared_cdf_decode, shared_cdf_encode

SIDE_INFO_BITS = 2 + 2 * 32  # 2 mode flag bits + min/max as 32-bit floats


def laplace_cdf_row(bitdepth: int, mu: float, b: float) -> np.ndarray:
    """Shared float-CDF row: cumsum of the normalized sampled Laplace pdf
    with a trailing 0 sentinel."""
    S = int(np.ceil(2**bitdepth))
    x = np.arange(S, dtype=np.float64)
    pdf = np.exp(-np.abs(x - mu) / b) / (2.0 * b)
    pdf = pdf / pdf.sum()
    cdf = np.cumsum(pdf)
    return np.concatenate([cdf, [0.0]]).astype(np.float32)


def quantize_uniform(flat: np.ndarray, bitdepth: int = 8):
    """Uniform min/max quantizer; returns (symbols, reconstruction, min, max)."""
    p = np.asarray(flat, np.float32)
    min_p = np.float32(p.min())
    max_p = np.float32(p.max())
    rng = np.float32(max_p - min_p)
    smax = np.float32(np.ceil(2.0**bitdepth) - 1)
    if rng == 0:
        q = np.zeros(p.shape, np.int32)
    else:
        q = np.round((p - min_p) / rng * smax).astype(np.int32)
    recon = dequantize_uniform(q, bitdepth, float(min_p), float(max_p))
    return q, recon, float(min_p), float(max_p)


def dequantize_uniform(q: np.ndarray, bitdepth: int, min_p: float, max_p: float):
    """Identical f32 ops on both codec sides: the reconstructed model is
    bit-identical."""
    smax = np.float32(np.ceil(2.0**bitdepth) - 1)
    rng = np.float32(np.float32(max_p) - np.float32(min_p))
    return (q.astype(np.float32) / smax * rng + np.float32(min_p)).astype(np.float32)


def _storage_dtype(bitdepth: int):
    if bitdepth <= 8:
        return np.uint8
    if bitdepth <= 16:
        return np.uint16
    return np.uint32


def compress_params(flat: np.ndarray, bitdepth: int = 8) -> dict:
    """Quantize + entropy-code a flat parameter vector: ``final_bytes``,
    JSON-ready ``side_info``, the dequantized ``recon`` and size
    bookkeeping."""
    n = len(flat)
    q, recon, min_p, max_p = quantize_uniform(flat, bitdepth)

    mu = float(np.round(q.astype(np.float64).mean()))
    b = float(np.round(np.abs(q - mu).mean()))

    # Laplace estimate: only pre-selects; the real AC size decides
    if b > 0:
        pdf = np.exp(-np.abs(q - mu) / b) / (2.0 * b)
        bits_laplace_est = float(-np.log2(np.maximum(pdf, 1e-300)).sum()) + 2 * bitdepth
    else:
        bits_laplace_est = float("inf")
    bpp_est = bits_laplace_est / n

    raw = q.astype(_storage_dtype(bitdepth)).tobytes()
    deflated = zlib.compress(raw)
    bpp_zlib = len(deflated) * 8 / n
    bpp_low_bound = min(bpp_zlib, float(bitdepth))

    def fallback():
        if bpp_low_bound == float(bitdepth):
            return 0, raw
        return 1, deflated

    if bpp_est > bpp_low_bound or b <= 0 or bitdepth > 8:
        enc_mode, final = fallback()
        bit_real = bpp_low_bound * n + SIDE_INFO_BITS
        side_bits = SIDE_INFO_BITS
    else:
        row = laplace_cdf_row(bitdepth, mu, b)
        coded = shared_cdf_encode(row, q.astype(np.int16))
        bit_laplace_real = len(coded) * 8 + 2 * np.ceil(bitdepth) + SIDE_INFO_BITS
        if bit_laplace_real > bpp_low_bound * n + SIDE_INFO_BITS:
            enc_mode, final = fallback()
            bit_real = bpp_low_bound * n + SIDE_INFO_BITS
            side_bits = SIDE_INFO_BITS
        else:
            enc_mode, final = 2, coded
            bit_real = bit_laplace_real
            side_bits = 2 * np.ceil(bitdepth) + SIDE_INFO_BITS

    return {
        "final_bytes": final,
        "recon": recon,
        "symbols": q,
        "enc_mode": enc_mode,
        "bit_real": float(bit_real),
        "bpp_real": float(bit_real) / n,
        "side_info_bit": float(side_bits),
        "zlib_bpp": bpp_zlib,
        "laplace_bpp_est": bpp_est,
        "side_info": {
            "mu": mu,
            "b": b,
            "min_param": min_p,
            "max_param": max_p,
            "enc_mode": enc_mode,
            "bitdepth": bitdepth,
        },
    }


def decompress_params(n_params: int, side_info: dict, blob: bytes) -> np.ndarray:
    """Rebuild the f32 parameter vector from side info + payload."""
    bitdepth = int(side_info["bitdepth"])
    mode = int(side_info["enc_mode"])
    if mode == 0:
        q = np.frombuffer(blob, _storage_dtype(bitdepth)).astype(np.int32)
    elif mode == 1:
        q = np.frombuffer(zlib.decompress(blob), _storage_dtype(bitdepth)).astype(np.int32)
    elif mode == 2:
        row = laplace_cdf_row(bitdepth, float(side_info["mu"]), float(side_info["b"]))
        q = shared_cdf_decode(row, n_params, blob).astype(np.int32)
    else:
        raise ValueError(f"unknown enc_mode {mode}")
    if len(q) != n_params:
        raise ValueError(f"decoded {len(q)} symbols, expected {n_params}")
    return dequantize_uniform(
        q, bitdepth, float(side_info["min_param"]), float(side_info["max_param"])
    )
