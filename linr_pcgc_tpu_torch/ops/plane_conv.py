"""K1: the plane-blocked slot-major conv matmul with its bias + mask
epilogue (the port of linr_pcgc_tpu/ops/pallas_conv.py::_fwd_bm_kernel).

The 16 slots of output x-plane p in 0..3 read exactly halo planes p..p+2,
the contiguous window [p*36*C, (p+3)*36*C) of the slot-major halo, and
write the contiguous output window [p*16*O, (p+1)*16*O): four products of
depth 108*C replace the dense 216*C x 64*O one.

``plane_matmul_bm`` launches the CUDA kernel (csrc/plane_conv.cu) on a CUDA
tensor and runs ``plane_matmul_bm_plain`` on a CPU tensor; there is no
other path.  Inputs may be float32 or bfloat16 (all one dtype); both
versions accumulate in float32 and round once to the input dtype.
"""

from __future__ import annotations

import torch

from . import cuda_build

B4 = 4
B4_SLOTS = 64
B4_PLANE = 36
B4_HALO_VOL = 216
DTYPES = (torch.float32, torch.bfloat16)


def _check(h, w2, kc, no, bias, mask):
    bb, s, hk = h.shape
    nn = B4_SLOTS * no
    if hk != B4_HALO_VOL * kc:
        raise ValueError(f"h has {hk} columns, expected 216*{kc}")
    for name, t, shape in (
        ("w2", w2, (s, hk, nn)), ("bias", bias, (s, nn)), ("mask", mask, (bb, B4_SLOTS)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != h.device or t.dtype != h.dtype:
            raise ValueError(f"{name} must match h's device and dtype")
    if h.dtype not in DTYPES:
        raise TypeError(f"plane_matmul_bm takes {DTYPES}, got {h.dtype}")


def plane_matmul_bm_plain(h, w2, kc: int, no: int, bias, mask):
    """The plain PyTorch version: per plane, f32 window product + bias,
    times the slot mask repeated over the O channels, rounded to h.dtype."""
    _check(h, w2, kc, no, bias, mask)
    bb, s, _ = h.shape
    n = 16 * no
    mrep = mask.float().repeat_interleave(no, dim=-1)  # (bb, 64*no)
    out = torch.empty((bb, s, B4_SLOTS * no), dtype=h.dtype, device=h.device)
    for p in range(B4):
        k0, k1 = p * B4_PLANE * kc, (p + 3) * B4_PLANE * kc
        acc = torch.einsum(
            "bsk,skn->bsn", h[:, :, k0:k1].float(), w2[:, k0:k1, p * n:(p + 1) * n].float()
        )
        acc = acc + bias[None, :, p * n:(p + 1) * n].float()
        out[:, :, p * n:(p + 1) * n] = (acc * mrep[:, None, p * n:(p + 1) * n]).to(h.dtype)
    return out


def plane_matmul_bm(h, w2, kc: int, no: int, bias, mask):
    """y (Bb, S, 64*no) = windowed h @ w2, + bias, * mask.

    h (Bb, S, 216*kc); w2 (S, 216*kc, 64*no) — the slot-major conv matrix
    (superbricks.b4_conv_weight_matrix_sm); bias (S, 64*no) slot-tiled;
    mask (Bb, 64)."""
    if h.device.type == "cpu":
        return plane_matmul_bm_plain(h, w2, kc, no, bias, mask)
    if h.device.type != "cuda":
        raise ValueError(f"plane_matmul_bm runs on CUDA or CPU tensors, not {h.device}")
    _check(h, w2, kc, no, bias, mask)
    if not all(t.is_contiguous() for t in (h, w2, bias, mask)):
        raise ValueError("plane_matmul_bm takes contiguous tensors")
    bb, s, _ = h.shape
    y = torch.empty((bb, s, B4_SLOTS * no), dtype=h.dtype, device=h.device)
    lib = cuda_build.load("plane_conv")
    fn = lib.plane_matmul_bm_f32 if h.dtype == torch.float32 else lib.plane_matmul_bm_bf16
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(h.data_ptr(), w2.data_ptr(), bias.data_ptr(), mask.data_ptr(),
                 y.data_ptr(), bb, s, kc, no, stream)
    if err:
        raise RuntimeError(f"plane_matmul_bm kernel launch failed (CUDA error {err})")
    plane_matmul_bm.launches += 1
    return y


plane_matmul_bm.launches = 0
