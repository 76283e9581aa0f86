"""Device selection, the codec's backend tag and its numerics guard."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card by default.  Asking for
    CUDA (explicitly or by default) where there is none raises — there is
    no silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "the plain PyTorch path on the CPU"
        )
    return dev


def backend_tag(device: torch.device) -> str:
    """Identifies the probability producer: streams decode only on the
    backend that encoded them (the kernels' summation orders differ)."""
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        return f"torch-cuda-sm{major}{minor}"
    return f"torch-{device.type}"


@contextlib.contextmanager
def codec_numerics():
    """Deterministic algorithms and full-f32 products for the codec: the
    decoder reproduces the encoder's bits only if every probability
    matches bit for bit.  Restores the caller's settings on exit.

    Deterministic mode would also fill every ``torch.empty`` with NaN; the
    codec's kernels write every element of their outputs, so that fill is
    switched off here (it would cost one extra write of each halo)."""
    det = torch.utils.deterministic
    prev = (
        torch.are_deterministic_algorithms_enabled(),
        torch.is_deterministic_algorithms_warn_only_enabled(),
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        det.fill_uninitialized_memory,
    )
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cuda.matmul.allow_tf32 = prev[2]
        torch.backends.cudnn.allow_tf32 = prev[3]
        det.fill_uninitialized_memory = prev[4]
