"""The card's probes of the mechanisms a fused halo + matmul kernel needs,
the ports of the three kernels of scripts/prof_pallas.py:

  * K7 ``probe_scale_shift`` (``probe_basic.kernel``): y = x * 2 + 1, a
    kernel that builds and runs;
  * K8 ``probe_matmul`` (``probe_matmul_grid.kernel``): a tiled f32 a @ b
    over a grid of 64 x 32 output tiles, as 3xTF32 on the tensor cores
    (each operand split into a big and a small TF32 part, three products
    into f32 accumulators);
  * K9 ``probe_row_gather`` (``probe_scalar_prefetch_gather.kernel``):
    out[i] = x[idx[i]], rows fetched by bulk asynchronous copies behind a
    ring of mbarriers, several in flight, and written by bulk stores; the
    kernel checks the indices itself.

Each wrapper launches its CUDA kernel (csrc/probes.cu) on a CUDA tensor
and runs its ``*_plain`` twin on a CPU tensor; there is no other path.
All three take float32; K7 and K9 are exact, K8 sums in another order than
the plain version's ``torch.matmul`` tiles and drops the small x small
TF32 products (about 2^-22 of a product).
"""

from __future__ import annotations

import torch

from . import cuda_build

MATMUL_TILE = 64          # output tile of K8's plain version
GATHER_MAX_ROW_BYTES = 32768  # a row of K9 lands in one block's shared memory


def _device(name: str, *tensors) -> str:
    """'cpu' or 'cuda' for tensors on one device; raises on any other."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name} takes tensors on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {dev}")
    return dev.type


def _f32(name: str, *tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")


def _launch(name: str, device, fn, *args):
    """Call the C launcher ``fn`` on ``device``'s current stream; raises if
    the launch failed."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {err})")


# -------------------------------------------------------------------- K7 --


def probe_scale_shift_plain(x):
    _f32("probe_scale_shift", x)
    return x * 2.0 + 1.0


def probe_scale_shift(x):
    """y = x * 2 + 1, elementwise, float32 (K7)."""
    if _device("probe_scale_shift", x) == "cpu":
        return probe_scale_shift_plain(x)
    _f32("probe_scale_shift", x)
    if not x.is_contiguous():
        raise ValueError("probe_scale_shift takes a contiguous tensor")
    y = torch.empty_like(x)
    _launch("probe_scale_shift", x.device, cuda_build.load("probes").probe_scale_shift,
            x.data_ptr(), y.data_ptr(), x.numel())
    probe_scale_shift.launches += 1
    return y


probe_scale_shift.launches = 0


def probe_empty(device):
    """Launch the empty yardstick kernel (one block, no work) on ``device``:
    K7's launch floor, a measuring stick and no port.  A card only: an
    empty launch has no CPU counterpart."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"probe_empty launches on a CUDA device, not {device}")
    _launch("probe_empty", device, cuda_build.load("probes").probe_empty)


# -------------------------------------------------------------------- K8 --


def _check_matmul(a, b):
    _f32("probe_matmul", a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"probe_matmul takes (m, k) @ (k, n), got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")


def probe_matmul_plain(a, b):
    """The plain version: one ``torch.matmul`` per 64 x 64 output tile."""
    _check_matmul(a, b)
    m, n = a.shape[0], b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    for m0 in range(0, m, MATMUL_TILE):
        for n0 in range(0, n, MATMUL_TILE):
            c[m0:m0 + MATMUL_TILE, n0:n0 + MATMUL_TILE] = torch.matmul(
                a[m0:m0 + MATMUL_TILE], b[:, n0:n0 + MATMUL_TILE])
    return c


def probe_matmul(a, b):
    """c = a @ b in float32 (K8): 3xTF32 on the tensor cores over 64 x 32
    output tiles, K chunks of 64 through a 3-stage cp.async ring; the
    same bits from every launch."""
    if _device("probe_matmul", a, b) == "cpu":
        return probe_matmul_plain(a, b)
    _check_matmul(a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("probe_matmul takes contiguous tensors")
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _launch("probe_matmul", a.device, cuda_build.load("probes").probe_matmul,
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, k, n)
    probe_matmul.launches += 1
    return c


probe_matmul.launches = 0


# -------------------------------------------------------------------- K9 --


def _check_gather(x, idx):
    _f32("probe_row_gather", x)
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError("probe_row_gather takes x (rows, d) and idx (nb,)")
    if idx.dtype != torch.int32:
        raise TypeError(f"probe_row_gather takes int32 indices, got {idx.dtype}")


def probe_row_gather_plain(x, idx):
    _check_gather(x, idx)
    return x[idx.long()]


_gather_flags: dict = {}


def _gather_flag(device) -> torch.Tensor:
    """A pinned host int32 the kernel can write (mapped through unified
    addressing), one per device: the wrapper reads it after the stream
    syncs, with no copy or fill kernel of its own."""
    device = torch.device(device)
    key = torch.cuda.current_device() if device.index is None else device.index
    flag = _gather_flags.get(key)
    if flag is None:
        flag = _gather_flags[key] = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    return flag


def launch_row_gather(x, idx, out):
    """Launch K9 on x's current stream: out = x[idx] for the indices in
    range, and the device's flag (``row_gather_flag``) set if one is not.
    Neither syncs nor checks; ``probe_row_gather`` is the call to use."""
    _check_gather(x, idx)
    if x.device.type != "cuda" or out.device != x.device or idx.device != x.device:
        raise ValueError("launch_row_gather takes CUDA tensors on one device")
    if not (x.is_contiguous() and idx.is_contiguous() and out.is_contiguous()):
        raise ValueError("probe_row_gather takes contiguous tensors")
    rows, d = x.shape
    nb = idx.shape[0]
    row_bytes = 4 * d
    if row_bytes == 0 or row_bytes % 16 or row_bytes > GATHER_MAX_ROW_BYTES:
        raise ValueError(f"probe_row_gather copies rows of 16 to {GATHER_MAX_ROW_BYTES} bytes "
                         f"in 16-byte units; a row of {d} float32 is {row_bytes} bytes")
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("probe_row_gather needs x and out at 16-byte-aligned addresses")
    if tuple(out.shape) != (nb, d) or out.dtype != torch.float32:
        raise ValueError(f"probe_row_gather writes a ({nb}, {d}) float32 out")
    _launch("probe_row_gather", x.device, cuda_build.load("probes").probe_row_gather,
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), _gather_flag(x.device).data_ptr(),
            nb, rows, d)
    probe_row_gather.launches += 1


def row_gather_flag(device) -> int:
    """Read and clear ``device``'s K9 flag: nonzero if a launch since the
    last read met an index out of range.  Syncs the current stream first."""
    torch.cuda.current_stream(device).synchronize()
    flag = _gather_flag(device)
    out = int(flag[0])
    flag[0] = 0
    return out


def probe_row_gather(x, idx):
    """out (nb, d) = x[idx] by bulk asynchronous row copies (K9).  The
    copies move whole 16-byte units from 16-byte-aligned addresses: a row of
    d float32 must be 16 to 32768 bytes, a multiple of 16, and x 16-byte
    aligned.  The kernel checks that every index lies in [0, rows); the
    wrapper syncs the stream and raises IndexError if one does not."""
    if _device("probe_row_gather", x, idx) == "cpu":
        return probe_row_gather_plain(x, idx)
    _check_gather(x, idx)
    out = torch.empty((idx.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    launch_row_gather(x, idx, out)
    if row_gather_flag(x.device):
        raise IndexError(f"probe_row_gather: an index lies outside [0, {x.shape[0]})")
    return out


probe_row_gather.launches = 0
