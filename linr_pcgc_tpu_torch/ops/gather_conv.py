"""The neighbour-gather conv of the flat gather backend: K10.

Port of linr_pcgc_tpu/models/network.py ``_gather_nbrs`` / ``_conv3_apply``
/ ``_conv3_op`` (XLA work on the TPU, no Pallas kernel):

    y[n, o] = b[o] + sum_k sum_c w[k, c, o] * x[idx[k, n], c]

with a tap whose ``idx`` is negative contributing 0.  Layouts: x (N, Cin)
float32 node-major, so that a neighbour's channels are one contiguous row
(one 32-byte sector at Cin = 8) and the rows of neighbouring nodes at one
tap lie near each other; idx (K, N) int32, so that a tap's indices of
neighbouring nodes are neighbouring words; w (K, Cin, Cout); y (N, Cout).

``gather_conv`` launches the CUDA kernel K10 (csrc/gather_conv.cu) on a
CUDA tensor and runs ``gather_conv_plain`` (a gather, then one einsum) on a
CPU tensor; there is no other path.  The kernel sums each output over the
taps in order, the channels in order, in f32 FMAs, then adds the bias; the
plain version sums the same products in the einsum's order, so the two
agree to f32 rounding, and two launches give the same bits (the codec's
encoder and decoder must agree).

K10 takes any Cin and Cout: a block computes a chunk of 4 or 8 outputs
for a tile of 256 (or 128) nodes, one thread a node, the last chunk
masked; a thread copies its node's index words into shared memory, then
walks the taps with the next tap's x row in flight into shared memory; the
chunk's columns of w stay there too (``k10_plan``); a tile whose shared
memory passes a block's raises.

``gather_conv3`` is the conv with its gradient, JAX's scatter-free VJP:
the neighbourhood relation is symmetric and the lexicographic offset table
has ``offsets[K-1-k] == -offsets[k]`` (per dilation too), so dx is the same
kernel over the same map with w flipped along K and transposed (Cin <->
Cout); dw is K11 (ops/wgrad.py::wgrad_gather, the reduction over the nodes
reading x's rows through the same map), whose plain version is
``gather_conv_dw``: the gather and a batched ``torch.matmul`` (JAX's
``dot_general``), which materialises the gathered (K, N, Cin) tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_build
from .wgrad import wgrad_gather

SMEM_MAX = 227 * 1024  # an H100 block's most shared memory, after opting in
K10_RING = 2           # csrc/gather_conv.cu's x rows a thread keeps in shared memory


class K10Plan(NamedTuple):
    chunk: int    # outputs a block computes: 4 or 8
    chunks: int   # blocks along Cout (grid.y), the last one masked
    threads: int  # nodes a block, one a thread: 256, or 128 where shared memory is short
    smem: int     # dynamic shared memory per block: index words, w's chunk, the ring


def k10_smem(k: int, cin: int, chunk: int, threads: int) -> int:
    """csrc/gather_conv.cu's shared memory: the (K, threads) index words
    (rounded up to 16 bytes), the chunk's (K, Cin, chunk) w, the (K10_RING,
    Cin, threads) x rows."""
    return -(-4 * k * threads // 16) * 16 + 4 * (k * cin * chunk + K10_RING * cin * threads)


def k10_plan(k: int, cin: int, cout: int) -> K10Plan:
    """K10's launch plan from the shapes alone: chunks of the output
    channels (Cout 4 and 8 in one chunk of their own width, the inception
    branch's and the blocks' at hidden_channel_conv 8; chunks of 8 from
    Cout 8 up, of 4 below), then tiles of 256 nodes, or 128 where those
    pass a block's shared memory.  Raises ValueError where the kernel
    cannot run: no taps or channels, or a 128-node tile past a block's
    shared memory."""
    if min(k, cin, cout) < 1:
        raise ValueError(f"gather_conv needs a tap and a channel in and out, got K={k} "
                         f"Cin={cin} Cout={cout}")
    chunk = 8 if cout >= 8 else 4
    threads = 256 if k10_smem(k, cin, chunk, 256) <= SMEM_MAX else 128
    smem = k10_smem(k, cin, chunk, threads)
    if smem > SMEM_MAX:
        raise ValueError(f"gather_conv's tile ({smem} bytes of shared memory at K={k} Cin={cin}) "
                         "exceeds a block's shared memory")
    return K10Plan(chunk, -(-cout // chunk), threads, smem)


def check_gather_conv(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None = None) -> K10Plan:
    """K10's checks of shapes, types, layout and widths, on any device:
    its plan, or ValueError / TypeError for what the kernel does not take."""
    if x.dim() != 2 or idx.dim() != 2 or w.dim() != 3:
        raise ValueError(f"gather_conv takes x (N, Cin), idx (K, N), w (K, Cin, Cout), got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}, {tuple(w.shape)}")
    n, cin = x.shape
    k, cout = w.shape[0], w.shape[2]
    if tuple(idx.shape) != (k, n) or w.shape[1] != cin or (b is not None and tuple(b.shape) != (cout,)):
        raise ValueError(f"gather_conv shapes disagree: x {tuple(x.shape)}, idx {tuple(idx.shape)}, "
                         f"w {tuple(w.shape)}, b {None if b is None else tuple(b.shape)}")
    if any(t.dtype != torch.float32 for t in (x, w) + ((b,) if b is not None else ())):
        raise TypeError("gather_conv takes float32 x, w and b")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_conv takes an int32 idx, got {idx.dtype}")
    if not all(t.is_contiguous() for t in (x, idx, w) + ((b,) if b is not None else ())):
        raise ValueError("gather_conv takes contiguous tensors")
    return k10_plan(k, cin, cout)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, C), (K, N) -> (K, N, C): x's rows by idx, zeros where idx < 0."""
    n = x.shape[0]
    xp = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return xp[torch.where(idx >= 0, idx, n).long()]


def gather_conv_plain(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of K10: the gathered rows contracted with w over
    (K, Cin) at once, plus b."""
    y = torch.einsum("knc,kco->no", gather_rows(x, idx), w)
    return y if b is None else y + b


def gather_conv(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor | None = None) -> torch.Tensor:
    """x (N, Cin), idx (K, N) int32, w (K, Cin, Cout), b (Cout,) or None ->
    y (N, Cout), float32: K10 on CUDA tensors, the plain version on CPU
    ones."""
    tensors = [t for t in (x, idx, w, b) if t is not None]
    dev = x.device
    if any(t.device != dev for t in tensors):
        raise ValueError("gather_conv takes tensors on one device")
    if dev.type == "cpu":
        return gather_conv_plain(x, idx, w, b)
    if dev.type != "cuda":
        raise ValueError(f"gather_conv runs on CUDA or CPU tensors, not {dev}")
    plan = check_gather_conv(x, idx, w, b)
    (n, cin), (k, cout) = x.shape, (w.shape[0], w.shape[2])
    y = torch.empty((n, cout), dtype=torch.float32, device=dev)
    if n == 0:
        return y
    with torch.cuda.device(dev):
        err = cuda_build.load("gather_conv").gather_conv_f32(
            x.data_ptr(), idx.data_ptr(), w.data_ptr(), 0 if b is None else b.data_ptr(),
            y.data_ptr(), n, k, cin, cout, plan.chunk, plan.threads,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gather_conv kernel launch failed (CUDA error {err})")
    gather_conv.launches += 1
    return y


gather_conv.launches = 0


def gather_conv_dw(x: torch.Tensor, idx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw (K, Cin, Cout) = sum_n gathered x (K, N, Cin)^T dy (N, Cout): the
    plain version of K11's gather form."""
    return torch.matmul(gather_rows(x, idx).transpose(1, 2), dy)


class _GatherConv3(torch.autograd.Function):
    """K10 with JAX's scatter-free VJP, dw by K11; saves (x, w, idx) only."""

    @staticmethod
    def forward(ctx, x, w, b, idx):
        ctx.save_for_backward(x, w, idx)
        return gather_conv(x, idx, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, idx = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = gather_conv(dy, idx, w.flip(0).transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dw = wgrad_gather(x, dy, idx)
        if ctx.needs_input_grad[2]:
            db = dy.sum(0)
        return dx, dw, db, None


def gather_conv3(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The k^3 conv with its gradient: x (N, Cin), idx (K, N) int32, w (K,
    Cin, Cout), b (Cout,) -> (N, Cout)."""
    return _GatherConv3.apply(x.contiguous(), w.contiguous(), b.contiguous(), idx.contiguous())
