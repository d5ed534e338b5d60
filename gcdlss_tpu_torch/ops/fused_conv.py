"""Sparse-conv kernel wrappers (CUDA, `csrc/gather_gemm.cu`) and their
autograd Functions.

K1 `gather_gemm` replaces the TPU kernel `_fwd_kernel` and K2
`gather_gemm_backward` replaces `_bwd_kernel` (both in
`gcdlss_tpu/ops/fused_conv.py`). One pair of kernels serves every book on the
MinkUNet path: the k=5 stem, the k=3 submanifold maps and the k=2 pool books,
at any channel count.

What bounds them on the card is their arithmetic, not their bytes: the books
are 74-95% absent, and a whole conv's gathered rows move in ~0.1 ms. So both
run their products on the tensor cores (bf16 `mma.sync`, f32 sums), gather
present rows 16 bytes a request, and skip absent work: K1 per (16-row strip,
offset), with no W[k] staged for an offset its 128-row block does not need; dW
walks only the present (input row, output row) pairs of each offset, compacted
in row order inside the kernel. Ragged widths, a one-channel input and
misaligned views take element-wise fills of the same tiles, chosen inside the
C entry from widths and pointers. Nothing uses float atomics: dW's row slices
are added in a fixed order, and every result repeats bit for bit.

K1 writes its result in the type the caller asks for (`out_dtype`): f32 for
comparisons, bf16 on the training path, which equals the f32 result cast and
saves a round trip of N x Co f32. K2's `reverse=True` reads the book as if
its columns were reversed (the adjoint of a submanifold book) without copying
it. K2 returns dX (K1 on the adjoint book with W transposed), or None when the
input needs no gradient, and dW in f32.

Each wrapper takes its plain version (`ops.conv`) only for tensors on the
CPU. For CUDA tensors it checks device, dtype (bf16 activations and weights,
int32 books), shape and contiguity, allocates the outputs, launches on the
current stream and raises on a non-zero CUDA error; there is no fallback.
Each keeps a plain integer launch count (`gather_gemm.launches`).

The autograd Functions (`SubmConvFn`, `PoolConvFn`) serve bf16 and f32
models: an f32 caller on the card has x, W and the cotangent rounded to bf16
on the way in, and gets f32 sums back (`_kernel_operands`).
"""

from __future__ import annotations

import torch

from . import _build
from .conv import gather_conv, gather_conv_backward

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, dim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(x: torch.Tensor, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device


def _check_out_dtype(out_dtype) -> None:
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def _launch_gather_gemm(x, nbr, w, out, reverse: bool = False):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    k, ci, co = w.shape
    rc = _build.library().gcd_gather_gemm(
        x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
        nbr.shape[0], k, ci, co, int(reverse), int(out.dtype == torch.bfloat16), stream)
    _build.check(rc, "gather_gemm")


def gather_gemm(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1: out [N_out, Co] = sum_k x[nbr[:, k]] @ w[k] (-1 entries skipped),
    summed in f32 and written as `out_dtype` (f32 or bf16).

    x [N_in, Ci], nbr int32 [N_out, K], w [K, Ci, Co]."""
    _check_out_dtype(out_dtype)
    if x.device.type == "cpu":
        return gather_conv(x, nbr, w, out_dtype)
    dev = _cuda_device(x, "gather_gemm")
    _check(x, "x", torch.bfloat16, 2, dev)
    _check(nbr, "nbr", torch.int32, 2, dev)
    _check(w, "w", torch.bfloat16, 3, dev)
    if w.shape[0] != nbr.shape[1] or w.shape[1] != x.shape[1]:
        raise ValueError(f"gather_gemm: x {tuple(x.shape)}, nbr {tuple(nbr.shape)}, "
                         f"w {tuple(w.shape)} do not agree")
    out = torch.empty((nbr.shape[0], w.shape[2]), dtype=out_dtype, device=dev)
    _launch_gather_gemm(x, nbr, w, out)
    gather_gemm.launches += 1
    return out


gather_gemm.launches = 0


def gather_gemm_backward(x: torch.Tensor, g: torch.Tensor, adj: torch.Tensor, w: torch.Tensor,
                         out_dtype: torch.dtype = torch.float32, reverse: bool = False,
                         need_dx: bool = True):
    """K2: (dX [N_in, Ci] as `out_dtype`, dW [K, Ci, Co] f32) over the adjoint
    book; dX is None, and is not computed, when `need_dx` is false.

    x [N_in, Ci], g [N_out, Co] (the output's cotangent), adj int32
    [N_in, K] with adj[v, k] = u wherever the forward book has nbr[u, k] = v,
    w [K, Ci, Co]. `reverse`: `adj` is given with its columns reversed (for a
    submanifold conv that is the forward book itself)."""
    _check_out_dtype(out_dtype)
    if x.device.type == "cpu":
        return gather_conv_backward(x, g, adj.flip(1) if reverse else adj, w, out_dtype, need_dx)
    dev = _cuda_device(x, "gather_gemm_backward")
    _check(x, "x", torch.bfloat16, 2, dev)
    _check(g, "g", torch.bfloat16, 2, dev)
    _check(adj, "adj", torch.int32, 2, dev)
    _check(w, "w", torch.bfloat16, 3, dev)
    k, ci, co = w.shape
    n_in = x.shape[0]
    if adj.shape != (n_in, k) or x.shape[1] != ci or g.shape[1] != co:
        raise ValueError(f"gather_gemm_backward: x {tuple(x.shape)}, g {tuple(g.shape)}, "
                         f"adj {tuple(adj.shape)}, w {tuple(w.shape)} do not agree")
    lib = _build.library()
    dx = None
    if need_dx:
        dx = torch.empty((n_in, ci), dtype=out_dtype, device=dev)
        _launch_gather_gemm(g, adj, w.transpose(1, 2).contiguous(), dx, reverse)
    # row slices, reduced by a second pass in a fixed order; the kernel's own
    # rule: enough blocks to fill the card, a bounded partial buffer
    nslices = lib.gcd_gather_dw_slices(n_in, k, ci, co)
    dw = torch.empty((k, ci, co), dtype=torch.float32, device=dev)
    partial = (torch.empty((nslices, k, ci, co), dtype=torch.float32, device=dev)
               if nslices > 1 else dw)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gcd_gather_dw(
        x.data_ptr(), g.data_ptr(), adj.data_ptr(), partial.data_ptr(), dw.data_ptr(),
        n_in, k, ci, co, nslices, int(reverse), stream)
    _build.check(rc, "gather_gemm_backward")
    gather_gemm_backward.launches += 1
    return dx, dw


gather_gemm_backward.launches = 0


def _kernel_operands(x: torch.Tensor, w: torch.Tensor):
    """(x, w, result dtype) as the convs hand them to K1/K2. bf16 activations
    keep bf16 results. An f32 caller on the card has x and W rounded to bf16
    and keeps the f32 sums, as the JAX package's fused conv rounds its inputs
    outside the kernel and returns the caller's dtype
    (`gcdlss_tpu/ops/fused_conv.py:480-481,773-775,867-868`). On the CPU the
    plain versions run in x's dtype throughout. Any other dtype on the card
    reaches the kernels' checks, which raise."""
    if x.dtype == torch.float32 and x.device.type == "cuda":
        return x.to(torch.bfloat16), w.to(torch.bfloat16), torch.float32
    return x, w.to(x.dtype), _out_dtype(x)


class SubmConvFn(torch.autograd.Function):
    """Submanifold conv; the adjoint book is the column-reversed `nbr`, read
    in place (`reverse=True`)."""

    @staticmethod
    def forward(ctx, x, nbr, w):
        xk, wk, out_dtype = _kernel_operands(x.contiguous(), w)
        ctx.save_for_backward(xk, nbr, wk)
        ctx.out_dtype, ctx.w_dtype = out_dtype, w.dtype
        return gather_gemm(xk, nbr, wk, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        xk, nbr, wk = ctx.saved_tensors
        dx, dw = gather_gemm_backward(xk, g.to(xk.dtype).contiguous(), nbr, wk,
                                      out_dtype=ctx.out_dtype, reverse=True,
                                      need_dx=ctx.needs_input_grad[0])
        return dx, None, dw.to(ctx.w_dtype)


class PoolConvFn(torch.autograd.Function):
    """k=2 s=2 pool conv (down: children/upmap, up: upmap/children); the
    adjoint book is the partner book at the same offset, with no flip."""

    @staticmethod
    def forward(ctx, x, nbr_fwd, nbr_adj, w):
        xk, wk, out_dtype = _kernel_operands(x.contiguous(), w)
        ctx.save_for_backward(xk, nbr_adj, wk)
        ctx.out_dtype, ctx.w_dtype = out_dtype, w.dtype
        return gather_gemm(xk, nbr_fwd, wk, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        xk, nbr_adj, wk = ctx.saved_tensors
        dx, dw = gather_gemm_backward(xk, g.to(xk.dtype).contiguous(), nbr_adj, wk,
                                      out_dtype=ctx.out_dtype,
                                      need_dx=ctx.needs_input_grad[0])
        return dx, None, None, dw.to(ctx.w_dtype)


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    """bf16 activations get bf16 results straight from the kernel; any other
    type (f32 on the CPU) keeps the f32 sums."""
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def subm_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Submanifold sparse conv [N, Ci] -> [N, Co] in x's dtype."""
    return SubmConvFn.apply(x, nbr, w)


def pool_conv(x: torch.Tensor, nbr_fwd: torch.Tensor, nbr_adj: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Strided k=2 s=2 conv over an explicit book pair, [nbr_fwd rows, Co]."""
    return PoolConvFn.apply(x, nbr_fwd, nbr_adj, w)
