"""Sparse-conv kernel wrappers (CUDA, `csrc/gather_gemm.cu`) and their
autograd Functions.

K1 `gather_gemm` replaces the TPU kernel `_fwd_kernel` and K2
`gather_gemm_backward` replaces `_bwd_kernel` (both in
`gcdlss_tpu/ops/fused_conv.py`). One generic gather-GEMM serves every book on
the MinkUNet path: the k=5 stem, the k=3 submanifold maps and the k=2 pool
books, at any channel count. K2 returns dX (the K1 kernel on the adjoint book
with W transposed) and dW (a per-offset gathered reduction, summed in a fixed
order: deterministic).

Each wrapper takes its plain version (`ops.conv`) only for tensors on the
CPU. For CUDA tensors it checks device, dtype (bf16 activations and weights,
int32 books), shape and contiguity, allocates the outputs, launches on the
current stream and raises on a non-zero CUDA error; there is no fallback.
Each keeps a plain integer launch count (`gather_gemm.launches`).
"""

from __future__ import annotations

import torch

from . import _build
from .conv import gather_conv, gather_conv_backward

# dW row slices reduced in a second pass: enough blocks to fill the card at
# the narrow widths, a bounded partial buffer at the wide ones
_DW_ROWS_PER_SLICE = 4096
_DW_MAX_SLICES = 16


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


def _launch_gather_gemm(x, nbr, w, out):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    k, ci, co = w.shape
    rc = _build.library().gcd_gather_gemm(
        x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
        nbr.shape[0], k, ci, co, stream)
    _build.check(rc, "gather_gemm")


def gather_gemm(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K1: out [N_out, Co] f32 = sum_k x[nbr[:, k]] @ w[k] (-1 entries skipped).

    x [N_in, Ci], nbr int32 [N_out, K], w [K, Ci, Co]."""
    if x.device.type == "cpu":
        return gather_conv(x, nbr, w)
    dev = _cuda_device(x, "gather_gemm")
    _check(x, "x", torch.bfloat16, 2, dev)
    _check(nbr, "nbr", torch.int32, 2, dev)
    _check(w, "w", torch.bfloat16, 3, dev)
    if w.shape[0] != nbr.shape[1] or w.shape[1] != x.shape[1]:
        raise ValueError(f"gather_gemm: x {tuple(x.shape)}, nbr {tuple(nbr.shape)}, "
                         f"w {tuple(w.shape)} do not agree")
    out = torch.empty((nbr.shape[0], w.shape[2]), dtype=torch.float32, device=dev)
    _launch_gather_gemm(x, nbr, w, out)
    gather_gemm.launches += 1
    return out


gather_gemm.launches = 0


def gather_gemm_backward(x: torch.Tensor, g: torch.Tensor, adj: torch.Tensor,
                         w: torch.Tensor):
    """K2: (dX [N_in, Ci], dW [K, Ci, Co]) in f32 over the adjoint book.

    x [N_in, Ci], g [N_out, Co] (the output's cotangent), adj int32
    [N_in, K] with adj[v, k] = u wherever the forward book has nbr[u, k] = v,
    w [K, Ci, Co]."""
    if x.device.type == "cpu":
        return gather_conv_backward(x, g, adj, w)
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
    wt = w.transpose(1, 2).contiguous()
    dx = torch.empty((n_in, ci), dtype=torch.float32, device=dev)
    _launch_gather_gemm(g, adj, wt, dx)
    nslices = max(1, min(_DW_MAX_SLICES, -(-n_in // _DW_ROWS_PER_SLICE)))
    partial = torch.empty((nslices, k, ci, co), dtype=torch.float32, device=dev)
    dw = torch.empty((k, ci, co), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.library().gcd_gather_dw(
        x.data_ptr(), g.data_ptr(), adj.data_ptr(), partial.data_ptr(), dw.data_ptr(),
        n_in, k, ci, co, nslices, stream)
    _build.check(rc, "gather_gemm_backward")
    gather_gemm_backward.launches += 1
    return dx, dw


gather_gemm_backward.launches = 0


class SubmConvFn(torch.autograd.Function):
    """Submanifold conv; the adjoint book is the column-reversed `nbr`."""

    @staticmethod
    def forward(ctx, x, nbr, w):
        x = x.contiguous()
        ctx.save_for_backward(x, nbr, w)
        return gather_gemm(x, nbr, w.to(x.dtype)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, nbr, w = ctx.saved_tensors
        adj = nbr.flip(1).contiguous()
        dx, dw = gather_gemm_backward(x, g.to(x.dtype).contiguous(), adj, w.to(x.dtype))
        return dx.to(x.dtype), None, dw.to(w.dtype)


class PoolConvFn(torch.autograd.Function):
    """k=2 s=2 pool conv (down: children/upmap, up: upmap/children); the
    adjoint book is the partner book at the same offset, with no flip."""

    @staticmethod
    def forward(ctx, x, nbr_fwd, nbr_adj, w):
        x = x.contiguous()
        ctx.save_for_backward(x, nbr_adj, w)
        return gather_gemm(x, nbr_fwd, w.to(x.dtype)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, nbr_adj, w = ctx.saved_tensors
        dx, dw = gather_gemm_backward(x, g.to(x.dtype).contiguous(), nbr_adj, w.to(x.dtype))
        return dx.to(x.dtype), None, None, dw.to(w.dtype)


def subm_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Submanifold sparse conv [N, Ci] -> [N, Co] in x's dtype."""
    return SubmConvFn.apply(x, nbr, w)


def pool_conv(x: torch.Tensor, nbr_fwd: torch.Tensor, nbr_adj: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Strided k=2 s=2 conv over an explicit book pair, [nbr_fwd rows, Co]."""
    return PoolConvFn.apply(x, nbr_fwd, nbr_adj, w)
