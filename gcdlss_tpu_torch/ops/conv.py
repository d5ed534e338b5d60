"""Sparse convolution, plain PyTorch versions (the kernels' references).

Port of `gcdlss_tpu/ops/conv.py`. Activations are `[N, C]` rows; invalid rows
are zero. A sparse convolution over a book `nbr [N_out, K]` (-1 absent) is

    out[u] = sum_k x[nbr[u, k]] @ W[k]                       W: [K, Ci, Co]

and its adjoint runs over the book `adj [N_in, K]` that lists the same
(u, v, k) triples from the input side (adj[v, k] = u wherever nbr[u, k] = v):

    dX[v] = sum_k g[adj[v, k]] @ W[k]^T
    dW[k] = sum_v x[v]^T g[adj[v, k]]

For a submanifold k^3 book the adjoint is the column-reversed book (the
offsets are negation-symmetric, z fastest); for a k=2 s=2 pool book it is the
partner book at the same offset (`children` <-> `upmap`). These functions are
what the CUDA wrappers in `fused_conv` run for tensors on the CPU; on the card
they are the references the kernels are checked against. All sums are f32.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_reduce, all_reduce_sum


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] in f32 with zero rows where idx < 0."""
    rows = x.float()[idx.clamp(min=0).long()]
    return rows * (idx >= 0).unsqueeze(-1).to(rows.dtype)


def gather_conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out [N_out, Co] = sum_k x[nbr[:, k]] @ W[k] (plain K1): f32 sums,
    returned as `out_dtype`."""
    wf = w.float()
    out = torch.zeros((nbr.shape[0], w.shape[2]), dtype=torch.float32, device=x.device)
    for k in range(nbr.shape[1]):
        out += _gather_rows(x, nbr[:, k]) @ wf[k]
    return out.to(out_dtype)


def gather_conv_backward(x: torch.Tensor, g: torch.Tensor, adj: torch.Tensor, w: torch.Tensor,
                         out_dtype: torch.dtype = torch.float32, need_dx: bool = True):
    """(dX [N_in, Ci] as `out_dtype`, or None unless `need_dx`; dW [K, Ci, Co]
    f32) over the adjoint book (plain K2)."""
    dx = gather_conv(g, adj, w.transpose(1, 2), out_dtype) if need_dx else None
    xf = x.float()
    dw = torch.stack([xf.T @ _gather_rows(g, adj[:, k]) for k in range(adj.shape[1])])
    return dx, dw


class _PairedGatherConv(torch.autograd.Function):
    """Forward over `nbr_fwd`, dX and dW over the partner book `nbr_adj`."""

    @staticmethod
    def forward(ctx, x, nbr_fwd, nbr_adj, w):
        ctx.save_for_backward(x, nbr_adj, w)
        return gather_conv(x, nbr_fwd, w)

    @staticmethod
    def backward(ctx, g):
        x, nbr_adj, w = ctx.saved_tensors
        dx, dw = gather_conv_backward(x, g, nbr_adj, w, need_dx=ctx.needs_input_grad[0])
        return None if dx is None else dx.to(x.dtype), None, None, dw.to(w.dtype)


def paired_gather_conv(x: torch.Tensor, nbr_fwd: torch.Tensor, nbr_adj: torch.Tensor,
                       w: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Strided sparse conv with an explicit adjoint book, plain (f32 sums):
    out[o] = sum_d x[nbr_fwd[o, d]] @ W[d]; the backward gathers the
    cotangent through `nbr_adj` at the same offset index, which must list
    the same (o, f, d) triples from the input side (`ops.asym`'s down and up
    maps, in either role order), as the JAX package's custom VJP does. The
    card's route is `fused_conv.pool_conv` (K1, and K2 over the partner
    book)."""
    out = _PairedGatherConv.apply(x, nbr_fwd, nbr_adj, w)
    return out if bias is None else out + bias.float()


def strips_kept_plain(nbr: torch.Tensor, rows: int = 16) -> torch.Tensor:
    """What K1 visits: bool [ceil(N_out / rows), K], true where the strip of
    `rows` consecutive output rows holds a present entry at that offset. The
    kernel gathers and multiplies a (strip, offset) pair only where this is
    true; everywhere else the sum gets nothing, as in `gather_conv`."""
    n, k = nbr.shape
    pad = -n % rows
    present = torch.nn.functional.pad(nbr >= 0, (0, 0, 0, pad))
    return present.view((n + pad) // rows, rows, k).any(dim=1)


def compact_pairs_plain(adj: torch.Tensor, k: int, rows: slice = slice(None)):
    """What dW visits at offset `k` within the row slice `rows`: the present
    pairs (v, u = adj[v, k]) in the order of the rows v, as int64 tensors.
    dW[k] is the sum over these pairs of outer(x[v], g[u])."""
    start = rows.indices(adj.shape[0])[0]
    col = adj[rows, k]
    v = torch.nonzero(col >= 0).squeeze(1)
    return v + start, col[v].long()


def down_conv(x: torch.Tensor, parent: torch.Tensor, dcode: torch.Tensor,
              w: torch.Tensor, cap_out: int) -> torch.Tensor:
    """k=2 s=2 down conv by segment sum (oracle for the `children` book):
    out[parent[f]] += x[f] @ W[dcode[f]]. Returns [cap_out, Co] f32."""
    h = torch.einsum("nc,nco->no", x.float(), w.float()[dcode.long()])
    out = torch.zeros((cap_out + 1, w.shape[2]), dtype=torch.float32, device=x.device)
    out.index_add_(0, parent.long().clamp(0, cap_out), h)
    return out[:cap_out]


def up_conv(x_coarse: torch.Tensor, parent: torch.Tensor, dcode: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """k=2 s=2 transpose conv onto the fine level (oracle for the `upmap`
    book): out[f] = x_coarse[parent[f]] @ W[dcode[f]]. Returns f32."""
    nc = x_coarse.shape[0]
    g = _gather_rows(x_coarse, torch.where(parent < nc, parent, -1))
    return torch.einsum("nc,nco->no", g, w.float()[dcode.long()])


def masked_batch_norm_stats(x: torch.Tensor, valid: torch.Tensor, group=None):
    """Mean / biased variance over valid rows. Returns (mean [C], var [C], count).

    With a process `group`, over the valid rows of every rank: the sums and
    the count are all-reduced, the sums differentiably (`parallel.mesh`), so
    a rank's rows get the other ranks' terms of the gradient."""
    m = valid[:, None].to(x.dtype)
    cnt = all_reduce(valid.to(x.dtype).sum(), group).clamp(min=1.0)
    mean = all_reduce_sum((x * m).sum(0), group) / cnt
    var = all_reduce_sum(((x - mean).square() * m).sum(0), group) / cnt
    return mean, var, cnt
