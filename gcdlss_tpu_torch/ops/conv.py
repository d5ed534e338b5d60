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


def masked_batch_norm_stats(x: torch.Tensor, valid: torch.Tensor):
    """Mean / biased variance over valid rows. Returns (mean [C], var [C], count)."""
    m = valid[:, None].to(x.dtype)
    cnt = valid.to(x.dtype).sum().clamp(min=1.0)
    mean = (x * m).sum(0) / cnt
    var = ((x - mean).square() * m).sum(0) / cnt
    return mean, var, cnt
