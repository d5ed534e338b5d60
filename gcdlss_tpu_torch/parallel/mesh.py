"""Data parallelism over a `torch.distributed` process group (PyTorch port
of `gcdlss_tpu/parallel/mesh.py`).

The reference's only parallelism is Lightning DDP over NCCL (`main.py:163`).
The JAX package runs the single-device step on a mesh instead (parameters
replicated, batches sharded), so its data-parallel step *is* the
single-device step on the union batch, with every cross-scan reduction made
global by the compiler. This port keeps those semantics and writes the
reductions out: a rank holds whole scans (`shard_voxel_batch`), and a step
given a `group` (`train.pretrain.pretrain_train_step`,
`train.discover.discover_train_step`) makes batch-norm statistics, loss
means, gradients and the Stage-2 candidate set global, so every rank ends
with the parameters, statistics, tau, queue and metrics of the one-process
step on all ranks' scans.

Every gather is an all-reduce of zero-padded per-rank slots: adding zeros is
exact, and all-reduce and broadcast are what NCCL, gloo on the CPU and gloo
on CUDA tensors all serve. `group=None` everywhere means no collective at
all: the one-process step, bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def make_mesh(group=None):
    """The group a data-parallel step runs over: `group`, or the default
    (world) group. Raises unless `torch.distributed` is initialised."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group (address, world size and rank) first")
    return group if group is not None else dist.group.WORLD


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_of(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _comm_device(group, device: torch.device) -> torch.device:
    """NCCL moves CUDA tensors only; gloo moves both kinds."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks (a new tensor; no gradient)."""
    if group is None:
        return x
    y = x.detach().clone()
    dev = _comm_device(group, y.device)
    if dev != y.device:
        z = y.to(dev)
        dist.all_reduce(z, group=group)
        return z.to(y.device)
    dist.all_reduce(y, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; dx = sum over ranks of dy. With each rank's
    loss its share of the global loss, this backward hands every rank the
    global loss's gradient of the sum, so the rows of other ranks reach this
    rank's rows through the shared statistic (the sync batch norm rule)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.contiguous(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """`all_reduce` that gradients flow through (`_AllReduceSum`)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_gather_padded(x: torch.Tensor, group) -> torch.Tensor:
    """[W, *x.shape]: every rank's `x` (equal shapes), as an all-reduce of
    zero-padded slots."""
    slots = torch.zeros((world_size(group), *x.shape), dtype=x.dtype, device=x.device)
    slots[rank_of(group)] = x
    return all_reduce(slots, group)


def all_reduce_grads(params, group) -> None:
    """Sum the parameters' gradients over the ranks, in one flat buffer. A
    missing gradient counts as zeros (and stays missing only where it is
    missing on every rank)."""
    if group is None:
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    dev = params[0].device
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
                      for p in params])
    have = torch.tensor([p.grad is not None for p in params], dtype=torch.int32, device=dev)
    flat, have = all_reduce(flat, group), all_reduce(have, group)
    off = 0
    for p, h in zip(params, have.tolist()):
        n = p.numel()
        if h:
            p.grad = flat[off:off + n].view_as(p).to(p.dtype)
        off += n


def _broadcast_(t: torch.Tensor, group, src: int) -> None:
    dev = _comm_device(group, t.device)
    z = t.detach().to(dev) if dev != t.device else t.detach()
    dist.broadcast(z, src=dist.get_global_rank(group, src), group=group)
    if z is not t:
        t.data.copy_(z)


def replicate(*items, group=None, src: int = 0) -> None:
    """Broadcast, in place, from rank `src` of `group` (the world if None):
    a module's parameters and buffers, a tensor, a `torch.Generator`'s state,
    or a `FeatureQueue` / tuple of tensors. Every rank must pass the same
    items in the same order."""
    group = make_mesh(group)
    for item in items:
        if isinstance(item, torch.nn.Module):
            for t in [*item.parameters(), *item.buffers()]:
                _broadcast_(t, group, src)
        elif isinstance(item, torch.Generator):
            state = item.get_state()
            _broadcast_(state, group, src)
            item.set_state(state)
        elif isinstance(item, torch.Tensor):
            _broadcast_(item, group, src)
        else:
            for t in item:
                _broadcast_(t, group, src)


def pad_cap_for_mesh(cap: int, n_devices: int) -> int:
    """Round a capacity up so sharded axes divide evenly."""
    return -(-cap // n_devices) * n_devices


def rank_cap(cap: int, world: int) -> int:
    """A rank's share of a global capacity: `pad_cap_for_mesh(cap) / world`."""
    return pad_cap_for_mesh(cap, world) // world


def rank_caps(caps: tuple, group) -> tuple:
    """Per-rank capacities of a step over `group` (`rank_cap` of each)."""
    if group is None:
        return caps
    return tuple(rank_cap(c, world_size(group)) for c in caps)


def _scan_block(vb: dict, num_scans: int, rank: int, world: int, cap: int | None) -> tuple:
    """(first scan, scan past the last, the rank's valid rows of `vb`, its
    capacity). Raises where the scans do not split over the ranks, or where
    the rank's scans hold more voxels than its capacity: a dropped row would
    leave the group step off the one-process step with no count to show it."""
    if num_scans % world:
        raise ValueError(f"{num_scans} scans do not split over {world} ranks")
    per = num_scans // world
    lo, hi = rank * per, (rank + 1) * per
    cap = rank_cap(vb["coords"].shape[0], world) if cap is None else cap
    b = vb["coords"][:, 0]
    rows = torch.nonzero(vb["valid"] & (b >= lo) & (b < hi)).squeeze(1)
    if rows.shape[0] > cap:
        raise ValueError(f"rank {rank}'s scans hold {rows.shape[0]} voxels, above its "
                         f"capacity {cap}: raise the capacity")
    return lo, hi, rows, cap


def shard_voxel_batch(vb: dict, num_scans: int, rank: int, world: int,
                      cap: int | None = None) -> dict:
    """Rank `rank`'s whole scans of a voxel batch dict (`coords` [N, 4] with
    the scan index in column 0, rows in (scan, x, y, z) order, valid rows
    first): scans [rank S/W, (rank + 1) S/W), renumbered from 0, in a buffer
    of `cap` rows (default `rank_cap(N, world)`); pads as the collation's
    (zero coordinates and features, label -1, not valid, `point_ids` -1).
    Raises if the scans hold more than `cap` voxels."""
    lo, _, rows, cap = _scan_block(vb, num_scans, rank, world, cap)
    out = {}
    for k, v in vb.items():
        fill = -1 if k in ("labels", "mapped_labels", "point_ids") else 0
        buf = torch.full((cap, *v.shape[1:]), fill, dtype=v.dtype, device=v.device)
        buf[:rows.shape[0]] = v[rows]
        out[k] = buf
    out["coords"][:rows.shape[0], 0] -= lo
    return out


def shard_point_batch(pb: dict, vb: dict, num_scans: int, rank: int, world: int,
                      cap: int | None = None) -> dict:
    """Rank `rank`'s scans of a point batch dict ([S, P, ...] buffers) that
    belongs to the voxel batch `vb`: `voxel_row` re-pointed at the rows of
    `shard_voxel_batch(vb, num_scans, rank, world, cap)`, the pad value the
    rank's capacity. Raises where `shard_voxel_batch` does."""
    lo, hi, rows, cap = _scan_block(vb, num_scans, rank, world, cap)
    n = vb["coords"].shape[0]
    first = int((vb["valid"] & (vb["coords"][:, 0] < lo)).sum())
    out = {k: v[lo:hi].clone() for k, v in pb.items()}
    vrow = out["voxel_row"].long() - first
    ok = (out["voxel_row"] < n) & (vrow >= 0) & (vrow < rows.shape[0])
    out["voxel_row"] = torch.where(ok, vrow, cap).to(pb["voxel_row"].dtype)
    return out
