"""Data parallelism over a `torch.distributed` process group (PyTorch port
of `gcdlss_tpu/parallel/mesh.py`).

The reference's only parallelism is Lightning DDP over NCCL (`main.py:163`).
The JAX package runs the single-device step on a mesh instead (parameters
replicated, batches sharded), so its data-parallel step *is* the
single-device step on the union batch, with every cross-scan reduction made
global by the compiler. This port keeps those semantics and writes the
reductions out: a rank holds whole scans (`shard_voxel_batch`), and a step
given a `group` (every training step: `train.pretrain`, `train.discover`,
`train.finetune`, `train.nops`, `train.cylinder`) makes batch-norm
statistics, loss means, gradients, the candidate sets and the rows a loss
pairs across scans global, so every rank ends with the parameters,
statistics, tau, queue and metrics of the one-process step on all ranks'
scans.

Every gather is an all-reduce of zero-padded per-rank slots: adding zeros is
exact, and all-reduce and broadcast are what NCCL, gloo on the CPU and gloo
on CUDA tensors all serve. `group=None` everywhere means no collective at
all: the one-process step, bit for bit.
"""

from __future__ import annotations

import dataclasses

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


class _GatherRows(torch.autograd.Function):
    """The ranks' row blocks in rank order; backward: the rank's own rows of
    the cotangent, summed over the ranks first if `summed`."""

    @staticmethod
    def forward(ctx, x, group, summed):
        ctx.group, ctx.rows, ctx.summed = group, x.shape[0], summed
        return all_gather_padded(x.detach(), group).reshape(-1, *x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = all_reduce(g.contiguous(), ctx.group)
        r = rank_of(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows].contiguous(), None, None


def gather_rows(x: torch.Tensor, group, cotangent: str = "replicated") -> torch.Tensor:
    """[W * n, ...]: every rank's `x` [n, ...] (equal shapes), in rank order,
    on every rank; `x` itself without a group. Differentiable, by one of two
    backward rules for the rank's rows:

      * "replicated": the rank's own slice of the cotangent. For a caller
        whose every rank computes the same global function of the gathered
        rows (the sharded passes' outputs in `parallel.sp_discover`, Lovasz
        over the union's points in `train.cylinder`): the cotangent is then
        the same on every rank and holds each term once, so slicing it hands
        each row its gradient once, and `all_reduce_grads` counts each term
        once. Summing it would count every term W times.
      * "summed": the cotangent summed over the ranks, then sliced. For a
        caller whose ranks each compute their own share of the loss from
        rows other ranks hold (a feature-mix pair whose partner lives on
        another rank: `union_rows`): a row's gradient is then the sum of
        what every rank's share sends it. Slicing alone would lose the
        terms of the other ranks' shares.

    Boolean and integer rows carry no gradient."""
    if cotangent not in ("replicated", "summed"):
        raise ValueError(f"cotangent must be 'replicated' or 'summed', got {cotangent!r}")
    if group is None:
        return x
    if x.dtype == torch.bool:
        return _GatherRows.apply(x.to(torch.uint8), group, False).bool()
    return _GatherRows.apply(x, group, cotangent == "summed")


def union_rows(grows: torch.Tensor, valid: torch.Tensor, cap: int, group, *pairs) -> tuple:
    """Each (rows, fill) of `pairs` in the row order of the one-process plan
    on the union batch (`cap` rows; `fill` where no rank holds a row), so
    that permutations drawn over the union's rows index them; the rows as
    they are without a group. `grows` [n]: each local row's index in that
    plan (`global_rows`), read where `valid`. A rank's share
    of a loss reads other ranks' rows here, so they take `gather_rows`'
    "summed" rule."""
    if group is None:
        return tuple(x for x, _ in pairs)
    n = grows.shape[0]
    gidx = gather_rows(torch.where(valid, grows, -1), group)
    index = torch.full((cap,), world_size(group) * n, dtype=torch.int64, device=grows.device)
    held = gidx >= 0
    index[gidx[held]] = torch.nonzero(held).squeeze(1)
    out = []
    for x, fill in pairs:
        g = gather_rows(x, group, "summed")
        pad = torch.full((1, *g.shape[1:]), fill, dtype=g.dtype, device=g.device)
        out.append(torch.cat([g, pad])[index])
    return tuple(out)


def rank_config(cfg, group, caps: tuple = ("voxel_caps",)):
    """`cfg`, the config of a step over whole scans (`num_sup_scans` scans a
    side, `sup_voxel_cap` rows of the sup side, and the capacity tuples it
    names in `caps`), as one rank of `group` sees it: its share of the
    scans and of each capacity (`rank_cap`). `None` returns `cfg`. Raises
    for scans that do not split over the ranks."""
    if group is None:
        return cfg
    w = world_size(group)
    if cfg.num_sup_scans % w:
        raise ValueError(f"{cfg.num_sup_scans} scans a side do not split over {w} ranks")
    return dataclasses.replace(cfg, sup_voxel_cap=rank_cap(cfg.sup_voxel_cap, w),
                               num_sup_scans=cfg.num_sup_scans // w,
                               **{f: rank_caps(getattr(cfg, f), group) for f in caps})


def global_scans(scans_a_side: int, group, device, sides: int = 2) -> torch.Tensor:
    """Each local scan's index among every rank's scans (int64 [sides S/W]):
    rank r holds scans [r S/W, (r + 1) S/W) of each side as its local scans
    k S/W .. (k + 1) S/W - 1 of side k (`scans_a_side` = S/W), and the union
    batch holds side 0's S scans, then side 1's (sup, then unsup)."""
    s_l = scans_a_side
    scan_l = torch.arange(sides * s_l, device=device)
    side = scan_l // s_l
    return side * s_l * world_size(group) + rank_of(group) * s_l + scan_l - side * s_l


def global_rows(lvl0, scans_a_side: int, group, sides: int = 2) -> torch.Tensor:
    """Each level-0 row's index in the one-process combined plan of every
    rank's scans (int64 [cap0]). That plan's rows are the valid voxels in
    (scan, x, y, z) order, sup scans before unsup scans (`global_scans`;
    `sides` 1 for a one-sided batch; `scans_a_side` a rank's): a row's
    index is the voxel count of the scans before its own in that global
    order (all ranks' per-scan counts, gathered) plus its rank within its
    scan. Rows past the valid ones keep their local index (no candidate is
    there); without a group every row does."""
    s_l = scans_a_side
    s_g = s_l * world_size(group)
    dev = lvl0.valid.device
    b = lvl0.coords[:, 0].long()
    local_counts = torch.zeros(sides * s_l, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(lvl0.valid, b, 0), lvl0.valid.long())
    scan_g = global_scans(s_l, group, dev, sides)
    counts = all_reduce(torch.zeros(sides * s_g, dtype=torch.int64, device=dev).index_copy_(
        0, scan_g, local_counts), group)
    start_g = torch.cumsum(counts, 0) - counts
    start_l = torch.cumsum(local_counts, 0) - local_counts
    rows = torch.arange(lvl0.valid.shape[0], dtype=torch.int64, device=dev)
    bs = torch.where(lvl0.valid, b, 0)
    return torch.where(lvl0.valid, start_g[scan_g[bs]] + rows - start_l[bs], rows)


def gather_candidates(key, cand_mask, cand_cap: int, group, *payloads):
    """The global first `cand_cap` candidates by key over every rank: each
    rank's own first `cand_cap` (no rank holds more of the global ones),
    gathered, ordered by key. Returns (each payload's rows [cand_cap, ...]
    in that order, the owner rank of each (-1 past the candidates), the
    local row of each on its owner (-1 where no row was gathered)). The
    rows past the candidates are other rows': mask them by the candidate
    count. Without a group, the first `cand_cap` rows by key."""
    n = key.shape[0]
    take = min(cand_cap, n)
    lrows = torch.argsort(key, stable=True)[:take]
    big = torch.iinfo(torch.int64).max
    lkey = torch.full((cand_cap,), big, dtype=torch.int64, device=key.device)
    lkey[:take] = torch.where(cand_mask[lrows], key[lrows], big)
    lrow = torch.full((cand_cap,), -1, dtype=torch.int64, device=key.device)
    lrow[:take] = lrows
    gkey, grow = gather_rows(lkey, group), gather_rows(lrow, group)
    order = torch.argsort(gkey, stable=True)[:cand_cap]
    found = gkey[order] != big
    out = []
    for x in payloads:
        lx = torch.zeros((cand_cap, *x.shape[1:]), dtype=x.dtype, device=key.device)
        lx[:take] = x[lrows]
        out.append(gather_rows(lx, group)[order])
    owner = torch.where(found, order // cand_cap, -1)
    return tuple(out), owner, grow[order]


def rank_share(rows: torch.Tensor, group) -> torch.Tensor:
    """Entries rank, rank + W, rank + 2W, ... of `rows` (`rows` itself
    without a group): the rank's share of a set every rank holds whole, such
    as the pairs of a feature mix drawn over the union's rows."""
    if group is None:
        return rows
    return rows[rank_of(group)::world_size(group)]


def all_reduce_metrics(metrics: dict, group) -> dict:
    """The metrics detached, each the sum of the ranks' shares over a group
    (the one-process values), in one all-reduce."""
    if group is None:
        return {k: v.detach() for k, v in metrics.items()}
    total = all_reduce(torch.stack([v.detach() for v in metrics.values()]), group)
    return dict(zip(metrics, total.unbind()))


def raise_if_dropped(dropped: torch.Tensor, group, what: str) -> None:
    """Raise on every rank if any rank's `dropped` count (a scalar tensor) is
    above 0: a row a rank's capacity drops where the union's might keep it
    would leave the group step off the one-process step with no count to
    show it. Reads the device once."""
    n = int(all_reduce(dropped.to(torch.int64), group))
    if n > 0:
        raise ValueError(f"{what}: the ranks' capacities dropped {n} rows: raise the capacity")


def raise_if_union_over(counts: torch.Tensor, caps: tuple, group, what: str) -> None:
    """Raise on every rank where the union's counts (the ranks' `counts`
    summed: each rank's rows are its own scans') exceed `caps`: there the
    one-process step drops rows a rank keeps, so the group step would leave
    it with no count to show it. Reads the device once."""
    union = all_reduce(counts, group).tolist()
    over = sum(max(n - c, 0) for n, c in zip(union, caps))
    if over:
        raise ValueError(f"{what}: the union's levels hold {over} voxels above their "
                         f"capacities {tuple(caps)}: raise the capacities")


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


def shard_scans(pb: dict, num_scans: int, rank: int, world: int) -> dict:
    """Rank `rank`'s scans [rank S/W, (rank + 1) S/W) of a point batch dict
    of [S, P, ...] buffers that belongs to no voxel batch (the Cylinder3D
    trainer's points). Raises where the scans do not split."""
    if num_scans % world:
        raise ValueError(f"{num_scans} scans do not split over {world} ranks")
    per = num_scans // world
    return {k: v[rank * per:(rank + 1) * per].clone() for k, v in pb.items()}


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
