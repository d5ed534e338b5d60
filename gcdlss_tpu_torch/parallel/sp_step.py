"""Voxel-sharded (sp) Stage-1 training step over a process group (PyTorch
port of `gcdlss_tpu/parallel/sp_step.py`).

Every rank holds the whole batch and a replica of the state. It builds the
whole plan from the whole batch (K3 for the maps), keeps its row block of
every level with window books (`shard_plan`, the counterpart of the JAX
package's plan stored sharded), and runs the backbone on its rows,
exchanging boundary rows with its ring neighbours (`parallel.voxel_shard`).
The step is `train.pretrain.pretrain_train_step` itself, given the
sharding through its `shard` seam. The masked-CE mean is the sum of the ranks' sums over the sum of their
counts, the parameter gradients are summed over the ring, and batch-norm
statistics are the ring's (`models.layers.batch_norm_group`), so every rank
ends with the one-process step's parameters and statistics. The windows'
dropped entries (`sp_overflow`, summed) must read 0; `backbone_halos`
sizes the halos that keep them so.

The plan is built whole on every rank: contiguous row blocks need the
whole level's key order, and the build costs milliseconds beside the step.

`make_dp_sp_pretrain_step` composes data and voxel parallelism: the world
splits into dp batch groups of sp rings (`dist.new_group`); convs exchange
halos within their ring, and batch norm, the loss mean and the gradients
reduce over the whole world, so the step is the one-process step on the
union of the groups' batches.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..train.common import resolve_device
from ..train.pretrain import pretrain_train_step
from . import voxel_shard as vs
from .mesh import make_mesh, rank_of, world_size

def backbone_halos(plan, n_shards: int, margin: float = 1.5, floor: int = 8) -> tuple:
    """Size the 10 static backbone halos (stem, subm0..4, pool0..3) from a
    representative plan's measured requirements, in one read of the device.
    `margin`/`floor` absorb batch-to-batch variation — the step's
    `sp_overflow` metric reports any batch that still exceeds them."""
    req = vs.required_halos(plan, n_shards)
    order = (["stem"] + [f"subm{l}" for l in range(len(plan.levels))]
             + [f"pool{l}" for l in range(len(plan.pools))])
    got = torch.stack([req[k] for k in order]).tolist()
    return tuple(max(floor, math.ceil(v * margin)) for v in got)


class ShardLevel(NamedTuple):
    valid: torch.Tensor  # [L] the rank's rows of the level
    nbr3: vs.WindowBook


class ShardPlan(NamedTuple):
    """A rank's share of a `UNetPlan`: its row block of every level and the
    window books its convs run over, in the plan's field names."""

    levels: tuple  # ShardLevel per stride level
    pools: tuple  # voxel_shard.WindowPool per pool edge
    stem_nbr: vs.WindowBook
    rows: tuple  # (first, past the last) level-0 row of the rank's block


def shard_plan(plan, group, halos: tuple) -> ShardPlan:
    """This rank's `ShardPlan` of the whole `plan` over the ring `group`,
    with the ten halos (stem, subm0..4, pool0..3), the JAX package's
    `sp_halos`: the stem's book at hs[0], level l's k3 book at hs[1 + l],
    the pool edge l -> l + 1 (down and up conv) at hs[6 + l]. Every level's
    capacity must divide by the ring's size."""
    if len(halos) != 10:
        raise ValueError(f"need 10 halos (stem, subm0..4, pool0..3), got {len(halos)}")
    levels = []
    r, w = rank_of(group), world_size(group)
    for l, lvl in enumerate(plan.levels):
        ln = vs._block(lvl.valid.shape[0], w, "level")
        levels.append(ShardLevel(lvl.valid[r * ln:(r + 1) * ln],
                                 vs.subm_book(lvl.nbr3, halos[1 + l], group)))
    pools = tuple(vs.pool_book(p, plan.levels[l + 1].valid.shape[0], halos[6 + l], group)
                  for l, p in enumerate(plan.pools))
    l0 = levels[0].valid.shape[0]
    return ShardPlan(tuple(levels), pools, vs.subm_book(plan.stem_nbr, halos[0], group),
                     (r * l0, (r + 1) * l0))


def _sp_step(cfg, sp_axis, halos: tuple, device):
    """The Stage-1 step of a rank whose rows ride the ring of `sp_axis` and
    whose statistics, loss and gradients reduce over its stats group
    (`voxel_shard.conv_axis`, `voxel_shard.stats_axis`):
    `train.pretrain.pretrain_train_step` through its sharding seam."""
    ring, stats = vs.conv_axis(sp_axis), vs.stats_axis(sp_axis)
    # one plan a ring: its first rank counts the dropped voxels
    weight = int(rank_of(ring) == 0)

    def shard(plan):
        splan = shard_plan(plan, ring, halos)
        return splan, slice(*splan.rows), weight

    def step(state, batch: dict):
        batch = {k: v.to(device) for k, v in batch.items()}
        return pretrain_train_step(state, batch, cfg, stats, shard)

    return step


def make_sp_pretrain_step(cfg, group, halos: tuple, device="cuda"):
    """The Stage-1 step with the backbone voxel-sharded over the process
    `group` (the world if None): step(state, batch) -> (state, metrics),
    with `batch` the whole batch on every rank and `state` replicated
    (`parallel.mesh.replicate`). It is `train.pretrain.pretrain_train_step`
    (masked CE, SGD with the schedule, batch-norm statistics) and gives its
    parameters and statistics on every rank; metrics: the loss,
    `sp_overflow` (must read 0) and `plan_overflow`. Runs on the card unless
    `device` names another (`train.common.resolve_device`)."""
    device = resolve_device(device)
    group = make_mesh(group)
    return _sp_step(cfg, group, tuple(halos), device)


def make_dp_sp_pretrain_step(cfg, halos: tuple, sp: int, device="cuda"):
    """The Stage-1 step on a dp x sp mesh of the whole world: rank r holds
    batch group r // sp (`batch` is that group's batch, at `cfg`'s
    capacities, the same on the group's ranks) and its rows' block r % sp.
    Convs exchange halos within the group's ring of `sp` ranks; batch-norm
    moments, the masked-CE mean, the gradients and the metrics reduce over
    the world, so the step is the one-process step on the groups'
    concatenated batch (their scans numbered apart). Every rank creates
    every ring (`dist.new_group`), in the same order."""
    device = resolve_device(device)
    world = make_mesh(None)
    n = world_size(world)
    if n % sp:
        raise ValueError(f"a world of {n} ranks does not split into rings of {sp}")
    rings = [dist.new_group(list(range(g * sp, (g + 1) * sp))) for g in range(n // sp)]
    ring = rings[dist.get_rank() // sp]
    return _sp_step(cfg, (world, ring), tuple(halos), device)
