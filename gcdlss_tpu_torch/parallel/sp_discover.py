"""Voxel-sharded (sp) Stage-2 discovery step over a process group (PyTorch
port of `gcdlss_tpu/parallel/sp_discover.py`).

The step's three backbone passes, the teacher's forward, the student's
forward and the student's mixed forward, run voxel-sharded over a ring
group (`parallel.voxel_shard`, `parallel.sp_step.shard_plan`) through the
step's `apply_model` seam, while every loss, the mining, k-means, the
Hungarian match, the queue and the EMA stay `train.discover`'s one tested
implementation, which every rank runs on the passes' row outputs gathered
to it. Every rank holds the whole batch and a replica of the state, and
ends the step with the same bits.

The JAX package differentiates through its `shard_map`. Here the gather of
a pass's rows is an autograd Function whose backward takes the rank's own
slice of the cotangent (the cotangent is the same on every rank, so it is
sliced, not summed), and the pass sees its parameters through an identity
whose backward sums their gradients over the ring: a parameter gets the sum
of the ranks' shares from the sharded passes plus, once, what the
replicated part adds (the heads' terms on the candidates; tau, which only
the replicated part touches, is not summed).

Halo sizing: the combined plan is batch-shaped like Stage 1
(`sp_step.backbone_halos` on a representative plan); the LaserMix plan is
built inside the step, from the teacher's pseudo labels and the step's
draws, so `probe_mix_plan` builds one to size the mixed pass's halos. The
step's `sp_overflow` metric must read 0.
"""

from __future__ import annotations

import torch

from ..models.layers import batch_norm_group
from ..train import discover as td
from ..train.common import resolve_device
from .mesh import all_gather_padded, all_reduce, make_mesh, rank_of, world_size
from .sp_step import shard_plan


class _GatherRows(torch.autograd.Function):
    """The ranks' row blocks, in rank order, on every rank; backward: the
    rank's own rows of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_padded(x.detach(), group).reshape(-1, *x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        r = rank_of(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows].contiguous(), None


class _RingSumGrads(torch.autograd.Function):
    """The identity on a pass's parameters; backward: each parameter's
    gradient summed over the ring, in one flat all-reduce (a missing
    gradient counts as zeros)."""

    @staticmethod
    def forward(ctx, group, *params):
        ctx.group = group
        ctx.metas = [(p.shape, p.dtype) for p in params]
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        dev = next(g.device for g in grads if g is not None)
        flat = torch.cat([(g if g is not None else torch.zeros(s, device=dev)).reshape(-1).float()
                          for g, (s, _) in zip(grads, ctx.metas)])
        flat = all_reduce(flat, ctx.group)
        out, off = [], 0
        for shape, dtype in ctx.metas:
            n = shape.numel()
            out.append(flat[off:off + n].view(shape).to(dtype))
            off += n
        return (None, *out)


class ShardedPasses:
    """`train.discover.apply_model` voxel-sharded over the ring `group`:
    the pass runs on the rank's rows of the plan (sharded once a plan, with
    `halos` for the combined plan, "main", and `mix_halos` for the LaserMix
    one, "mix"), its row outputs are gathered to every rank, and its
    windows' dropped entries summed over the ring."""

    def __init__(self, group, halos: tuple, mix_halos: tuple):
        self.group = group
        self.halos = {"main": tuple(halos), "mix": tuple(mix_halos)}
        self.plans = {}

    def __call__(self, model, plan, feats, kind: str):
        key = (kind, id(plan))
        if key not in self.plans:  # the plan is kept, so its id stays its own
            self.plans[key] = (plan, shard_plan(plan, self.group, self.halos[kind]))
        splan = self.plans[key][1]
        x = feats[slice(*splan.rows)]
        if torch.is_grad_enabled():
            named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
            ring_params = _RingSumGrads.apply(self.group, *(p for _, p in named))
            out = torch.func.functional_call(
                model, {n: p for (n, _), p in zip(named, ring_params)}, (splan, x))
        else:
            out = model(splan, x)
        overflow = all_reduce(out.pop("sp_overflow"), self.group)
        return {k: _GatherRows.apply(v, self.group) for k, v in out.items()}, overflow


def _check_caps(cfg, world: int) -> None:
    for what in ("voxel_caps", "mix_voxel_caps"):
        bad = [c for c in getattr(cfg, what) if c % world]
        if bad:
            raise ValueError(f"DiscoverConfig.{what} {bad} do not divide by {world} shards")


def probe_mix_plan(cfg, state, sup_vb: dict, unsup_vb: dict, draws: dict | None = None,
                   sup_pb: dict | None = None, unsup_pb: dict | None = None):
    """The LaserMix plan the step would build from `state` and these
    batches (with `draws`, or the state's next draws), for sizing the mixed
    pass's halos with `sp_step.backbone_halos`: the step's body on one
    process, stopped once the plan is built. The state is left as it was
    (the teacher's batch-norm statistics and the generator restored)."""
    if cfg.mix_mode != "lasermix":
        raise ValueError("mix_mode must be 'lasermix' to probe the mixed plan")
    stats = {k: b.clone() for k, b in state.teacher.named_buffers()}
    gen = state.generator.get_state()
    try:
        return td._train_step(state, sup_vb, unsup_vb, cfg, cfg, draws, sup_pb, unsup_pb, None,
                              probe=True)
    finally:
        with torch.no_grad():
            for k, b in state.teacher.named_buffers():
                b.copy_(stats[k])
        state.generator.set_state(gen)


def make_sp_discover_step(cfg, group, halos: tuple, mix_halos: tuple, device="cuda"):
    """The discovery step with the backbone voxel-sharded over the process
    `group` (the world if None): step(state, sup_vb, unsup_vb, draws=None,
    sup_pb=None, unsup_pb=None) -> (state, metrics), `train.discover.
    discover_train_step` on the whole batches every rank holds, from a
    state replicated on every rank (`parallel.mesh.replicate`).

    `halos` sizes the combined plan's 10 windows, `mix_halos` the LaserMix
    plan's (`probe_mix_plan`). Every cap in cfg.voxel_caps and
    cfg.mix_voxel_caps must divide by the group's size; Cylinder3D raises
    NotImplementedError. metrics["sp_overflow"] must read 0. Runs on the
    card unless `device` names another (`train.common.resolve_device`)."""
    if cfg.arch == "Cylinder3D":
        raise NotImplementedError("voxel-sharded SP is MinkUNet-only; run Cylinder3D "
                                  "discovery data-parallel")
    device = resolve_device(device)
    group = make_mesh(group)
    _check_caps(cfg, world_size(group))

    def step(state, sup_vb: dict, unsup_vb: dict, draws: dict | None = None,
             sup_pb: dict | None = None, unsup_pb: dict | None = None):
        move = lambda b: None if b is None else {k: v.to(device) for k, v in b.items()}
        passes = ShardedPasses(group, halos, mix_halos)
        with batch_norm_group(group):
            return td._train_step(state, move(sup_vb), move(unsup_vb), cfg, cfg, draws,
                                  move(sup_pb), move(unsup_pb), None, passes)

    return step
