"""Single-model (NOPS-style) discovery without a mean teacher (PyTorch port
of `gcdlss_tpu/train/nops.py`).

Rebuilds of the reference's discovery ablations:
  * ExpDiscover (`modules/exp.py:5050-5340`): one MinkUNetRC over the
    combined sup + unsup batch; sup CE + calibration; the novel branch mines
    candidates at a fixed NCC probability (0.2), clusters them with the
    queue by euclidean k-means into Ku + 1 clusters, drops the ONE cluster
    whose centre is closest (summed L2) to the base prototypes, aligns the
    rest to the novel head by a Hungarian matching and trains the novel head
    on them (coefficient 1); the queue keeps the MEAN reliable feature of a
    step (20 slots, `exp.py:5035-5048,5320-5322`);
  * ExpMixDiscoverJoint (`exp.py:4452-4600`): the same, feature mixing in
    the sup loss, the novel CE over the joint [base | novel] logits with the
    labels shifted by K, coefficient 0.002;
  * ExpMixDiscover (`exp.py:3587-3990`): label-distinct centroid mixing in
    the sup loss, the unsup pseudo-label and mixed-unsup CE (0.1) and the
    OpenMatch-style entropy terms;
  * ExpMixDiscoverSwaV (`exp.py:4680-4980`, `swav_train_step`): two
    augmented views of the same scans, per-view mining, each view's novel
    logits supervised by the other view's aligned cluster label of the same
    original point (the JAX package's runnable realisation of the
    reference's dead code).

The steps stay on the device: shapes are fixed and the novel branch is gated
by `has_novel` as a tensor, never by a host branch. The k^3 maps of every
plan go through K3 and every conv through K1 / K2. The Hungarian matching
maximises agreement and supervises with the mapped cluster labels, the JAX
package's deliberate fix of the reference (`gcdlss_tpu/train/nops.py:202-209`).

Each step's random draws (the k-means initial-row scores, the mixing
permutations and ratio) come from the state's generator, or from `draws=`,
e.g. the JAX package's.

Both steps take a process `group` (`parallel.mesh`), on the pattern of
`train.discover`: each rank holds whole scans of each side
(`shard_voxel_batch`) and plans them at its share of the capacities; batch
norm, the loss means and the gradients are global; the candidates are the
union's first `cand_cap` in the one-process plan's row order, gathered to
every rank, where k-means, the prototype distances, the Hungarian match,
SwaV's key search and the queue push run whole, each rank taking the loss
of the candidates it holds; the mixing permutations are drawn over the
union's rows and each rank mixes its share of them
(`parallel.mesh.union_rows`). Every rank ends with the parameters,
statistics, queue and metrics of the one-process step on the union batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..algo.hungarian import hungarian_small
from ..algo.kmeans import euclidean_kmeans
from ..algo.queue import FeatureQueue, queue_init, queue_push
from ..eval.metrics import confusion_update
from ..losses import calibration_loss, cross_entropy, soft_cross_entropy
from ..models.layers import batch_norm_group
from ..models.minkunet import DEFAULT_PLANES, MinkUNetRC, assemble_dummy_logits
from ..ops.plan import plan_capacity_overflow
from ..parallel.mesh import (all_reduce, all_reduce_grads, all_reduce_metrics,
                             gather_candidates, global_rows, global_scans, rank_config, rank_of,
                             rank_share, union_rows, world_size)
from .common import StepClock, make_sgd, plan_and_gather, resolve_device, voxel_batch_to_device
from .discover import _combine_batches
from .feature_mixing import (beta_draw, draw_perms, mix_centroid_sup, mix_features,
                             mix_unsup_centroid)
from .schedule import make_lr_schedule

INT32_MAX = 2 ** 31 - 1
KEY_SHIFT = 1 << 20  # the cross-view identity: scan * 2^20 + original point index


@dataclass(frozen=True)
class NopsConfig:
    num_labeled_classes: int
    num_unlabeled_classes: int
    num_classes: int
    unknown_label: int
    voxel_caps: tuple
    sup_voxel_cap: int
    num_sup_scans: int
    arch: str = "MinkUNet34"
    planes: tuple = DEFAULT_PLANES
    in_channels: int = 1
    dtype: str = "float32"  # activation dtype: "bfloat16" on the card
    remat: bool = False
    feat_dim: int = 96
    ncc_heads: int = 3
    # discovery knobs (`exp.py:5052-5054,3596-3614`)
    prob_threshold: float = 0.2
    cand_cap: int = 4096
    queue_slots: int = 20  # mean reliable feature per step
    kmeans_iters: int = 15
    calib_coeff: float = 0.05
    novel_coeff: float = 1.0  # 0.002 for Joint (`exp.py:4458`)
    # variant switches
    joint_logits: bool = False  # Joint: CE over [base | novel], labels += K
    use_mix_features: bool = False  # Joint: feature mixing in the sup loss
    beta_coeff: float = 0.5
    # ExpMixDiscover switches (`exp.py:3587-3990`)
    mix_centroid: bool = False  # sup mixing = label-distinct triples -> unknown
    unsup_mix_coeff: float = 0.0  # pseudo-GT CE on non-candidates + mixed unsup as unknown
    entropy_minimize: bool = False  # OpenMatch-style entropy terms
    id_entropy_coeff: float = 1.0
    ood_entropy_coeff: float = 1e-3
    # optimizer
    lr: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 1e-4
    use_scheduler: bool = True
    warmup_epochs: int = 4
    min_lr: float = 1e-5
    epochs: int = 50
    steps_per_epoch: int = 1000
    # shim so discover-style helpers work
    num_scans_total: int = 4


@dataclass
class NopsState:
    model: MinkUNetRC
    optimizer: torch.optim.Optimizer
    queue: FeatureQueue  # [queue_slots, 1, feat_dim]: a step's mean reliable feature a slot
    generator: torch.Generator  # k-means initial rows, mixing permutations and ratio
    step: int = 0


def make_model(cfg: NopsConfig, generator: torch.Generator | None = None) -> MinkUNetRC:
    return MinkUNetRC(cfg.num_labeled_classes, cfg.num_unlabeled_classes, cfg.ncc_heads,
                      arch=cfg.arch, planes=cfg.planes, in_channels=cfg.in_channels,
                      dtype=getattr(torch, cfg.dtype), generator=generator, remat=cfg.remat)


def create_nops_state(seed: int, cfg: NopsConfig, pretrained: dict | None = None,
                      device="cuda") -> NopsState:
    """Model with weights drawn from `seed` (on the CPU, then moved), SGD, an
    empty queue of `queue_slots` single rows and the step's generator, on the
    card unless `device` names another (`resolve_device`).

    `pretrained`: a state dict (a Stage-1 `MinkUNetSeg`'s, or any
    `MinkUNetRC`'s): its backbone, `final` and `final2` parameters warm-start
    the model, as the JAX package copies the `encoder`, `final` and `final2`
    trees (`nops.py:138-143`); `final3` and the batch-norm statistics stay
    fresh."""
    from ..utils.weights import warm_start

    device = resolve_device(device)
    model = make_model(cfg, torch.Generator().manual_seed(seed))
    if pretrained is not None:
        warm_start(model, {k: v for k, v in pretrained.items()
                           if not k.startswith("encoder.final3.")})
    model = model.to(device)
    return NopsState(model=model, optimizer=make_sgd(cfg, model.parameters()),
                     queue=queue_init(cfg.queue_slots, 1, cfg.feat_dim, device=device),
                     generator=torch.Generator(device=device).manual_seed(seed))


def _cand_cap(cfg: NopsConfig) -> int:
    return min(cfg.cand_cap, cfg.voxel_caps[0])  # no more candidates than voxels


def draw_step_randoms(state: NopsState, cfg: NopsConfig, swav: bool = False) -> dict:
    """The step's draws from the state's generator: the k-means initial-row
    scores (uniform over the candidate and queue rows; `kmeans_scores_b` for
    SwaV's second view), and by the config the sup mixing permutations of
    the cap0 rows (`mix_perms`: 3 for centroid mixing, else 2 and the Beta
    ratio `mix_ratio`) and the unsup centroid permutations (`umix_perms`)."""
    g = state.generator
    dev = g.device
    n = _cand_cap(cfg) + cfg.queue_slots
    draws = {"kmeans_scores": torch.rand(n, generator=g, device=dev)}
    if swav:
        draws["kmeans_scores_b"] = torch.rand(n, generator=g, device=dev)
        return draws
    cap0 = cfg.voxel_caps[0]
    if cfg.use_mix_features:
        draws["mix_perms"] = draw_perms(g, cap0, 3 if cfg.mix_centroid else 2, dev)
        if not cfg.mix_centroid:
            draws["mix_ratio"] = beta_draw(cfg.beta_coeff, cfg.beta_coeff, g, dev)
    if cfg.unsup_mix_coeff > 0.0:
        draws["umix_perms"] = draw_perms(g, cap0, 3, dev)
    return draws


def _novel_branch(cfg: NopsConfig, dummy, feats, unsup_mask, queue: FeatureQueue, heads,
                  scores, grows, keys=None, group=None) -> dict:
    """Candidate mining -> euclidean k-means over the candidates and the
    queue -> the cluster closest to the base prototypes dropped -> compact
    relabel -> Hungarian matching to the novel head's argmax. Nothing here
    carries a gradient: `dummy` and the heads are read detached, the
    candidates' features are detached. `keys`: a row payload the candidates
    carry along (SwaV's point keys, `cand_key`).

    The candidates are the first `cand_cap` in the row order of the
    one-process plan (`grows`: each row's index there, `global_rows`), as
    the JAX package's stable argsort: over a process `group`, the union's,
    gathered to every rank. `cand_rows`: each one's row on the rank that
    holds it; `own`: those this rank holds."""
    K, Ku = cfg.num_labeled_classes, cfg.num_unlabeled_classes
    dev = dummy.device
    dummy = dummy.detach()
    probs = torch.softmax(dummy, dim=-1)
    cand_mask = (probs[:, -1] > cfg.prob_threshold) & unsup_mask
    n_cand = all_reduce(cand_mask.sum().to(torch.int32), group)
    cand_cap = min(cfg.cand_cap, cfg.voxel_caps[0])
    cand_valid = torch.arange(cand_cap, device=dev) < n_cand.clamp(max=cand_cap)
    payload = (feats.detach(),) + (() if keys is None else (keys,))
    big = torch.iinfo(torch.int64).max
    got, owner, cand_rows = gather_candidates(torch.where(cand_mask, grows, big), cand_mask,
                                              cand_cap, group, *payload)
    own = cand_valid & (owner == rank_of(group))
    cand_feats = got[0] * cand_valid[:, None]

    # the queue holds one mean reliable vector per past step (`exp.py:5320-5322`)
    qfeats = queue.feats[:, 0, :]
    qvalid = queue.counts > 0
    all_valid = torch.cat([cand_valid, qvalid])
    n_all = all_valid.sum()
    nclu = Ku + 1
    assign_all, cents = euclidean_kmeans(torch.cat([cand_feats, qfeats]), all_valid, nclu,
                                         scores, iters=cfg.kmeans_iters)
    # the unreliable cluster: the least summed L2 distance from its centre to
    # the base prototypes, the `final` kernel's columns (`exp.py:5283-5293`)
    base_protos = heads.final.kernel.detach().T  # [K, C]
    d = ((cents[:, None, :] - base_protos[None, :, :]) ** 2).sum(dim=-1)
    unreliable = d.clamp(min=1e-12).sqrt().sum(dim=1).argmin()
    assign = assign_all[:cand_cap].long()
    rel_mask = cand_valid & (assign != unreliable)
    n_rel = rel_mask.sum().to(torch.int32)
    has_novel = (n_all > Ku + 1) & (n_rel > 0)
    # compact relabel of the surviving clusters to 0..M-1 (`exp.py:5300-5310`)
    present = torch.zeros(nclu, dtype=torch.int32, device=dev).scatter_reduce(
        0, torch.where(rel_mask, assign, nclu - 1), rel_mask.to(torch.int32), "amax")
    new_id = torch.cumsum(present, 0) - 1
    rel_labels = new_id[assign.clamp(0, nclu - 1)].clamp(0, Ku - 1)
    # per-step Hungarian: novel-head argmax against the cluster labels,
    # maximising agreement (the JAX package's fix, `nops.py:202-209`)
    f3 = heads.final3
    novel_preds = (cand_feats @ f3.kernel.detach() + f3.bias.detach()).argmax(dim=-1)
    cost = confusion_update(novel_preds, rel_labels, Ku, rel_mask)
    row_of_col = hungarian_small(cost.float(), maximize=True)
    out = dict(cand_rows=cand_rows, cand_valid=cand_valid, own=own, cand_feats=cand_feats,
               rel_mask=rel_mask, mapped_novel=row_of_col[rel_labels], has_novel=has_novel,
               n_cand=n_cand, n_rel=n_rel)
    if keys is not None:
        out["cand_key"] = got[1]
    return out


def _mix_dummy(heads, mixf):
    """Mixed features through the raw `final` / `final2` parameters ->
    [M, K + 1] dummy logits (`exp.py:3799-3805,4504-4518`); amax, so a tie
    shares its gradient as jnp.max's does."""
    kin = mixf @ heads.final.kernel + heads.final.bias
    kout = mixf @ heads.final2.kernel + heads.final2.bias
    return torch.cat([kin, kout.amax(dim=-1, keepdim=True)], dim=-1)


def _entropy(logits, mask, group=None):
    """(id, ood) entropy terms over the `mask` rows: -mean of sum(p log p)
    over the known columns, and the SUM of p_last log p_last
    (`exp.py:3826-3838`); the rank's shares over a process `group`."""
    p = torch.softmax(logits, dim=-1)
    mf = mask.float()
    nrow = all_reduce(mf.sum(), group).clamp(min=1.0)
    plogp = p * torch.log(p + 1e-8)
    return -(plogp[:, :-1].sum(dim=-1) * mf).sum() / nrow, (plogp[:, -1] * mf).sum()


def _sgd_step(state: NopsState, cfg: NopsConfig, loss: torch.Tensor, group=None) -> None:
    lr = make_lr_schedule(cfg)(state.step)
    for pg in state.optimizer.param_groups:
        pg["lr"] = lr
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    all_reduce_grads(state.model.parameters(), group)
    state.optimizer.step()


def _push_mean_reliable(state: NopsState, nb: dict) -> None:
    """The queue takes the step's MEAN reliable feature (one row), only if
    the novel branch fired: a `torch.where` on the device, no host branch."""
    with torch.no_grad():
        rel = nb["rel_mask"]
        mean_rel = ((nb["cand_feats"] * rel[:, None]).sum(dim=0, keepdim=True)
                    / rel.sum().float().clamp(min=1.0))
        pushed = queue_push(state.queue, mean_rel,
                            torch.ones(1, dtype=torch.bool, device=rel.device))
        state.queue = FeatureQueue(*(torch.where(nb["has_novel"], new, old)
                                     for new, old in zip(pushed, state.queue)))


def _plan_rows(cfg: NopsConfig, sup_vb: dict, unsup_vb: dict, group=None):
    """The combined plan and its level-0 rows: (combined batch, plan, feats0,
    mapped0, ok, valid0, is_sup, grows), at the rank's share of the
    capacities over a process `group`; `grows` each row's index in the
    one-process plan (`global_rows`)."""
    lcfg = rank_config(cfg, group)
    combined = _combine_batches(sup_vb, unsup_vb, lcfg)
    plan, feats0, _, mapped0 = plan_and_gather(combined, lcfg.voxel_caps)
    n_in = combined["coords"].shape[0]
    ok = plan.rep < n_in
    valid0 = plan.levels[0].valid
    is_sup = ok & (plan.rep < lcfg.sup_voxel_cap)
    grows = global_rows(plan.levels[0], lcfg.num_sup_scans, group)
    return combined, plan, feats0, mapped0, ok, valid0, is_sup, grows


def _global_metrics(metrics: dict, counts: dict, plan_ovf, group) -> dict:
    """The ranks' loss shares summed (the one-process values), the counts
    (global already) and the plans' overflow summed over the ranks."""
    return {**all_reduce_metrics(metrics, group), **counts,
            "plan_overflow": all_reduce(plan_ovf, group)}


def nops_train_step(state: NopsState, sup_vb: dict, unsup_vb: dict, cfg: NopsConfig,
                    draws: dict | None = None, group=None):
    """One ExpDiscover / ExpMixDiscoverJoint / ExpMixDiscover step in place
    on `state` (`exp.py:5163-5330,4463-4600,3587-3990`); returns (state,
    metrics), the metrics as tensors on the device. `draws` replaces the
    step's random draws (`draw_step_randoms`). With a process `group`,
    `sup_vb` / `unsup_vb` are this rank's whole scans and the step is the
    one-process step on the union batch (see the module's docstring)."""
    if draws is None:
        draws = draw_step_randoms(state, cfg)
    K, unk = cfg.num_labeled_classes, cfg.unknown_label
    model = state.model
    model.train()
    heads = model.encoder
    _, plan, feats0, mapped0, _, valid0, is_sup, grows = _plan_rows(cfg, sup_vb, unsup_vb, group)
    sup_mask = is_sup & valid0
    unsup_mask = valid0 & ~is_sup
    cap0 = cfg.voxel_caps[0]
    share = lambda perms: tuple(rank_share(p, group) for p in perms)

    with batch_norm_group(group):
        out = model(plan, feats0)
        dummy = assemble_dummy_logits(out)  # [N, K + 1]
        h = out["feats"]
        sup_targets = torch.where(sup_mask, mapped0, -1)
        l_sup = cross_entropy(dummy, sup_targets, valid0, group=group)
        mix_logits = mix_labels = None
        if cfg.use_mix_features:
            # the union's rows over a group, each rank mixing its share
            src = union_rows(grows, valid0, cap0, group, (h, 0), (sup_targets, -1),
                             (sup_mask, False))
        if cfg.use_mix_features and cfg.mix_centroid:
            # ExpMixDiscover: label-distinct triples averaged, targeted at the
            # unknown slot (`exp.py:3793-3809` via `exp.py:1494-1517`)
            mixf, mix_labels, mixok = mix_centroid_sup(None, *src, unk,
                                                       perms=share(draws["mix_perms"]))
            mix_logits = _mix_dummy(heads, mixf)
            l_sup = l_sup + cross_entropy(mix_logits, mix_labels, mixok, group=group)
        elif cfg.use_mix_features:
            # Joint: feature-mixed rows with soft two-hot targets over K + 1
            # columns beside the sup CE (`exp.py:4504-4518`)
            mixf, mixp, mixok = mix_features(None, *src, K + 1, cfg.beta_coeff,
                                             perms=share(draws["mix_perms"]),
                                             ratio=draws["mix_ratio"])
            mix_logits = _mix_dummy(heads, mixf)
            l_sup = l_sup + soft_cross_entropy(mix_logits, mixp, mixok, group=group)
        l_cal = cfg.calib_coeff * calibration_loss(dummy, sup_targets, unk, valid0, group=group)

        # the live softmax: the entropy terms differentiate through it
        # (`exp.py:3852,3940`); the argmax and threshold consumers carry no
        # gradient either way
        probs_uns = torch.softmax(dummy, dim=-1)
        zero = torch.zeros((), device=dummy.device)
        l_unsup_mix = zero
        if cfg.unsup_mix_coeff > 0.0:
            # CE of the non-candidate unsup rows against their own argmax, and
            # the centroid-mixed unsup features at the unknown slot, under one
            # coefficient (`exp.py:3848-3874`)
            cand = (probs_uns[:, -1] > cfg.prob_threshold) & unsup_mask
            keep = unsup_mask & ~cand
            l_pseudo = cross_entropy(dummy, torch.where(keep, probs_uns.argmax(dim=-1), -1),
                                     group=group)
            usrc = union_rows(grows, valid0, cap0, group, (h, 0), (unsup_mask, False))
            mixuf, mixul, mixuok = mix_unsup_centroid(None, *usrc, unk,
                                                      perms=share(draws["umix_perms"]))
            l_umixed = cross_entropy(_mix_dummy(heads, mixuf), mixul, mixuok, group=group)
            l_unsup_mix = cfg.unsup_mix_coeff * (l_pseudo + l_umixed)
        l_ent = zero
        if cfg.entropy_minimize:
            # over the [sup | mixed sup] rows, each population's id term a mean
            # (`exp.py:3826-3838`)
            ide, ood = _entropy(dummy, sup_mask, group)
            if mix_logits is not None:
                ide_m, ood_m = _entropy(mix_logits, mix_labels >= 0, group)
                ide, ood = ide + ide_m, ood + ood_m
            l_ent = cfg.id_entropy_coeff * ide + cfg.ood_entropy_coeff * ood

        with torch.no_grad():
            nb = _novel_branch(cfg, dummy, h, unsup_mask, state.queue, heads,
                               draws["kmeans_scores"], grows, group=group)
        g = nb["has_novel"].float()
        f3 = heads.final3
        nov_logits = nb["cand_feats"] @ f3.kernel + f3.bias
        # each rank takes the terms of the candidates it holds
        mine = nb["rel_mask"] & nb["own"]
        targets = torch.where(mine, nb["mapped_novel"], -1)
        if cfg.joint_logits:
            # Joint: CE over [base | novel] with the labels shifted by K
            # (`exp.py:4597-4600`)
            base_logits = nb["cand_feats"] @ heads.final.kernel + heads.final.bias
            l_nov = cfg.novel_coeff * cross_entropy(
                torch.cat([base_logits, nov_logits], dim=-1),
                torch.where(mine, targets + K, -1), group=group)
        else:
            l_nov = cfg.novel_coeff * cross_entropy(nov_logits, targets, group=group)
        # the has_novel-gated unsup entropy terms, added once (the reference
        # re-adds the sup terms through a shadowed name, `exp.py:3940-3947`)
        l_ent_u = zero
        if cfg.entropy_minimize:
            ide_u, ood_u = _entropy(dummy, unsup_mask, group)
            l_ent_u = g * (cfg.id_entropy_coeff * ide_u + cfg.ood_entropy_coeff * ood_u)

        loss = l_sup + l_cal + g * l_nov + l_unsup_mix + l_ent + l_ent_u
        _sgd_step(state, cfg, loss, group)
    _push_mean_reliable(state, nb)
    state.step += 1
    metrics = {"loss": loss, "sup_seg": l_sup, "calib": l_cal, "novel_unsup": g * l_nov,
               "unsup_mix": l_unsup_mix, "entropy": l_ent + l_ent_u}
    counts = dict(n_cand=nb["n_cand"], n_rel=nb["n_rel"],
                  has_novel=nb["has_novel"].to(torch.int32))
    return state, _global_metrics(metrics, counts, plan_capacity_overflow(plan), group)


def swav_train_step(state: NopsState, sup_vb: dict, unsup_vb: dict, sup_vb2: dict,
                    unsup_vb2: dict, cfg: NopsConfig, draws: dict | None = None, group=None):
    """ExpMixDiscoverSwaV in place on `state`: two augmented views of the same
    scans on two plans, one backward through both (`exp.py:4763-4956`, as
    the JAX package realises it). View B's forward starts from the
    batch-norm statistics view A updated. Each view mines and clusters its
    own candidates; view X's novel logits on its reliable candidates are
    supervised by the aligned cluster label of the same original point
    (scan * 2^20 + point index) among view Y's reliable candidates, matched
    by a sorted search; unmatched candidates are ignored. Returns (state,
    metrics); `n_match` counts the matched candidates of both directions.
    With a process `group`, the four batches are this rank's whole scans and
    the step is the one-process step on the union batch: the candidates and
    their keys (the scan index global) gathered, the search run whole on
    every rank, each rank taking the terms of its own candidates."""
    if draws is None:
        draws = draw_step_randoms(state, cfg, swav=True)
    unk = cfg.unknown_label
    model = state.model
    model.train()
    heads = model.encoder

    def fwd(svb, uvb):
        combined, plan, feats0, mapped0, ok, valid0, is_sup, grows = _plan_rows(cfg, svb, uvb,
                                                                                 group)
        pids = torch.cat([svb["point_ids"], uvb["point_ids"]])
        scan = combined["coords"][:, 0]
        scan = global_scans(cfg.num_sup_scans // world_size(group), group,
                            scan.device)[scan.long()].to(scan.dtype)
        key_in = torch.where(combined["valid"] & (pids >= 0), scan * KEY_SHIFT + pids, -1)
        key0 = torch.where(ok, key_in[torch.where(ok, plan.rep, 0).long()], -1)
        out = model(plan, feats0)
        return dict(out=out, dummy=assemble_dummy_logits(out), mapped=mapped0, valid=valid0,
                    sup=is_sup & valid0, unsup=valid0 & ~is_sup, key=key0, plan=plan,
                    grows=grows)

    with batch_norm_group(group):
        va, vb = fwd(sup_vb, unsup_vb), fwd(sup_vb2, unsup_vb2)
        l_sup = zero = torch.zeros((), device=va["dummy"].device)
        l_cal = zero
        for v in (va, vb):
            tgt = torch.where(v["sup"], v["mapped"], -1)
            l_sup = l_sup + cross_entropy(v["dummy"], tgt, v["valid"], group=group)
            l_cal = l_cal + calibration_loss(v["dummy"], tgt, unk, v["valid"], group=group)
        l_cal = cfg.calib_coeff * l_cal
        with torch.no_grad():
            nb_a, nb_b = (_novel_branch(cfg, v["dummy"], v["out"]["feats"], v["unsup"],
                                        state.queue, heads, draws[k], v["grows"],
                                        keys=v["key"], group=group)
                          for v, k in ((va, "kmeans_scores"), (vb, "kmeans_scores_b")))
        f3 = heads.final3

        def swap_term(nb_x, nb_y):
            # view X's logits on its candidates against the aligned cluster
            # label of the same point's candidate in view Y
            logits = nb_x["cand_feats"] @ f3.kernel + f3.bias
            kx = torch.where(nb_x["rel_mask"], nb_x["cand_key"], -1)
            ky = torch.where(nb_y["rel_mask"], nb_y["cand_key"], INT32_MAX)
            ky_s, order = torch.sort(ky, stable=True)
            pos = torch.searchsorted(ky_s, kx).clamp(0, ky_s.shape[0] - 1)
            m = torch.where((ky_s[pos] == kx) & (kx >= 0), order[pos], -1)
            tgt = torch.where((m >= 0) & nb_x["own"], nb_y["mapped_novel"][m.clamp(min=0)], -1)
            return cross_entropy(logits, tgt, group=group), (m >= 0).sum()

        g = (nb_a["has_novel"] & nb_b["has_novel"]).float()
        term_ab, match_ab = swap_term(nb_a, nb_b)
        term_ba, match_ba = swap_term(nb_b, nb_a)
        l_swav = cfg.novel_coeff * (term_ab + term_ba)
        loss = l_sup + l_cal + g * l_swav
        _sgd_step(state, cfg, loss, group)
    _push_mean_reliable(state, nb_a)
    state.step += 1
    metrics = {"loss": loss, "sup_seg": l_sup, "calib": l_cal, "swav": g * l_swav}
    counts = dict(n_cand=nb_a["n_cand"] + nb_b["n_cand"],
                  has_novel=(nb_a["has_novel"] & nb_b["has_novel"]).to(torch.int32),
                  n_rel=nb_a["n_rel"] + nb_b["n_rel"],
                  n_match=(match_ab + match_ba).to(torch.int32))
    ovf = plan_capacity_overflow(va["plan"]) + plan_capacity_overflow(vb["plan"])
    return state, _global_metrics(metrics, counts, ovf, group)


class ExpNops:
    """Host-side loop of the single-model discovery recipes, the `nops` /
    `nops_swav` epoch body of the JAX package's `main.py:439-535`: a labeled
    and an unlabeled loader at `num_sup_scans` scans each, in pairs, and for
    SwaV a second view of both (the same scans in the same order, each scan's
    augmentation drawn from a stream of its own, `view=1`).

    `step_log` keeps one record per step: its metrics and `step_ms`, its time
    on the device between two CUDA events (on the CPU: the host clock); an
    epoch reads the device once, at its end."""

    def __init__(self, cfg: NopsConfig, pretrained: dict | None = None, seed: int = 1234,
                 device="cuda", swav: bool = False):
        self.cfg = cfg
        self.swav = swav
        self.device = resolve_device(device)
        self.state = create_nops_state(seed, cfg, pretrained, self.device)
        self.step_log: list = []

    def make_loaders(self, lab_dataset, unlab_dataset, num_workers: int = 4, epoch: int = 0,
                     backend: str = "thread") -> tuple:
        """Epoch `epoch`'s loaders as `main.py:486-517` builds them: shuffled
        by `epoch` (the unlabeled side by 1000 + `epoch`), each scan's
        augmentation drawn from (dataset seed, `epoch`, scan[, view])."""
        from ..data import make_loader

        cfg = self.cfg
        caps = (cfg.sup_voxel_cap, cfg.voxel_caps[0] - cfg.sup_voxel_cap)
        kw = dict(backend=backend, num_workers=num_workers, epoch=epoch)
        loaders = []
        for view in ((0, 1) if self.swav else (0,)):
            loaders += [make_loader(lab_dataset, cfg.num_sup_scans, caps[0], seed=epoch,
                                    view=view, **kw),
                        make_loader(unlab_dataset, cfg.num_sup_scans, caps[1],
                                    seed=1000 + epoch, view=view, **kw)]
        return tuple(loaders)

    def train_epoch(self, *loaders) -> dict:
        """One pass over the loaders in step; returns the mean of each metric."""
        if len(loaders) != (4 if self.swav else 2):
            raise ValueError(f"{'SwaV' if self.swav else 'the nops step'} takes "
                             f"{4 if self.swav else 2} loaders, got {len(loaders)}")
        step = swav_train_step if self.swav else nops_train_step
        logs, clock = [], StepClock(self.device)
        for sides in zip(*loaders):
            clock.start()
            vbs = [voxel_batch_to_device(b["voxel"], self.device) for b in sides]
            self.state, metrics = step(self.state, *vbs, self.cfg)
            clock.stop()
            logs.append(metrics)
        if not logs:
            return {}
        keys = list(logs[0])
        # the epoch's one read of the device
        values = torch.stack([torch.stack([m[k].float() for k in keys])
                              for m in logs]).cpu().numpy()
        for row, ms in zip(values, clock.ms()):
            self.step_log.append({**dict(zip(keys, map(float, row))), "step_ms": ms})
        return {k: float(np.mean(values[:, i], dtype=np.float64)) for i, k in enumerate(keys)}
