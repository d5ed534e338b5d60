"""Stage 2: mean-teacher generalized class discovery with LaserMix and the
NCC threshold (PyTorch port of `gcdlss_tpu/train/discover.py`, the
reference's `ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive` and its
discovery family).

One step: the combined sup + unsup plan, a teacher forward (train-mode batch
norm, no gradient), the LaserMix plan built from the teacher's pseudo
labels, NCC candidate mining, the assignment of the candidates to novel
classes, the student's forwards with the 8-term objective, one backward,
SGD on the student and tau, the EMA teacher update and the queue push.
Everything stays on the device: shapes are fixed and the novel branch is
gated by a mask, never by a host branch.

Every variant of the JAX step runs (`check_config` names the values):
  * threshold_mode: "adaptive_logit" (learnable tau), "hybrid" (tau plus an
    offset), "fixed_prob" (NCC probability), "oracle_logit" (fixed NCC
    logit), "msp" (max known probability);
  * assigner: "kmeans_hungarian" (cosine k-means over the candidates and the
    queue, the alpha clusters the base head claims dropped, a per-step
    Hungarian) or "sinkhorn" (Sinkhorn-Knopp against `final3`'s kernel,
    the queue in the marginals);
  * mix_mode: "lasermix" (the mixed plan and a third forward), "feature"
    (PolarMix-MT: labeled feature pairs mixed through the heads, soft
    targets) or "none";
  * mix_plan_mode: "voxel" (the combined plan's voxels re-batched) or
    "point" (the points mixed and re-quantized, the reference's protocol
    and the voxel mode's oracle; needs the point batches);
  * use_lion: the Gambler and energy losses in place of the calibration.
Linear heads, on a MinkUNet backbone or, with `arch="Cylinder3D"`, on
`Cylinder3DRC` (f32 whatever `dtype` says, as in the JAX package). The k^3
neighbor maps of the UNet plans go through K3 (`plan_kernel=2`) or K4
(`plan_kernel=1`); the cylinder plan's through K3.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from ..algo.hungarian import hungarian_small
from ..algo.kmeans import cosine_kmeans
from ..algo.queue import FeatureQueue, queue_flatten, queue_init, queue_push
from ..algo.sinkhorn import sinkhorn_knopp
from ..eval.metrics import confusion_update
from ..losses import (adaptive_threshold_loss, calibration_loss, cross_entropy, mse_prob_loss,
                      soft_cross_entropy)
from ..losses_lion import energy_loss, gambler_loss
from ..models.cylinder3d import Cylinder3DRC, cylinder_caps
from ..models.layers import batch_norm_group
from ..models.minkunet import (DEFAULT_PLANES, MinkUNetRC, assemble_dummy_logits,
                               assemble_dummy_logits_from_heads, assemble_novel_logits)
from ..ops.plan import PLAN_KERNELS, build_unet_plan, plan_capacity_overflow
from ..ops.voxelize import sparse_quantize
from ..parallel.mesh import (all_reduce, all_reduce_grads, all_reduce_metrics,
                             gather_candidates, global_rows, raise_if_dropped,
                             raise_if_union_over, rank_config, rank_of, rank_share, union_rows)
from ..utils.logging import span
from .common import make_sgd, plan_and_gather, resolve_device
from .feature_mixing import draw_perms, mix_features
from .lasermix import NUM_AREAS_CHOICES, lasermix_batch, lasermix_voxel_groups
from .schedule import make_lr_schedule

# field -> the values the step runs
_CHOICES = {
    "threshold_mode": ("adaptive_logit", "hybrid", "fixed_prob", "oracle_logit", "msp"),
    "assigner": ("kmeans_hungarian", "sinkhorn"),
    "mix_mode": ("lasermix", "feature", "none"),
    "mix_plan_mode": ("voxel", "point"),
    "use_lion": (False, True),
    "plan_kernel": PLAN_KERNELS,
}
# the capacities a rank of a process group takes its share of (`rank_config`)
RANK_CAPS = ("voxel_caps", "mix_voxel_caps")


@dataclass(frozen=True)
class DiscoverConfig:
    num_labeled_classes: int
    num_unlabeled_classes: int
    num_classes: int
    unknown_label: int
    voxel_caps: tuple  # combined sup+unsup plan capacities (5 levels)
    sup_voxel_cap: int  # sup rows occupy [0, sup_voxel_cap) of the combined input
    mix_voxel_caps: tuple  # capacities of the LaserMix-mixed plan
    num_sup_scans: int  # scans per batch on each side
    point_cap: int  # per-scan point capacity
    voxel_size: float = 0.05
    arch: str = "MinkUNet34"
    planes: tuple = DEFAULT_PLANES
    in_channels: int = 1
    dtype: str = "float32"  # activation dtype: "bfloat16" on the card
    remat: bool = False
    feat_dim: int = 96
    ncc_heads: int = 3
    alpha: int = 5
    kmeans_iters: int = 15
    cand_cap: int = 4096
    queue_slots: int = 20
    queue_per_slot: int = 1024
    ema_momentum: float = 0.01
    pseudo_thr: float = 0.9
    threshold_mode: str = "adaptive_logit"
    fixed_prob_thld: float = 0.2
    tau_init: float = 0.0
    threshold_offset: float = 0.0
    oracle_logit_thld: float = 0.2052
    msp_threshold: float = 0.0883
    assigner: str = "kmeans_hungarian"
    use_lion: bool = False
    lion_reward: float = 4.5
    lion_ood_reg: float = 0.1
    lion_coeff: float = 0.1
    calib_coeff: float = 0.05
    mse_coeff: float = 200.0
    lasermix_coeff: float = 0.1
    mix_mode: str = "lasermix"
    mix_plan_mode: str = "voxel"
    mixing_ratio_feat: float = 0.1
    novel_coeff: float = 0.1
    sup_novel_coeff: float = 1.0
    ncc_coeff: float = 0.1
    threshold_loss_weight: float = 0.2
    lr: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 1e-4
    use_scheduler: bool = True
    warmup_epochs: int = 4
    min_lr: float = 1e-5
    epochs: int = 50
    steps_per_epoch: int = 1000
    plan_kernel: int = 2  # k^3 maps: 2 = K3 (a search per row and column), 1 = K4 (ranks)


def make_discover_config(dataset: str, **kw) -> dict:
    """Per-dataset coefficient defaults (`exp_merge_mean_teacher.py:1454-1488,
    2744-2748`), under the keyword overrides: a copy of the JAX package's
    `make_discover_config`."""
    if dataset == "nuScenes":
        base = dict(calib_coeff=0.1, threshold_loss_weight=0.5)
    else:
        base = dict(calib_coeff=0.05, threshold_loss_weight=0.2)
    base.update(kw)
    if base.get("arch") == "Cylinder3D":
        # queue width must match the backbone feature dim (4 x base_channels)
        base.setdefault("feat_dim", 128)
    return base


def check_config(cfg: DiscoverConfig) -> None:
    """Raise ValueError for a value outside a variant field's set (`_CHOICES`)."""
    for field, choices in _CHOICES.items():
        if getattr(cfg, field) not in choices:
            raise ValueError(f"DiscoverConfig.{field} must be one of {choices}, "
                             f"got {getattr(cfg, field)!r}")


@dataclass
class DiscoverState:
    student: MinkUNetRC | Cylinder3DRC
    teacher: MinkUNetRC | Cylinder3DRC  # EMA of the student's parameters; its own BN statistics
    tau: nn.Parameter  # learnable NCC logit threshold, trained with the student
    optimizer: torch.optim.Optimizer  # SGD over the student's parameters and tau
    queue: FeatureQueue
    generator: torch.Generator  # LaserMix areas, k-means initial rows, feature-mix pairs
    step: int = 0


def make_model(cfg: DiscoverConfig,
               generator: torch.Generator | None = None) -> MinkUNetRC | Cylinder3DRC:
    """The student: `MinkUNetRC`, or `Cylinder3DRC` for `arch="Cylinder3D"`
    (f32 and its own widths: `dtype`, `planes` and `remat` do not apply;
    `feat_dim` must be 128, 4 x its base channels). As in the JAX package,
    `Cylinder3DRC` keeps its own 0.05 m for the voxel centres it feeds the
    VFE, whatever `voxel_size` says."""
    check_config(cfg)
    if cfg.arch == "Cylinder3D":
        return Cylinder3DRC(cfg.num_labeled_classes, cfg.num_unlabeled_classes, cfg.ncc_heads,
                            in_channels=cfg.in_channels, generator=generator)
    return MinkUNetRC(cfg.num_labeled_classes, cfg.num_unlabeled_classes, cfg.ncc_heads,
                      arch=cfg.arch, planes=cfg.planes, in_channels=cfg.in_channels,
                      dtype=getattr(torch, cfg.dtype), generator=generator, remat=cfg.remat)


def create_discover_state(seed: int, cfg: DiscoverConfig, pretrained: dict | None = None,
                          device="cuda") -> DiscoverState:
    """Student with weights drawn from `seed` (on the CPU, then moved), its
    copy as the teacher, tau, SGD, an empty queue and the step's generator,
    on the card unless `device` names another (`resolve_device`).

    `pretrained`: a Stage-1 `MinkUNetSeg` state dict, or for Cylinder3D a
    `Cylinder3DRC` one; its backbone and `final` parameters warm-start the
    student (`utils.weights.warm_start`), as the JAX package copies the
    `encoder` and `final` trees: the VFE, `final2` and `final3` stay fresh."""
    from ..utils.weights import warm_start

    device = resolve_device(device)
    student = make_model(cfg, torch.Generator().manual_seed(seed))
    if pretrained is not None:
        warm_start(student, {k: v for k, v in pretrained.items() if k.startswith("encoder.")
                             and not k.startswith(("encoder.final2.", "encoder.final3."))})
    student = student.to(device)
    teacher = copy.deepcopy(student)
    teacher.requires_grad_(False)
    tau = nn.Parameter(torch.tensor(cfg.tau_init, dtype=torch.float32, device=device))
    return DiscoverState(
        student=student, teacher=teacher, tau=tau,
        optimizer=make_sgd(cfg, [*student.parameters(), tau]),
        queue=queue_init(cfg.queue_slots, cfg.queue_per_slot, cfg.feat_dim, device=device),
        generator=torch.Generator(device=device).manual_seed(seed))


def _cand_cap(cfg: DiscoverConfig) -> int:
    return min(cfg.cand_cap, cfg.voxel_caps[0])  # no more candidates than voxels


def draw_step_randoms(state: DiscoverState, cfg: DiscoverConfig) -> dict:
    """The step's random draws from the state's generator: LaserMix's
    `num_areas` (int32 scalar from NUM_AREAS_CHOICES), the k-means
    initial-row scores (uniform [cand_cap + queue rows]) and, with
    mix_mode "feature", the two permutations of the cap0 rows that pair the
    mixed features (`featmix_perms`)."""
    g = state.generator
    dev = g.device
    choices = torch.as_tensor(NUM_AREAS_CHOICES, dtype=torch.int32, device=dev)
    pick = torch.randint(len(NUM_AREAS_CHOICES), (), generator=g, device=dev)
    n = _cand_cap(cfg) + cfg.queue_slots * cfg.queue_per_slot
    draws = {"num_areas": choices[pick],
             "kmeans_scores": torch.rand(n, generator=g, device=dev)}
    if cfg.mix_mode == "feature":
        draws["featmix_perms"] = draw_perms(g, cfg.voxel_caps[0], 2, dev)
    return draws


def _combine_batches(sup_vb: dict, unsup_vb: dict, cfg: DiscoverConfig):
    """Concatenate the sup and unsup voxel buffers, shifting the unsup batch
    indices by num_sup_scans."""
    ucoords = unsup_vb["coords"].clone()
    ucoords[:, 0] += cfg.num_sup_scans
    return {
        "coords": torch.cat([sup_vb["coords"], ucoords]),
        "feats": torch.cat([sup_vb["feats"], unsup_vb["feats"]]),
        "labels": torch.cat([sup_vb["labels"], unsup_vb["labels"]]),
        "mapped_labels": torch.cat([sup_vb["mapped_labels"], unsup_vb["mapped_labels"]]),
        "valid": torch.cat([sup_vb["valid"], unsup_vb["valid"]]),
    }


def _mixed_plan_voxel(cfg: DiscoverConfig, plan, feats0, mapped0, is_sup, pseudo_vox,
                      num_areas):
    """The LaserMix plan: the combined plan's level-0 voxels re-batched into
    the mixed scans. Band parity is a function of the coordinates, so the two
    copies of a coordinate shared by a sup/unsup pair land in opposite mixed
    scans and the re-batched keys are unique (`assume_unique`)."""
    lvl0 = plan.levels[0]
    g = lasermix_voxel_groups(lvl0.coords, is_sup, cfg.num_sup_scans, num_areas,
                              cfg.voxel_size)
    new_coords = torch.cat([g[:, None], lvl0.coords[:, 1:4]], dim=1)
    mix_plan = build_unet_plan(new_coords, lvl0.valid, cfg.mix_voxel_caps, assume_unique=True,
                               plan_kernel=cfg.plan_kernel)
    cap0 = lvl0.coords.shape[0]
    mix_ok = mix_plan.rep < cap0
    mix_safe = torch.where(mix_ok, mix_plan.rep, 0).long()
    mix_feats0 = feats0[mix_safe] * mix_ok[:, None].to(feats0.dtype)
    src_labels = torch.where(is_sup, mapped0, pseudo_vox)
    mix_labels0 = torch.where(mix_ok, src_labels[mix_safe], -1)
    return mix_plan, mix_feats0, mix_labels0


def _mixed_plan_point(cfg: DiscoverConfig, sup_pb: dict, unsup_pb: dict, pseudo, num_areas,
                      group=None):
    """The reference's mixed plan: LaserMix the 2S x 2P points and quantize
    them again (`exp_merge_mean_teacher.py:2856-2861`), at capacity
    `mix_voxel_caps[0]`; the voxel mode's oracle. A voxel whose points fall
    in two bands lands in both mixed scans, each time with its first point
    in that band as representative. Over a process `group` each rank mixes
    its own scan pairs (the same scan block on both sides) at its share of
    the capacity, and every rank raises if any rank's quantizer dropped a
    voxel."""
    mxyz, mfeats, mlabels, mvalid = lasermix_batch(sup_pb, unsup_pb, pseudo, num_areas)
    nscan, npt = mxyz.shape[0], mxyz.shape[1]
    n = nscan * npt
    bidx = torch.arange(nscan, dtype=torch.int32, device=mxyz.device).repeat_interleave(npt)
    vox = sparse_quantize(mxyz.reshape(n, 3), bidx, mvalid.reshape(-1), cfg.voxel_size,
                          cfg.mix_voxel_caps[0])
    if group is not None:
        raise_if_dropped((vox["count"] - cfg.mix_voxel_caps[0]).clamp(min=0), group,
                         "the point-mode LaserMix quantizer")
    flat_feats = mfeats.reshape(n, -1)
    mrep_ok = vox["rep"] < n
    mrep = torch.where(mrep_ok, vox["rep"], 0).long()
    mix_feats0 = flat_feats[mrep] * mrep_ok[:, None].to(flat_feats.dtype)
    mix_labels0 = torch.where(mrep_ok, mlabels.reshape(-1)[mrep], -1)
    mix_plan = build_unet_plan(vox["coords"], vox["valid"], cfg.mix_voxel_caps, presorted=True,
                               plan_kernel=cfg.plan_kernel)
    mix_ok = mix_plan.rep < cfg.mix_voxel_caps[0]
    mix_safe = torch.where(mix_ok, mix_plan.rep, 0).long()
    mix_feats0 = mix_feats0[mix_safe] * mix_ok[:, None].to(mix_feats0.dtype)
    mix_labels0 = torch.where(mix_ok, mix_labels0[mix_safe], -1)
    return mix_plan, mix_feats0, mix_labels0


def mixed_plan(cfg: DiscoverConfig, plan, feats0, mapped0, is_sup, unsup_mask, maxp_t, argm_t,
               num_areas, sup_pb=None, unsup_pb=None, group=None):
    """The LaserMix plan of `cfg.mix_plan_mode` with its level-0 features and
    labels (labeled rows their mapped labels, unlabeled rows the teacher's
    argmax where its top probability reaches `pseudo_thr`, else -1).
    Returns (mix_plan, mix_feats0, mix_labels0)."""
    if cfg.mix_plan_mode == "voxel":
        pseudo_vox = torch.where(unsup_mask & (maxp_t >= cfg.pseudo_thr), argm_t, -1).to(
            mapped0.dtype)
        return _mixed_plan_voxel(cfg, plan, feats0, mapped0, is_sup, pseudo_vox, num_areas)
    if sup_pb is None or unsup_pb is None:
        raise ValueError('mix_plan_mode="point" needs the point batches (sup_pb, unsup_pb)')
    # each unlabeled point's pseudo label: the teacher's at its voxel's row
    cap0, sup_cap = cfg.voxel_caps[0], cfg.sup_voxel_cap
    vrow = unsup_pb["voxel_row"]
    ok_p = vrow < (cap0 - sup_cap)
    prow = plan.inverse[torch.where(ok_p, sup_cap + vrow, 0).long()]
    ok_p = ok_p & (prow < cap0)
    srow = torch.where(ok_p, prow, 0).long()
    pseudo = torch.where(ok_p & (maxp_t[srow] >= cfg.pseudo_thr), argm_t[srow], -1).to(
        torch.int32)
    return _mixed_plan_point(cfg, sup_pb, unsup_pb, pseudo, num_areas, group)


def candidate_mask(cfg: DiscoverConfig, dummy_t, probs_t, tau, unsup_mask):
    """The unlabeled voxels the teacher calls novel, by `cfg.threshold_mode`."""
    if cfg.threshold_mode in ("adaptive_logit", "hybrid"):
        novel = dummy_t[:, -1] > tau + cfg.threshold_offset
    elif cfg.threshold_mode == "oracle_logit":
        novel = dummy_t[:, -1] > cfg.oracle_logit_thld
    elif cfg.threshold_mode == "msp":
        novel = probs_t[:, :-1].max(dim=-1).values < cfg.msp_threshold
    else:  # fixed_prob
        novel = probs_t[:, -1] > cfg.fixed_prob_thld
    return novel & unsup_mask


def _assign_kmeans_hungarian(cfg, heads, cand_feats, cand_valid, n_cand, qfeats, qvalid,
                             scores):
    """Cosine k-means over the candidates and the queue into Ku + alpha
    clusters; the alpha clusters the base head claims most confidently are
    dropped, the rest relabelled 0..M-1 and aligned to the novel head's
    argmax by a Hungarian matching. Returns (rel_mask, n_rel, has_novel,
    novel column per candidate)."""
    K, Ku = cfg.num_labeled_classes, cfg.num_unlabeled_classes
    cand_cap = cand_feats.shape[0]
    all_valid = torch.cat([cand_valid, qvalid])
    do_cluster = (n_cand > 0) & (all_valid.sum() > Ku + cfg.alpha)
    nclu = Ku + cfg.alpha
    assign_all, cents = cosine_kmeans(torch.cat([cand_feats, qfeats]), all_valid, nclu, scores,
                                      iters=cfg.kmeans_iters)
    cluster_logits = cents @ heads.final.kernel + heads.final.bias
    top = torch.sort(cluster_logits.max(dim=-1).values, descending=True, stable=True)
    unreliable = top.indices[:cfg.alpha]
    assign = assign_all[:cand_cap].long()
    rel_mask = cand_valid & ~(assign[:, None] == unreliable[None, :]).any(dim=1)
    n_rel = rel_mask.sum().to(torch.int32)
    has_novel = do_cluster & (n_rel > 0)
    # compact-relabel the surviving clusters to 0..M-1
    present = torch.zeros(nclu, dtype=torch.int32, device=cand_feats.device).scatter_reduce(
        0, torch.where(rel_mask, assign, nclu - 1), rel_mask.to(torch.int32), "amax")
    new_id = torch.cumsum(present, 0) - 1
    rel_labels = new_id[assign.clamp(0, nclu - 1)].clamp(0, Ku - 1)
    # per-step Hungarian: novel-head argmax against the cluster labels
    novel_preds = (cand_feats @ heads.final3.kernel + heads.final3.bias).argmax(dim=-1)
    cost = confusion_update(novel_preds, rel_labels, Ku, rel_mask)
    row_of_col = hungarian_small(cost.float(), maximize=True)
    return rel_mask, n_rel, has_novel, row_of_col[rel_labels] + K


def discover_train_step(state: DiscoverState, sup_vb: dict, unsup_vb: dict,
                        cfg: DiscoverConfig, draws: dict | None = None,
                        sup_pb: dict | None = None, unsup_pb: dict | None = None,
                        group=None):
    """One Stage-2 step in place on `state`; returns (state, metrics), the
    metrics as tensors on the device.

    `draws` replaces the step's random draws (`draw_step_randoms`), e.g. with
    the JAX package's. The point batches `sup_pb` / `unsup_pb` are read only
    by the point-mode mixed plan, which raises without them.

    With a process `group` (`parallel.mesh`), `sup_vb` / `unsup_vb` (and
    `sup_pb` / `unsup_pb`, `shard_point_batch`) are this rank's whole scans
    (`shard_voxel_batch`, the same scan block on both sides, so every
    LaserMix pair stays on its rank) and the step is the one-process step on
    every rank's scans under `cfg`, whose capacities and scan counts stay
    global (`rank_config` derives the rank's): batch norm over all rows,
    each loss the rank's share of the global mean, gradients summed over the
    ranks, the candidates mined by their row in the global plan
    (`global_rows`, `gather_candidates`), and the assignment (k-means and
    the Hungarian match, or Sinkhorn) and the queue push run on the gathered
    set on every rank. Every variant runs so: the feature mix pairs the
    union plan's rows (`parallel.mesh.union_rows`), each rank mixing its
    share of the pairs; the point-mode quantizer raises where a rank's
    capacity drops a voxel; Cylinder3D's cylinder levels keep the union's
    capacities on every rank. Every rank must hold the same state and draws
    (`parallel.mesh.replicate`)."""
    lcfg = rank_config(cfg, group, RANK_CAPS)
    if group is not None and sup_vb["coords"].shape[0] != lcfg.sup_voxel_cap:
        raise ValueError(f"a rank's sup batch must have {lcfg.sup_voxel_cap} rows "
                         "(shard_voxel_batch)")
    apply = apply_model
    if group is not None and cfg.arch == "Cylinder3D":
        apply = _union_cylinder_passes(cfg, group)
    with batch_norm_group(group):
        return _train_step(state, sup_vb, unsup_vb, cfg, lcfg, draws, sup_pb, unsup_pb, group,
                           apply)


def apply_model(model, plan, feats, kind: str):
    """The seam every backbone pass of the step goes through (the JAX
    package's `apply_model`): (outputs, entries the windows dropped) of
    `model` on `plan`. `kind` is "main" (the combined plan: the teacher and
    the student) or "mix" (the LaserMix plan). Here, the one-process pass;
    `parallel.sp_discover` runs the passes voxel-sharded instead."""
    del kind
    return model(plan, feats), None


def _union_cylinder_passes(cfg: DiscoverConfig, group):
    """The seam of Cylinder3D's passes over a process group: each rank's
    cylinder levels at the union's capacities (its voxels are a subset of
    the union's at every level, so it drops none the one-process step
    keeps), and every rank raises where the union's voxels (the ranks'
    counts summed) exceed a level's capacity, as there the one-process step
    drops some that a rank keeps. Reads the device once a pass."""
    union_cap0 = {"main": cfg.voxel_caps[0], "mix": cfg.mix_voxel_caps[0]}

    def apply(model, plan, feats, kind: str):
        out = model(plan, feats, cap0=union_cap0[kind])
        raise_if_union_over(out["cyl_counts"], cylinder_caps(union_cap0[kind],
                                                             model.cyl_cap_ratio),
                            group, "Cylinder3D's cylinder plan (voxel_caps[0] sets its "
                            "capacities)")
        return out, None

    return apply


def _train_step(state, sup_vb, unsup_vb, cfg, lcfg, draws, sup_pb, unsup_pb, group,
                apply=apply_model, probe=False):
    """The step's body. `apply`: the seam of its backbone passes
    (`apply_model`). `probe`: return the LaserMix plan as soon as it is
    built, the teacher pass run and nothing updated but the teacher's
    batch-norm statistics (`parallel.sp_discover.probe_mix_plan`)."""
    check_config(cfg)
    if draws is None:
        draws = draw_step_randoms(state, cfg)
    K = cfg.num_labeled_classes
    student, teacher = state.student, state.teacher
    student.train()
    teacher.train()

    # ---- combined sup + unsup plan ----
    with span("discover/plan"):
        plan, feats0, _, mapped0 = plan_and_gather(_combine_batches(sup_vb, unsup_vb, lcfg),
                                                   lcfg.voxel_caps, cfg.plan_kernel)
    n_in = sup_vb["coords"].shape[0] + unsup_vb["coords"].shape[0]
    ok = plan.rep < n_in
    valid0 = plan.levels[0].valid
    is_sup = ok & (plan.rep < lcfg.sup_voxel_cap)
    sup_mask = is_sup & valid0
    unsup_mask = valid0 & ~is_sup
    cap0 = lcfg.voxel_caps[0]

    # ---- teacher forward: train-mode BN, its statistics become the teacher's ----
    with torch.no_grad(), span("discover/teacher"):
        out_t, ovf_t = apply(teacher, plan, feats0, "main")
        dummy_t = assemble_dummy_logits(out_t)
        feats_t = out_t["feats"]
        probs_t = torch.softmax(dummy_t, dim=-1)
        maxp_t, argm_t = probs_t.max(dim=-1)

    # ---- LaserMix plan from the teacher's pseudo labels ----
    mix_plan = None
    if cfg.mix_mode == "lasermix":
        with torch.no_grad(), span("discover/mix_plan"):
            mix_plan, mix_feats0, mix_labels0 = mixed_plan(
                lcfg, plan, feats0, mapped0, is_sup, unsup_mask, maxp_t, argm_t,
                draws["num_areas"], sup_pb, unsup_pb, group)
    if probe:
        return mix_plan

    # ---- NCC candidate mining and the novel assignment (teacher side, no grad) ----
    with torch.no_grad(), span("discover/mining"):
        cand_mask = candidate_mask(cfg, dummy_t, probs_t, state.tau, unsup_mask)
        n_cand = all_reduce(cand_mask.sum().to(torch.int32), group)
        cand_cap = _cand_cap(cfg)
        # a capped subset in hashed row order: plan order is coordinate
        # order, so a prefix would keep one spatial corner of the scans; the
        # low 27 bits of the int32-wrapped product are those of the int64 one
        grows = global_rows(plan.levels[0], lcfg.num_sup_scans, group)
        h = (grows * -1640531527) & 0x07FFFFFF
        key = torch.where(cand_mask, h, h + (1 << 27))
        cand_valid = torch.arange(cand_cap, device=valid0.device) < n_cand.clamp(max=cand_cap)
        # the student's terms of a candidate are taken on the rank that holds
        # its row (`own`); the assignment and the queue see all of them
        (gfeats,), owner, lrow = gather_candidates(key, cand_mask, cand_cap, group, feats_t)
        cand_feats = gfeats * cand_valid[:, None]
        own = cand_valid & (owner == rank_of(group))
        cand_rows = torch.where(own, lrow, 0)
        qfeats, qvalid = queue_flatten(state.queue)
        heads = student.encoder
        if cfg.assigner == "sinkhorn":
            # Sinkhorn-Knopp against the novel head's kernel, the queue in
            # the marginals: every candidate is kept
            q_assign = sinkhorn_knopp(cand_feats, heads.final3.kernel, valid=cand_valid,
                                      queue=qfeats, queue_valid=qvalid)
            rel_mask, n_rel, has_novel = cand_valid, n_cand, n_cand > 0
            mapped_novel = q_assign.argmax(dim=-1) + K
        else:
            rel_mask, n_rel, has_novel, mapped_novel = _assign_kmeans_hungarian(
                cfg, heads, cand_feats, cand_valid, n_cand, qfeats, qvalid,
                draws["kmeans_scores"])

    # ---- student forwards, one loss, one backward ----
    with span("discover/student_main_fwd"):
        out_s, ovf_s = apply(student, plan, feats0, "main")
        dummy_s = assemble_dummy_logits(out_s)
        feats_s = out_s["feats"]
        sup_targets = torch.where(sup_mask, mapped0, -1)
        l_sup = cross_entropy(dummy_s, sup_targets, valid0, group=group)
        l_mse = cfg.mse_coeff * mse_prob_loss(torch.softmax(dummy_s, dim=-1), probs_t,
                                              unsup_mask, group=group)
    with span("discover/student_mix_fwd"):
        if cfg.mix_mode == "lasermix":
            out_mix, ovf_m = apply(student, mix_plan, mix_feats0, "mix")
            dummy_mix = assemble_dummy_logits(out_mix)
            del out_mix  # only the assembled logits live on into the backward
            l_lm = cfg.lasermix_coeff * cross_entropy(dummy_mix, mix_labels0,
                                                      mix_plan.levels[0].valid, group=group)
        elif cfg.mix_mode == "feature":
            # PolarMix-MT: labeled feature pairs mixed with soft targets,
            # through the raw `final` / `final2` heads; over a group, pairs
            # of the union plan's rows, each rank mixing its share of them
            src = union_rows(grows, valid0, cfg.voxel_caps[0], group, (feats_s, 0),
                             (sup_targets, -1), (sup_mask & (sup_targets >= 0), False))
            mixf, mixp, mixok = mix_features(
                None, *src, K + 1, mixing_ratio=cfg.mixing_ratio_feat,
                perms=tuple(rank_share(p, group) for p in draws["featmix_perms"]))
            mix_logits = assemble_dummy_logits_from_heads(
                mixf, {"kernel": heads.final.kernel, "bias": heads.final.bias},
                {"kernel": heads.final2.kernel, "bias": heads.final2.bias})
            l_lm = cfg.lasermix_coeff * soft_cross_entropy(mix_logits, mixp, mixok, group=group)
        else:
            l_lm = torch.zeros((), device=valid0.device)
    with span("discover/losses"):
        if cfg.use_lion:
            # LiON: the Gambler and energy-margin losses in f32, in place of
            # the calibration loss
            l_gam = gambler_loss(dummy_s.float(), sup_targets, valid0, cfg.unknown_label,
                                 reward_default=cfg.lion_reward, ood_reg=cfg.lion_ood_reg,
                                 group=group)
            l_en, _ = energy_loss(dummy_s.float(), sup_targets, valid0,
                                  ood_ind=cfg.unknown_label, group=group)
            l_cal = cfg.lion_coeff * (l_gam + l_en)
        else:
            l_cal = cfg.calib_coeff * calibration_loss(dummy_s, sup_targets, cfg.unknown_label,
                                                       valid0, group=group)
        if cfg.threshold_mode in ("adaptive_logit", "hybrid"):
            l_thr = cfg.threshold_loss_weight * adaptive_threshold_loss(
                dummy_s[:, -1], sup_targets, cfg.unknown_label, state.tau, valid0, group=group)
        else:
            # tau stays in the graph with a zero gradient, so SGD still
            # decays it, as optax's chain does in the JAX package
            l_thr = 0.0 * state.tau
        # the novel terms, gated by has_novel
        g = has_novel.float()
        f2, f3 = heads.final2, heads.final3
        stud_known_cand = dummy_s[cand_rows][:, :-1]
        cat_nov = torch.cat([stud_known_cand, cand_feats @ f3.kernel + f3.bias], dim=-1)
        own_rel = rel_mask & own
        l_nov_unsup = cfg.novel_coeff * cross_entropy(
            cat_nov, torch.where(own_rel, mapped_novel, -1), group=group)
        cat_sup = torch.cat([dummy_s[:, :-1], feats_s @ f3.kernel + f3.bias], dim=-1)
        l_nov_sup = cfg.sup_novel_coeff * cross_entropy(cat_sup, sup_targets, valid0,
                                                        group=group)
        ncc_rel = (cand_feats @ f2.kernel + f2.bias).max(dim=-1, keepdim=True).values
        l_ncc = cfg.ncc_coeff * cross_entropy(
            torch.cat([stud_known_cand, ncc_rel], dim=-1),
            torch.where(own_rel, cfg.unknown_label, -1), group=group)
        loss = l_sup + l_mse + l_lm + l_cal + l_thr + g * (l_nov_unsup + l_nov_sup + l_ncc)

    with span("discover/backward"):
        lr = make_lr_schedule(cfg)(state.step)
        for pg in state.optimizer.param_groups:
            pg["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with torch.no_grad(), span("discover/update"):
        all_reduce_grads([*student.parameters(), state.tau], group)
        state.optimizer.step()
        # EMA teacher over the parameters only: t <- (1 - m) t + m s
        m = cfg.ema_momentum
        tparams = list(teacher.parameters())
        torch._foreach_mul_(tparams, 1.0 - m)
        torch._foreach_add_(tparams, list(student.parameters()), alpha=m)
        # the queue takes this step's reliable candidates only if the novel
        # branch fired
        pushed = queue_push(state.queue, cand_feats, rel_mask)
        state.queue = FeatureQueue(*(torch.where(has_novel, new, old)
                                     for new, old in zip(pushed, state.queue)))
    state.step += 1

    metrics = {
        "loss": loss, "sup_seg": l_sup, "mse": l_mse, "lasermix": l_lm, "calib": l_cal,
        "thr_loss": l_thr, "novel_unsup": g * l_nov_unsup, "novel_sup": g * l_nov_sup,
        "ncc_unsup": g * l_ncc,
    }
    metrics = all_reduce_metrics(metrics, group)  # the ranks' shares -> the global values
    # unique voxels dropped by the capacities of the main and mixed plans
    plan_ovf = plan_capacity_overflow(plan)
    if mix_plan is not None:
        plan_ovf = plan_ovf + plan_capacity_overflow(mix_plan)
    plan_ovf = all_reduce(plan_ovf, group)
    if ovf_t is not None:  # a sharded run: the windows' dropped entries
        metrics["sp_overflow"] = ovf_t + ovf_s + (ovf_m if mix_plan is not None else 0)
    metrics.update({
        "tau": state.tau.detach().clone(),
        "n_cand": n_cand,
        "cand_overflow": (n_cand - cand_cap).clamp(min=0),
        "plan_overflow": plan_ovf,
        "n_rel": n_rel,
        "has_novel": has_novel.to(torch.int32),
    })
    return state, metrics


@torch.no_grad()
def discover_eval_step(state: DiscoverState, vb: dict, pb: dict, inv_lut: torch.Tensor,
                       cfg: DiscoverConfig) -> torch.Tensor:
    """The teacher's `forward_discover` eval: argmax over [K known | Ku
    novel] (the NCC column dropped), mapped to train-label ids, expanded to
    points; returns the [D, D] confusion increment."""
    teacher = state.teacher
    teacher.eval()
    plan, feats0, _, _ = plan_and_gather(vb, cfg.voxel_caps, cfg.plan_kernel)
    probs = torch.softmax(assemble_novel_logits(teacher(plan, feats0)), dim=-1)
    preds_raw = inv_lut[probs[:, :-1].argmax(dim=-1)]
    n_in = vb["coords"].shape[0]
    cap0 = cfg.voxel_caps[0]
    vrow = pb["voxel_row"].reshape(-1)
    okp = vrow < n_in
    prow = plan.inverse[torch.where(okp, vrow, 0).long()]
    okp = okp & (prow < cap0)
    point_pred = torch.where(okp, preds_raw[torch.where(okp, prow, 0).long()], -1)
    pvalid = pb["valid"].reshape(-1) & okp
    return confusion_update(point_pred, pb["labels"].reshape(-1), cfg.num_classes, pvalid)
