"""Stage 1.5: NCC-head calibration and its mixing / scheduling ablations
(PyTorch port of `gcdlss_tpu/train/finetune.py`).

Rebuilds of the reference finetune classes (`modules/exp.py`):
  * ExpFineTuning (`:505-687`): dummy-logit CE + calibration loss;
  * ExpMixFineTuning (`:1306-1520`): + feature mixing in the sup CE and
    optional entropy-minimisation terms; ExpMixCosineFineTuning (`:1758`)
    the same on cosine heads;
  * ExpBetaSchedulingFineTuning (`:1624-1757`): centroid-triple mixing
    (target: the unknown slot) with a linearly scheduled pair-mixing ratio;
  * ExpMixExtraFineTuning (`:2125-2430`) and its step / poly / linear
    threshold schedules (`:2431-2798`): one forward over sup + unsup scans
    with a 0.1x pseudo-label unsup CE (NCC prob > threshold -> unknown slot);
  * ExpRCExtra (`:975-1112`): the unsup rows whose stored GT is the unknown
    label, target unknown where the NCC prob passes the threshold;
  * ExpClusterFineTuning (`:1123-1306`): the pseudo-unknown rows mined on the
    host (`_cluster_unknown_mask_host`: DBSCAN over each unlabeled scan's
    voxels, k-means over the clusters, a Hungarian matching to the classes).

All are config switches on two steps (`finetune_train_step`,
`finetune_extra_train_step`); `train/registry.py` maps the names. The k^3
maps of every plan go through K3. The cluster miner reads the device once a
step (its one host round trip); the plan build waits for nothing.

The JAX package hands its miner the input rows' coordinates beside the plan
rows' masks and features (`gcdlss_tpu/train/finetune.py:405-409`); plan rows
are the input rows compacted (pads and duplicates dropped), so wherever the
labeled side holds fewer voxels than `sup_voxel_cap` its DBSCAN clusters
other voxels than those it pairs with features and masks. The port hands
it the plan rows' coordinates (ROADMAP Queue 3, closed or deliberate).

Each step draws its permutations from a generator seeded by (1234, step)
(the Extra step: (4321, step)), as the JAX package folds the step into a
fixed key: a resumed run draws what an unbroken one draws. `draws=` replaces
them, e.g. with the JAX package's.

Both steps take a process `group` (`parallel.mesh`), on the pattern of
`train.discover`: each rank holds whole scans (`shard_voxel_batch`) and
plans them at its share of the capacities; batch norm, the loss means and
the gradients are global; the mixing permutations are drawn over the union
plan's rows and each rank mixes its share of them, reading the partner rows
of other ranks (`parallel.mesh.union_rows`); the cluster miner runs once,
on rank 0, over every rank's rows, and its mask is broadcast. Every rank
ends with the parameters, statistics and metrics of the one-process step
on the union batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..losses import calibration_loss, cross_entropy, soft_cross_entropy
from ..models.layers import batch_norm_group, normed_linear
from ..models.minkunet import DEFAULT_PLANES, HEADS, MinkUNetRC, assemble_dummy_logits
from ..ops.plan import plan_capacity_overflow
from ..parallel.mesh import (all_reduce, all_reduce_grads, all_reduce_metrics, gather_rows,
                             global_rows, global_scans, raise_if_dropped, rank_config, rank_of,
                             rank_share, replicate, union_rows)
from .common import (StepClock, TrainState, make_sgd, plan_and_gather, resolve_device,
                     voxel_batch_to_device)
from .discover import _combine_batches
from .feature_mixing import draw_perms, mix_centroid_sup, mix_features
from .schedule import make_lr_schedule

PLAIN_SEED, EXTRA_SEED = 1234, 4321
_CHOICES = {"mix_mode": ("none", "pairs", "centroid"), "mix_schedule": ("const", "linear"),
            "thr_schedule": ("const", "step", "poly", "linear"), "head": HEADS,
            "extra_mode": ("threshold", "rc_oracle", "cluster")}


@dataclass(frozen=True)
class FineTuneConfig:
    num_labeled_classes: int
    num_classes: int
    unknown_label: int
    voxel_caps: tuple
    arch: str = "MinkUNet34"
    planes: tuple = DEFAULT_PLANES
    in_channels: int = 1
    dtype: str = "float32"  # activation dtype: "bfloat16" on the card
    remat: bool = False
    head: str = "linear"  # "cosine" = ExpMixCosineFineTuning (`exp.py:1758`)
    ncc_heads: int = 3
    calib_coeff: float = 0.05  # 0.15 for nuScenes (`exp.py:542-546`)
    # --- feature-mixing family (`exp.py:1306-1757`) ---
    mix_mode: str = "none"  # none | pairs | centroid
    mixing_ratio: float = 0.1  # pairs-mode ratio (`mixing_ratio_feat`)
    mix_schedule: str = "const"  # const | linear: 1 -> mix_end over training
    mix_start: float = 1.0
    mix_end: float = 0.1
    beta_coeff: float = 0.5
    entropy_minimize: bool = False
    id_entropy_coeff: float = 1.0
    ood_entropy_coeff: float = 1e-6
    # --- "Extra" family: sup+unsup pseudo-label loss (`exp.py:2125-2798`) ---
    sup_voxel_cap: int = 0  # > 0: the Extra step; sup rows are [0, sup_voxel_cap)
    num_sup_scans: int = 2
    unsup_coeff: float = 0.1
    thr_schedule: str = "const"  # const | step | poly | linear
    thr_init: float = 0.1
    thr_end: float = 0.5
    # unsup pseudo-label source: threshold (NCC prob > thr over all unsup
    # rows, `exp.py:2524-2534`), rc_oracle (rows whose stored GT is the
    # unknown label, `exp.py:1087-1100`), cluster (host DBSCAN -> k-means(K+1)
    # -> Hungarian picks the unknown cluster, `exp.py:1123-1306`)
    extra_mode: str = "threshold"
    lr: float = 1e-4  # finetune_lr
    momentum: float = 0.9
    weight_decay: float = 1e-4
    use_scheduler: bool = True
    warmup_epochs: int = 4
    min_lr: float = 1e-5
    epochs: int = 50
    steps_per_epoch: int = 1000


def check_config(cfg: FineTuneConfig) -> None:
    """Raise ValueError for a value no recipe has."""
    for field, choices in _CHOICES.items():
        if getattr(cfg, field) not in choices:
            raise ValueError(f"FineTuneConfig.{field} must be one of {choices}, "
                             f"got {getattr(cfg, field)!r}")


def make_model(cfg: FineTuneConfig, generator: torch.Generator | None = None) -> MinkUNetRC:
    """`MinkUNetRC` with one novel column (`final3` is unused in Stage 1.5 but
    present, as in the reference's checkpoint)."""
    check_config(cfg)
    return MinkUNetRC(cfg.num_labeled_classes, 1, cfg.ncc_heads, arch=cfg.arch,
                      planes=cfg.planes, in_channels=cfg.in_channels,
                      dtype=getattr(torch, cfg.dtype), generator=generator, head=cfg.head,
                      remat=cfg.remat)


def create_finetune_state(seed: int, cfg: FineTuneConfig, pretrained: dict | None = None,
                          device="cuda") -> TrainState:
    """Model with weights drawn from `seed` (on the CPU, then moved) and SGD,
    on the card unless `device` names another (`resolve_device`).

    `pretrained`: a Stage-1 `MinkUNetSeg` state dict. Its backbone and
    `final` parameters warm-start the model, as the JAX package's
    `create_finetune_state` copies the `encoder` and `final` trees;
    batch-norm statistics, `final2` and `final3` stay fresh
    (`utils.weights.warm_start`)."""
    from ..utils.weights import warm_start

    device = resolve_device(device)
    model = make_model(cfg, torch.Generator().manual_seed(seed))
    if pretrained is not None:
        warm_start(model, pretrained)
    model = model.to(device)
    return TrainState(model=model, optimizer=make_sgd(cfg, model.parameters()))


def step_generator(base: int, step: int, device) -> torch.Generator:
    """The generator of step `step`: seeded by (base, step) alone."""
    seed = int(np.random.SeedSequence([base, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def draw_step_randoms(cfg: FineTuneConfig, base: int, step: int, n: int, device) -> dict:
    """The step's draws: the row permutations of its mix mode (2 for pairs,
    3 for centroid, none otherwise) over the plan's `n` level-0 rows. The
    ratio is never drawn: the steps pass `_mix_ratio`."""
    count = {"pairs": 2, "centroid": 3}.get(cfg.mix_mode, 0)
    return {"perms": draw_perms(step_generator(base, step, device), n, count, device)}


def _f32(x) -> float:
    return float(np.float32(x))


def _mix_ratio(cfg: FineTuneConfig, step: int) -> float:
    """Pair-mixing ratio schedule (`exp.py:1731-1737`: 1 -> mix_end), in f32
    as the JAX package computes it."""
    if cfg.mix_schedule == "linear":
        total = max(cfg.epochs * cfg.steps_per_epoch, 1)
        prog = np.clip(np.float32(step) / np.float32(total), np.float32(0), np.float32(1))
        return _f32(np.float32(1.0) - prog * np.float32(cfg.mix_start - cfg.mix_end))
    return _f32(cfg.mixing_ratio)


def _centroid_mix(feats, labels, valid, unknown_label: int, perms):
    """Triples of distinct-label features averaged; target = unknown slot
    (`exp.py:1494-1517`): `feature_mixing.mix_centroid_sup`."""
    return mix_centroid_sup(None, feats, labels, valid, unknown_label, perms=perms)


def _mixed_logits(cfg: FineTuneConfig, model: MinkUNetRC, mixf: torch.Tensor) -> torch.Tensor:
    """Mixed features through the raw `final` / `final2` parameters (the
    reference reads `.kernel` directly, `exp.py:1692-1707`; the cosine
    variant its prototype weights, `exp.py:1856-1871`), so the mixed rows'
    loss reaches both heads. [known | max(ncc)]."""
    heads = model.encoder
    if cfg.head == "cosine":
        kin = normed_linear(mixf, heads.final.weight)
        kout = normed_linear(mixf, heads.final2.weight)
    else:
        kin = mixf @ heads.final.kernel + heads.final.bias
        kout = mixf @ heads.final2.kernel + heads.final2.bias
    # amax: a tie shares the gradient, as jnp.max's does
    return torch.cat([kin, kout.amax(dim=-1, keepdim=True)], dim=-1)


def _entropy_terms(cfg: FineTuneConfig, logits, valid, group=None):
    """id / ood entropy regularisers (`exp.py:1731-1746`). The ood term is a
    masked SUM (the reference's `mean(sum(...))` over a 1-D vector)."""
    probs = torch.softmax(logits.float(), dim=-1)
    m = valid.float()
    known = probs[:, :-1]
    ent = -(known * torch.log(known + 1e-8)).sum(dim=-1)
    l_id = cfg.id_entropy_coeff * (ent * m).sum() / all_reduce(m.sum(), group).clamp(min=1.0)
    rc = probs[:, -1]
    l_ood = cfg.ood_entropy_coeff * (rc * torch.log(rc + 1e-8) * m).sum()
    return l_id + l_ood


def _sup_losses(cfg: FineTuneConfig, model, out, targets, valid0, perms, step: int,
                group=None, grows=None):
    """Sup CE (with the mixed-feature rows appended in the pairs and centroid
    modes), calibration and the entropy terms; shared by both steps. Returns
    (loss, dummy logits, parts). Over a process `group`, the rank's shares:
    `perms` are over the union plan's rows, which `grows` (each local row's
    index there) places, and the rank mixes its share of them."""
    logits = assemble_dummy_logits(out)  # [N, K + 1]
    # the reference appends the mixed rows BEFORE the calibration / entropy
    # terms (`exp.py:1709-1735`), so they take the calibration too
    ext_logits, ext_targets, ext_valid = logits, targets, valid0
    if cfg.mix_mode == "none":
        seg = cross_entropy(logits, targets, valid0, group=group)
    else:
        src = union_rows(grows, valid0, cfg.voxel_caps[0], group, (out["feats"], 0),
                         (targets, -1), (valid0 & (targets >= 0), False))
        perms = tuple(rank_share(p, group) for p in perms)
        if cfg.mix_mode == "pairs":
            mixf, mixp, mixok = mix_features(None, *src, cfg.num_labeled_classes + 1,
                                             cfg.beta_coeff, mixing_ratio=_mix_ratio(cfg, step),
                                             perms=perms)
            mix_logits = _mixed_logits(cfg, model, mixf)
            mix_seg = soft_cross_entropy(mix_logits, mixp, mixok, group=group)
            # the mixed rows' hard target: their dominant component
            mix_tgt = torch.where(mixok, mixp.argmax(dim=-1), -1)
        else:
            mixf, mix_tgt, mixok = _centroid_mix(*src, cfg.unknown_label, perms)
            mix_logits = _mixed_logits(cfg, model, mixf)
            mix_seg = cross_entropy(mix_logits, mix_tgt, mixok, group=group)
        n0, n_mix = all_reduce(valid0.sum(), group), all_reduce(mixok.sum(), group)
        seg = ((cross_entropy(logits, targets, valid0, group=group) * n0 + mix_seg * n_mix)
               / (n0 + n_mix).clamp(min=1).float())
        ext_logits = torch.cat([logits, mix_logits])
        ext_targets = torch.cat([targets, mix_tgt.to(targets.dtype)])
        ext_valid = torch.cat([valid0, mixok])
    calib = cfg.calib_coeff * calibration_loss(ext_logits, ext_targets, cfg.unknown_label,
                                               ext_valid, group=group)
    loss = seg + calib
    if cfg.entropy_minimize:
        loss = loss + _entropy_terms(cfg, ext_logits, ext_valid, group)
    return loss, logits, {"seg": seg, "calib": calib}


def _sgd_step(state: TrainState, cfg: FineTuneConfig, loss: torch.Tensor, group=None) -> None:
    lr = make_lr_schedule(cfg)(state.step)
    for pg in state.optimizer.param_groups:
        pg["lr"] = lr
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    all_reduce_grads(state.model.parameters(), group)
    state.optimizer.step()
    state.step += 1


def finetune_train_step(state: TrainState, batch: dict, cfg: FineTuneConfig,
                        draws: dict | None = None, group=None):
    """One Stage-1.5 step in place on `state`; returns (state, metrics), the
    metrics ('loss', 'seg', 'calib') as tensors on the device.

    With a process `group`, `batch` is this rank's whole scans
    (`shard_voxel_batch`) of a union batch of `cfg.num_sup_scans` scans, and
    the step is the one-process step on that union batch (see the module's
    docstring); every rank raises if any rank's plan drops a voxel."""
    check_config(cfg)
    model = state.model
    model.train()
    lcfg = rank_config(cfg, group)
    plan, feats0, _, mapped0 = plan_and_gather(batch, lcfg.voxel_caps)
    valid0 = plan.levels[0].valid
    targets = torch.where(valid0, mapped0, -1)
    grows = global_rows(plan.levels[0], lcfg.num_sup_scans, group, sides=1)
    if group is not None:
        raise_if_dropped(plan_capacity_overflow(plan), group, "the Stage-1.5 plan")
    if draws is None:
        draws = draw_step_randoms(cfg, PLAIN_SEED, state.step, cfg.voxel_caps[0], valid0.device)
    with batch_norm_group(group):
        out = model(plan, feats0)
        loss, _, parts = _sup_losses(cfg, model, out, targets, valid0, draws["perms"],
                                     state.step, group, grows)
        _sgd_step(state, cfg, loss, group)
    return state, all_reduce_metrics({"loss": loss, **parts}, group)


def _threshold(cfg: FineTuneConfig, step: int) -> float:
    """The unsup pseudo-label NCC threshold at `step` (`exp.py:2431-2798`),
    in f32 as the JAX package computes it; the step is a host int, so the
    `step` schedule's recurrence is a host loop."""
    a, b = np.float32(cfg.thr_init), np.float32(cfg.thr_end)
    total = max(cfg.epochs * cfg.steps_per_epoch, 1)
    prog = np.clip(np.float32(step) / np.float32(total), np.float32(0), np.float32(1))
    if cfg.thr_schedule == "linear":
        return _f32(a + np.float32(cfg.thr_end - cfg.thr_init) * prog)
    if cfg.thr_schedule == "poly":
        return _f32(a + np.float32(cfg.thr_end - cfg.thr_init) * prog ** 2)
    if cfg.thr_schedule == "step":
        # every even epoch, from epoch 0: thr += (end - thr) * e / epochs
        # (`exp.py:2548-2551`)
        thr = a
        for e in range(0, step // max(cfg.steps_per_epoch, 1), 2):
            thr = thr + (b - thr) * np.float32(e) / np.float32(max(cfg.epochs, 1))
        return _f32(thr)
    return _f32(a)


def _cluster_unknown_mask_host(coords, unsup, feats, probs_known):
    """ExpClusterFineTuning's pseudo-unknown mining (`exp.py:1206-1296`), on
    the host, a copy of the JAX package's: per unlabeled scan,
    DBSCAN(eps=3, min_samples=2) on the voxel coordinates -> k-means(K+1)
    over the cluster-mean input features (sklearn's KMeans when importable,
    else a numpy Lloyd; noise points assigned by the fitted k-means, where
    the reference re-fits a second k-means and merges by cluster id) -> a
    Hungarian matching between cluster-mean class probabilities and classes;
    the points of the cluster matched to the unknown column are the mask.
    All four arrays are rows of the same level-0 plan."""
    from scipy.optimize import linear_sum_assignment

    from ..algo.dbscan import dbscan

    coords = np.asarray(coords)
    unsup = np.asarray(unsup)
    feats = np.asarray(feats, np.float64)
    probs_known = np.asarray(probs_known, np.float64)
    K = probs_known.shape[1]
    mask = np.zeros(coords.shape[0], bool)
    for b in np.unique(coords[unsup, 0]) if unsup.any() else []:
        rows = np.flatnonzero(unsup & (coords[:, 0] == b))
        if rows.size < (K + 1) * 2:
            continue
        db = dbscan(coords[rows, 1:].astype(np.float64), eps=3, min_samples=2)
        ncl = int(db.max()) + 1
        if ncl < K + 1:
            continue
        cm = np.zeros((ncl, feats.shape[1]))
        cnt = np.zeros(ncl)
        core = db >= 0
        np.add.at(cm, db[core], feats[rows[core]])
        np.add.at(cnt, db[core], 1.0)
        cm /= np.maximum(cnt, 1.0)[:, None]
        try:
            from sklearn.cluster import KMeans

            km = KMeans(n_clusters=K + 1, n_init="auto", random_state=0).fit(cm)
            assign, cents = km.labels_, km.cluster_centers_
        except ImportError:  # numpy Lloyd
            rng = np.random.default_rng(0)
            cents = cm[rng.choice(ncl, K + 1, replace=False)]
            for _ in range(25):
                d = ((cm[:, None] - cents[None]) ** 2).sum(-1)
                assign = d.argmin(1)
                for c in range(K + 1):
                    if (assign == c).any():
                        cents[c] = cm[assign == c].mean(0)
        point_k = np.full(rows.size, -1, np.int64)
        point_k[core] = assign[db[core]]
        if (~core).any():
            dn = ((feats[rows[~core]][:, None] - cents[None]) ** 2).sum(-1)
            point_k[~core] = dn.argmin(1)
        P = np.zeros((K + 1, K + 1))
        for c in range(K + 1):
            sel = point_k == c
            if sel.any():
                P[c, :K] = probs_known[rows[sel]].mean(0)
        np.nan_to_num(P, copy=False)
        r_ind, c_ind = linear_sum_assignment(P, maximize=True)
        for ri, ci in zip(r_ind, c_ind):
            if ci == K:
                mask[rows[point_k == ri]] = True
    return mask


def _cluster_unknown_mask(coords0, unsup_mask, feats0, probs_known, group=None):
    """`_cluster_unknown_mask_host` on the plan's level-0 rows: the four
    tensors read from the device in one copy, the mask sent back.

    Over a process `group` (`coords0` with the scan index made global), the
    ranks' rows are gathered, the miner runs once, on rank 0 (a host DBSCAN
    and k-means run on every rank need not give every rank the same bits),
    and the mask is broadcast; each rank takes its own rows. A scan's rows
    reach the miner in the order the one-process plan holds them (each scan
    lies whole on one rank, in (x, y, z) order), so it sees the union's
    input."""
    dev = unsup_mask.device
    f, k = feats0.shape[1], probs_known.shape[1]
    rows = torch.cat([coords0.double(), unsup_mask.double()[:, None], feats0.double(),
                      probs_known.double()], dim=1)
    n = rows.shape[0]
    rows = gather_rows(rows, group)
    if rank_of(group) == 0:
        rows = rows.cpu().numpy()  # the step's one read
        mask = torch.as_tensor(_cluster_unknown_mask_host(
            rows[:, :4].astype(np.int64), rows[:, 4] > 0, rows[:, 5:5 + f],
            rows[:, 5 + f:5 + f + k]), device=dev)
    else:
        mask = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
    if group is None:
        return mask
    mask = mask.to(torch.uint8)
    replicate(mask, group=group)
    return mask[rank_of(group) * n:(rank_of(group) + 1) * n].bool()


def _pseudo_labels(cfg: FineTuneConfig, probs, mapped0, unsup_mask, thr: float,
                   cluster_mask=None):
    """The unsup rows' pseudo labels and the rows that take part:
      * threshold (`exp.py:2524-2534`): every unsup row, its argmax, forced
        to the unknown slot where the NCC prob passes `thr`;
      * rc_oracle (`exp.py:1087-1100`): the unsup rows whose stored GT is the
        unknown label, target unknown where the NCC prob passes `thr`,
        ignored (-1) otherwise;
      * cluster (`exp.py:1206-1300`): every unsup row, the unknown slot where
        `cluster_mask` holds, else class 0, as the reference's `torch.zeros`
        targets are (faithfully)."""
    unk = cfg.unknown_label
    if cfg.extra_mode == "cluster":
        return torch.where(unsup_mask, torch.where(cluster_mask, unk, 0), -1), unsup_mask
    if cfg.extra_mode == "rc_oracle":
        rows = unsup_mask & (mapped0 == unk)
        return torch.where(rows & (probs[:, -1] > thr), unk, -1), rows
    pseudo = torch.where(probs[:, -1] > thr, unk, probs.argmax(dim=-1))
    return torch.where(unsup_mask, pseudo, -1), unsup_mask


def finetune_extra_train_step(state: TrainState, sup_vb: dict, unsup_vb: dict,
                              cfg: FineTuneConfig, draws: dict | None = None, group=None):
    """ExpMixExtra*FineTuning / ExpRCExtra / ExpClusterFineTuning step in
    place on `state`: one forward over the sup + unsup scans, the sup losses
    of `finetune_train_step` on the sup rows, plus `unsup_coeff` x the
    pseudo-label CE on the unsup rows (`exp.py:2236-2798`). Returns (state,
    metrics): 'loss', 'seg', 'calib', 'unsup_seg', 'thr'.

    With a process `group`, `sup_vb` / `unsup_vb` are this rank's whole
    scans of each side (`shard_voxel_batch`, the same scan block on both),
    and the step is the one-process step on the union batch (see the
    module's docstring); every rank raises if any rank's plan drops a
    voxel."""
    check_config(cfg)
    model = state.model
    model.train()
    lcfg = rank_config(cfg, group)
    combined = _combine_batches(sup_vb, unsup_vb, lcfg)
    plan, feats0, _, mapped0 = plan_and_gather(combined, lcfg.voxel_caps)
    n_in = sup_vb["coords"].shape[0] + unsup_vb["coords"].shape[0]
    ok = plan.rep < n_in
    valid0 = plan.levels[0].valid
    is_sup = ok & (plan.rep < lcfg.sup_voxel_cap)
    sup_mask = is_sup & valid0
    unsup_mask = valid0 & ~is_sup
    grows = global_rows(plan.levels[0], lcfg.num_sup_scans, group)
    if group is not None:
        raise_if_dropped(plan_capacity_overflow(plan), group, "the Stage-1.5 plan")
    if draws is None:
        draws = draw_step_randoms(cfg, EXTRA_SEED, state.step, cfg.voxel_caps[0], valid0.device)
    thr = _threshold(cfg, state.step)

    with batch_norm_group(group):
        out = model(plan, feats0)
        sup_targets = torch.where(sup_mask, mapped0, -1)
        loss, logits, parts = _sup_losses(cfg, model, out, sup_targets, sup_mask,
                                          draws["perms"], state.step, group, grows)
        probs = torch.softmax(logits.detach(), dim=-1)
        cluster_mask = None
        if cfg.extra_mode == "cluster":
            # the level-0 rows' coordinates, gathered as feats0 is, the scan
            # index the union's
            coords0 = combined["coords"][torch.where(ok, plan.rep, 0).long()]
            scans = global_scans(lcfg.num_sup_scans, group, coords0.device)
            coords0 = torch.cat([scans[coords0[:, 0].long()].to(coords0.dtype)[:, None],
                                 coords0[:, 1:]], dim=1)
            cluster_mask = _cluster_unknown_mask(coords0, unsup_mask, feats0,
                                                 probs[:, :cfg.num_labeled_classes], group)
        pseudo, rows = _pseudo_labels(cfg, probs, mapped0, unsup_mask, thr, cluster_mask)
        l_unsup = cfg.unsup_coeff * cross_entropy(logits, pseudo, rows, group=group)
        loss = loss + l_unsup
        _sgd_step(state, cfg, loss, group)
    metrics = all_reduce_metrics({"loss": loss, **parts, "unsup_seg": l_unsup}, group)
    metrics["thr"] = torch.full((), thr, dtype=torch.float32, device=loss.device)  # no copy
    return state, metrics


class ExpFineTuning:
    """Host-side Stage-1.5 loop, the `finetune` / `finetune_extra` epoch
    bodies of the JAX package's `main.py:407-434`: the plain step over one
    loader, or (`cfg.sup_voxel_cap` > 0) the Extra step over a labeled and
    an unlabeled loader in pairs.

    `step_log` keeps one record per step: its metrics and `step_ms`, its time
    on the device between two CUDA events (on the CPU: the host clock). An
    epoch reads the device once, at its end."""

    def __init__(self, cfg: FineTuneConfig, pretrained: dict | None = None, seed: int = 1234,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = create_finetune_state(seed, cfg, pretrained, self.device)
        self.step_log: list = []

    @property
    def extra(self) -> bool:
        return self.cfg.sup_voxel_cap > 0

    def make_loaders(self, lab_dataset, unlab_dataset=None, batch_size: int = 2,
                     num_workers: int = 4, epoch: int = 0, backend: str = "thread") -> tuple:
        """Epoch `epoch`'s loaders as `main.py:407-423` builds them: `batch_size`
        scans at `voxel_caps[0]` for the plain step; for the Extra step
        `num_sup_scans` labeled scans at `sup_voxel_cap` and as many unlabeled
        ones at the rest of `voxel_caps[0]`. Shuffled by `epoch` (the
        unlabeled side by 1000 + `epoch`), each scan's augmentation drawn
        from (dataset seed, `epoch`, scan); `backend` as `data.make_loader`."""
        from ..data import make_loader

        cfg = self.cfg
        kw = dict(backend=backend, num_workers=num_workers, epoch=epoch)
        if not self.extra:
            return (make_loader(lab_dataset, batch_size, cfg.voxel_caps[0], seed=epoch, **kw),)
        if unlab_dataset is None:
            raise ValueError("the Extra step needs an unlabeled dataset")
        return (make_loader(lab_dataset, cfg.num_sup_scans, cfg.sup_voxel_cap, seed=epoch,
                            **kw),
                make_loader(unlab_dataset, cfg.num_sup_scans,
                            cfg.voxel_caps[0] - cfg.sup_voxel_cap, seed=1000 + epoch, **kw))

    def train_epoch(self, loader, unlab_loader=None) -> dict:
        """One pass; returns the mean of each metric over its steps."""
        if self.extra and unlab_loader is None:
            raise ValueError("the Extra step needs an unlabeled loader")
        step = finetune_extra_train_step if self.extra else finetune_train_step
        batches = zip(loader, unlab_loader) if self.extra else ((b,) for b in loader)
        logs, clock = [], StepClock(self.device)
        for sides in batches:
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
