"""Experiment-module registry: reference module names -> config recipes
(PyTorch port of `gcdlss_tpu/train/registry.py`).

Maps every runnable reference experiment class (SURVEY §2.1) onto a stage and
its config overrides; `resolve_module` adds the reference CLI's substring
dispatch. `finetune_config` builds a Stage-1.5 recipe's `FineTuneConfig` as
the JAX package's `main.py:277-300` does. The table is a copy of the JAX
package's, held to it by a test.
"""

from __future__ import annotations

# name -> (stage, DiscoverConfig overrides)
MODULE_REGISTRY: dict = {
    # ---- exported (modules/__init__.py) ----
    "ExpPretrain": ("pretrain", {}),
    "ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive": (
        "discover", dict(threshold_mode="adaptive_logit", alpha=5)
    ),
    # ---- parents / threshold ablations (exp_merge_mean_teacher.py) ----
    "ExpMergeDiscover_LaserMix_MeanTeacher": (
        "discover", dict(threshold_mode="fixed_prob", alpha=3)
    ),
    "ExpMergeDiscover_LaserMix_MeanTeacher_HybridAdaptive": (
        "discover", dict(threshold_mode="hybrid", tau_init=-1.4, alpha=5)
    ),
    "ExpMergeDiscover_LaserMix_MeanTeacher_Oracle_threshold": (
        "discover", dict(threshold_mode="oracle_logit", alpha=5)
    ),
    "ExpMergeDiscover_LaserMix_MeanTeacher_MSP_threshold": (
        "discover", dict(threshold_mode="msp", alpha=5)
    ),
    # ---- PolarMix mean-teacher (grandparent; the reference class is dead
    #      code — `exp_merge_mean_teacher.py:672,729` use a never-created
    #      `self.model` — rebuilt from its spec: dataset-side PolarMix on
    #      labeled scans + labeled feature-pair mixing, no LaserMix) ----
    "ExpMergeDiscover_PolarMix_MeanTeacher": (
        "discover",
        dict(mix_mode="feature", threshold_mode="fixed_prob", alpha=3),
    ),
    # ---- Sinkhorn-Knopp assignment family (exp.py:3290+) ----
    "ExpMixRealMeanTeacherDiscover": (
        "discover", dict(assigner="sinkhorn", threshold_mode="fixed_prob")
    ),
    # ---- LiON energy-OOD variant ----
    "ExpMergeDiscover_LaserMix_LiON_MeanTeacher": (
        "discover", dict(threshold_mode="fixed_prob", use_lion=True, alpha=3)
    ),
    # ---- NOPS-style single-model discovery (exp.py:5050, 4452, 4680) ----
    "ExpDiscover": ("nops", {}),
    "ExpMixDiscoverJoint": (
        "nops",
        dict(joint_logits=True, use_mix_features=True, novel_coeff=0.002),
    ),
    "ExpMixDiscoverSwaV": ("nops_swav", {}),
    # ---- ExpMixDiscover (`exp.py:3587-3990`): single-model discovery on
    #      the finetune-extra chassis — centroid feature mixing (sup +
    #      unsup), fixed prob threshold 0.2, sklearn-style euclidean
    #      k-means over Ku+1 clusters dropping the one closest to the base
    #      prototypes, mean-feature queue, entropy minimization (KITTI) ----
    "ExpMixDiscover": (
        "nops",
        dict(use_mix_features=True, mix_centroid=True, unsup_mix_coeff=0.1,
             entropy_minimize=True),
    ),
    # ---- Stage 1.5 + mixing/scheduling ablation family (exp.py) ----
    "ExpFineTuning": ("finetune", {}),
    "ExpMixFineTuning": ("finetune", dict(mix_mode="pairs")),
    "ExpMixRealAugFineTuning": ("finetune", dict(mix_mode="pairs")),  # + resize_aug data
    "ExpBetaSchedulingFineTuning": (
        "finetune", dict(mix_mode="centroid", mix_schedule="linear")
    ),
    "ExpMixExtraFineTuning": (
        "finetune_extra",
        dict(mix_mode="pairs", entropy_minimize=True),
    ),
    "ExpMixRealAugExtraFineTuning": (
        "finetune_extra", dict(mix_mode="pairs", entropy_minimize=True)
    ),
    "ExpMixExtraStepSchedulingFineTuning": (
        "finetune_extra",
        dict(mix_mode="pairs", entropy_minimize=True, thr_schedule="step"),
    ),
    "ExpMixExtraPolySchedulingFineTuning": (
        "finetune_extra",
        dict(mix_mode="pairs", entropy_minimize=True, thr_schedule="poly"),
    ),
    "ExpMixExtraLinearSchedulingFineTuning": (
        "finetune_extra",
        dict(mix_mode="pairs", entropy_minimize=True, thr_schedule="linear"),
    ),
    # ---- unlabeled-scan uncertainty ranking (exp.py:2799) ----
    "ExpUncertaintyCheck": ("uncertainty", {}),
    # ---- cosine-classifier variants (exp.py:493, 1758) ----
    "ExpCosinePretrain": ("pretrain", dict(head="cosine")),
    "ExpMixCosineFineTuning": (
        "finetune", dict(mix_mode="pairs", head="cosine")
    ),
    # ---- RC-extra with stored-unlabeled-GT novel rows (exp.py:975-1112) ----
    "ExpRCExtra": (
        "finetune_extra",
        dict(extra_mode="rc_oracle", unsup_coeff=0.2, calib_coeff=0.01,
             thr_init=0.21, thr_schedule="const"),
    ),
    # ---- DBSCAN+kmeans pseudo-unknown mining (exp.py:1123-1306) ----
    "ExpClusterFineTuning": (
        "finetune_extra", dict(extra_mode="cluster", unsup_coeff=0.1)
    ),
    # ---- test-only threshold sweeps (exp.py:3000-3290) ----
    "ExpRCTest": ("finetune_test", dict(mix_mode="pairs")),
    "ExpMixExtraTest": (
        "finetune_test",
        dict(mix_mode="pairs", entropy_minimize=True, subdivide_novel=True),
    ),
}


def resolve_module(name: str):
    if name in MODULE_REGISTRY:
        return MODULE_REGISTRY[name]
    # substring dispatch like the reference CLI (`main.py:172-293`)
    if "Merge" in name or "Discover" in name:
        return ("discover", {})
    if "FineTuning" in name:
        return ("finetune", {})
    if "Pretrain" in name:
        return ("pretrain", {})
    raise NameError(f"Unknown module {name}")


STAGE15 = ("finetune", "finetune_extra", "finetune_test", "uncertainty")
NOPS = ("nops", "nops_swav")


def finetune_config(name: str, *, voxel_caps: tuple, batch_size: int,
                    dataset: str = "SemanticKITTI", **fields):
    """(stage, FineTuneConfig) of the Stage-1.5 recipe `name`, as
    `main.py:277-300` builds it: for `finetune_extra` the sup rows take half
    of `voxel_caps[0]` and `batch_size // 2` scans a side; the calibration
    weight is 0.15 on nuScenes, 0.05 elsewhere; `fields` (FineTuneConfig
    fields: the label space, `arch`, `lr`, ...) come next, and the recipe's
    own overrides last. ExpMixExtraTest's `subdivide_novel` is no config
    field: the sweep reads it from the recipe (`subdivide_novel`).

    Raises for a recipe of another stage; `FineTuneConfig` values it does not
    run raise when a model is made (`finetune.check_config`)."""
    from .finetune import FineTuneConfig

    stage, overrides = resolve_module(name)
    if stage not in STAGE15:
        raise ValueError(f"{name} is a {stage!r} recipe, not a Stage-1.5 one {STAGE15}")
    overrides = {k: v for k, v in overrides.items() if k != "subdivide_novel"}
    if stage == "finetune_extra":
        overrides.setdefault("sup_voxel_cap", voxel_caps[0] // 2)
        overrides.setdefault("num_sup_scans", max(batch_size // 2, 1))
    kw = {"voxel_caps": tuple(voxel_caps),
          "calib_coeff": 0.15 if dataset == "nuScenes" else 0.05, **fields}
    kw.update(overrides)  # the recipe wins (e.g. ExpRCExtra's 0.01)
    return stage, FineTuneConfig(**kw)


def subdivide_novel(name: str) -> bool:
    """Whether the sweep of recipe `name` splits the novel points in two
    (ExpMixExtraTest), as `main.py:278` pops it from the recipe."""
    return bool(resolve_module(name)[1].get("subdivide_novel", False))


def nops_config(name: str, *, voxel_caps: tuple, batch_size: int, **fields):
    """(stage, NopsConfig) of the single-model discovery recipe `name`, as
    `main.py:447-468` builds it: the sup rows take half of `voxel_caps[0]`,
    `batch_size // 2` scans a side; `fields` (NopsConfig fields: the label
    space, `arch`, `feat_dim`, `lr`, ...) come next, the recipe's overrides
    last. Raises for a recipe of another stage."""
    from .nops import NopsConfig

    stage, overrides = resolve_module(name)
    if stage not in NOPS:
        raise ValueError(f"{name} is a {stage!r} recipe, not a single-model discovery one {NOPS}")
    kw = {"voxel_caps": tuple(voxel_caps), "sup_voxel_cap": voxel_caps[0] // 2,
          "num_sup_scans": max(batch_size // 2, 1), **fields, **overrides}
    return stage, NopsConfig(**kw)
