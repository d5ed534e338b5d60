"""The port's command-line launcher: the PyTorch counterpart of `main.py`,
with its arguments under the same names and one more, `--device`.

    python -m gcdlss_tpu_torch.main -s 1 --dataset SemanticKITTI \\
        --dataset_config gcdlss_tpu_torch/configs/semkitti_minkunet.yaml \\
        --module ExpPretrain --experiment pretrain-split1 --use_scheduler

    python -m gcdlss_tpu_torch.main -s 1 --dataset SemanticKITTI --use_scheduler \\
        --module ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive \\
        --pretrained checkpoints/pretrain-split1 --epochs 50 --batch_size 4

Module names resolve through `train/registry.py`: `pretrain` (Stage 1), the
Stage-1.5 family (`finetune`, `finetune_extra`, `finetune_test`,
`uncertainty`), `discover` (Stage 2) and the single-model discovery family
(`nops`, `nops_swav`: ExpDiscover, ExpMixDiscoverJoint, ExpMixDiscover,
ExpMixDiscoverSwaV). The epoch-loop recipes save a
checkpoint an epoch, keyed by the epoch, and `<checkpoint_dir>/<experiment>/
pretrained` at the end; `--resume_checkpoint` restarts them at the saved
epoch + 1, each epoch's loaders seeded by the epoch, so a resumed run draws
and updates as an unbroken one. Stage 2 saves each epoch keyed by the step,
and `--resume_checkpoint` restores its latest state and then runs `--epochs`
epochs, as `main.py` does. `--pretrained <dir>` warm-starts Stage 1.5 and
Stage 2 from a Stage-1 run's `pretrained` state dict; `--test --checkpoint
<dir>` evaluates a saved state.

Runs on the card (`--device cuda`, the default) and raises without one;
`--device cpu` runs everything on the CPU, the kernels' plain versions
included. The model is f32, as `main.py`'s: on the card its convs hand K1 and
K2 bf16-rounded inputs and keep f32 sums (`ops.fused_conv`).
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np

SEED = 1234
_ITEM7 = "ROADMAP Queue 1 item 7, Cylinder3D and the mmdet3d-style stack"


def resolve_discover_overrides(module_name: str, dataset: str) -> dict:
    """Merge-branch config resolution: the registry recipe over the dataset's
    coefficient defaults, as `main.py:40-53` resolves it."""
    from .train.discover import make_discover_config
    from .train.registry import resolve_module

    stage, overrides = resolve_module(module_name)
    if stage != "discover":
        raise NameError(f"{module_name} is not a Merge/Discover module")
    return make_discover_config(dataset, **overrides)


def resume_from_checkpoint(mgr, state, resume_arg):
    """`--resume_checkpoint` restore for the epoch-loop recipes
    (`main.py:56-80`). Returns (state, start_epoch). A value that names a
    directory restores from that experiment's checkpoints; any other truthy
    value from this experiment's own latest save."""
    from .train.checkpoint import CheckpointManager

    if not resume_arg:
        return state, 0
    src = mgr
    if isinstance(resume_arg, str) and os.path.isdir(resume_arg):
        src = CheckpointManager(resume_arg)
    restored = src.restore(state)
    if restored is None:
        print("WARNING: --resume_checkpoint found no restorable step; starting fresh")
        return state, 0
    start = int(src.latest_step()) + 1
    print(f"resumed from saved epoch {start - 1}")
    return restored, start


# value flags default to None so that a `--dataset_config` file can supply
# them; the defaults live in one place, `config.ExperimentConfig`
parser = ArgumentParser(prog="python -m gcdlss_tpu_torch.main")
parser.add_argument("-s", "--split", default=None, type=int, required=False)
parser.add_argument("--dataset", choices=["SemanticKITTI", "nuScenes", "SemanticPOSS"],
                    default=None, type=str)
parser.add_argument("--dataset_config", default=None, type=str)
parser.add_argument("--dataset_path", default=None, type=str)
parser.add_argument("--voxel_size", default=None, type=float)
parser.add_argument("--downsampling", default=None, type=int)
parser.add_argument("--batch_size", default=None, type=int)
parser.add_argument("--num_workers", default=None, type=int)
parser.add_argument("--loader_backend", default=None, type=str,
                    choices=(None, "thread", "process"),
                    help="host loader worker backend (default: thread)")
parser.add_argument("--log_dir", default=None, type=str)
parser.add_argument("--checkpoint_dir", default=None, type=str)
parser.add_argument("--pretrained", type=str, default=None,
                    help="a Stage-1 run's checkpoint dir, for the Stage-1.5 / Stage-2 warm start")
parser.add_argument("--resume_checkpoint", type=str, default=None)
parser.add_argument("--checkpoint", type=str, default=None)
parser.add_argument("--train_lr", default=None, type=float)
parser.add_argument("--finetune_lr", default=None, type=float)
parser.add_argument("--use_scheduler", default=None, action="store_true")
parser.add_argument("--warmup_epochs", default=None, type=int)
parser.add_argument("--min_lr", default=None, type=float)
parser.add_argument("--momentum_for_optim", default=None, type=float)
parser.add_argument("--weight_decay_for_optim", default=None, type=float)
parser.add_argument("--experiment", default=None, type=str)
parser.add_argument("--epochs", type=int, default=None)
parser.add_argument("--set_deterministic", default=True, action="store_true")
parser.add_argument("--visualize", default=None, action="store_true")
parser.add_argument("--test", default=None, action="store_true")
parser.add_argument("--debug", default=None, action="store_true")
parser.add_argument("--module", type=str, default=None)
parser.add_argument("--arch", type=str, default=None)
parser.add_argument("--split_dir", type=str, default=None)
parser.add_argument("--voxel_cap", type=int, default=None)
parser.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default cuda; raises without a card)")


def epoch_loader(dataset, batch_size: int, voxel_cap: int, cfg, epoch: int, **kw):
    """Epoch `epoch`'s training loader: shuffled by `epoch` and, with per-scan
    seeds, each scan's augmentation drawn from (dataset seed, `epoch`, scan)."""
    from .data import make_loader

    return make_loader(dataset, batch_size, voxel_cap, backend=cfg.loader_backend,
                       num_workers=cfg.num_workers, seed=epoch, epoch=epoch, **kw)


def eval_loader(dataset, batch_size: int, voxel_cap: int, point_cap: int, cfg):
    from .data import make_loader

    return make_loader(dataset, batch_size, voxel_cap, backend=cfg.loader_backend,
                       point_cap=point_cap, shuffle=False, num_workers=cfg.num_workers,
                       drop_last=False)


def pretrain_epoch(module, train_ds, cfg, epoch: int, **loader_kw) -> float:
    """One Stage-1 epoch of the CLI's loop: the mean train loss."""
    caps = cfg.resolved_caps()
    return module.train_epoch(epoch_loader(train_ds, cfg.batch_size, caps[0], cfg, epoch,
                                           **loader_kw))


def _summary(result: dict) -> dict:
    return {k: v for k, v in result.items() if k not in ("iou", "conf")}


def _restore_for_test(cfg, mgr, state):
    """`--test`: the state of `--checkpoint`'s latest step, else this
    experiment's; a `--checkpoint` with none raises."""
    from .train.checkpoint import CheckpointManager

    src = CheckpointManager(cfg.checkpoint) if cfg.checkpoint else mgr
    restored = src.restore(state)
    if restored is None and cfg.checkpoint:
        raise FileNotFoundError(f"--checkpoint {cfg.checkpoint} has no restorable step")
    if restored is None:
        print("WARNING: --test without --checkpoint and no saved state; evaluating the fresh "
              "(untrained) model.")
    return state


def main(argv=None) -> dict:
    """Run the CLI on `argv` (sys.argv[1:] when None). Returns a record of
    the run: `recipe`, `module`, `start_epoch`, `history` (one dict an
    epoch) and `result` (a test's or sweep's output), for callers in the
    same process."""
    args = parser.parse_args(argv)
    from .train.common import resolve_device

    device = resolve_device(args.device)

    from .config import load_config
    from .data import ensure_split_file, get_dataset, load_split_indices
    from .models.minkunet import ARCHS, BLOCKS, DEFAULT_PLANES
    from .train.checkpoint import CheckpointManager, load_pretrained, save_pretrained
    from .train.registry import resolve_module, subdivide_novel
    from .utils.logging import MetricsLogger

    overrides = {k: v for k, v in vars(args).items() if v is not None and k != "device"}
    cfg = load_config(args.dataset_config, **overrides)
    if args.set_deterministic:
        np.random.seed(SEED)
    if cfg.arch == "Cylinder3D":
        raise NotImplementedError(f"--arch Cylinder3D is not ported yet ({_ITEM7})")
    if cfg.arch not in ARCHS:
        raise ValueError(f"--arch must be one of {sorted(ARCHS)} or Cylinder3D, got {cfg.arch!r}")
    recipe, mod_overrides = resolve_module(cfg.module)

    space = cfg.label_space()
    print(f"Unknown labels in split {cfg.split}:")
    for lab in space["unknown_labels"]:
        raw = space["meta"]["learning_map_inv"][lab]
        print(f"  {lab}: {space['meta']['labels'][raw]}")
    caps = cfg.resolved_caps()
    point_cap = cfg.point_cap or cfg.downsampling
    labels = dict(num_labeled_classes=space["num_labeled_classes"],
                  num_classes=space["num_classes"], unknown_label=space["unknown_label"])
    optim = dict(momentum=cfg.momentum_for_optim, weight_decay=cfg.weight_decay_for_optim,
                 use_scheduler=cfg.use_scheduler, warmup_epochs=cfg.warmup_epochs,
                 min_lr=cfg.min_lr, epochs=cfg.epochs)
    mapping, inv = space["label_mapping"], space["label_mapping_inv"]
    data_kw = dict(label_mapping=mapping, unknown_labels=space["unknown_labels"])
    # the queue holds backbone features: a bottleneck's are 4x wider
    feat_dim = DEFAULT_PLANES[7] * BLOCKS[ARCHS[cfg.arch][0]][1]

    logger = MetricsLogger(cfg.log_dir, cfg.experiment)
    ds_cls = get_dataset(cfg.dataset, "disjoint")
    probe = ds_cls(cfg.dataset_path, "train")
    split_idx = load_split_indices(
        ensure_split_file(cfg.split_dir, cfg.dataset, cfg.split, len(probe)))
    run_dir = os.path.join(cfg.checkpoint_dir, cfg.experiment)
    mgr = CheckpointManager(run_dir)
    # Stage 1 takes no warm start (as in `main.py`)
    pretrained = (load_pretrained(cfg.pretrained)
                  if cfg.pretrained and recipe != "pretrain" else None)
    record = {"recipe": recipe, "start_epoch": 0, "history": [], "result": None}

    def train_ds(labeled: bool, seed: int, **kw):
        ds = ds_cls(cfg.dataset_path, "train", split_indices=split_idx, labeled=labeled,
                    voxel_size=cfg.voxel_size, downsampling=cfg.downsampling, seed=seed,
                    **data_kw, **kw)
        if cfg.debug:
            ds.num_files = min(ds.num_files, 200 if recipe == "discover" else 50)
        return ds

    def val_ds():
        ds = ds_cls(cfg.dataset_path, "valid", voxel_size=cfg.voxel_size, **data_kw)
        if cfg.debug:
            ds.num_files = min(ds.num_files, 50)
        return ds

    try:
        if recipe == "pretrain":
            from .train.pretrain import ExpPretrain, PretrainConfig

            pcfg = PretrainConfig(**labels, voxel_caps=caps, arch=cfg.arch, lr=cfg.train_lr,
                                  steps_per_epoch=max(1, len(split_idx) // cfg.batch_size),
                                  **optim, **mod_overrides)
            module = record["module"] = ExpPretrain(pcfg, mapping, inv, seed=SEED,
                                                    device=device)
            val = val_ds()
            if cfg.test:
                _restore_for_test(cfg, mgr, module.state)
                result = record["result"] = module.validate(
                    eval_loader(val, cfg.batch_size, caps[0], point_cap, cfg))
                print(_summary(result))
                return record
            ds = train_ds(True, SEED, augment=True)
            module.state, start = resume_from_checkpoint(mgr, module.state,
                                                         cfg.resume_checkpoint)
            record["start_epoch"] = start
            for epoch in range(start, cfg.epochs):
                loss = pretrain_epoch(module, ds, cfg, epoch)
                vm = module.validate(eval_loader(val, cfg.batch_size, caps[0], point_cap, cfg))
                rec = {"train/loss": loss, "valid/mIoU": vm["mIoU"],
                       "valid/mIoU_old": vm["mIoU_old"], "valid/loss": vm["loss"]}
                logger.log_dict(rec, epoch)
                record["history"].append({"epoch": epoch, **rec})
                print(f"epoch {epoch}: loss={loss:.4f} mIoU={vm['mIoU']:.4f}")
                mgr.save(epoch, module.state)
            save_pretrained(run_dir, module.state.model.state_dict())

        elif recipe in ("finetune", "finetune_extra", "finetune_test", "uncertainty"):
            from .train.finetune import ExpFineTuning
            from .train.registry import finetune_config

            _, fcfg = finetune_config(
                cfg.module, voxel_caps=caps, batch_size=cfg.batch_size, dataset=cfg.dataset,
                **labels, arch=cfg.arch, lr=cfg.finetune_lr,
                steps_per_epoch=max(1, len(split_idx) // cfg.batch_size), **optim)
            module = record["module"] = ExpFineTuning(fcfg, pretrained, seed=SEED,
                                                      device=device)
            if recipe == "uncertainty":
                from .train.uncertainty import rank_uncertain_scans

                out_file = os.path.join(cfg.checkpoint_dir, f"uncertain_idx_{cfg.experiment}.npy")
                order, scores = rank_uncertain_scans(
                    module.state.model, train_ds(False, SEED, augment=False), fcfg, caps[0],
                    out_file)
                record["result"] = {"order": order, "scores": scores}
                print(f"ranked {len(order)} unlabeled scans -> {out_file}; most uncertain: "
                      f"{order[:10].tolist()}")
                return record
            if recipe == "finetune_test":
                from .eval.sweep import threshold_sweep_test

                _restore_for_test(cfg, mgr, module.state)
                known = [k for k, v in mapping.items() if v != space["unknown_label"]]
                unknown = [k for k, v in mapping.items() if v == space["unknown_label"]]
                res = record["result"] = threshold_sweep_test(
                    module.state.model, val_ds(), fcfg, inv, known, unknown,
                    subdivide=subdivide_novel(cfg.module), num_workers=cfg.num_workers,
                    point_cap=point_cap)
                for t, r in sorted(res.items()):
                    print(f"threshold {t}: mIoU={r['mIoU']:.4f} old={r['mIoU_old']:.4f} "
                          f"new={r['mIoU_new']:.4f}")
                    logger.log_dict({f"threshold{t}-valid/{k}": v for k, v in r.items()
                                     if k != "conf"}, 0)
                return record
            # the 'finetuning' dataset type: REAL-augmented labeled scans
            lab = train_ds(True, SEED, augment=True, resize_aug=True)
            unlab = train_ds(False, SEED + 1, augment=True) if module.extra else None
            module.state, start = resume_from_checkpoint(mgr, module.state,
                                                         cfg.resume_checkpoint)
            record["start_epoch"] = start
            for epoch in range(start, cfg.epochs):
                m = module.train_epoch(*module.make_loaders(
                    lab, unlab, batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                    epoch=epoch, backend=cfg.loader_backend))
                avg = m.get("loss", float("nan"))
                logger.log("train/loss", avg, epoch)
                record["history"].append({"epoch": epoch,
                                          **{f"train/{k}": v for k, v in m.items()}})
                print(f"epoch {epoch}: loss={avg:.4f}")
                mgr.save(epoch, module.state)
            save_pretrained(run_dir, module.state.model.state_dict())

        elif recipe == "discover":
            from .train.discover import DiscoverConfig, check_config
            from .train.modules import ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive

            discover_kw = resolve_discover_overrides(cfg.module, cfg.dataset)
            discover_kw.setdefault("feat_dim", feat_dim)
            nsc = cfg.batch_size // 2
            dcfg = DiscoverConfig(
                **labels, num_unlabeled_classes=space["num_unlabeled_classes"],
                voxel_caps=caps, sup_voxel_cap=caps[0] // 2, mix_voxel_caps=caps,
                num_sup_scans=nsc, point_cap=point_cap, voxel_size=cfg.voxel_size,
                arch=cfg.arch, lr=cfg.train_lr,
                steps_per_epoch=max(1, len(split_idx) // max(nsc, 1)), **optim, **discover_kw)
            check_config(dcfg)
            label_dict = {tid: space["meta"]["labels"][raw]
                          for tid, raw in space["meta"]["learning_map_inv"].items() if tid >= 0}
            module = record["module"] = ExpMergeDiscoverLaserMixMeanTeacherNCCAdaptive(
                dcfg, mapping, inv, pretrained, seed=SEED, device=device,
                label_dict=label_dict, logger=logger, checkpoint_manager=mgr)
            if cfg.resume_checkpoint:
                mgr.restore(module.state)
            val = val_ds()
            if cfg.test:
                _restore_for_test(cfg, mgr, module.state)
                result = record["result"] = module.test(
                    val, cfg.num_workers, visualize=bool(cfg.visualize),
                    save_dir=os.path.join(cfg.log_dir, cfg.experiment, "ply"))
                print(_summary(result))
                return record
            # PolarMix-MT mixes labeled scans dataset-side
            lab = train_ds(True, SEED, augment=True, resize_aug=True,
                           polarmix="PolarMix" in cfg.module)
            unlab = train_ds(False, SEED + 1, augment=True)
            history = record["history"] = module.fit(lab, unlab, val, epochs=cfg.epochs,
                                                     num_workers=cfg.num_workers)
            for rec in history[-3:]:
                print(rec)
        elif recipe in ("nops", "nops_swav"):
            from .train.nops import ExpNops
            from .train.registry import nops_config

            nsc = max(cfg.batch_size // 2, 1)
            _, ncfg = nops_config(
                cfg.module, voxel_caps=caps, batch_size=cfg.batch_size, **labels,
                num_unlabeled_classes=space["num_unlabeled_classes"], arch=cfg.arch,
                feat_dim=feat_dim, lr=cfg.train_lr,
                steps_per_epoch=max(1, len(split_idx) // nsc), **optim)
            swav = recipe == "nops_swav"
            module = record["module"] = ExpNops(ncfg, pretrained, seed=SEED, device=device,
                                                swav=swav)
            # 'finetuning'-type labeled scans (REAL aug; not for SwaV) and the
            # unlabeled complement
            lab = train_ds(True, SEED, augment=True, resize_aug=not swav)
            unlab = train_ds(False, SEED + 1, augment=True)
            module.state, start = resume_from_checkpoint(mgr, module.state,
                                                         cfg.resume_checkpoint)
            record["start_epoch"] = start
            for epoch in range(start, cfg.epochs):
                m = module.train_epoch(*module.make_loaders(
                    lab, unlab, num_workers=cfg.num_workers, epoch=epoch,
                    backend=cfg.loader_backend))
                avg = m.get("loss", float("nan"))
                logger.log("train/loss", avg, epoch)
                record["history"].append({"epoch": epoch,
                                          **{f"train/{k}": v for k, v in m.items()}})
                print(f"epoch {epoch}: loss={avg:.4f}")
                mgr.save(epoch, module.state)
            save_pretrained(run_dir, module.state.model.state_dict())
        else:
            raise NameError(f"Unknown module {cfg.module}")
    finally:
        logger.close()
    return record


if __name__ == "__main__":
    main()
