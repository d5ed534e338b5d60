"""The port's CLI (`gcdlss_tpu_torch.main`) and its host layer against the JAX
package's `main.py`, on the CPU (`--device cpu`).

A `write_synthetic_kitti` fixture (900 points a scan, 0.15 m voxels, cap
2048, MinkUNet14: the verify skill's sizes; 4 train scans, 2 of them
labeled in split 1, and 2 valid scans). Checked: config resolution against
`main.py` and `gcdlss_tpu.config` for every file, dataset x split and
registry name; the flat-YAML reader against `yaml.safe_load`; checkpoint
round trips; a resumed Stage-1 run against an unbroken one, bit for bit; the
Stage-1 -> 1.5 / 2 handoff and `--test` through the CLI; the single-model
discovery recipes (a resumed SwaV run bit-equal to an unbroken one),
ExpClusterFineTuning and ExpMixExtraTest's subdivided sweep through the
CLI; Stage 2 on `--arch Cylinder3D` and its `--test`, and its refusal of a
Stage-1 module; and one Stage-1 epoch of the CLI's
loop against the JAX loop from the same weights and batches (one compiled
JAX step), within 1e-5 relative.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import main as jax_cli
from gcdlss_tpu import config as jconfig
from gcdlss_tpu.data import PrefetchLoader as JaxLoader
from gcdlss_tpu.data import SemanticKITTIDataset as JaxKITTI
from gcdlss_tpu.train import pretrain as jpt
from gcdlss_tpu.train.registry import MODULE_REGISTRY as JAX_REGISTRY
from gcdlss_tpu_torch import config as tconfig
from gcdlss_tpu_torch import main as cli
from gcdlss_tpu_torch.data import SemanticKITTIDataset, write_synthetic_kitti
from gcdlss_tpu_torch.train import checkpoint as tck
from gcdlss_tpu_torch.train import discover as td
from gcdlss_tpu_torch.train import pretrain as tpt
from gcdlss_tpu_torch.train.registry import MODULE_REGISTRY
from gcdlss_tpu_torch.utils.weights import load_jax_params, warm_start

ROOT = Path(__file__).resolve().parent.parent
JAX_CONFIGS = sorted((ROOT / "gcdlss_tpu" / "configs").glob("*.yaml"))
NARROW = (8,) * 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one CPU thread while this module's tests run
    (the suite runs several workers at once; each worker's default pool
    would oversubscribe the cores). Restored when the module's tests end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    write_synthetic_kitti(str(root / "kitti"), sequences=("00", "01"), scans_per_seq=2,
                          num_points=900, seed=3)
    return root


def _argv(root: Path, experiment: str, *extra) -> list:
    return ["--dataset", "SemanticKITTI", "-s", "1", "--dataset_path", str(root / "kitti"),
            "--voxel_size", "0.15", "--downsampling", "800", "--voxel_cap", "2048",
            "--arch", "MinkUNet14", "--batch_size", "2", "--num_workers", "1",
            "--checkpoint_dir", str(root / "ck"), "--log_dir", str(root / "logs"),
            "--split_dir", str(root / "split"), "--experiment", experiment,
            "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def stage1(tree):
    """An unbroken 2-epoch Stage-1 run; its `pretrained` is the handoff."""
    return cli.main(_argv(tree, "s1", "--module", "ExpPretrain", "--epochs", "2"))


# ------------------------------------------------------------ configuration


def test_port_yaml_is_a_copy_read_alike():
    """The port's copy of each file holds the same values as the JAX
    package's, and `load_config` gives the same ExperimentConfig from it.
    The four files are one item (the suite's count of items is held, see
    ROADMAP "Test budget"); a failure names every file that differs, and how."""
    assert len(JAX_CONFIGS) == 4
    wrong = []
    for path in JAX_CONFIGS:
        mine = tconfig.CONFIG_DIR / path.name
        flat = tconfig.read_flat_yaml(mine)
        if flat != yaml.safe_load(path.read_text()):
            wrong.append(f"{path.name}: values differ from the JAX package's")
        if flat != yaml.safe_load(mine.read_text()):
            wrong.append(f"{path.name}: read unlike yaml")
        got = dataclasses.asdict(tconfig.load_config(str(mine), experiment="x"))
        want = dataclasses.asdict(jconfig.load_config(str(path), experiment="x"))
        if got != want:
            wrong.append(f"{path.name}: ExperimentConfig differs")
    assert wrong == []


def test_port_configs_are_the_four_files():
    assert sorted(p.name for p in tconfig.CONFIG_DIR.glob("*.yaml")) == \
        [p.name for p in JAX_CONFIGS]
    assert [f.name for f in dataclasses.fields(tconfig.ExperimentConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.ExperimentConfig)]


def test_flat_yaml_reader_refuses_what_it_cannot_read(tmp_path):
    lines = {"nested": "a: 1\nb:\n  c: 2\n", "list": "a:\n- 1\n", "flow": "a: [1, 2]\n",
             "no_key": "just text\n", "octal": "a: 012\n", "anchor": "a: &x 1\n"}
    for name, text in lines.items():
        p = tmp_path / f"{name}.yaml"
        p.write_text(text)
        with pytest.raises(ValueError):
            tconfig.read_flat_yaml(p)
    p = tmp_path / "scalars.yaml"
    p.write_text("# c\na: 1  # x\nb: 1.5\nc: 0.00001\nd: 1e-5\ne: true\nf: Off\ng: ~\nh:\n"
                 "i: 'q #'\nj: \"w\"\nk: -3\nl: .5\nm: abc def\nn: -.inf\n")
    assert tconfig.read_flat_yaml(p) == yaml.safe_load(p.read_text())


@pytest.mark.parametrize("dataset,splits", [("SemanticKITTI", (0, 1, 2, 3)),
                                            ("nuScenes", (0, 1, 2, 3)),
                                            ("SemanticPOSS", (0,))])
def test_label_space_and_caps_match_jax(dataset, splits):
    for split in splits:
        for kw in (dict(), dict(downsampling=0, batch_size=3), dict(voxel_cap=138240),
                   dict(downsampling=80000, batch_size=2)):
            t = tconfig.ExperimentConfig(dataset=dataset, split=split, **kw)
            j = jconfig.ExperimentConfig(dataset=dataset, split=split, **kw)
            assert t.resolved_caps() == j.resolved_caps()
        got, want = t.label_space(), j.label_space()
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == v, (dataset, split, k)


@pytest.mark.parametrize("dataset", ["SemanticKITTI", "nuScenes"])
def test_discover_overrides_match_main_py(dataset):
    assert MODULE_REGISTRY == JAX_REGISTRY
    for name, (stage, _) in MODULE_REGISTRY.items():
        if stage != "discover":
            for fn in (cli.resolve_discover_overrides, jax_cli.resolve_discover_overrides):
                with pytest.raises(NameError):
                    fn(name, dataset)
            continue
        assert cli.resolve_discover_overrides(name, dataset) == \
            jax_cli.resolve_discover_overrides(name, dataset), name
    # a name the registry lacks, by substring, as main.py dispatches it
    assert cli.resolve_discover_overrides("MyMergeVariant", dataset) == \
        jax_cli.resolve_discover_overrides("MyMergeVariant", dataset)


def test_parser_has_main_py_arguments():
    theirs = {a.dest for a in jax_cli.parser._actions}
    mine = {a.dest for a in cli.parser._actions}
    assert mine == theirs | {"device"}
    assert cli.parser.parse_args([]).device == "cuda"


# --------------------------------------------------------------- checkpoints


def _small_discover_state(seed: int):
    cfg = td.DiscoverConfig(num_labeled_classes=17, num_unlabeled_classes=2, num_classes=19,
                            unknown_label=17, voxel_caps=(512,) * 5, sup_voxel_cap=256,
                            mix_voxel_caps=(512,) * 5, num_sup_scans=1, point_cap=100,
                            arch="MinkUNet14", planes=NARROW, queue_slots=2,
                            queue_per_slot=16, feat_dim=8)
    state = td.create_discover_state(seed, cfg, device="cpu")
    # momentum buffers, a moved tau, a used queue and generator
    loss = sum(p.square().sum() for p in state.student.parameters()) + state.tau * 3
    loss.backward()
    state.optimizer.step()
    state.queue = state.queue._replace(feats=torch.randn(state.queue.feats.shape),
                                       counts=torch.tensor([16, 3], dtype=torch.int32),
                                       head=torch.tensor(1, dtype=torch.int32))
    torch.rand(5, generator=state.generator)
    state.step = 7 + seed
    return state


def _state_tensors(state) -> dict:
    tree = tck.state_to_dict(state)
    out = {}

    def walk(prefix, v):
        if isinstance(v, torch.Tensor):
            out[prefix] = v
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}/{k}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}/{i}", x)
        else:
            out[prefix] = v
    walk("", tree)
    return out


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    """A Stage-2 state (student, teacher, BN buffers, momentum, tau, queue,
    step, generator) saved and restored into another state: every tensor
    and number bit-equal, and the next draws equal."""
    saved, other = _small_discover_state(0), _small_discover_state(1)
    mgr = tck.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step in (3, 5, 9):
        assert mgr.save(step, saved)
    assert mgr.all_steps() == [5, 9] and mgr.latest_step() == 9
    raw = torch.load(tmp_path / "ck" / "9" / "state.pt", weights_only=True)
    assert set(raw) == {"student", "teacher", "tau", "optimizer", "queue", "generator", "step"}
    before = _state_tensors(saved)
    assert mgr.restore(other) is other
    after = _state_tensors(other)
    assert set(before) == set(after)
    for k, v in before.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == after[k].dtype and torch.equal(v, after[k]), k
        else:
            assert v == after[k], k
    assert other.step == saved.step
    assert torch.equal(torch.rand(4, generator=saved.generator),
                       torch.rand(4, generator=other.generator))
    assert tck.CheckpointManager(str(tmp_path / "empty")).restore(other) is None


def test_checkpoint_interval_and_field_check(tmp_path):
    state = tpt.create_pretrain_state(0, tpt.PretrainConfig(
        num_labeled_classes=17, num_classes=19, unknown_label=17, voxel_caps=(512,) * 5,
        arch="MinkUNet14", planes=NARROW), device="cpu")
    mgr = tck.CheckpointManager(str(tmp_path), save_interval_steps=2)
    assert not mgr.save(1, state) and mgr.save(2, state)
    with pytest.raises(KeyError):
        mgr.restore(_small_discover_state(0))


def test_pretrained_handoff_round_trip(tmp_path):
    """`save_pretrained` writes the Stage-1 model's state dict; `load_pretrained`
    reads it back bit for bit, and `warm_start` takes its parameters."""
    cfg = tpt.PretrainConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                             voxel_caps=(512,) * 5, arch="MinkUNet14", planes=NARROW)
    model = tpt.make_model(cfg, torch.Generator().manual_seed(4))
    tck.save_pretrained(str(tmp_path), model.state_dict())
    tck.save_pretrained(str(tmp_path), model.state_dict())  # a repeated save replaces
    sd = tck.load_pretrained(str(tmp_path))
    assert set(sd) == set(model.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    rc = _small_discover_state(0).student
    left = warm_start(rc, sd)
    assert torch.equal(rc.encoder.block1[0].conv1.kernel, model.encoder.block1[0].conv1.kernel)
    assert "encoder.final2.kernel" in left and "encoder.final3.kernel" in left


# --------------------------------------------------- logging, misc, visualize


def test_metrics_logger_timer_and_trace(tmp_path):
    from gcdlss_tpu_torch.utils.logging import MetricsLogger, profile_trace

    log = MetricsLogger(str(tmp_path), "run")
    log.log("a", torch.tensor(2.5), 0, on_epoch=True)
    log.log_dict({"b": np.float32(1.0), "a": 3.5}, 1, prefix="p/", on_epoch=True)
    log.log("a", 4.5, 2, on_epoch=True)
    log.epoch_end(0)
    log.close()
    import json

    rows = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert rows[0] == {"tag": "a", "value": 2.5, "step": 0}
    assert {"tag": "a_epoch", "value": 3.5, "step": 0} in rows
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_misc_and_visualize_match_jax(tmp_path):
    import jax.numpy as jnp

    from gcdlss_tpu.utils import misc as jmisc
    from gcdlss_tpu.utils import visualize as jvis
    from gcdlss_tpu_torch.utils import misc as tmisc
    from gcdlss_tpu_torch.utils import visualize as tvis

    rng = np.random.default_rng(6)
    y_true, y_pred = rng.integers(0, 5, 400), rng.integers(0, 5, 400)
    assert tmisc.cluster_acc(y_true, y_pred) == jmisc.cluster_acc(y_true, y_pred)
    probs = rng.dirichlet(np.ones(7), 50).astype(np.float32)
    np.testing.assert_allclose(float(tmisc.entropy(probs)),
                               float(jmisc.entropy(jnp.asarray(probs))), rtol=1e-6)
    logits = rng.standard_normal((60, 7)).astype(np.float32)
    labels = rng.integers(-1, 7, 60).astype(np.int32)
    weight = rng.uniform(0.5, 2, 7).astype(np.float32)
    for w in (None, weight):
        ref = jmisc.margin_loss(jnp.asarray(logits), jnp.asarray(labels), 3.0,
                                None if w is None else jnp.asarray(w))
        got = tmisc.margin_loss(torch.as_tensor(logits), torch.as_tensor(labels), 3.0,
                                None if w is None else torch.as_tensor(w))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    meter = tmisc.AverageMeter()
    meter.update(2.0, 3)
    meter.update(4.0)
    assert meter.avg == 2.5 and meter.count == 4
    assert tmisc.TransformTwice(lambda v: v + 1)(1) == (2, 2)
    lab = rng.integers(-1, 19, 100)
    np.testing.assert_array_equal(tvis.get_color(lab), jvis.get_color(lab))
    xyz = rng.standard_normal((100, 3)).astype(np.float32)
    fields = ["x", "y", "z", "red", "green", "blue"]
    tvis.write_ply(str(tmp_path / "t.ply"), [xyz, tvis.get_color(lab)], fields)
    jvis.write_ply(str(tmp_path / "j.ply"), [xyz, jvis.get_color(lab)], fields)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back = tvis.read_ply(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(back["x"], xyz[:, 0])


# ---------------------------------------------------------------- the CLI


def test_resumed_run_equals_unbroken_one(tree, stage1):
    """1 epoch, then a second `main` call that builds its module anew and
    resumes from the saved epoch for 1 more: the losses, validation and every
    parameter, statistic and momentum buffer equal the unbroken 2-epoch
    run's, bit for bit."""
    first = cli.main(_argv(tree, "s1b", "--module", "ExpPretrain", "--epochs", "1"))
    resumed = cli.main(_argv(tree, "s1b", "--module", "ExpPretrain", "--epochs", "2",
                             "--resume_checkpoint", "1"))
    assert resumed["start_epoch"] == 1 and [h["epoch"] for h in resumed["history"]] == [1]
    assert first["history"][0] == stage1["history"][0]
    assert resumed["history"][0] == stage1["history"][1]
    want, got = stage1["module"].state, resumed["module"].state
    assert want.step == got.step == 2
    for (k, a), (k2, b) in zip(want.model.state_dict().items(), got.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    for a, b in zip(want.optimizer.state.values(), got.optimizer.state.values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])
    # each epoch's checkpoint, keyed by the epoch, and the handoff
    assert tck.CheckpointManager(str(tree / "ck" / "s1b")).all_steps() == [0, 1]
    assert (tree / "ck" / "s1b" / "pretrained" / "state_dict.pt").is_file()
    assert (tree / "logs" / "s1b" / "metrics.jsonl").read_text().count('"train/loss"') == 2


def test_stage1_test_mode_reads_a_checkpoint(tree, stage1):
    run = cli.main(_argv(tree, "s1t", "--module", "ExpPretrain", "--test", "--checkpoint",
                         str(tree / "ck" / "s1")))
    assert run["result"]["mIoU"] == stage1["history"][-1]["valid/mIoU"]
    with pytest.raises(FileNotFoundError):
        cli.main(_argv(tree, "s1t", "--module", "ExpPretrain", "--test", "--checkpoint",
                       str(tree / "nothing")))


def test_handoff_stage15_stage2_and_test(tree, stage1):
    """Stage 1.5 and Stage 2 warm-started from Stage 1's `pretrained`, the
    uncertainty ranking and the threshold sweep on the Stage-1.5 state, and
    `--test` on Stage 2's saved state, all through `main`."""
    s1 = str(tree / "ck" / "s1")
    s15 = cli.main(_argv(tree, "s15", "--module", "ExpMixExtraFineTuning", "--pretrained", s1,
                         "--epochs", "1"))
    sd = stage1["module"].state.model.state_dict()
    assert s15["module"].cfg.sup_voxel_cap == 1024 and len(s15["module"].step_log) == 2
    assert all(np.isfinite(v) for st in s15["module"].step_log for v in st.values())
    assert (tree / "ck" / "s15" / "0" / "state.pt").is_file()
    # the warm start took Stage 1's weights (before its own step moved them)
    assert s15["module"].state.model.encoder.conv0p1s1.kernel.shape == \
        sd["encoder.conv0p1s1.kernel"].shape

    rank = cli.main(_argv(tree, "s15", "--module", "ExpUncertaintyCheck", "--pretrained", s1))
    assert sorted(rank["result"]["order"].tolist()) == [0, 1]
    sweep = cli.main(_argv(tree, "s15", "--module", "ExpRCTest", "--checkpoint",
                           str(tree / "ck" / "s15")))
    assert sweep["result"] and all(r["conf"].sum() > 0 for r in sweep["result"].values())

    s2_args = ("--module", "ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive",
               "--batch_size", "4", "--voxel_cap", "4096")
    s2 = cli.main(_argv(tree, "s2", *s2_args, "--pretrained", s1, "--epochs", "1"))
    steps = s2["module"].step_log
    assert len(steps) == 1 and all(np.isfinite(steps[0][k]) for k in ("loss", "tau"))
    assert s2["module"].cfg.feat_dim == 96 and s2["module"].cfg.num_sup_scans == 2
    saved = tck.CheckpointManager(str(tree / "ck" / "s2")).all_steps()
    assert saved == [1]  # keyed by the step, as main.py's Stage 2
    tested = cli.main(_argv(tree, "s2", *s2_args, "--test", "--checkpoint",
                            str(tree / "ck" / "s2")))
    assert tested["result"]["mIoU"] == s2["history"][-1]["valid/mIoU"]


STAGE2_RECIPES = ("ExpMergeDiscover_LaserMix_MeanTeacher",
                  "ExpMergeDiscover_LaserMix_MeanTeacher_HybridAdaptive",
                  "ExpMergeDiscover_LaserMix_MeanTeacher_Oracle_threshold",
                  "ExpMergeDiscover_LaserMix_MeanTeacher_MSP_threshold",
                  "ExpMergeDiscover_PolarMix_MeanTeacher", "ExpMixRealMeanTeacherDiscover",
                  "ExpMergeDiscover_LaserMix_LiON_MeanTeacher")


def test_stage2_recipes_train_through_the_cli(tree, stage1):
    """Each Stage-2 recipe the registry adds to the default one trains an
    epoch through `main`, warm-started from Stage 1's handoff: its config
    is the recipe's, every logged metric is finite, and the epoch's
    checkpoint is written."""
    for name in STAGE2_RECIPES:
        exp = f"s2-{name}"
        run = cli.main(_argv(tree, exp, "--module", name, "--batch_size", "4", "--voxel_cap",
                             "4096", "--pretrained", str(tree / "ck" / "s1"), "--epochs", "1"))
        module = run["module"]
        for k, v in cli.resolve_discover_overrides(name, "SemanticKITTI").items():
            assert getattr(module.cfg, k) == v, (name, k)
        assert len(module.step_log) == 1, name
        bad = [k for k, v in module.step_log[0].items() if not np.isfinite(v)]
        assert not bad and np.isfinite(run["history"][-1]["valid/mIoU"]), (name, bad)
        assert tck.CheckpointManager(str(tree / "ck" / exp)).all_steps() == [1], name


@pytest.mark.parametrize("extra", [
    ("--module", "ExpDiscover"),
    ("--module", "ExpPretrain", "--arch", "Cylinder3D"),
    ("--module", "ExpClusterFineTuning", "--batch_size", "4"),
    ("--module", "ExpMixExtraTest"),
], ids=["nops", "cylinder3d", "cluster", "subdivide"])
def test_unported_recipes_raise_naming_roadmap(tree, stage1, extra):
    """The recipes this CLI once refused, each naming its ROADMAP item, now
    run on the CPU. `--arch Cylinder3D` trains a Stage-2 epoch of the
    default recipe on `Cylinder3DRC` (finite metrics, the epoch's
    checkpoint written), and `--test` on that state gives the epoch's
    validation mIoU; with a Stage-1 module it raises a ValueError that
    names the Stage-2 discovery recipes. From Stage 1's handoff,
    ExpDiscover and ExpClusterFineTuning train an epoch (finite metrics,
    the epoch's checkpoint and the handoff written) and ExpMixExtraTest
    runs its subdivided sweep (every threshold scored)."""
    if "Cylinder3D" in extra:
        with pytest.raises(ValueError, match=r"only the Stage-2 discovery recipes"):
            cli.main(_argv(tree, "refused", *extra))
        s2 = ("--module", "ExpMergeDiscover_LaserMix_MeanTeacher_NCCAdaptive", "--arch",
              "Cylinder3D", "--batch_size", "4", "--voxel_cap", "4096")
        run = cli.main(_argv(tree, "s2-cyl", *s2, "--epochs", "1"))
        module = run["module"]
        assert module.cfg.arch == "Cylinder3D" and module.cfg.feat_dim == 128
        assert type(module.state.student).__name__ == "Cylinder3DRC"
        assert len(module.step_log) == 1
        assert all(np.isfinite(v) for v in module.step_log[0].values())
        assert tck.CheckpointManager(str(tree / "ck" / "s2-cyl")).all_steps() == [1]
        tested = cli.main(_argv(tree, "s2-cyl", *s2, "--test", "--checkpoint",
                                str(tree / "ck" / "s2-cyl")))
        assert tested["result"]["mIoU"] == run["history"][-1]["valid/mIoU"]
        return
    exp = f"ran-{extra[1]}"
    run = cli.main(_argv(tree, exp, *extra, "--epochs", "1", "--pretrained",
                         str(tree / "ck" / "s1")))
    if extra[1] == "ExpMixExtraTest":
        assert run["recipe"] == "finetune_test" and len(run["result"]) == 7
        assert all(r["conf"].sum() > 0 and np.isfinite(r["mIoU"]) for r in run["result"].values())
        return
    steps = run["module"].step_log
    assert steps and all(np.isfinite(v) for st in steps for v in st.values())
    assert [h["epoch"] for h in run["history"]] == [0]
    saved = sorted(p.name for p in (tree / "ck" / exp).iterdir())
    assert saved == ["0", "pretrained"]


def test_nops_recipes_train_and_resume_through_the_cli(tree, stage1):
    """ExpMixDiscoverJoint and ExpMixDiscover train an epoch through `main`
    from Stage 1's handoff with their registry configs and the backbone's
    queue width; ExpMixDiscoverSwaV trains 2 epochs, and 1 epoch resumed
    into a second from its checkpoint ends bit-equal to them (model,
    batch-norm statistics, momentum, queue, generator, step)."""
    s1 = str(tree / "ck" / "s1")
    for name in ("ExpMixDiscoverJoint", "ExpMixDiscover"):
        run = cli.main(_argv(tree, f"nops-{name}", "--module", name, "--pretrained", s1,
                             "--epochs", "1"))
        module = run["module"]
        for k, v in MODULE_REGISTRY[name][1].items():
            assert getattr(module.cfg, k) == v, (name, k)
        assert module.cfg.feat_dim == module.state.queue.feats.shape[-1] == 96
        assert all(np.isfinite(v) for st in module.step_log for v in st.values()), name
    unbroken = cli.main(_argv(tree, "swav-a", "--module", "ExpMixDiscoverSwaV", "--pretrained",
                              s1, "--epochs", "2"))
    cli.main(_argv(tree, "swav-b", "--module", "ExpMixDiscoverSwaV", "--pretrained", s1,
                   "--epochs", "1"))
    resumed = cli.main(_argv(tree, "swav-b", "--module", "ExpMixDiscoverSwaV", "--pretrained",
                             s1, "--epochs", "2", "--resume_checkpoint", "1"))
    assert resumed["start_epoch"] == 1 and [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["history"][0] == unbroken["history"][1]
    a, b = _state_tensors(unbroken["module"].state), _state_tensors(resumed["module"].state)
    assert set(a) == set(b)
    for k, v in a.items():
        assert (torch.equal(v, b[k]) if isinstance(v, torch.Tensor) else v == b[k]), k


def test_cli_epoch_matches_jax_loop(tree):
    """One Stage-1 epoch of the CLI's loop (`pretrain_epoch`, the module and
    config the CLI builds) from the JAX `ExpPretrain`'s initial weights,
    with the JAX loader's draws (`per_scan_seed=False`, one worker): its
    loss equals the JAX loop's (`main.py:246-249`) within 1e-5 relative.
    Batch size 1, so the epoch's second step sees the first one's update."""
    argv = _argv(tree, "parity", "--module", "ExpPretrain", "--epochs", "0", "--batch_size", "1")
    run = cli.main(argv)
    cfg = tconfig.load_config(None, **{k: v for k, v in vars(cli.parser.parse_args(argv)).items()
                                       if v is not None and k != "device"})
    space, caps = cfg.label_space(), cfg.resolved_caps()
    split_idx = np.load(next((tree / "split").glob("*.npy")))
    pcfg = run["module"].cfg
    jcfg = jpt.PretrainConfig(**{f.name: getattr(pcfg, f.name)
                                 for f in dataclasses.fields(jpt.PretrainConfig)
                                 if hasattr(pcfg, f.name)})
    assert jcfg.steps_per_epoch == len(split_idx) == 2 and jcfg.voxel_caps == caps
    jmod = jpt.ExpPretrain(jcfg, space["label_mapping"], space["label_mapping_inv"])
    load_jax_params(run["module"].state.model,
                    *jax.tree_util.tree_map(np.asarray, (jmod.state.params,
                                                         jmod.state.batch_stats)))
    kw = dict(split_indices=split_idx, labeled=True, voxel_size=cfg.voxel_size,
              downsampling=cfg.downsampling, augment=True, label_mapping=space["label_mapping"],
              unknown_labels=space["unknown_labels"], seed=cli.SEED)
    jloss = jmod.train_epoch(JaxLoader(JaxKITTI(cfg.dataset_path, "train", **kw), 1, caps[0],
                                       num_workers=1, seed=0))
    tloss = cli.pretrain_epoch(run["module"], SemanticKITTIDataset(cfg.dataset_path, "train",
                                                                   **kw),
                               cfg, 0, per_scan_seed=False)
    assert len(run["module"].step_log) == 2
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
