"""The port's data package (`gcdlss_tpu_torch.data`, numpy) against the JAX
package's (`gcdlss_tpu.data`) on the same synthetic SemanticKITTI tree.

Everything here is integer bookkeeping or the same float32 numpy arithmetic on
both sides, so every comparison is exact (bit for bit)."""

import dataclasses

import numpy as np
import pytest

import bench
import gcdlss_tpu.data as jd
import gcdlss_tpu_torch.data as td
from gcdlss_tpu.data import nuscenes as jnusc
from gcdlss_tpu.utils import import_torch as jw
from gcdlss_tpu_torch.data import native_voxelizer, nuscenes as tnusc
from gcdlss_tpu_torch.data.loader import scan_rng
from gcdlss_tpu_torch.data.quantize_np import sparse_quantize_np
from gcdlss_tpu_torch.utils import weights as tw

VOXEL = 0.1
CAP = 2048


@pytest.fixture(autouse=True)
def jax_side_quantizes_with_numpy(monkeypatch):
    """Both sides on the numpy quantizer. The JAX package switches to its
    C++ voxelizer wherever that library loads; it scales by a float32
    reciprocal where numpy divides, so a point on a voxel face can land one
    voxel over. The port's default is numpy; its C++ path is compared with
    the JAX package's C++ path in `test_quantize_numpy_and_native`."""
    monkeypatch.setattr(jd.quantize_np, "_native", False)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    jd.write_synthetic_kitti(str(root), sequences=("00", "08"), scans_per_seq=6,
                             num_points=1500, seed=3)
    return str(root)


def label_space(pkg):
    unknown, _ = pkg.split_table("SemanticKITTI", 1)
    mapping, _, _ = pkg.build_label_mapping(
        unknown, pkg.dataset_meta("SemanticKITTI")["learning_map_inv"].keys())
    return unknown, mapping


def make_ds(pkg, tree, **kw):
    unknown, mapping = label_space(pkg)
    kw = {"voxel_size": VOXEL, "downsampling": 1200, "label_mapping": mapping,
          "unknown_labels": unknown, **kw}
    return pkg.SemanticKITTIDataset(tree, kw.pop("split", "train"), **kw)


def assert_tree_equal(a, b):
    """NamedTuples / dicts / dataclasses of numpy arrays, bit for bit."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if hasattr(a, "_asdict"):
        a, b = a._asdict(), b._asdict()
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_package_exports_the_same_names():
    names = ("dataset_meta learning_map_lut build_label_mapping balanced_unknown_labels "
             "split_table SemanticKITTIDataset get_dataset collate_batch collate_voxels "
             "collate_points VoxelBatchNp PointBatchNp MultiprocessLoader PrefetchLoader cycle "
             "make_loader ensure_split_file generate_split_indices load_split_indices "
             "write_synthetic_kitti synthetic_scan write_learnable_kitti "
             "synthetic_scan_learnable").split()
    for name in names:
        assert hasattr(jd, name) and hasattr(td, name), name
        assert getattr(td, name).__module__.startswith("gcdlss_tpu_torch.data"), name


@pytest.mark.parametrize("dataset", ["SemanticKITTI", "SemanticPOSS", "nuScenes"])
def test_meta_and_label_mapping_equal(dataset):
    jm, tm = jd.dataset_meta(dataset), td.dataset_meta(dataset)
    assert jm.keys() == tm.keys()
    for k in jm:
        assert jm[k] == tm[k], k
    np.testing.assert_array_equal(jd.learning_map_lut(jm["learning_map"]),
                                  td.learning_map_lut(tm["learning_map"]))
    from gcdlss_tpu.data.labels import _SPLIT_TABLES

    for split in _SPLIT_TABLES[dataset]:
        assert jd.split_table(dataset, split) == td.split_table(dataset, split)
        unknown, _ = jd.split_table(dataset, split)
        keys = jm["learning_map_inv"].keys()
        assert jd.build_label_mapping(unknown, keys) == td.build_label_mapping(unknown, keys)


def test_split_tables_and_files_equal(tree, tmp_path):
    ja, ta = make_ds(jd, tree), make_ds(td, tree)
    assert ja.scan_files == ta.scan_files and ja.label_files == ta.label_files
    np.testing.assert_array_equal(jd.generate_split_indices(len(ja), 0.5, 7),
                                  td.generate_split_indices(len(ta), 0.5, 7))
    pj = jd.ensure_split_file(str(tmp_path / "j"), "SemanticKITTI", 1, len(ja))
    pt = td.ensure_split_file(str(tmp_path / "t"), "SemanticKITTI", 1, len(ta))
    np.testing.assert_array_equal(jd.load_split_indices(pj), td.load_split_indices(pt))


@pytest.mark.parametrize("kw", [
    dict(augment=False, split="valid"),
    dict(augment=True, seed=5),
    dict(augment=True, seed=5, resize_aug=True),
    dict(augment=True, seed=6, labeled=False, split_indices=np.arange(3)),
    dict(augment=True, seed=7, polarmix=True),
], ids=["no-aug", "aug", "resize", "unlabeled-side", "polarmix"])
def test_dataset_items_bit_equal(tree, kw):
    """`dataset[i]`: coords, features, labels, inverse maps, in sequence from
    the one shared generator (the JAX package's mode)."""
    ja, ta = make_ds(jd, tree, **kw), make_ds(td, tree, **kw)
    assert len(ja) == len(ta) > 0
    for i in (0, 2, 1, 0):
        assert_tree_equal(ja[i], ta[i])


def test_collate_batch_equal(tree):
    ja, ta = make_ds(jd, tree, augment=True, seed=1), make_ds(td, tree, augment=True, seed=1)
    for point_cap in (None, 1500):
        assert_tree_equal(jd.collate_batch([ja[0], ja[1]], CAP, point_cap),
                          td.collate_batch([ta[0], ta[1]], CAP, point_cap))


def test_prefetch_loader_one_worker_equal(tree):
    """One epoch, one worker, same seeds, the shared generator: the JAX
    package's batches, twice over (the second pass continues both generators)."""
    ja = make_ds(jd, tree, augment=True, seed=2, resize_aug=True)
    ta = make_ds(td, tree, augment=True, seed=2, resize_aug=True)
    jl = jd.PrefetchLoader(ja, 2, CAP, point_cap=1500, num_workers=1, seed=4)
    tl = td.PrefetchLoader(ta, 2, CAP, point_cap=1500, num_workers=1, seed=4,
                           per_scan_seed=False)
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            assert_tree_equal(a, b)


def epochs(tree, workers, cls=None, n_epochs=2, **kw):
    ds = make_ds(td, tree, augment=True, seed=9, resize_aug=True)
    loader = (cls or td.PrefetchLoader)(ds, 2, CAP, point_cap=1500, num_workers=workers,
                                        seed=4, per_scan_seed=True, **kw)
    return [list(loader) for _ in range(n_epochs)]


@pytest.mark.parametrize("workers", [1, 4])
def test_per_scan_seed_repeats(tree, workers):
    """Per-scan seeding: two runs give the same batches, with 1 worker and
    with 4; a scan's draw is that of `scan_rng(seed, epoch, index)`; the two
    epochs differ."""
    first, second = epochs(tree, workers), epochs(tree, workers)
    for ea, eb in zip(first, second):
        assert len(ea) == len(eb) == 3
        for a, b in zip(ea, eb):
            assert_tree_equal(a, b)
    ref = epochs(tree, 1)
    for ea, eb in zip(first, ref):
        for a, b in zip(ea, eb):
            assert_tree_equal(a, b)
    assert not np.array_equal(first[0][0]["voxel"].coords, first[1][0]["voxel"].coords)
    ds = make_ds(td, tree, augment=True, seed=9, resize_aug=True)
    order = np.arange(len(ds))
    np.random.default_rng(4).shuffle(order)
    want = td.collate_batch([ds.get(i, scan_rng(9, 0, i)) for i in order[:2]], CAP, 1500)
    assert_tree_equal(first[0][0], want)


def test_per_scan_seed_process_loader(tree):
    got = epochs(tree, 2, cls=td.MultiprocessLoader, n_epochs=1, mp_context="spawn")
    for a, b in zip(got[0], epochs(tree, 1, n_epochs=1)[0]):
        assert_tree_equal(a, b)


def test_synth_scan_points_equal():
    for n in (8000, 8031):
        a = bench.synth_scan_points(np.random.default_rng(11), n)
        b = td.synth_scan_points(np.random.default_rng(11), n)
        assert a.dtype == b.dtype == np.float32 and a.shape == (n, 3)
        np.testing.assert_array_equal(a, b)


def test_synthetic_writers_equal(tmp_path):
    jd.write_synthetic_kitti(str(tmp_path / "j"), sequences=("00",), scans_per_seq=2,
                             num_points=700, seed=1)
    td.write_synthetic_kitti(str(tmp_path / "t"), sequences=("00",), scans_per_seq=2,
                             num_points=700, seed=1)
    for rel in ("velodyne/000001.bin", "labels/000001.label"):
        assert ((tmp_path / "j/sequences/00" / rel).read_bytes()
                == (tmp_path / "t/sequences/00" / rel).read_bytes())


def test_nuscenes_dataset_equal(tmp_path):
    jnusc.write_synthetic_nuscenes(str(tmp_path / "j"), num_scans=3, num_points=900, seed=2)
    tnusc.write_synthetic_nuscenes(str(tmp_path / "t"), num_scans=3, num_points=900, seed=2)
    kw = dict(voxel_size=VOXEL, downsampling=700, augment=True, seed=3)
    ja = jnusc.NuScenesDataset(str(tmp_path / "j"), "train", **kw)
    ta = tnusc.NuScenesDataset(str(tmp_path / "t"), "train", **kw)
    assert len(ja) == len(ta) == 3
    for i in range(3):
        assert_tree_equal(ja[i], ta[i])
    assert_tree_equal(ta.get(1, scan_rng(3, 0, 1)), ta.get(1, scan_rng(3, 0, 1)))


def test_quantize_numpy_and_native():
    """numpy is the default and equals the JAX package's numpy path; the C++
    voxelizer, asked for, equals the JAX package's C++ voxelizer (and, away
    from voxel faces, numpy)."""
    from gcdlss_tpu.data import native_voxelizer as jnv

    pts = np.random.default_rng(0).uniform(-50, 50, (20000, 3)).astype(np.float32)
    got = sparse_quantize_np(pts, 0.2)
    assert_tree_equal(got, jd.quantize_np.sparse_quantize_np(pts, 0.2))
    nat = sparse_quantize_np(pts, 0.2, native=True)
    assert_tree_equal(got, nat)
    if jnv.available():
        assert_tree_equal(nat, jnv.sparse_quantize(pts, 0.2))
    raw = np.array([10 | (3 << 16), 48, 99, 259 | (7 << 16)], np.int32)
    lut = np.full(260, -1, np.int32)
    lut[[10, 48, 259]] = (0, 10, 4)
    sem, inst = native_voxelizer.decode_labels(raw, lut)
    np.testing.assert_array_equal(sem, [0, 10, -1, 4])
    np.testing.assert_array_equal(inst, [3, 0, 0, 7])


def test_native_voxelizer_raises_without_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native_voxelizer, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises((RuntimeError, OSError)):
        native_voxelizer.build()


@pytest.mark.parametrize("me_order", ["first_fastest", "last_fastest"])
def test_weight_helpers_equal(me_order):
    for k in (1, 3, 5):
        np.testing.assert_array_equal(jw.offset_permutation(k, me_order),
                                      tw.offset_permutation(k, me_order))
    np.testing.assert_array_equal(jw.dcode_permutation(me_order), tw.dcode_permutation(me_order))
    rng = np.random.default_rng(0)
    for shape in ((27, 4, 6), (125, 1, 3), (8, 5, 5), (4, 6)):
        sd = {"w": rng.normal(size=shape).astype(np.float32)}
        np.testing.assert_array_equal(jw._conv_in(sd, "w", shape, me_order),
                                      tw._conv_in(sd, "w", shape, me_order))
    names = (["conv0p1s1", "bn0", "final", "final2", "final3"]
             + [f"conv{i}s2" for i in range(1, 5)] + [f"bn{i}" for i in range(1, 5)]
             + [f"convtr{j}s2" for j in range(4, 8)] + [f"bntr{j}" for j in range(4, 8)]
             + [f"block{i}" for i in range(1, 9)])
    for name in names:
        assert jw._ref_name(name) == tw._ref_name(name), name
    with pytest.raises(KeyError):
        tw._ref_name("stem")


def test_loader_raises_what_its_producer_raised(tree):
    """A failure while a batch is made reaches the consumer (it must not wait
    for ever on a producer thread that died), and per-scan seeding refuses a
    dataset that cannot take a generator."""
    ds = make_ds(td, tree, augment=True, seed=1)
    ds.scan_files[2] = ds.scan_files[2] + ".missing"
    for cls, kw in ((td.PrefetchLoader, {}), (td.MultiprocessLoader, {"mp_context": "spawn"})):
        loader = cls(ds, 2, CAP, num_workers=2, shuffle=False, per_scan_seed=True, **kw)
        with pytest.raises(FileNotFoundError):
            list(loader)
    with pytest.raises(TypeError, match="per_scan_seed"):
        td.PrefetchLoader(make_ds(jd, tree), 2, CAP)  # the default mode
