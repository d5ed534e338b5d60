"""PyTorch port vs JAX package: DBSCAN and ExpClusterFineTuning's host
miner on the CPU.

`algo/dbscan.dbscan` on both routes (scikit-learn, and with scikit-learn
hidden from both packages: the JAX package's `_dbscan_np` against the port's
`_dbscan_grid`), label for label; `_dbscan_grid` against `_dbscan_np` on
adversarial inputs (points at exactly eps, duplicates, border points between
clusters, every min_samples up to 6, 1-3 dimensions, no point);
`cluster_candidates_density`; `_cluster_unknown_mask_host` on both routes
(scikit-learn's KMeans and the numpy Lloyd) mask for mask; and the JAX
step's row misalignment: it hands the miner the input rows' coordinates
beside the plan rows' masks and features. The Extra step with the miner is
held to the JAX step in `test_torch_finetune.py`.

Everything here is integer or exact: labels and masks bit for bit; centroids
of `cluster_candidates_density` within 1e-12.
"""

import sys

import numpy as np
import pytest
import torch

from gcdlss_tpu.algo import dbscan as jdb
from gcdlss_tpu.train import finetune as jft
from gcdlss_tpu_torch.algo import dbscan as tdb
from gcdlss_tpu_torch.train import common as tcommon
from gcdlss_tpu_torch.train import finetune as tft
from gcdlss_tpu_torch.train.discover import _combine_batches


@pytest.fixture(params=["sklearn", "fallback"])
def route(request, monkeypatch):
    """The scikit-learn route, or the fallback with `sklearn` hidden from both
    packages (an import of it raises ImportError)."""
    if request.param == "fallback":
        monkeypatch.setitem(sys.modules, "sklearn", None)
        monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    return request.param


def _blobs(rng, n, n_blobs, spread=0.5, span=40):
    centers = rng.uniform(-span, span, size=(n_blobs, 3))
    return np.floor(centers[rng.integers(0, n_blobs, n)]
                    + rng.normal(0, spread, size=(n, 3))).astype(np.float64)


def test_dbscan_routes_match_jax(route):
    """The miner's use (integer voxel coordinates, eps 3, min_samples 2) and
    a float use (eps 0.3, min_samples 5), as each package's `dbscan` runs
    them on this route."""
    rng = np.random.default_rng(0)
    cases = [(_blobs(rng, 1500, 30), 3, 2),
             (rng.normal(size=(800, 4)) * 0.25 + rng.integers(0, 3, (800, 1)), 0.3, 5)]
    for x, eps, ms in cases:
        got, ref = tdb.dbscan(x, eps, ms), jdb.dbscan(x, eps, ms)
        np.testing.assert_array_equal(got, ref)
        assert got.max() >= 2


def test_dbscan_grid_matches_dbscan_np_on_adversarial_inputs():
    """`_dbscan_grid` against the JAX package's `_dbscan_np` label for
    label: small integer grids (many pairs at exactly
    eps, duplicate points, border points reachable from two clusters, seeds
    above their borders), half-integer grids, gaussians; 1-3 dimensions,
    min_samples 1-6, eps 0.5-3; a chain of borders; no point at all."""
    checked = 0
    for seed in range(240):
        rng = np.random.default_rng(seed)
        n, d = int(rng.integers(1, 90)), int(rng.integers(1, 4))
        kind = seed % 3
        if kind == 0:
            x = rng.integers(0, 6, (n, d)).astype(np.float64)
        elif kind == 1:
            x = np.round(rng.uniform(0, 5, (n, d)) * 2) / 2
        else:
            x = rng.normal(size=(n, d)) * rng.uniform(0.3, 3)
        eps = float(rng.choice([0.5, 1.0, 1.5, 3.0]))
        ms = int(rng.integers(1, 7))
        ref = jdb._dbscan_np(x, eps, ms)
        np.testing.assert_array_equal(tdb._dbscan_grid(x, eps, ms), ref,
                                      err_msg=f"seed {seed} eps {eps} min_samples {ms}")
        checked += int((ref >= 0).any() and (ref < 0).any())
    assert checked > 60  # clusters and noise together in many cases
    # a border point whose only core neighbours are two clusters' seeds, both
    # above it; and points beyond every core
    x = np.array([[0.0], [1.0], [-1.0], [-1.1], [-2.0], [2.0], [2.1], [3.0], [9.0]])
    for ms in (2, 3, 4):
        np.testing.assert_array_equal(tdb._dbscan_grid(x, 1.0, ms), jdb._dbscan_np(x, 1.0, ms))
    assert tdb._dbscan_grid(np.zeros((0, 3)), 1.0, 2).shape == (0,)


def test_cluster_candidates_density_matches_jax(monkeypatch):
    """Both routes: labels by descending cluster size, `max_clusters`
    merging the rest into noise, unit centroids."""
    rng = np.random.default_rng(1)
    feats = np.concatenate([rng.normal(size=(1, 6)) + rng.normal(0, 0.05, (n, 6))
                            for n in (80, 50, 30, 12)])
    for hide in (False, True):
        if hide:
            monkeypatch.setitem(sys.modules, "sklearn", None)
            monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
        for max_clusters in (None, 2):
            got = tdb.cluster_candidates_density(feats, 0.3, 5, max_clusters)
            ref = jdb.cluster_candidates_density(feats, 0.3, 5, max_clusters)
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-12)
            np.testing.assert_array_equal(got[2], ref[2])
            assert len(got[2]) == (max_clusters or 4)


def _miner_inputs(rng, n=1400, K=17):
    """Plan-row inputs of the miner: 2 labeled scans (rows 0..) and 2
    blobby unlabeled scans, the known-class probabilities of a softmax."""
    b = np.sort(rng.integers(0, 4, n))
    coords = np.concatenate([b[:, None], _blobs(rng, n, 30).astype(np.int64)], axis=1)
    unsup = b >= 2
    feats = rng.uniform(0, 1, (n, 1))
    logits = rng.normal(size=(n, K + 1)) * 2
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return coords, unsup, feats, probs[:, :K]


def test_cluster_miner_matches_jax(route):
    """`_cluster_unknown_mask_host` of both packages on the same plan rows,
    mask for mask, on this route (KMeans(K+1) or the numpy Lloyd)."""
    for seed in (2, 3):
        args = _miner_inputs(np.random.default_rng(seed))
        got = tft._cluster_unknown_mask_host(*args)
        ref = jft._cluster_unknown_mask_host(*args)
        np.testing.assert_array_equal(got, ref)
        assert got.any() and not got[~args[1]].any()


def test_cluster_miner_row_alignment_fault():
    """The JAX step hands its miner `coords` as `_combine_batches` returns
    them (input rows) beside `unsup_mask` and `feats0` in plan rows
    (`gcdlss_tpu/train/finetune.py:405-409`). Plan rows are the input rows
    compacted: a labeled side that holds fewer voxels than `sup_voxel_cap`
    leaves pad rows mid-stream, and from there on the two row spaces part.
    Shown here: the JAX pairing reads other voxels' coordinates (pads and
    labeled voxels among them) for the unlabeled plan rows and marks other
    rows than the port, which hands the miner the plan rows' coordinates."""
    rng = np.random.default_rng(4)
    caps = (2048, 1024, 512, 512, 256)
    half = caps[0] // 2

    def side(n_valid, scans, blobs):
        coords = np.zeros((half, 4), np.int64)
        c = np.unique(np.concatenate([np.sort(rng.integers(0, scans, n_valid))[:, None],
                                      _blobs(rng, n_valid, blobs).astype(np.int64)], 1),
                      axis=0)
        coords[:len(c)] = c
        valid = np.arange(half) < len(c)
        return {"coords": torch.as_tensor(coords.astype(np.int32)),
                "feats": torch.as_tensor(rng.uniform(0, 1, (half, 1)).astype(np.float32)),
                "labels": torch.zeros(half, dtype=torch.int32),
                "mapped_labels": torch.zeros(half, dtype=torch.int32),
                "valid": torch.as_tensor(valid)}

    sup, unsup = side(600, 2, 10), side(1000, 2, 30)  # the labeled side is 40% pads
    cfg = tft.FineTuneConfig(num_labeled_classes=17, num_classes=19, unknown_label=17,
                             voxel_caps=caps, sup_voxel_cap=half, num_sup_scans=2,
                             extra_mode="cluster")
    combined = _combine_batches(sup, unsup, cfg)
    plan, feats0, _, _ = tcommon.plan_and_gather(combined, caps)
    ok = plan.rep < caps[0]
    unsup_mask = plan.levels[0].valid & ok & (plan.rep >= half)
    coords_in = combined["coords"]
    coords0 = coords_in[torch.where(ok, plan.rep, 0).long()]
    probs = torch.softmax(torch.as_tensor(rng.normal(size=(caps[0], 18)) * 2,
                                          dtype=torch.float32), dim=-1)[:, :17]
    # the unlabeled plan rows read labeled-scan and pad coordinates in the JAX pairing
    assert (coords_in[unsup_mask][:, 0] < 2).sum() > 0
    assert not torch.equal(coords_in[unsup_mask], coords0[unsup_mask])
    assert (coords0[unsup_mask][:, 0] >= 2).all()
    args = [a.numpy() for a in (unsup_mask, feats0, probs)]
    jax_mask = jft._cluster_unknown_mask_host(coords_in.numpy(), *args)
    fixed = jft._cluster_unknown_mask_host(coords0.numpy(), *args)
    port = tft._cluster_unknown_mask(coords0, unsup_mask, feats0, probs).numpy()
    np.testing.assert_array_equal(port, fixed)
    assert fixed.any() and not np.array_equal(jax_mask, fixed)
