"""Density-based clustering on the host (port of `gcdlss_tpu/algo/dbscan.py`).

The reference imports `sklearn.cluster.DBSCAN` / `hdbscan` for
candidate-clustering ablations (`modules/exp.py:28-30`) and for
ExpClusterFineTuning's pseudo-unknown mining (`exp.py:1206-1296`). These run
on the host, once a step at most, on numpy arrays. scikit-learn is used when
importable, as in the JAX package; otherwise `_dbscan_grid`, which gives the
labels of the JAX package's fallback (`gcdlss_tpu/algo/dbscan.py` `_dbscan_np`,
a Python loop a point: seconds for one scan's ~66k voxels) label for label,
from a k-d tree's neighbour pairs and a connected-components pass.
"""

from __future__ import annotations

import numpy as np


def dbscan(x: np.ndarray, eps: float = 0.5, min_samples: int = 5) -> np.ndarray:
    """Cluster rows of x; returns int labels, -1 = noise.

    Uses sklearn when available; otherwise `_dbscan_grid` (core points =
    >= min_samples within eps, itself included; clusters = connected core
    points plus the border points `_dbscan_np` gives them)."""
    try:
        from sklearn.cluster import DBSCAN

        return DBSCAN(eps=eps, min_samples=min_samples).fit(x).labels_
    except ImportError:
        return _dbscan_grid(x, eps, min_samples)


def _dbscan_grid(x: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """The JAX package's `_dbscan_np` labels without its loop a point.

    The pairs within eps come from a k-d tree at a radius a hair above eps
    and are kept by `_dbscan_np`'s own test (`np.linalg.norm` of the
    difference <= eps). What `_dbscan_np` does (a loop over the points in
    index order, each cluster grown from its first core point), as rules:
      * a cluster is a connected component of the core points; it is grown
        from its lowest core index (its seed), and clusters are numbered in
        the order of their seeds;
      * a border point b (not core, a core within eps) takes the first
        cluster, in seed order, among those within reach whose seed is below
        b: each of them is grown before the index loop reaches b, and the
        first one claims b;
      * failing that, b is marked visited by the index loop before any
        cluster reaches it, and a later cluster takes it only from its
        seed's own neighbours (the seed's frontier is all of them, visited
        or not; a grown point's is its unvisited neighbours): b takes the
        first cluster whose seed lies within eps of it, else it is noise."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    x = np.asarray(x)
    n = x.shape[0]
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    pairs = cKDTree(x).query_pairs(eps * (1 + 1e-9) + 1e-300, output_type="ndarray")
    pairs = pairs.reshape(-1, 2).astype(np.int64)
    keep = np.linalg.norm(x[pairs[:, 1]] - x[pairs[:, 0]], axis=1) <= eps
    a, b = pairs[keep, 0], pairs[keep, 1]
    count = 1 + np.bincount(a, minlength=n) + np.bincount(b, minlength=n)
    core = count >= min_samples
    if not core.any():
        return labels
    # clusters: components of the core graph, numbered by their lowest index
    both = core[a] & core[b]
    graph = coo_matrix((np.ones(int(both.sum()), np.int8), (a[both], b[both])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    core_idx = np.flatnonzero(core)
    seed_of_comp = np.full(int(comp.max()) + 1, n, np.int64)
    np.minimum.at(seed_of_comp, comp[core_idx], core_idx)
    seeds = np.unique(seed_of_comp[comp[core_idx]])  # ascending: cluster id order
    cid_of_comp = np.full(seed_of_comp.shape[0], -1, np.int64)
    cid_of_comp[comp[seeds]] = np.arange(seeds.shape[0])
    labels[core] = cid_of_comp[comp[core]]
    # border points: (border, core neighbour) pairs
    one = core[a] ^ core[b]
    border = np.where(core[a[one]], b[one], a[one])
    nbr = np.where(core[a[one]], a[one], b[one])
    cid = labels[nbr]
    seed = seeds[cid]
    big = np.iinfo(np.int64).max
    first = np.full(n, big, np.int64)  # rule 1: a seed below the border point
    np.minimum.at(first, border, np.where(seed < border, cid, big))
    late = np.full(n, big, np.int64)  # rule 2: the seed itself within eps
    np.minimum.at(late, border, np.where(nbr == seed, cid, big))
    pick = np.where(first < big, first, late)
    labels = np.where(~core & (pick < big), pick, labels)
    return labels


def cluster_candidates_density(
    feats: np.ndarray,
    eps: float = 0.3,
    min_samples: int = 10,
    max_clusters: int | None = None,
):
    """DBSCAN over (l2-normalized) candidate features, the ablation
    counterpart of the discovery step's cosine k-means.

    Returns (labels [N] with -1 noise, centroids [C, D] l2-normalized,
    counts [C]). Clusters are ordered by descending size; with
    `max_clusters`, smaller clusters are merged into noise."""
    nrm = np.linalg.norm(feats, axis=1, keepdims=True)
    xn = feats / np.maximum(nrm, 1e-12)
    labels = dbscan(xn, eps=eps, min_samples=min_samples)
    uniq, counts = np.unique(labels[labels >= 0], return_counts=True)
    order = np.argsort(-counts)
    uniq, counts = uniq[order], counts[order]
    if max_clusters is not None and len(uniq) > max_clusters:
        drop = set(uniq[max_clusters:].tolist())
        labels = np.where(np.isin(labels, list(drop)), -1, labels)
        uniq, counts = uniq[:max_clusters], counts[:max_clusters]
    remap = {int(u): i for i, u in enumerate(uniq)}
    labels = np.asarray([remap.get(int(l), -1) for l in labels], np.int64)
    cents = np.zeros((len(uniq), feats.shape[1]), np.float64)
    for i in range(len(uniq)):
        m = labels == i
        c = xn[m].mean(axis=0)
        cents[i] = c / max(np.linalg.norm(c), 1e-12)
    return labels, cents, counts
