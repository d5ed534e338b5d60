"""Semi-supervised clustering (PyTorch port of `gcdlss_tpu/algo/clustering.py`).

Rebuild of the reference's `utils/clustering.py`:
  * `pairwise_distance`: squared euclidean distances in one product;
  * `kmeans_pp_init`: k-means++ seeding, optionally after given centers;
  * `OnlineSemiKMeans`: semi-supervised k-means whose first centroids are
    anchored on the labeled class means (`clustering.py:93-411`), for the
    offline clustering evaluation (`eval/clustering_eval.py`);
  * `SemiSupervisedStreamKM`: streaming coreset k-means (`:9-53`).

The k-means++ picks are drawn from an explicit `torch.Generator` (restart i
of a seeded class from `seed + i`), or given as row indices (`picks`), so
that a test can feed the JAX package's. The iterations run on tensors on
`device`; the classes take and return numpy arrays, as the JAX ones do.
"""

from __future__ import annotations

import numpy as np
import torch

from .kmeans import euclidean_kmeans


def pairwise_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances [N, M]."""
    a2 = a.square().sum(dim=-1, keepdim=True)
    b2 = b.square().sum(dim=-1)
    return a2 - 2.0 * (a @ b.T) + b2[None, :]


def _pick(generator, p: torch.Tensor) -> torch.Tensor:
    # a distance of a row to itself can round below 0
    return torch.multinomial(p.clamp(min=0), 1, generator=generator)[0]


def kmeans_pp_init(x: torch.Tensor, valid: torch.Tensor, k: int, pre_centers=None,
                   generator: torch.Generator | None = None, picks=None) -> torch.Tensor:
    """k-means++ seeding of k centers [k, C] among the valid rows of x: the
    `pre_centers` first (else one row drawn uniformly), then each next row
    with probability proportional to its squared distance to the nearest
    center so far. `picks` gives the drawn rows instead of `generator`, in
    order (k - len(pre_centers) of them, or k)."""
    n_pre = 0 if pre_centers is None else pre_centers.shape[0]
    validf = valid.to(x.dtype)
    it = iter([] if picks is None else [int(i) for i in picks])

    def draw(p):
        return next(it) if picks is not None else int(_pick(generator, p))

    centers = torch.zeros(k, x.shape[1], dtype=x.dtype, device=x.device)
    if n_pre:
        centers[:n_pre] = pre_centers
        d = pairwise_distance(x, pre_centers).min(dim=1).values
    else:
        i0 = draw(validf / validf.sum().clamp(min=1))
        centers[0] = x[i0]
        d = pairwise_distance(x, centers[0:1])[:, 0]
        n_pre = 1
    d = torch.where(valid, d, 0.0)
    for i in range(n_pre, k):
        idx = draw(d / d.sum().clamp(min=1e-12))
        centers[i] = x[idx]
        d = torch.minimum(d, pairwise_distance(x, centers[i:i + 1])[:, 0])
        d = torch.where(valid, d, 0.0)
    return centers


def _semi_lloyd(x, valid, l_feats, l_valid, l_targets, centers, k: int, iters: int,
                n_labeled_clusters: int, with_inertia: bool = True):
    """Lloyd iterations whose first `n_labeled_clusters` centroids mix the
    labeled class sums into their assigned unlabeled mass every step (the
    reference's `fit_mix_once` rule). Returns (centers, assignments (-1 on
    masked rows), inertia (None unless `with_inertia`)).

    The inertia is the sum of each valid row's squared distance to its
    nearest centre. Where the last update left the assignment as it was (the
    iterations converged), it is taken from the partition alone: each row's
    distance to its own cluster's centre, recomputed by the same update in a
    numbering of the clusters that the partition fixes (the anchored ones
    first, the rest by their first row). The distance matrix's columns and
    the update's product round by the clusters' numbers, so two restarts
    that reach one partition under two numberings would otherwise differ in
    the last bits; this way they tie exactly, and the first is kept."""
    vmask = valid[:, None].to(x.dtype)
    if n_labeled_clusters:
        onehot_l = torch.nn.functional.one_hot(
            l_targets.clamp(0, n_labeled_clusters - 1).long(), n_labeled_clusters).to(x.dtype)
        onehot_l = onehot_l * l_valid[:, None].to(x.dtype)
        l_sums, l_cnts = onehot_l.T @ l_feats, onehot_l.sum(dim=0)[:, None]

    def update(assign, centers):
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype) * vmask
        sums, cnts = onehot.T @ x, onehot.sum(dim=0)[:, None]
        if n_labeled_clusters:
            sums = torch.cat([sums[:n_labeled_clusters] + l_sums, sums[n_labeled_clusters:]])
            cnts = torch.cat([cnts[:n_labeled_clusters] + l_cnts, cnts[n_labeled_clusters:]])
        return torch.where(cnts > 0, sums / cnts.clamp(min=1.0), centers)

    prev = None
    for _ in range(iters):
        prev = (-pairwise_distance(x, centers)).argmax(dim=-1)
        centers = update(prev, centers)
    dist = pairwise_distance(x, centers)
    assign = (-dist).argmax(dim=-1)
    inertia = None
    if with_inertia and prev is not None and torch.equal(prev[valid], assign[valid]):
        rows = torch.arange(x.shape[0], device=x.device)
        member = (assign[:, None] == torch.arange(k, device=x.device)) & valid[:, None]
        first = torch.where(member, rows[:, None], x.shape[0]).amin(dim=0)
        first[:n_labeled_clusters] = -1
        order = torch.sort(first, stable=True).indices  # canonical number -> cluster
        canon = torch.empty_like(order)
        canon[order] = torch.arange(k, device=x.device)
        own = canon[assign]
        own_centers = update(own, centers[order])[own]
        inertia = ((x - own_centers).square().sum(dim=-1) * valid).sum()
    elif with_inertia:
        inertia = (dist.min(dim=-1).values * valid).sum()
    return centers, torch.where(valid, assign, -1), inertia


class OnlineSemiKMeans:
    """Semi-supervised k-means: labeled features anchor the first centroids."""

    def __init__(self, k: int = 3, max_iterations: int = 100, n_init: int = 3, seed: int = 0,
                 device="cpu"):
        self.k = k
        self.max_iterations = max_iterations
        self.n_init = n_init
        self.seed = seed
        self.device = torch.device(device)
        self.cluster_centers_ = None
        self.labels_ = None
        self.inertias_ = None

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _init_centers(self, i: int, x, valid, pre_centers, picks):
        gen = torch.Generator(device=self.device).manual_seed(self.seed + i)
        return kmeans_pp_init(x, valid, self.k, pre_centers, generator=gen,
                              picks=None if picks is None else picks[i])

    def fit(self, x: np.ndarray, picks=None):
        """k-means++ and Lloyd `n_init` times; the first run of least inertia
        is kept (`inertias_`: each run's, None for a single run). `picks`: one
        k-means++ pick list per restart, in place of the draws."""
        x = self._tensor(x)
        valid = torch.ones(x.shape[0], dtype=torch.bool, device=self.device)
        runs = []
        for i in range(self.n_init):
            centers = self._init_centers(i, x, valid, None, picks)
            runs.append(_semi_lloyd(
                x, valid, x[:1] * 0, torch.zeros(1, dtype=torch.bool, device=self.device),
                torch.zeros(1, dtype=torch.int32, device=self.device), centers, self.k,
                self.max_iterations, 0, with_inertia=self.n_init > 1))
        centers, labels = self._keep(runs)
        self.cluster_centers_ = centers.cpu().numpy()
        self.labels_ = labels.cpu().numpy()
        return self

    def _keep(self, runs: list) -> tuple:
        """The (centers, labels) of the first run of least inertia."""
        self.inertias_ = [None if r[2] is None else float(r[2]) for r in runs]
        best = 0
        for i in range(1, len(runs)):
            if self.inertias_[i] < self.inertias_[best]:
                best = i
        return runs[best][:2]

    def fit_mix(self, u_feats: np.ndarray, l_feats: np.ndarray, l_targets: np.ndarray,
                cluster_center=None, center_only: bool = False, picks=None):
        """Cluster the unlabeled features with centroids anchored on the
        labeled class means. Returns the labels of every point, labeled ones
        first, as the reference's `fit_mix` (or the centers, `center_only`).
        `picks` as in `fit`."""
        u, lf = self._tensor(u_feats), self._tensor(l_feats)
        lt = self._tensor(l_targets, torch.int32)
        n_lab = int(lt.max()) + 1 if l_targets.size else 0
        uvalid = torch.ones(u.shape[0], dtype=torch.bool, device=self.device)
        lvalid = torch.ones(lf.shape[0], dtype=torch.bool, device=self.device)
        onehot = torch.nn.functional.one_hot(lt.long(), n_lab).to(torch.float32)
        anchors = (onehot.T @ lf) / onehot.sum(dim=0)[:, None].clamp(min=1.0)
        runs = []
        for i in range(self.n_init):
            if cluster_center is not None:
                centers = self._tensor(cluster_center)
            else:
                centers = self._init_centers(i, u, uvalid, anchors, picks)
            runs.append(_semi_lloyd(u, uvalid, lf, lvalid, lt, centers, self.k,
                                    self.max_iterations, n_lab, with_inertia=self.n_init > 1))
        centers, ulabels = self._keep(runs)
        self.cluster_centers_ = centers.cpu().numpy()
        if center_only:
            return self.cluster_centers_
        l_labels = (-pairwise_distance(lf, centers)).argmax(dim=-1).cpu().numpy()
        self.labels_ = np.concatenate([l_labels, ulabels.cpu().numpy()])
        return self.labels_


class SemiSupervisedStreamKM:
    """Streaming coreset k-means: labeled batches add their class means to
    the coreset, unlabeled batches the centers of a mini-batch k-means.

    The k-means' initial rows are drawn from `torch.Generator`s seeded
    `seed + call` (`partial_fit`) and `seed` (`get_cluster_centers`), or
    taken from `scores`, one uniform draw per row, when given."""

    def __init__(self, num_clusters: int, coreset_size: int = 1000, batch_size: int = 100,
                 seed: int = 0, device="cpu"):
        self.num_clusters = num_clusters
        self.coreset_size = coreset_size
        self.batch_size = batch_size
        self.coreset: list = []
        self.seed = seed
        self.device = torch.device(device)
        self._calls = 0

    def add_to_coreset(self, centers: np.ndarray):
        for c in np.atleast_2d(centers):
            self.coreset.append(c)
        if len(self.coreset) > self.coreset_size:
            self.coreset = self.coreset[-self.coreset_size:]

    def _kmeans(self, data: np.ndarray, k: int, seed: int, scores) -> np.ndarray:
        x = torch.as_tensor(np.asarray(data), dtype=torch.float32, device=self.device)
        if scores is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            scores = torch.rand(x.shape[0], generator=gen, device=self.device)
        else:
            scores = torch.as_tensor(np.asarray(scores), device=self.device)
        valid = torch.ones(x.shape[0], dtype=torch.bool, device=self.device)
        return euclidean_kmeans(x, valid, k, scores)[1].cpu().numpy()

    def partial_fit(self, new_data: np.ndarray, labels: np.ndarray | None = None, scores=None):
        if labels is not None:
            for c in np.unique(labels):
                self.add_to_coreset(new_data[labels == c].mean(axis=0))
        else:
            self._calls += 1
            k = min(self.batch_size, max(1, new_data.shape[0] // 2))
            self.add_to_coreset(self._kmeans(new_data, k, self.seed + self._calls, scores))

    def get_cluster_centers(self, scores=None) -> np.ndarray:
        return self._kmeans(np.stack(self.coreset), self.num_clusters, self.seed, scores)
