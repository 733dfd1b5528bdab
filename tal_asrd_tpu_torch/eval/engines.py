"""Clustering engines in numpy and scipy.

The JAX package clusters speaker embeddings with scikit-learn's PCA, DBSCAN,
HDBSCAN, AgglomerativeClustering and BayesianGaussianMixture (its KMeans
seeds the mixture). The port has no scikit-learn: each engine here is the
computation scikit-learn 1.9 runs at the settings eval/clustering.py uses,
written again operation by operation — the same numpy and scipy calls on
the same dtypes, the same tie-breaking and the same numbering of the labels
— so that both packages give the same labels for the same input:

  * pca_transform: centre, SVD (`full` solver) or the covariance's
    eigendecomposition (`covariance_eigh`), sign flip, project;
  * dbscan: neighbourhoods `<= eps` (the point itself included), clusters
    grown depth first from the core points in index order;
  * hdbscan: core distances (the point itself counted), mutual
    reachability, Prim's spanning tree, single linkage, the condensed tree
    and excess-of-mass selection without a single cluster;
  * agglomerative: scipy's linkage (or Ward) and scikit-learn's own cut of
    the tree (`count(distances >= threshold) + 1` clusters);
  * kmeans_labels / bayesian_gmm: k-means++ and Lloyd's iterations, then
    the variational Gaussian mixture (full covariance, Dirichlet-process
    prior), drawing from the caller's numpy RandomState as scikit-learn
    draws from its random_state.
"""
from __future__ import annotations

import math
from heapq import heappush, heappushpop
from typing import List, Optional

import numpy as np
from scipy import linalg
from scipy.linalg import blas
from scipy.cluster import hierarchy
from scipy.special import betaln, digamma, gammaln

# --- PCA ---------------------------------------------------------------------


def pca_transform(x: np.ndarray, n_components: int) -> np.ndarray:
    """PCA(n_components).fit_transform(x) with the `auto` solver choice."""
    x = np.asarray(x)
    n_samples, n_features = x.shape
    if n_features <= 1_000 and n_samples >= 10 * n_features:
        solver = "covariance_eigh"
    elif max(x.shape) <= 500:
        solver = "full"
    elif 1 <= n_components < 0.8 * min(x.shape):
        # scikit-learn draws this solver's projections from numpy's global
        # generator; no segment of the embedding chain is this large.
        raise NotImplementedError(
            f"PCA of a {n_samples}x{n_features} input takes the randomized solver, "
            "which the port does not implement")
    else:
        solver = "full"
    if not 0 <= n_components <= min(n_samples, n_features):
        raise ValueError(
            f"n_components={n_components} must be between 0 and "
            f"min(n_samples, n_features)={min(n_samples, n_features)} with "
            f"svd_solver={solver!r}")
    mean = np.mean(x, axis=0).reshape(-1)
    if solver == "full":
        centred = x.copy()
        centred -= mean
        u, s, vt = linalg.svd(centred, full_matrices=False)
        u, vt = _svd_flip_rows(u, vt)
        u = u[:, :n_components]
        u *= s[:n_components]
        return u
    c = x.T @ x
    c -= n_samples * mean.reshape(-1, 1) * mean.reshape(1, -1)
    c /= n_samples - 1
    _, eigenvecs = np.linalg.eigh(c)
    vt = np.flip(eigenvecs, axis=1).T
    _, vt = _svd_flip_rows(None, vt)
    components = vt[:n_components, :].copy()
    out = x @ components.T
    out -= mean.reshape(1, -1) @ components.T
    return out


def _svd_flip_rows(u, v):
    """scikit-learn's svd_flip(u, v, u_based_decision=False)."""
    max_abs_rows = np.argmax(np.abs(v), axis=1)
    shift = np.arange(v.shape[0])
    signs = np.sign(np.take(v.reshape(-1), max_abs_rows + shift * v.shape[1], axis=0))
    if u is not None:
        u *= signs[np.newaxis, :]
    v *= signs[:, np.newaxis]
    return u, v


# --- distances ---------------------------------------------------------------


def euclidean_sequential(x: np.ndarray) -> np.ndarray:
    """[N, D] -> [N, N] float64 euclidean distances summed feature by feature
    in index order (scikit-learn's DistanceMetric and KD-tree arithmetic)."""
    x = np.asarray(x, np.float64)
    d = np.zeros((len(x), len(x)), np.float64)
    for j in range(x.shape[1]):
        tmp = x[:, None, j] - x[None, :, j]
        d += tmp * tmp
    return np.sqrt(d)


def _euclidean_sq_upcast(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Squared distances of float32 rows, computed in float64 and rounded to
    float32 (scikit-learn's _euclidean_distances_upcast, one batch)."""
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    d = -2 * (x64 @ y64.T)
    d += np.einsum("ij,ij->i", x64, x64)[:, None]
    d += np.einsum("ij,ij->i", y64, y64)[None, :]
    d = d.astype(np.float32, copy=False)
    np.maximum(d, np.float32(0), out=d)
    return d


# --- DBSCAN ------------------------------------------------------------------


def dbscan(x: np.ndarray, eps: float = 0.5, min_samples: int = 5,
           precomputed: bool = False) -> np.ndarray:
    """DBSCAN(eps, min_samples, metric="precomputed" | "euclidean").fit_predict
    (raw rows in float32)."""
    if precomputed:
        within = np.asarray(x) <= eps
    else:
        x = np.asarray(x, np.float32)
        within = _euclidean_sq_upcast(x, x) <= eps * eps
    neighborhoods = [np.where(row)[0] for row in within]
    n = len(neighborhoods)
    core = np.array([len(nb) for nb in neighborhoods]) >= min_samples
    labels = np.full(n, -1, dtype=np.intp)
    label_num = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        stack: List[int] = []
        while True:
            if labels[i] == -1:
                labels[i] = label_num
                if core[i]:
                    for v in neighborhoods[i]:
                        if labels[v] == -1:
                            stack.append(int(v))
            if not stack:
                break
            i = stack.pop()
        label_num += 1
    return labels


# --- HDBSCAN -----------------------------------------------------------------


def hdbscan(x: np.ndarray, min_cluster_size: int = 5, min_samples: Optional[int] = None,
            precomputed: bool = False) -> np.ndarray:
    """HDBSCAN(min_cluster_size, min_samples, metric="precomputed" |
    "euclidean").fit_predict: excess of mass, no single cluster, epsilon 0."""
    x = np.asarray(x, np.float64)
    if x.shape[0] == 1:
        raise ValueError("n_samples=1 while HDBSCAN requires more than one sample")
    min_samples = min_cluster_size if min_samples is None else min_samples
    if min_samples > x.shape[0]:
        raise ValueError(f"min_samples ({min_samples}) must be at most the number of "
                         f"samples in X ({x.shape[0]})")
    if precomputed and (x.shape[0] != x.shape[1]
                        or not np.allclose(x, x.T, rtol=1e-7, atol=1e-9)):
        raise ValueError("The precomputed distance matrix is expected to be symmetric")
    if precomputed:
        mst = _mst_from_mutual_reachability(x.copy(), min_samples)
    else:
        mst = _mst_from_data(euclidean_sequential(x), min_samples)
    order = np.argsort(mst[:, 2])
    tree = _single_linkage(mst[order])
    condensed = _condense_tree(tree, min_cluster_size)
    return _select_eom(condensed, _stability(condensed))


def _mst_from_mutual_reachability(d: np.ndarray, min_samples: int) -> np.ndarray:
    """Rows (current_node, next_node, distance) of Prim's tree over the
    mutual reachability of a dense distance matrix."""
    core = np.ascontiguousarray(np.partition(d, min_samples - 1, axis=1)[:, min_samples - 1])
    mr = np.maximum(np.maximum(core[:, None], core[None, :]), d)
    n = len(d)
    mst = np.empty((n - 1, 3), np.float64)
    labels = np.arange(n, dtype=np.int64)
    current = 0
    min_reach = np.full(n, np.inf)
    for i in range(n - 1):
        keep = labels != current
        labels = labels[keep]
        min_reach = np.minimum(min_reach[keep], mr[current][labels])
        k = int(np.argmin(min_reach))
        new = int(labels[k])
        mst[i] = (current, new, min_reach[k])
        current = new
    return mst


def _mst_from_data(dist: np.ndarray, min_samples: int) -> np.ndarray:
    """Prim's tree from pairwise distances with core distances from the
    min_samples nearest rows (scikit-learn's mst_from_data_matrix)."""
    n = len(dist)
    core = np.partition(dist, min_samples - 1, axis=1)[:, min_samples - 1]
    in_tree = np.zeros(n, bool)
    min_reach = np.full(n, np.inf)
    sources = np.ones(n, np.int64)
    mst = np.empty((n - 1, 3), np.float64)
    current = 0
    big = np.finfo(np.float64).max
    for i in range(n - 1):
        in_tree[current] = True
        js = np.where(~in_tree)[0]
        mrd = np.maximum(np.maximum(core[current], core[js]), dist[current, js])
        update = mrd < min_reach[js]
        min_reach[js[update]] = mrd[update]
        sources[js[update]] = current
        cand = np.where(update, mrd, min_reach[js])
        k = int(np.argmin(cand))
        if cand[k] < big:
            new, source, value = int(js[k]), int(sources[js[k]]), float(cand[k])
        else:
            new, source, value = 0, 0, big
        mst[i] = (source, new, value)
        current = new
    return mst


def _single_linkage(mst: np.ndarray) -> np.ndarray:
    """Rows (left, right, distance, size) from MST edges sorted by distance."""
    n = len(mst) + 1
    parent = np.full(2 * n - 1, -1, np.intp)
    size = np.concatenate([np.ones(n, np.intp), np.zeros(n - 1, np.intp)])
    next_label = n

    def find(node):
        p = node
        while parent[node] != -1:
            node = parent[node]
        while parent[p] != node:
            p, parent[p] = parent[p], node
        return node

    out = np.zeros((n - 1, 4), np.float64)
    for i, (a, b, dist) in enumerate(mst):
        ca, cb = find(int(a)), find(int(b))
        out[i] = (ca, cb, dist, size[ca] + size[cb])
        parent[ca] = parent[cb] = next_label
        size[next_label] = size[ca] + size[cb]
        next_label += 1
    return out


def _bfs_hierarchy(tree: np.ndarray, root: int) -> List[int]:
    n = len(tree) + 1
    queue, result = [root], []
    while queue:
        result.extend(queue)
        queue = [x - n for x in queue if x >= n]
        if queue:
            queue = [int(c) for node in queue for c in tree[node, :2]]
    return result


def _condense_tree(tree: np.ndarray, min_cluster_size: int) -> np.ndarray:
    """Rows (parent, child, lambda, size) of the condensed tree."""
    root = 2 * len(tree)
    n = len(tree) + 1
    next_label = n + 1
    nodes = _bfs_hierarchy(tree, root)
    relabel = np.empty(root + 1, np.intp)
    relabel[root] = n
    ignore = np.zeros(len(nodes), bool)
    rows = []
    for node in nodes:
        if ignore[node] or node < n:
            continue
        left, right, dist = int(tree[node - n, 0]), int(tree[node - n, 1]), tree[node - n, 2]
        lam = 1.0 / dist if dist > 0.0 else np.inf
        left_count = int(tree[left - n, 3]) if left >= n else 1
        right_count = int(tree[right - n, 3]) if right >= n else 1
        if left_count >= min_cluster_size and right_count >= min_cluster_size:
            relabel[left] = next_label
            next_label += 1
            rows.append((relabel[node], relabel[left], lam, left_count))
            relabel[right] = next_label
            next_label += 1
            rows.append((relabel[node], relabel[right], lam, right_count))
            continue
        if left_count < min_cluster_size and right_count < min_cluster_size:
            drop = (left, right)
        elif left_count < min_cluster_size:
            relabel[right] = relabel[node]
            drop = (left,)
        else:
            relabel[left] = relabel[node]
            drop = (right,)
        for side in drop:
            for sub in _bfs_hierarchy(tree, side):
                if sub < n:
                    rows.append((relabel[node], sub, lam, 1))
                ignore[sub] = True
    return np.array(rows, dtype=[("parent", np.intp), ("child", np.intp),
                                 ("value", np.float64), ("cluster_size", np.intp)])


def _stability(condensed: np.ndarray) -> dict:
    parents = condensed["parent"]
    smallest = int(parents.min())
    n_clusters = int(parents.max()) - smallest + 1
    largest_child = max(int(condensed["child"].max()), smallest)
    births = np.full(largest_child + 1, np.nan)
    for row in condensed:
        births[row["child"]] = row["value"]
    births[smallest] = 0.0
    result = np.zeros(n_clusters)
    with np.errstate(invalid="ignore"):     # inf - inf at zero distances, as in C
        for row in condensed:
            result[row["parent"] - smallest] += \
                (row["value"] - births[row["parent"]]) * row["cluster_size"]
    return {i + smallest: result[i] for i in range(n_clusters)}


def _bfs_cluster_tree(tree: np.ndarray, root: int) -> List[int]:
    result, queue = [], np.array([root], np.intp)
    while len(queue) > 0:
        result.extend(queue.tolist())
        queue = tree["child"][np.isin(tree["parent"], queue)]
    return result


class _TreeUnionFind:
    def __init__(self, size):
        self.data = np.zeros((size, 2), np.intp)
        self.data[:, 0] = np.arange(size)

    def union(self, x, y):
        xr, yr = self.find(x), self.find(y)
        if self.data[xr, 1] < self.data[yr, 1]:
            self.data[xr, 0] = yr
        elif self.data[xr, 1] > self.data[yr, 1]:
            self.data[yr, 0] = xr
        else:
            self.data[yr, 0] = xr
            self.data[xr, 1] += 1

    def find(self, x):
        if self.data[x, 0] != x:
            self.data[x, 0] = self.find(self.data[x, 0])
        return self.data[x, 0]


def _select_eom(condensed: np.ndarray, stability: dict) -> np.ndarray:
    """Excess-of-mass selection and labelling (noise -1), clusters numbered
    by their node ids in ascending order."""
    node_list = sorted(stability.keys(), reverse=True)[:-1]
    cluster_tree = condensed[condensed["cluster_size"] > 1]
    is_cluster = {c: True for c in node_list}
    for node in node_list:
        children = cluster_tree["child"][cluster_tree["parent"] == node]
        subtree = np.sum([stability[c] for c in children])
        if subtree > stability[node]:
            is_cluster[node] = False
            stability[node] = subtree
        else:
            for sub in _bfs_cluster_tree(cluster_tree, node):
                if sub != node:
                    is_cluster[sub] = False
    clusters = {c for c in is_cluster if is_cluster[c]}
    label_map = {c: i for i, c in enumerate(sorted(clusters))}
    root = int(condensed["parent"].min())
    uf = _TreeUnionFind(int(condensed["parent"].max()) + 1)
    for row in condensed:
        if row["child"] not in clusters:
            uf.union(int(row["parent"]), int(row["child"]))
    labels = np.empty(root, np.intp)
    for i in range(root):
        c = uf.find(i)
        labels[i] = label_map[c] if c != root else -1
    return labels


# --- agglomerative -------------------------------------------------------------


def agglomerative(x: np.ndarray, n_clusters: Optional[int] = 2, linkage: str = "ward",
                  distance_threshold: Optional[float] = None,
                  precomputed: bool = False) -> np.ndarray:
    """AgglomerativeClustering(n_clusters, linkage, distance_threshold,
    metric="precomputed" | "euclidean").fit_predict."""
    if not ((n_clusters is None) ^ (distance_threshold is None)):
        raise ValueError("Exactly one of n_clusters and distance_threshold has to be "
                         "set, and the other needs to be None.")
    x = np.asarray(x)
    if linkage == "ward":
        if precomputed:
            raise ValueError("precomputed was provided as metric. Ward can only work "
                             "with euclidean distances (i.e. 'euclidean' and 'l2').")
        out = hierarchy.ward(np.require(x, requirements="W"))
    elif linkage not in ("average", "complete", "single"):
        raise ValueError(f"Unknown linkage option {linkage!r}")
    elif precomputed:
        if x.shape[0] != x.shape[1]:
            raise ValueError(f"Distance matrix should be square, got matrix of shape "
                             f"{x.shape}")
        i, j = np.triu_indices(x.shape[0], k=1)
        out = hierarchy.linkage(x[i, j], method=linkage, metric="precomputed")
    else:
        if linkage == "single":
            raise NotImplementedError("single linkage on raw embeddings is not ported")
        out = hierarchy.linkage(x, method=linkage, metric="euclidean")
    children = out[:, :2].astype(np.intp)
    if distance_threshold is not None:
        n_clusters = int(np.count_nonzero(out[:, 2] >= distance_threshold)) + 1
    return _hc_cut(n_clusters, children, len(x))


def _hc_cut(n_clusters: int, children: np.ndarray, n_leaves: int) -> np.ndarray:
    if n_clusters > n_leaves:
        raise ValueError(f"Cannot extract more clusters than samples: {n_clusters} "
                         f"clusters were given for a tree with {n_leaves} leaves.")
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(n_clusters - 1):
        these = children[-nodes[0] - n_leaves]
        heappush(nodes, -these[0])
        heappushpop(nodes, -these[1])
    label = np.zeros(n_leaves, np.intp)
    for i, node in enumerate(nodes):
        stack, leaves = [-node], []
        while stack:
            k = stack.pop()
            if k < n_leaves:
                leaves.append(k)
            else:
                stack.extend(children[k - n_leaves])
        label[leaves] = i
    return label


# --- k-means (the mixture's initialisation) ----------------------------------------


def kmeans_labels(x: np.ndarray, n_clusters: int, rng: np.random.RandomState,
                  max_iter: int = 300, tol: float = 1e-4) -> np.ndarray:
    """KMeans(n_clusters, n_init=1, random_state=rng).fit(x).labels_ with
    k-means++ seeding and Lloyd's iterations."""
    x = np.array(x, order="C", copy=True)     # the layout decides the sums' rounding
    n_samples = x.shape[0]
    if n_samples < n_clusters:
        raise ValueError(f"n_samples={n_samples} should be >= n_clusters={n_clusters}.")
    tol = np.mean(np.var(x, axis=0)) * tol if tol else 0
    weight = np.ones(n_samples, dtype=x.dtype)
    x -= x.mean(axis=0)
    norms = np.einsum("ij,ij->i", x, x)
    centers = _kmeans_plusplus(x, n_clusters, norms, weight, rng)
    centers_new = np.zeros_like(centers)
    labels = np.full(n_samples, -1, np.int32)
    labels_old = labels.copy()
    weight_in = np.zeros(n_clusters, x.dtype)
    shift = np.zeros(n_clusters, x.dtype)
    strict = False
    for _ in range(max_iter):
        _lloyd_iter(x, weight, centers, centers_new, weight_in, labels, shift)
        centers, centers_new = centers_new, centers
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old[:] = labels
    if not strict:
        _lloyd_iter(x, weight, centers, centers, weight_in, labels, shift, update=False)
    return labels


def _kmeans_plusplus(x, n_clusters, norms, weight, rng):
    n_samples, n_features = x.shape
    centers = np.empty((n_clusters, n_features), dtype=x.dtype)
    n_local_trials = 2 + int(np.log(n_clusters))
    center_id = rng.choice(n_samples, p=weight / weight.sum())
    centers[0] = x[center_id]
    closest = _euclidean_sq_upcast(centers[0, np.newaxis], x)
    pot = closest @ weight
    for c in range(1, n_clusters):
        rand_vals = rng.uniform(size=n_local_trials) * pot
        cand = np.searchsorted(np.cumsum(weight * closest), rand_vals)
        np.clip(cand, None, closest.size - 1, out=cand)
        to_cand = _euclidean_sq_upcast(x[cand], x)
        np.minimum(closest, to_cand, out=to_cand)
        cand_pot = to_cand @ weight.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot = cand_pot[best]
        closest = to_cand[best]
        centers[c] = x[cand[best]]
    return centers


def _lloyd_iter(x, weight, centers_old, centers_new, weight_in, labels, shift,
                update=True, chunk=256):
    """One Lloyd step: labels from the old centres (first nearest on a tie),
    new centres as the float32 sums of their rows in row order, empty
    clusters moved to the farthest rows."""
    n_samples = x.shape[0]
    n_clusters = centers_old.shape[0]
    c_norms = np.einsum("ij,ij->i", centers_old, centers_old)
    if update:
        sums = np.zeros_like(centers_old)
        counts = np.zeros(n_clusters, x.dtype)
    for start in range(0, n_samples, chunk):
        xc = x[start:start + chunk]
        # norms - 2 x.c in one BLAS gemm call laid out as scikit-learn's
        # (row-major through the column-major interface), so the rounding
        # that breaks near-ties is the same
        gemm = blas.sgemm if x.dtype == np.float32 else blas.dgemm
        dist = np.empty((len(xc), n_clusters), x.dtype)
        dist[:] = c_norms
        dist = gemm(-2.0, centers_old.T, xc.T, beta=1.0, c=dist.T, trans_a=1,
                    overwrite_c=1).T
        lab = np.argmin(dist, axis=1).astype(np.int32)
        labels[start:start + chunk] = lab
        if update:
            part = np.zeros_like(centers_old)
            part_w = np.zeros(n_clusters, x.dtype)
            np.add.at(part_w, lab, weight[start:start + chunk])
            np.add.at(part, lab, xc * weight[start:start + chunk, None])
            counts += part_w
            sums += part
    if not update:
        return
    centers_new[:] = sums
    weight_in[:] = counts
    _relocate_empty(x, weight, centers_old, centers_new, weight_in, labels)
    argmax_w = np.argmax(weight_in)
    for j in range(n_clusters):
        if weight_in[j] > 0:
            centers_new[j] *= x.dtype.type(1.0) / weight_in[j]
        else:
            centers_new[j] = centers_new[argmax_w]
    shift[:] = np.sqrt(((centers_new - centers_old) ** 2).sum(axis=1))


def _relocate_empty(x, weight, centers_old, centers_new, weight_in, labels):
    empty = np.where(np.equal(weight_in, 0))[0].astype(np.int32)
    n_empty = empty.shape[0]
    if n_empty == 0:
        return
    distances = ((x - centers_old[labels]) ** 2).sum(axis=1)
    far = np.argpartition(distances, -n_empty)[:-n_empty - 1:-1].astype(np.int32)
    if np.max(distances) == 0:
        return
    for new_id, far_idx in zip(empty, far):
        w = weight[far_idx]
        old_id = labels[far_idx]
        centers_new[old_id] -= x[far_idx] * w
        centers_new[new_id] = x[far_idx] * w
        weight_in[new_id] = w
        weight_in[old_id] -= w


# --- the variational Gaussian mixture ---------------------------------------------


def bayesian_gmm(x: np.ndarray, rng: np.random.RandomState, n_components: int = 1,
                 max_iter: int = 100, tol: float = 1e-3, reg_covar: float = 1e-6,
                 weight_concentration_prior: Optional[float] = None) -> np.ndarray:
    """BayesianGaussianMixture(n_components, max_iter, weight_concentration_prior)
    .fit_predict(x) at scikit-learn's other defaults: full covariance, the
    Dirichlet-process prior, n_init 1, k-means initialisation."""
    x = np.asarray(x)
    n_samples, n_features = x.shape
    if n_samples < n_components:
        raise ValueError(f"Expected n_samples >= n_components but got n_components = "
                         f"{n_components}, n_samples = {n_samples}")
    prior = _GmmPrior(
        weight=1.0 / n_components if weight_concentration_prior is None
        else weight_concentration_prior,
        mean=x.mean(axis=0), dof=n_features, covariance=np.atleast_2d(np.cov(x.T)))
    resp = np.zeros((n_samples, n_components), dtype=x.dtype)
    resp[np.arange(n_samples), kmeans_labels(x, n_components, rng)] = 1
    state = _gmm_m_step(x, resp, prior, reg_covar)
    lower_bound = -np.inf
    for _ in range(max_iter):
        prev = lower_bound
        _, log_resp = _gmm_e_step(x, state)
        state = _gmm_m_step(x, np.exp(log_resp), prior, reg_covar)
        lower_bound = _gmm_lower_bound(state, log_resp, n_features)
        if abs(lower_bound - prev) < tol:
            break
    _, log_resp = _gmm_e_step(x, state)
    return log_resp.argmax(axis=1)


class _GmmPrior:
    def __init__(self, weight, mean, dof, covariance):
        self.weight, self.mean, self.dof, self.covariance = weight, mean, dof, covariance
        self.mean_precision = 1.0


def _gmm_m_step(x, resp, prior, reg_covar):
    """nk, xk, sk of the responsibilities, then the posterior parameters:
    (weight concentrations, mean precisions, means, degrees of freedom,
    precision Cholesky factors)."""
    n_features = x.shape[1]
    nk = np.sum(resp, axis=0) + 10 * np.finfo(resp.dtype).eps
    xk = (resp.T @ x) / nk[:, np.newaxis]
    sk = np.empty((len(nk), n_features, n_features), dtype=x.dtype)
    reg = np.asarray(reg_covar, dtype=x.dtype)
    for k in range(len(nk)):
        diff = x - xk[k, :]
        sk[k] = ((resp[:, k] * diff.T) @ diff) / nk[k]
        sk[k].flat[::n_features + 1] += reg
    concentration = (1.0 + nk,
                     prior.weight + np.hstack((np.cumsum(nk[::-1])[-2::-1], 0)))
    mean_precision = prior.mean_precision + nk
    means = (prior.mean_precision * prior.mean + nk[:, np.newaxis] * xk) / \
        mean_precision[:, np.newaxis]
    dof = prior.dof + nk
    cov = np.empty((len(nk), n_features, n_features))
    for k in range(len(nk)):
        diff = xk[k] - prior.mean
        cov[k] = (prior.covariance + nk[k] * sk[k]
                  + nk[k] * prior.mean_precision / mean_precision[k] * np.outer(diff, diff))
    cov /= dof[:, np.newaxis, np.newaxis]
    prec_chol = np.empty(cov.shape, dtype=cov.dtype)
    for k in range(len(nk)):
        try:
            chol = linalg.cholesky(cov[k], lower=True)
        except np.linalg.LinAlgError:
            raise ValueError(
                "Fitting the mixture model failed because some components have "
                "ill-defined empirical covariance (for instance caused by singleton "
                "or collapsed samples). Try to decrease the number of components, "
                "increase reg_covar, or scale the input data.")
        prec_chol[k] = linalg.solve_triangular(
            chol, np.eye(n_features, dtype=cov.dtype), lower=True).T
    return concentration, mean_precision, means, dof, prec_chol


def _log_det_chol(prec_chol, n_features):
    return np.sum(np.log(prec_chol.reshape(len(prec_chol), -1)[:, ::n_features + 1]), axis=1)


def _gmm_e_step(x, state):
    """(mean log-likelihood, log responsibilities)."""
    concentration, mean_precision, means, dof, prec_chol = state
    n_features = x.shape[1]
    log_prob = np.empty((x.shape[0], len(means)), dtype=x.dtype)
    for k in range(len(means)):
        y = (x @ prec_chol[k]) - (means[k] @ prec_chol[k])
        log_prob[:, k] = np.sum(np.square(y), axis=1)
    log_gauss = (-0.5 * (n_features * math.log(2 * math.pi) + log_prob)
                 + _log_det_chol(prec_chol, n_features)) - 0.5 * n_features * np.log(dof)
    log_lambda = n_features * np.log(2.0) + np.sum(
        digamma(0.5 * (dof - np.arange(0, n_features)[:, np.newaxis])), 0)
    log_prob = log_gauss + 0.5 * (log_lambda - n_features / mean_precision)
    digamma_sum = digamma(concentration[0] + concentration[1])
    log_weights = (digamma(concentration[0]) - digamma_sum
                   + np.hstack((0, np.cumsum(digamma(concentration[1]) - digamma_sum)[:-1])))
    weighted = log_prob + log_weights
    norm = _logsumexp_rows(weighted)
    with np.errstate(under="ignore"):
        log_resp = weighted - norm[:, np.newaxis]
    return np.mean(norm), log_resp


def _logsumexp_rows(a):
    """scikit-learn's _logsumexp(a, axis=1)."""
    a_max = np.max(a, axis=1, keepdims=True)
    is_max = a == a_max
    a = a.copy()
    a[is_max] = -np.inf
    m = np.sum(is_max.astype(a.dtype), axis=1, keepdims=True, dtype=a.dtype)
    shift = np.where(np.isfinite(a_max), a_max, 0)
    s = np.sum(np.exp(a - shift), axis=1, keepdims=True, dtype=a.dtype)
    s = np.where(s == 0, s, s / m)
    return np.squeeze(np.log1p(s) + np.log(m) + a_max, axis=1)


def _gmm_lower_bound(state, log_resp, n_features):
    concentration, mean_precision, _, dof, prec_chol = state
    log_det = _log_det_chol(prec_chol, n_features) - 0.5 * n_features * np.log(dof)
    log_wishart = np.sum(-(
        dof * log_det + dof * n_features * 0.5 * math.log(2.0)
        + np.sum(gammaln(0.5 * (dof - np.arange(n_features)[:, np.newaxis])), 0)))
    log_norm_weight = -np.sum(betaln(concentration[0], concentration[1]))
    return (-np.sum(np.exp(log_resp) * log_resp) - log_wishart - log_norm_weight
            - 0.5 * n_features * np.sum(np.log(mean_precision)))
