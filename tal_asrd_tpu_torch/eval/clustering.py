"""Speaker-embedding clustering for the WDER search.

Counterpart of tal_asrd_tpu/eval/clustering.py: identity, Bayesian GMM,
HDBSCAN, DBSCAN and agglomerative clustering over euclidean, cosine,
inverse-dot and negative-dot metrics, with optional PCA. The cosine-distance
matrix is one [N, D] x [D, N] product on `device` (f32, TF32 off); the
engines run on the host in numpy and scipy (eval/engines.py), where the JAX
package runs scikit-learn's. A failing device call raises: there is no
numpy fallback.

The Bayesian GMM seeds its k-means from `rng`, a numpy RandomState drawn in
call order (numpy's global generator when None, which is where
scikit-learn draws from when it is given no random_state).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tal_asrd_tpu_torch.eval import engines


# --- pairwise metrics ----------------------------------------------------------

def cosine_similarity(x, y, **kw):
    return float(np.dot(x, y) / (np.linalg.norm(x) * np.linalg.norm(y) + 1e-8))


def cosine_distance(x, y, **kw):
    return 1.0 - cosine_similarity(x, y)


def inverse_dot_product(x, y, **kw):
    return float(1.0 / (np.dot(x, y) + 1e-8))


def neg_dot_product(x, y, **kw):
    return float(-np.dot(x, y))


METRICS = {
    "euclidean": None,  # the engine's own metric
    "cos_sim": cosine_similarity,
    "cos_dist": cosine_distance,
    "idp": inverse_dot_product,
    "ndp": neg_dot_product,
}


def cosine_distance_matrix(embeddings: np.ndarray, device="cuda") -> np.ndarray:
    """Pairwise cosine distances 1 - X^ X^T, the product on `device`."""
    x = np.asarray(embeddings, np.float32)
    xn = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-8)
    t = torch.from_numpy(xn).to(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sim = torch.matmul(t, t.T).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    d = 1.0 - sim
    np.fill_diagonal(d, 0.0)
    return np.maximum(d, 0.0)


def pairwise_matrix(embeddings: np.ndarray, metric: Callable) -> np.ndarray:
    """Precomputed distance matrix of a callable metric (diagonal 0)."""
    x = np.asarray(embeddings, np.float32)
    n = len(x)
    d = np.zeros((n, n), np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            d[i, j] = d[j, i] = metric(x[i], x[j])
    return d


# --- engines --------------------------------------------------------------------

def cluster_embeddings(
    embeddings: Sequence[np.ndarray],
    method: str = "hdbscan",
    metric: str = "euclidean",
    pca_dims: Optional[int] = None,
    device="cuda",
    rng: Optional[np.random.RandomState] = None,
    **kwargs,
) -> np.ndarray:
    """Speaker embeddings -> integer labels. The density methods' noise
    points (-1) each get a fresh label, so every utterance has a speaker."""
    x = np.asarray(list(embeddings), np.float32)
    if x.ndim == 1:
        x = x[:, None]
    if len(x) < 2:
        # every engine needs two samples: one utterance is one speaker
        return np.zeros(len(x), np.int64)
    if pca_dims and 0 < pca_dims < x.shape[1]:
        x = engines.pca_transform(x, pca_dims)

    if method == "id":
        # every distinct embedding row is its own cluster
        _, labels = np.unique(x, axis=0, return_inverse=True)
        return labels

    precomputed = None
    if metric == "cos_dist":
        precomputed = cosine_distance_matrix(x, device)
    elif metric in METRICS and METRICS[metric] is not None:
        precomputed = pairwise_matrix(x, METRICS[metric])
    pre = None if precomputed is None else precomputed - precomputed.min()

    kw = dict(kwargs)
    if method == "hdbscan":
        kw.setdefault("min_cluster_size", 2)
        labels = engines.hdbscan(x if pre is None else pre, precomputed=pre is not None, **kw)
    elif method == "dbscan":
        kw.setdefault("eps", 0.5)
        kw.setdefault("min_samples", 2)
        labels = engines.dbscan(x if pre is None else pre, precomputed=pre is not None, **kw)
    elif method == "agglomerative":
        if pre is not None:
            kw.setdefault("linkage", "average")
        labels = engines.agglomerative(x if pre is None else pre,
                                       precomputed=pre is not None, **kw)
    elif method == "gmm":
        kw.setdefault("n_components", min(8, len(x)))
        labels = engines.bayesian_gmm(x, np.random.mtrand._rand if rng is None else rng,
                                      **kw)
    else:
        raise ValueError(f"Unknown clustering method {method!r}")

    labels = np.asarray(labels)
    if (labels == -1).any():
        nxt = labels.max() + 1
        for i in np.where(labels == -1)[0]:
            labels[i] = nxt
            nxt += 1
    return labels


def make_cluster_fn(method: str, metric: str = "euclidean",
                    pca_dims: Optional[int] = None, device="cuda",
                    rng: Optional[np.random.RandomState] = None, **kwargs):
    """A cluster_fn for eval/wder.py: cluster_embeddings with these settings
    (a call's own keywords win). A partial, so that worker processes can
    take it."""
    return functools.partial(cluster_embeddings, method=method, metric=metric,
                             pca_dims=pca_dims, device=device, rng=rng, **kwargs)
