"""Speaker-embedding clustering (eval/clustering.py, eval/engines.py), port
against the JAX package on the CPU. The JAX package's engines are
scikit-learn's; the port's are numpy and scipy:

  * every engine x metric x PCA setting of `default_param_grid()` and every
    method x metric of `cli.wder` on seeded inputs of 2, 3, 8, 12 and 40 rows
    (blobs, duplicated rows, all-zero rows, plain noise): the same
    partition and cluster count as JAX's `cluster_embeddings`, or the same
    ValueError (PCA wider than the rows, a singular mixture); the Bayesian
    GMM from the same seed (np.random.seed for JAX, RandomState for the
    port), the grid's and the CLI's n_components;
  * `cosine_distance_matrix` and `pairwise_matrix` within 1e-6;
  * HDBSCAN with min_samples above the row count raises as JAX's does;
  * the engines alone against scikit-learn where JAX reaches them with
    other settings: DBSCAN's border points (first cluster in expansion
    order), HDBSCAN on exact duplicates, the agglomerative cut at a
    threshold, k-means labels from the same draws.
"""
import warnings

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from tal_asrd_tpu.eval import clustering as jc
from tal_asrd_tpu.eval.wder_search import default_param_grid
from tal_asrd_tpu_torch.eval import clustering as pc
from tal_asrd_tpu_torch.eval import engines

# (kind, rows): the inputs every configuration is held on, 24 wide
INPUTS = (("blobs", 40), ("dups", 12), ("zeros", 8), ("noise", 3),
          ("noise", 2))


def seeded(kind, n, d=24, seed=0):
    r = np.random.RandomState(seed + 7 * n + d)
    if kind == "blobs":
        centres = r.randn(4, d) * 3
        return (centres[r.randint(0, 4, n)] + r.randn(n, d) * 0.5).astype(np.float32)
    if kind == "dups":
        base = r.randn(max(2, n // 3), d).astype(np.float32)
        return base[r.randint(0, len(base), n)]
    x = r.randn(n, d).astype(np.float32)
    if kind == "zeros":
        x[::3] = 0
    return x


def grid_configs():
    """(method, metric, pca, kwargs) of default_param_grid() (kwargs None:
    the GMM's, sized from the rows) and of cli.wder's methods x metrics."""
    out = []
    for p in default_param_grid()[1:]:
        method, pca, metric = p[0], p[-2], p[-1]
        if method == "hdbscan":
            kw = {"min_cluster_size": p[1], "min_samples": p[2]}
        elif method == "dbscan":
            kw = {"eps": p[1], "min_samples": p[2]}
        elif method == "agg":
            method, kw = "agglomerative", {"n_clusters": None, "linkage": p[1],
                                           "distance_threshold": p[2]}
        else:
            kw = None
        out.append((method, metric, pca, kw))
    for method in ("hdbscan", "dbscan", "agglomerative", "gmm"):
        for metric in ("euclidean", "cos_sim", "cos_dist", "idp", "ndp"):
            out.append((method, metric, None, {}))
    return out


CONFIGS = grid_configs()


def same_partition(a, b):
    pairs = {}
    for x, y in zip(a, b):
        if pairs.setdefault(x, y) != y:
            return False
    return len(a) == len(b) and len(set(a)) == len(set(b))


def run(fn, x, method, metric, pca, kw):
    if kw is None:
        kw = {"n_components": min(100, len(x)), "max_iter": 400,
              "weight_concentration_prior": 1.0}
    try:
        return np.asarray(fn(x, method, metric, pca, kw)).tolist()
    except ValueError as e:
        return f"ValueError: {e}"


def jax_labels(x, method, metric, pca, kw):
    np.random.seed(2020)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jc.cluster_embeddings(x, method=method, metric=metric, pca_dims=pca, **kw)


def port_labels(x, method, metric, pca, kw):
    return pc.cluster_embeddings(x, method=method, metric=metric, pca_dims=pca,
                                 device="cpu", rng=np.random.RandomState(2020), **kw)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """Products of 40 rows: threads cost more than they give (both packages
    alike)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def jax_results():
    """JAX's labels (or error) for every configuration on every input."""
    return {(i, c): run(jax_labels, seeded(*inp), *CONFIGS[c])
            for i, inp in enumerate(INPUTS) for c in range(len(CONFIGS))}


@pytest.mark.parametrize("c", range(len(CONFIGS)),
                         ids=[f"{m}-{x}-pca{p}-{'grid' if k != {} else 'cli'}"
                              for m, x, p, k in CONFIGS])
def test_partitions_equal_jax(jax_results, c):
    for i, inp in enumerate(INPUTS):
        want = jax_results[(i, c)]
        got = run(port_labels, seeded(*inp), *CONFIGS[c])
        if isinstance(want, str) or isinstance(got, str):
            assert got == want, (inp, CONFIGS[c])
        else:
            assert same_partition(got, want), (inp, CONFIGS[c], got, want)
            assert len(set(got)) == len(set(want))


def test_the_configurations_cover_the_grid_and_the_cli():
    assert len(CONFIGS) == 28 + 20
    assert {m for m, *_ in CONFIGS} == {"hdbscan", "dbscan", "agglomerative", "gmm"}
    assert {p for _, _, p, _ in CONFIGS} == {None, 16}


@pytest.mark.parametrize("kind,n", [("blobs", 40), ("zeros", 8), ("dups", 12)])
def test_distance_matrices_within_1e6(kind, n):
    x = seeded(kind, n)
    np.testing.assert_allclose(pc.cosine_distance_matrix(x, "cpu"),
                               jc.cosine_distance_matrix(x), rtol=0, atol=1e-6)
    for name in ("cos_sim", "cos_dist", "idp", "ndp"):
        np.testing.assert_allclose(pc.pairwise_matrix(x, pc.METRICS[name]),
                                   jc.pairwise_matrix(x, jc.METRICS[name]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method,kw", [("hdbscan", {"min_samples": 5}),
                                       ("hdbscan", {"min_cluster_size": 4}),
                                       ("gmm", {"n_components": 5})])
def test_the_same_value_error_where_jax_raises(method, kw):
    x = seeded("noise", 3)
    with pytest.raises(ValueError) as want:
        jax_labels(x, method, "euclidean", None, kw)
    with pytest.raises(ValueError) as got:
        port_labels(x, method, "euclidean", None, kw)
    assert str(got.value).split(" (")[0][:20] == str(want.value).split(" (")[0][:20]


def test_pca_wider_than_the_rows_raises_as_jax():
    x = seeded("blobs", 8)
    with pytest.raises(ValueError, match="n_components=16 must be between 0 and"):
        jax_labels(x, "hdbscan", "euclidean", 16, {})
    with pytest.raises(ValueError, match="n_components=16 must be between 0 and"):
        port_labels(x, "hdbscan", "euclidean", 16, {})


def test_one_row_is_one_speaker_and_id_is_np_unique():
    x = seeded("dups", 40)
    assert pc.cluster_embeddings(x[:1], "gmm", device="cpu").tolist() == [0]
    np.testing.assert_array_equal(pc.cluster_embeddings(x, "id", device="cpu"),
                                  jc.cluster_embeddings(x, "id"))


def test_engines_against_scikit_learn_directly():
    from sklearn.cluster import DBSCAN, HDBSCAN, AgglomerativeClustering, KMeans
    x = seeded("blobs", 40, d=6)
    for eps, ms in ((0.8, 3), (1.2, 5), (2.0, 4)):
        np.testing.assert_array_equal(engines.dbscan(x, eps, ms),
                                      DBSCAN(eps=eps, min_samples=ms).fit_predict(x))
    dup = np.repeat(x[:10], 3, axis=0)
    for mcs, ms in ((2, 2), (3, 5), (5, None)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = HDBSCAN(min_cluster_size=mcs, min_samples=ms).fit_predict(dup)
        np.testing.assert_array_equal(engines.hdbscan(dup, mcs, ms), want)
    for link, t in (("average", 2.0), ("complete", 4.0), ("single", 1.0)):
        d = engines.euclidean_sequential(x)
        want = AgglomerativeClustering(n_clusters=None, metric="precomputed", linkage=link,
                                       distance_threshold=t).fit_predict(d)
        np.testing.assert_array_equal(
            engines.agglomerative(d, None, link, t, precomputed=True), want)
    for k in (3, 7):
        want = KMeans(k, n_init=1, random_state=np.random.RandomState(5)).fit(x).labels_
        np.testing.assert_array_equal(engines.kmeans_labels(x, k, np.random.RandomState(5)),
                                      want)
