"""The WDER grid search (eval/wder_search.py) and the clustered WDER
(eval/wder.py), port against the JAX package on the CPU, on seeded
wder-ready pairs (blob embeddings a speaker, some hyp words changed, a
missing embedding filled forward and one at a segment's end filled with
zeros):

  * get_word_speakers, get_wder_edits and get_wder (optimal assignment and
    role-based) equal;
  * wder_segment_grid and corpus_wder_map over `default_param_grid()` equal
    row for row (the Bayesian GMM from np.random.seed(2020) / RandomState
    (2020), one generator through every segment in order), plain and
    role-based with a role map;
  * convert_to_wder_format / corpus_wder with clustering equal;
  * ROADMAP C20: a segment of fewer than 16 unique embeddings stops the
    grid at its PCA-16 leg in both packages; C22: the GMM on fewer rows
    than they are wide raises in both;
  * workers=2 gives workers=1's rows for the deterministic engines;
  * apply_embed_head within 1e-5 on the same head tree (one batch a segment
    in the port, a row at a time in JAX), token embeddings too;
  * mean_utterance_embeddings, normalize_lower_no_punct and
    majority_vote_token_clusters equal.
"""
import os
import warnings

import numpy as np
import pytest

import tal_asrd_tpu.eval.wder as jw
import tal_asrd_tpu.eval.wder_search as jws
import tal_asrd_tpu_torch.eval.wder as pw
import tal_asrd_tpu_torch.eval.wder_search as pws
from tal_asrd_tpu.eval.clustering import make_cluster_fn as j_make
from tal_asrd_tpu_torch.core.checkpoint import save_pytree
from tal_asrd_tpu_torch.eval.clustering import make_cluster_fn as p_make

WORDS = ("so", "the", "story", "began", "when", "we", "left", "town", "and", "never",
         "looked", "back", "right", "okay")
ROLES = ("host", "interviewer", "subject")
DETERMINISTIC = [p for p in jws.default_param_grid() if p[0] != "gmm"]


def seeded_pairs(n_seg=2, n_utt=24, d=20, n_spk=4, seed=0, spread=0.6):
    r = np.random.RandomState(seed)
    centres = r.randn(n_spk, d) * 2
    pairs = []
    for s in range(n_seg):
        refs, hyps = [], []
        for u in range(n_utt):
            spk = int(r.randint(n_spk))
            words = list(r.choice(WORDS, r.randint(2, 7)))
            refs.append((" ".join(words), f"spk{spk}", ROLES[spk % 3]))
            if r.rand() < 0.3:
                words[r.randint(len(words))] = "uh"
            emb = (centres[spk] + r.randn(d) * spread).astype(np.float32)
            if u == 5 or (s == 1 and u == n_utt - 1):
                emb = None
            sid = spk if r.rand() > 0.2 else (spk + 1) % n_spk
            hyps.append((" ".join(words), (emb, int(sid)), "subject"))
        pairs.append((refs, hyps))
    return pairs


def jax_map(pairs, grid, **kw):
    np.random.seed(2020)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jws.corpus_wder_map(pairs, grid, workers=1, **kw)


def port_map(pairs, grid, workers=1, **kw):
    return pws.corpus_wder_map(pairs, grid, workers=workers, device="cpu",
                               rng=np.random.RandomState(2020), **kw)


@pytest.fixture(scope="module")
def pairs():
    return seeded_pairs()


@pytest.fixture(scope="module")
def jax_rows(pairs):
    return jax_map(pairs, jws.default_param_grid())


def test_word_speakers_edits_and_wder_equal(pairs):
    role_map = {0: "host", 1: "interviewer"}
    for refs, hyps in pairs:
        for kw in ({"is_ref": True}, {"embeddings": True}, {"embeddings": False},
                   {"role_based": True, "role_map": role_map}):
            us = refs if kw.get("is_ref") else hyps
            j, p = jws.get_word_speakers(us, **kw), pws.get_word_speakers(us, **kw)
            assert j == p
        rw, rs, rr, _, _ = pws.get_word_speakers(refs, is_ref=True)
        hw, hs, hr, _, _ = pws.get_word_speakers(hyps)
        edits = pws.get_wder_edits(rw, hw)
        assert edits == jws.get_wder_edits(rw, hw)
        assert pws.get_wder(edits, rs, hs, rr) == jws.get_wder(edits, rs, hs, rr)
        assert pws.get_wder(edits, rr, hr, rr, optimize_assignments=False) == \
            jws.get_wder(edits, rr, hr, rr, optimize_assignments=False)


def test_corpus_wder_map_rows_equal(pairs, jax_rows):
    rows = port_map(pairs, pws.default_param_grid())
    assert len(rows) == len(jws.default_param_grid())
    assert rows == jax_rows


def test_wder_segment_grid_and_role_based_rows_equal(pairs):
    role_map = {0: "host", 1: "interviewer", 2: "subject"}
    grid = DETERMINISTIC[:8]
    refs, hyps = pairs[0]
    assert pws.wder_segment_grid(0, refs, hyps, grid, device="cpu") == \
        jws.wder_segment_grid(0, refs, hyps, grid)
    assert port_map(pairs, grid, role_based=True, role_map=role_map) == \
        jax_map(pairs, grid, role_based=True, role_map=role_map)


@pytest.mark.parametrize("method,metric", [("agglomerative", "cos_dist"), ("gmm", "euclidean"),
                                           ("hdbscan", "idp"), ("dbscan", "ndp")])
def test_clustered_corpus_wder_equal(pairs, method, metric):
    np.random.seed(2020)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jw.corpus_wder(pairs, should_cluster=True, cluster_fn=j_make(method, metric))
    got = pw.corpus_wder(pairs, should_cluster=True, cluster_fn=p_make(
        method, metric, device="cpu", rng=np.random.RandomState(2020)))
    assert got[2:] == want[2:]
    assert [np.asarray(h).tolist() for h in got[1]] == [np.asarray(h).tolist()
                                                        for h in want[1]]


def test_c20_fewer_than_16_unique_embeddings_stop_the_grid_in_both():
    small = seeded_pairs(n_seg=1, n_utt=10, seed=3)
    with pytest.raises(ValueError, match="n_components=16") as want:
        jax_map(small, jws.default_param_grid())
    with pytest.raises(ValueError, match="n_components=16") as got:
        port_map(small, pws.default_param_grid())
    assert str(got.value) == str(want.value)


def test_c22_the_gmm_on_fewer_rows_than_wide_raises_in_both():
    """20 rows 64 wide, as an episode's rows of the 1x model's speaker
    embeddings: one component a row, a singular covariance prior."""
    narrow = seeded_pairs(n_seg=1, n_utt=20, d=64, seed=4)
    grid = [("gmm", 1.0, None, "euclidean")]
    with pytest.raises(ValueError, match="ill-defined empirical covariance"):
        jax_map(narrow, grid)
    with pytest.raises(ValueError, match="ill-defined empirical covariance"):
        port_map(narrow, grid)


def test_workers_2_give_workers_1_rows(pairs):
    grid = DETERMINISTIC
    assert port_map(pairs, grid, workers=2) == port_map(pairs, grid, workers=1)
    fn = p_make("hdbscan", "cos_dist", device="cpu")
    two, one = (pw.corpus_wder(pairs, workers=w, should_cluster=True, cluster_fn=fn)
                for w in (2, 1))
    assert repr(two) == repr(one)


def test_apply_embed_head_within_1e5(pairs, tmp_path):
    r = np.random.RandomState(7)
    tree = {f"Dense_{i}": {"kernel": (r.randn(a, b) / np.sqrt(a)).astype(np.float32),
                           "bias": (r.randn(b) * 0.1).astype(np.float32)}
            for i, (a, b) in enumerate(((20, 256), (256, 256), (256, 10)))}
    path = os.path.join(tmp_path, "head.msgpack")
    save_pytree(path, tree)
    tokens = [(pairs[0][0], [("a b", (r.randn(3, 20).astype(np.float32), 1), "subject")])]
    for case in (pairs, tokens):
        want, got = jws.apply_embed_head(case, path), pws.apply_embed_head(case, path, "cpu")
        for (_, jh), (_, ph) in zip(want, got):
            for j, p in zip(jh, ph):
                assert (j[0], j[1][1], j[2:]) == (p[0], p[1][1], p[2:])
                if j[1][0] is None:
                    assert p[1][0] is None
                else:
                    np.testing.assert_allclose(p[1][0], j[1][0], rtol=0, atol=1e-5)


def test_helpers_equal(pairs):
    hyps = pairs[0][1] + [("x y", (np.ones((3, 4), np.float32), 2), "host"), ("z", 5, "h")]
    for j, p in zip(jws.mean_utterance_embeddings(hyps), pws.mean_utterance_embeddings(hyps)):
        assert repr(j) == repr(p)
    for text in ("Hello, World! It's 3 o'clock.", "UH -- okay?"):
        assert pws.normalize_lower_no_punct(text) == jws.normalize_lower_no_punct(text)
    labels, counts = [3, 3, 1, 2, 2, 2, 0], [3, 0, 4]
    assert pws.majority_vote_token_clusters(labels, counts) == \
        jws.majority_vote_token_clusters(labels, counts)
