"""The alignment package (tal_asrd_tpu_torch/align) against the JAX
package's on the CPU, in float32: the DTW's accumulated cost and path, the
MFCCs, the word groups, the attention matrix and the forced aligner on a
tiny converted model (with `full_force_align`'s resume), and the tracked
checkpoint's alignments against tests/fixtures/torch_align_reference*."""
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.align import dtw as jdtw
from tal_asrd_tpu.align import forced as jforced
from tal_asrd_tpu.align.mfcc import dct_matrix as jdct_matrix
from tal_asrd_tpu.align.mfcc import mfcc as jmfcc
from tal_asrd_tpu.core.config import FrontendConfig as JFrontendConfig
from tal_asrd_tpu_torch.align import dtw, forced
from tal_asrd_tpu_torch.align.mfcc import dct_matrix, mfcc
from tal_asrd_tpu_torch.core.config import FrontendConfig
from tal_asrd_tpu_torch.eval import convert
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
from tests.synthetic_corpus import build_tokenizer
from tests.test_torch_helpers import tiny_model_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_REL_TOL = 1e-6


def _cost(n, m, seed, integer=False):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, (n, m)) if integer else rng.random((n, m)) * 5
    return c.astype(np.float32)


def first_parting_gap(d, path_a, path_b):
    """Where two backtraces over D part (walking from the end), the gap
    between the D values each chose, over their size; 0 if they never part."""
    a, b = path_a[::-1], path_b[::-1]
    for (i, j), pa, pb in zip(a, a[1:], b[1:]):
        if pa != pb:
            return abs(float(d[pa]) - float(d[pb])) / max(abs(float(d[pa])), 1e-30)
    return 0.0


@pytest.mark.parametrize("n,m", [(1, 1), (1, 6), (6, 1), (3, 7), (9, 4), (30, 200)])
def test_dtw_cost_matrix_and_path_match_jax(n, m):
    """The wavefront's D within 1e-6 of the largest of JAX's row scan (row 0
    is each framework's cumsum); the path equal, or parting only where the
    two options lie within 1e-6 (a witnessed tie); on integer costs (exact
    sums, many ties) D and the path are equal to the bit."""
    cost = _cost(n, m, n * m)
    want = np.asarray(jdtw.dtw_cost_matrix(jnp.asarray(cost)))
    got = dtw.dtw_cost_matrix(torch.from_numpy(cost)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= D_REL_TOL * np.abs(want).max()
    pa, pb = dtw.dtw_path(cost, "cpu"), jdtw.dtw_path(cost)
    assert pa == pb or first_parting_gap(want, pa, pb) <= D_REL_TOL
    icost = _cost(n, m, n + m, integer=True)
    assert np.array_equal(dtw.dtw_cost_matrix(torch.from_numpy(icost)).numpy(),
                          np.asarray(jdtw.dtw_cost_matrix(jnp.asarray(icost))))
    assert dtw.dtw_path(icost, "cpu") == jdtw.dtw_path(icost)
    assert dtw.monotonic_segmentation(icost, "cpu") == jdtw.monotonic_segmentation(icost)


def test_dtw_known_values():
    cost = np.array([[1.0, 2.0], [3.0, 1.0]], np.float32)
    assert dtw.dtw_cost_matrix(torch.from_numpy(cost)).tolist() == [[1, 3], [4, 2]]
    eye = np.ones((4, 4), np.float32)
    np.fill_diagonal(eye, 0.0)
    assert dtw.dtw_path(eye, "cpu") == [(i, i) for i in range(4)]


def test_mfcc_matches_jax():
    """The DCT basis equal; MFCCs of 1 s of audio (the production frontend,
    K2's plain version on the CPU) within 1e-4 of JAX's, and at a small
    frontend configuration."""
    assert np.array_equal(dct_matrix(80, 13), jdct_matrix(80, 13))
    audio = (np.random.default_rng(0).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    for kw in ({}, dict(n_mels=8, n_fft=64, win_length=64, hop_length=32)):
        want = np.asarray(jmfcc(jnp.asarray(audio), JFrontendConfig(**kw), n_mfcc=5))
        got = mfcc(torch.from_numpy(audio), FrontendConfig(**kw), n_mfcc=5).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_token_word_groups_match_jax_and_serve_convert():
    tok = BpeTokenizer(model_path=os.path.join(ROOT, "accuracy_release", "bpe.model"))
    from tal_asrd_tpu.text import BpeTokenizer as JBpeTokenizer
    jtok = JBpeTokenizer(model_path=os.path.join(ROOT, "accuracy_release", "bpe.model"))
    for text in ("the quick brown fox", "a", "hello there, world: again"):
        ids = tok.encode(text, bos_token=False, eos_token=False)
        assert forced.token_word_groups(tok, ids) == jforced.token_word_groups(jtok, ids)
    assert convert.token_word_groups is forced.token_word_groups


@pytest.fixture(scope="module")
def tiny_world(tmp_path_factory):
    """A tiny corpus (2 episodes of 10 s), its tokenizer and the tiny model
    pair (seeded weights, converted)."""
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    root = tmp_path_factory.mktemp("align")
    jtok = build_tokenizer(str(root), vocab_size=60)
    tok = BpeTokenizer(model_path=str(root / "bpe.model"))
    data = str(root / "data")
    build_synth_corpus(data, n_episodes=2, episode_seconds=10.0, n_speakers=2, seed=3)
    jmodel, variables, tmodel = tiny_model_pair(seed=2, vocab_size=len(tok))
    return {"root": root, "data": data, "tok": tok, "jtok": jtok, "jmodel": jmodel,
            "variables": variables, "tmodel": tmodel}


def test_attention_alignment_matrix_matches_jax(tiny_world):
    w = tiny_world
    audio = (np.random.default_rng(1).standard_normal(24000) * 0.1).astype(np.float32)
    ids = w["tok"].encode("the quick brown fox", bos_token=False, eos_token=False)
    want = jforced.attention_alignment_matrix(w["jmodel"], w["variables"], audio, ids)
    got = forced.attention_alignment_matrix(w["tmodel"], audio, ids)
    assert got.shape == want.shape == (len(ids), want.shape[1]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_full_force_align_matches_jax_and_resumes(tiny_world, tmp_path):
    """full_force_align over the tiny corpus: every utterance's word
    alignments equal JAX's; with episode 1 removed from the output, a second
    run aligns episode 1 alone and writes the same file."""
    w = tiny_world
    out = str(tmp_path / "aligned.pkl")
    got = forced.full_force_align(w["tmodel"], w["tok"], w["data"], out)
    want = jforced.full_force_align(w["jmodel"], w["variables"], w["jtok"], w["data"],
                                    str(tmp_path / "jax.pkl"))
    assert got.keys() == want.keys() == {"ep0", "ep1"}
    n_words = 0
    for stub in got:
        for u, v in zip(got[stub], want[stub]):
            assert u["utterance"] == v["utterance"]
            assert len(u["alignments"]) == len(v["alignments"]) > 0
            np.testing.assert_allclose(np.asarray(u["alignments"], float),
                                       np.asarray(v["alignments"], float), rtol=0, atol=1e-9)
            n_words += len(u["alignments"])
    assert n_words > 5
    with open(out, "rb") as f:
        first = pickle.load(f)
    with open(out, "wb") as f:
        pickle.dump({"ep0": first["ep0"]}, f)
    seen = []
    real = forced.align_episode
    forced.align_episode = lambda *a, **k: seen.append(a[3]) or real(*a, **k)
    try:
        again = forced.full_force_align(w["tmodel"], w["tok"], w["data"], out)
    finally:
        forced.align_episode = real
    assert seen == ["ep1"] and again.keys() == first.keys()
    with open(out, "rb") as f:
        assert pickle.load(f)["ep1"] == first["ep1"]


def test_tracked_checkpoint_alignments_equal_the_jax_fixture(tmp_path):
    """The tracked checkpoint in f32 over the fixture's utterances of the
    test split's episode 0: the attention within 1e-4 of JAX's and the word
    alignments equal (tests/fixtures/torch_align_reference*)."""
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree
    from tal_asrd_tpu_torch.core.config import ModelConfig
    from tal_asrd_tpu_torch.core.convert import load_into
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.models.asr import ASRModel

    with open(os.path.join(ROOT, "tests", "fixtures", "torch_align_reference.json")) as f:
        fx = json.load(f)
    arrays = np.load(os.path.join(ROOT, "tests", "fixtures", "torch_align_reference_arrays.npz"))
    tok = BpeTokenizer(model_path=os.path.join(ROOT, fx["tokenizer"]))
    model = ASRModel(ModelConfig(model_type="1x", num_speakers=8, vocab_size=len(tok)),
                     dtype=torch.float32, device="cpu")
    load_into(model, load_pytree(os.path.join(ROOT, fx["checkpoint"])))
    split = str(tmp_path / "test")
    utts = build_synth_corpus(split, **dict(fx["split"], n_episodes=1))["ep0"]
    rows = fx["utterances"]
    out = forced.align_episode(model, tok, split, "ep0", utts[:len(rows)])
    from tal_asrd_tpu_torch.data.audio_io import load_audio_segment
    for i, (u, want) in enumerate(zip(out, rows)):
        assert u["utterance"] == want["utterance"]
        audio = load_audio_segment(os.path.join(split, "ep0.wav"), u["utterance_start"],
                                   u["utterance_end"])
        attn = forced.attention_alignment_matrix(model, audio, want["token_ids"])
        assert np.abs(attn - arrays[f"attn/{i}"]).max() <= 1e-4
        assert [list(map(float, a[:2])) + [int(a[2])] for a in u["alignments"]] == \
            want["alignments"]
