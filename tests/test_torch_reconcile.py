"""The reconciliation of a separate ASR system with the separate SD system:
every function of the port's baseline/reconcile.py against the JAX
package's, and `cli.tools wder-format --sd-features` on the features the
tiny SD model writes, against the JAX tool."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.baseline import SDSystem as JSDSystem
from tal_asrd_tpu.baseline import reconcile as jrec
from tal_asrd_tpu.cli.tools import main as jax_tools
from tal_asrd_tpu.cli.wder import main as jax_wder
from tal_asrd_tpu.core.config import FrontendConfig as JFrontendConfig
from tal_asrd_tpu.core.config import SDModelConfig as JSDModelConfig
from tal_asrd_tpu_torch.baseline import SDSystem
from tal_asrd_tpu_torch.baseline import reconcile as rec
from tal_asrd_tpu_torch.cli.tools import main as port_tools
from tal_asrd_tpu_torch.cli.wder import main as port_wder
from tal_asrd_tpu_torch.core.config import FrontendConfig, SDModelConfig

from tests.test_torch_helpers import seeded_like, to_numpy_tree

MODEL = dict(num_speakers=12, n_mels=8, dropout=0.0, embed_size=16, tds_depths=(1, 1, 1),
             tds_kernel=5)
FRONTEND = dict(n_mels=8, n_fft=64, win_length=64, hop_length=32)
UTTS = [  # overlapping, touching, a gap, one past every frame
    {"utterance_start": 0.0, "utterance_end": 1.0, "speaker": "a"},
    {"utterance_start": 0.9, "utterance_end": 2.0, "speaker": "b"},
    {"utterance_start": 2.0, "utterance_end": 2.6, "speaker": "c"},
    {"utterance_start": 3.5, "utterance_end": 4.0, "speaker": 7},
    {"utterance_start": 99.0, "utterance_end": 100.0, "speaker": "z"},
]


@pytest.mark.parametrize("n_frames,hop,rf", [(60, 0.08, 1.41), (7, 0.5, 0.2), (0, 0.08, 1.41)])
def test_frame_gold_speakers(n_frames, hop, rf):
    got = rec.frame_gold_speakers(UTTS, n_frames, hop, rf)
    want = jrec.frame_gold_speakers(UTTS, n_frames, hop, rf)
    assert got.dtype == want.dtype == object and got.tolist() == want.tolist()
    if n_frames == 60:
        assert {-1, "a", "b", "c", 7} <= set(got.tolist())


@pytest.mark.parametrize("start,end", [(0.0, 0.0), (0.0, 0.05), (0.079, 0.161), (1.2, 3.4),
                                       (10.0, 9.0), (0.16, 0.16)])
def test_utterance_frame_span(start, end):
    assert rec.utterance_frame_span(start, end) == jrec.utterance_frame_span(start, end)


@pytest.mark.parametrize("features", [True, False])
def test_merge_asr_sd(features):
    """Majority ties (the smallest id wins), spans cut to the track, a span
    past its end clamped to its last frame, an empty track, None features,
    the role map and its "subject" default."""
    ids = np.array([3, 3, 1, 1, 2, 2, 2, 5, 5, 0])
    feats = np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32) \
        if features else None
    hyps = [{"utterance": "tie", "utterance_start": 0.0, "utterance_end": 0.33},
            {"utterance": "major", "utterance_start": 0.16, "utterance_end": 0.6},
            {"utterance": "past", "utterance_start": 2.0, "utterance_end": 3.0},
            {"utterance": "tail", "utterance_start": 0.7, "utterance_end": 5.0},
            {"utterance": "zero", "utterance_start": 0.0, "utterance_end": 0.0}]
    role_map = {2: "host", 5: "interviewer"}
    for args in ((hyps, ids, feats, role_map), (hyps, ids, feats), (hyps, ids[:0], feats)):
        got, want = rec.merge_asr_sd(*args), jrec.merge_asr_sd(*args)
        assert len(got) == len(want) == len(hyps)
        for (t, (e, s), r), (jt, (je, js), jr) in zip(got, want):
            assert (t, s, r) == (jt, js, jr)
            assert (e is None) == (je is None)
            if e is not None:
                assert e.tobytes() == je.tobytes()
    assert rec.merge_asr_sd(hyps, ids)[0][1][1] == 1


@pytest.fixture(scope="module")
def systems():
    """The JAX SDSystem (f32) on a seeded tiny tree and the port's holding it."""
    jsys = JSDSystem(JSDModelConfig(**MODEL), frontend_cfg=JFrontendConfig(**FRONTEND),
                     dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jsys.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4000)), jnp.array([4000]), train=False))
    params = to_numpy_tree(seeded_like(shapes["params"], 5))
    port = SDSystem(SDModelConfig(**MODEL), frontend_cfg=FrontendConfig(**FRONTEND),
                    compute_dtype=torch.float32, device="cpu")
    port.load_params(params)
    return jsys, params, port


@pytest.fixture(scope="module")
def dumped(systems, tmp_path_factory):
    """Both packages' dump_episode_features of one episode of 38400 samples
    (1201 log-mel frames at the tiny frontend, 147 encoder frames)."""
    jsys, params, port = systems
    audio = (np.random.default_rng(2).standard_normal(4800 * 8) * 0.1).astype(np.float32)
    utts = [{"utterance_start": 0.2, "utterance_end": 1.1, "speaker": "a"},
            {"utterance_start": 1.0, "utterance_end": 1.6, "speaker": "b"}]
    root = tmp_path_factory.mktemp("dump")
    want = jrec.dump_episode_features(jsys, params, audio, utts, str(root / "jax"), "ep0")
    got = rec.dump_episode_features(port, audio, utts, str(root / "port"), "ep0")
    return got, want


def test_dump_episode_features_writes_the_same_three_files(dumped):
    """<stub>.sd_features.npy within 1e-5, <stub>.sd_ids.npy and
    <stub>.gold_speakers.pkl equal."""
    got, want = dumped
    assert {k: os.path.basename(v) for k, v in got.items()} == \
        {k: os.path.basename(v) for k, v in want.items()}
    feats, jfeats = np.load(got["features"]), np.load(want["features"])
    assert feats.dtype == jfeats.dtype == np.float32 and feats.shape == jfeats.shape
    assert feats.shape[0] > 10
    np.testing.assert_allclose(feats, jfeats, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.load(got["pred_ids"]), np.load(want["pred_ids"]))
    with open(got["gold"], "rb") as f, open(want["gold"], "rb") as g:
        assert pickle.load(f).tolist() == pickle.load(g).tolist()


def test_wder_format_on_real_sd_features(dumped, tmp_path):
    """An unaligned test_result.pkl (attention over a chunk of 6 encoder
    frames, chunk starts running past the features' end) through both
    tools' wder-format with the JAX SD dump's features: the same pairs,
    embeddings within 1e-5; both cli.wder score them alike."""
    _, want = dumped
    feats = np.load(want["features"])
    rng = np.random.default_rng(4)

    def hyp(text, n_tok, sid, first):
        att = rng.random((n_tok, 6)).astype(np.float32)
        return {"utterance": text, "speakerId": sid, "attention": att / att.sum(1, keepdims=True),
                "chunkStart": np.minimum(first + np.arange(n_tok) // 2, len(feats) - 2),
                "utteranceTokens": list(range(n_tok))}

    results = [([{"utterance": "one two", "speaker": "a", "role": "host"},
                 {"utterance": "three", "speaker": "b"}],
                [hyp("one two", 5, 1, 0), hyp("three", 3, 2, len(feats) - 3)]),
               ([{"utterance": "four", "speaker": "a"}], [hyp("four", 4, 1, 4)])]
    path = tmp_path / "test_result.pkl"
    with open(path, "wb") as f:
        pickle.dump(results, f)
    outs = {}
    for name, tools, extra in (("jax", jax_tools, []), ("port", port_tools, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.pkl")
        tools(["wder-format", "--test-result", str(path), "--out", out, "--sd-features",
               want["features"], "--chunk", "6"] + extra)
        with open(out, "rb") as f:
            outs[name] = pickle.load(f)
    assert len(outs["port"]) == len(outs["jax"]) == 2
    for (refs, hyps), (jrefs, jhyps) in zip(outs["port"], outs["jax"]):
        assert refs == jrefs
        for (t, (e, s), r), (jt, (je, js), jr) in zip(hyps, jhyps):
            assert (t, s, r) == (jt, js, jr) and e.shape == je.shape == (len(e), 16)
            np.testing.assert_allclose(e, je, rtol=0, atol=1e-5)
    # each utterance holds its tokens' window embeddings [n_tok, 16]: both
    # packages' clustering stacks one row an utterance and raises on them
    # (ROADMAP C27); without --cluster both score the machine's speaker ids
    for name, wder_main, extra in (("jax", jax_wder, []), ("port", port_wder, ["--device", "cpu"])):
        argv = ["--eval-file", str(tmp_path / f"{name}.pkl"), "--workers", "1"] + extra
        with pytest.raises(ValueError, match="inhomogeneous"):
            wder_main(argv + ["--cluster", "--cluster-method", "agglomerative",
                              "--metric", "cos_dist"])
        wder_main(argv)
    with open(tmp_path / "jax-wder.pkl", "rb") as f, open(tmp_path / "port-wder.pkl", "rb") as g:
        jfields, fields = pickle.load(f), pickle.load(g)
    assert fields["overall_wder"] == jfields["overall_wder"]
    assert fields["overall_wer"] == jfields["overall_wer"]


def test_a_bf16_dump_writes_float32_features(systems, tmp_path):
    """With bf16 compute (SDSystem's default) the port's dump holds float32
    features that wder-format reads; the JAX package's holds bfloat16,
    which np.save writes as raw 2-byte records (|V2) that np.load cannot
    turn back into numbers (ROADMAP C26)."""
    jsys32, params, _ = systems
    audio = (np.random.default_rng(3).standard_normal(16000) * 0.1).astype(np.float32)
    port = SDSystem(SDModelConfig(**MODEL), frontend_cfg=FrontendConfig(**FRONTEND),
                    device="cpu")
    port.load_params(params)
    got = rec.dump_episode_features(port, audio, [], str(tmp_path / "port"), "ep")
    assert np.load(got["features"]).dtype == np.float32
    jsys = JSDSystem(JSDModelConfig(**MODEL), frontend_cfg=JFrontendConfig(**FRONTEND))
    want = jrec.dump_episode_features(jsys, params, audio, [], str(tmp_path / "jax"), "ep")
    assert np.load(want["features"]).dtype == np.dtype("V2")
