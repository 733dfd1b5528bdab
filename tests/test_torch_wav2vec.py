"""The wav2vec-style extractor (tal_asrd_tpu_torch/diarization/wav2vec.py)
against the JAX package's on the CPU, in float32, at full width (512
channels, 5 + 9 convolutions), from converted trees: the forward, the
fairseq converter and its layout checks, the plan, the window means, the
corpus extraction with its resume, and `diar-features --features wav2vec`
against the JAX CLI's pickle in tests/fixtures/torch_diar_reference*."""
import contextlib
import importlib.util
import io
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tal_asrd_tpu.diarization import wav2vec as jw2v
from tal_asrd_tpu_torch.cli import tools
from tal_asrd_tpu_torch.core.checkpoint import save_pytree
from tal_asrd_tpu_torch.diarization import wav2vec as w2v

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-4


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "torch_diar_reference", os.path.join(ROOT, "scripts", "torch_diar_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_model():
    """JAX's extractor, its init tree and its jitted forward."""
    model, variables = jw2v.init_wav2vec(0)
    return model, variables, jax.jit(model.apply)


@pytest.fixture(scope="module")
def seeded_tree(jax_model):
    """The fixture's seeded fairseq state dict through JAX's converter."""
    sd = _reference_script().seeded_fairseq_state_dict()
    return sd, jw2v.convert_fairseq_weights(sd, jax_model[1])


def _audio(n, seed=0):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("n", [16000, 24000 + 123, 470])
def test_forward_matches_jax_from_the_init_tree(jax_model, n):
    """JAX's own initial tree, converted: [frames, 512] within 1e-4 of the
    largest value (flax's GroupNorm takes E[x^2] - E[x]^2, F.group_norm
    another order), at 1 s, at a length that is no multiple of the hop, and
    at 470 samples (one frame)."""
    model, variables, fwd = jax_model
    a = _audio(n)
    want = np.asarray(fwd(variables, jnp.asarray(a)[None])[0])
    port = w2v.load_wav2vec(jax.tree_util.tree_map(np.asarray, variables["params"]), "cpu")
    got = w2v.extract_utterance_features(port, a, window_s=None)
    assert got.shape == want.shape == (1 + ((n - 465) // 160 if n >= 465 else -1), 512)
    assert _rel(got, want) <= REL_TOL


def test_too_short_for_a_frame_gives_no_frame(jax_model):
    """Under 465 samples no VALID window fits the last extractor
    convolution: no frame in either package (F.conv1d alone would raise)."""
    model, variables, fwd = jax_model
    a = _audio(464)
    want = np.asarray(fwd(variables, jnp.asarray(a)[None])[0])
    port = w2v.load_wav2vec(jax.tree_util.tree_map(np.asarray, variables["params"]), "cpu")
    got = w2v.extract_utterance_features(port, a, window_s=None)
    assert got.shape == want.shape == (0, 512)


def test_fairseq_converter_and_plan_match_jax(seeded_tree, jax_model):
    """The converter maps the seeded fairseq layout (dropout and padding
    modules shifting the block indices) to JAX's tree bit for bit,
    zero-filling the convolutions' biases; a missing leaf and a shape drift
    fail in both; the plans equal JAX's."""
    sd, want = seeded_tree
    _, variables = w2v.init_wav2vec(device="cpu")
    got = w2v.convert_fairseq_weights(sd, variables)
    flat = lambda t: {"/".join(str(k.key) for k in p): np.asarray(v)
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(got), flat(want)
    assert a.keys() == b.keys() and all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert not a["feature_aggregator/conv_3/bias"].any()
    for mod in (w2v, jw2v):
        broken = {k: v for k, v in sd.items() if k != "feature_aggregator.conv_layers.2.3.bias"}
        with pytest.raises(AssertionError):
            mod.convert_fairseq_weights(broken, jax_model[1])
        drift = dict(sd, **{"feature_extractor.conv_layers.1.0.weight": np.zeros((512, 512, 7),
                                                                                np.float32)})
        with pytest.raises(AssertionError):
            mod.convert_fairseq_weights(drift, jax_model[1])
    for prefix in ("feature_extractor", "feature_aggregator"):
        assert w2v.plan_from_state_dict(sd, prefix) == jw2v.plan_from_state_dict(sd, prefix)
    assert w2v.plan_from_state_dict(sd, "feature_extractor") == w2v.EXTRACTOR_PLAN
    assert w2v.plan_from_state_dict(sd, "feature_aggregator", [2] * 9)[0] == (512, 3, 2)


def test_window_means_and_initial_draw(seeded_tree, jax_model):
    """extract_utterance_features' 0.4-s window means (and the shorter-than-
    a-window mean) from the seeded tree within 1e-4 of JAX's; init_wav2vec's
    tree has JAX's leaves, shapes, unit scales and zero biases."""
    _, tree = seeded_tree
    model, _, fwd = jax_model
    port = w2v.load_wav2vec(tree, "cpu")
    for n in (8000 + 50, 3000):
        a = _audio(n, seed=1)
        want = jw2v.extract_utterance_features(model, {"params": tree}, a)
        got = w2v.extract_utterance_features(port, a)
        assert got.shape == want.shape and _rel(got, want) <= REL_TOL
    _, variables = w2v.init_wav2vec(seed=0, device="cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda x: np.shape(x), t)
    assert shapes(variables["params"]) == shapes(jax_model[1]["params"])
    norm = variables["params"]["feature_aggregator"]["norm_4"]
    assert (norm["scale"] == 1).all() and not norm["bias"].any()


def test_corpus_extraction_records_errors_and_resumes(seeded_tree, jax_model, tmp_path):
    """extract_corpus_features: an item that raises is recorded (the
    reference's quarantine) and the others equal JAX's; a second run skips
    the items done and extracts only what is missing."""
    _, tree = seeded_tree
    items = [_audio(3200, seed=s) for s in range(3)] + [None, _audio(4000, seed=7)]

    class Items:
        def __len__(self):
            return len(items)

        def __getitem__(self, i):
            if items[i] is None:
                raise ValueError("unreadable item")
            return items[i], i

    port = w2v.load_wav2vec(tree, "cpu")
    done, errors = w2v.extract_corpus_features(port, Items(), str(tmp_path / "p.pkl"),
                                               checkpoint_every=2)
    jdone, jerrors = jw2v.extract_corpus_features(jax_model[0], {"params": tree}, Items(),
                                                  str(tmp_path / "j.pkl"), checkpoint_every=2)
    assert errors.keys() == jerrors.keys() == {"3"} and done.keys() == jdone.keys()
    for k in done:
        assert _rel(done[k], jdone[k]) <= REL_TOL
    with open(tmp_path / "p.pkl.ERRORS.pkl", "rb") as f:
        assert pickle.load(f) == errors
    items[3] = _audio(2000, seed=9)
    seen = []
    real = w2v.extract_utterance_features
    w2v.extract_utterance_features = lambda m, a, *r, **k: seen.append(len(a)) or real(m, a, *r, **k)
    try:
        again, errors2 = w2v.extract_corpus_features(port, Items(), str(tmp_path / "p.pkl"))
    finally:
        w2v.extract_utterance_features = real
    assert seen == [2000] and not errors2 and set(again) == {"0", "1", "2", "3", "4"}
    assert all(np.array_equal(again[k], done[k]) for k in done)


def test_diar_features_wav2vec_equals_the_jax_cli(seeded_tree, tmp_path):
    """`diar-features --features wav2vec --wav2vec-ckpt` (the seeded tree,
    saved by the port) over the first 4 utterances of the reference split's
    first episode: the rows of the JAX CLI's [utterances, 512] pickle (the
    committed fixture) within 1e-4."""
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus

    ref = _reference_script()
    with open(ref.FIXTURE) as f:
        fx = json.load(f)["wav2vec"]
    want = np.load(ref.ARRAYS_NPZ)["wav2vec/ep0"]
    data = str(tmp_path / "data")
    tr = build_synth_corpus(data, **dict(ref.SPLIT, n_episodes=1))
    with open(os.path.join(data, "transcript.pkl"), "wb") as f:
        pickle.dump({"ep0": tr["ep0"][:4]}, f)
    ckpt = str(tmp_path / "w2v.msgpack")
    save_pytree(ckpt, seeded_tree[1])
    with contextlib.redirect_stdout(io.StringIO()):
        tools.main(["diar-features", "--data", data, "--out-dir", str(tmp_path / "out"),
                    "--features", "wav2vec", "--wav2vec-ckpt", ckpt, "--device", "cpu"])
    with open(tmp_path / "out" / "ep0.pkl", "rb") as f:
        got, ids = pickle.load(f)
    assert ids == fx["ids"][:4] and got.dtype == np.float32 and got.shape == (4, 512)
    assert _rel(got, want[:4]) <= REL_TOL
