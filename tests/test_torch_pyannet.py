"""The neural SAD's model and harness: the port's PyanNet (tal_asrd_tpu_torch/
vad/pyannet.py) and vad/sad.py against the JAX package's on the CPU, in
float32, on the seeded full-size tree of scripts/torch_sad_reference.py."""
import importlib.util
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.vad import pyannet as jpyannet
from tal_asrd_tpu.vad import sad as jsad
from tal_asrd_tpu_torch.vad import pyannet, sad
from tal_asrd_tpu_torch.vad.pyannet import (
    FRAME_HOP,
    PyanNet,
    SincConv,
    load_pyannet,
    params_to_state_dict,
    state_dict_to_params,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "torch_sad_reference", os.path.join(ROOT, "scripts", "torch_sad_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tree():
    return _reference_script().seeded_pyannet_tree()


@pytest.fixture(scope="module")
def jax_logits():
    model = jpyannet.PyanNet()
    return jax.jit(lambda p, w: model.apply({"params": p}, w))


def _wav(b, n, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, n)) * 0.1).astype(np.float32)


def _jax_filters(params, n=4000):
    """The [K, 1, C] filter bank JAX's SincConv builds, caught at its conv."""
    seen = {}
    real = jax.lax.conv_general_dilated

    def catch(lhs, rhs, *a, **k):
        seen["rhs"] = np.asarray(rhs)
        return real(lhs, rhs, *a, **k)

    with mock.patch.object(jax.lax, "conv_general_dilated", catch):
        jpyannet.SincConv().apply({"params": params}, jnp.zeros((1, n)))
    return seen["rhs"][:, 0, :].T


@pytest.mark.parametrize("which", ["init", "seeded"])
def test_sinc_filters_and_their_gradient(tree, which):
    """SincConv's [80, 251] filters (peak 1) within 2e-6 of JAX's, at the
    mel-spaced initial cut-offs (27 of them exactly 0) and at perturbed
    ones: f32 sines of arguments up to 400 rad put both packages' filters
    4.5e-6 (initial) and 5.7e-6 (perturbed) from the float64 filters, and
    1.1e-6 / 1.9e-6 from each other. The gradient of a seeded projection of
    its output to the cut-offs is within 1e-5 of the leaf's largest, against
    JAX's op-by-op gradient (jnp.abs's derivative is 1 at 0)."""
    params = {k: np.asarray(v) for k, v in tree["SincConv_0"].items()}
    if which == "seeded":
        rng = np.random.default_rng(3)
        params = {k: (v + rng.standard_normal(v.shape) * 20).astype(np.float32)
                  for k, v in params.items()}
    want = _jax_filters(params)
    sinc = SincConv()
    sinc.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    np.testing.assert_allclose(sinc.filters().detach().numpy(), want, rtol=0, atol=2e-6)

    wav = _wav(2, 3001, seed=4)
    w = np.random.default_rng(5).standard_normal((2, 301, 80)).astype(np.float32)
    grads = jax.grad(lambda p: (jpyannet.SincConv().apply({"params": p}, jnp.asarray(wav))
                                * w).sum())(params)
    (sinc(torch.from_numpy(wav)) * torch.from_numpy(w)).sum().backward()
    for name in ("low_hz", "band_hz"):
        g = np.asarray(grads[name])
        err = np.abs(getattr(sinc, name).grad.numpy() - g).max()
        assert err <= 1e-5 * np.abs(g).max(), (name, err)


@pytest.mark.parametrize("n", [32000, 16000 * 2 + 1237])
def test_pyannet_forward_matches(tree, jax_logits, n):
    """Logits within 1e-4 at B = 2 x 2 s and at a length that is no multiple
    of the 270-sample hop (SAME padding, floor pooling)."""
    wav = _wav(2, n)
    want = np.asarray(jax_logits(tree, jnp.asarray(wav)))
    with torch.no_grad():
        got = load_pyannet(tree, "cpu")(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, pyannet.n_frames(n))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_tree_round_trips_and_lstm_cells_map_to_directions(tree, jax_logits):
    """The flax tree -> state_dict -> flax tree is the identity bit for bit;
    swapping the two directions of a layer (cells 0 and 1) changes the
    logits, so the converter's cell order is the one the outputs pin."""
    back = state_dict_to_params(params_to_state_dict(tree))
    flat = lambda t: {"/".join(p): np.asarray(v) for p, v in
                      ((tuple(k.key for k in path), v) for path, v in
                       jax.tree_util.tree_leaves_with_path(t))}
    a, b = flat(tree), flat(back)
    assert a.keys() == b.keys() and all(a[k].tobytes() == b[k].tobytes() for k in a)
    swapped = dict(tree, OptimizedLSTMCell_0=tree["OptimizedLSTMCell_1"],
                   OptimizedLSTMCell_1=tree["OptimizedLSTMCell_0"])
    wav = _wav(1, 8100)
    with torch.no_grad():
        got = load_pyannet(swapped, "cpu")(torch.from_numpy(wav)).numpy()
    assert np.abs(got - np.asarray(jax_logits(tree, jnp.asarray(wav)))).max() > 1e-3


def test_port_init_has_the_flax_trees_names_shapes_and_statistics():
    """PyanNet's own initial tree has every name and shape of flax's init;
    the cut-offs are flax's, LayerNorm scales 1, biases 0, recurrent
    kernels orthogonal."""
    model = jpyannet.PyanNet()
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 5400))))
    want = {"/".join(k.key for k in p): v.shape
            for p, v in jax.tree_util.tree_leaves_with_path(shapes["params"])}
    mine = state_dict_to_params(PyanNet(device="cpu", generator=torch.Generator()
                                        .manual_seed(0)).state_dict())
    got = {"/".join(k.key for k in p): np.shape(v)
           for p, v in jax.tree_util.tree_leaves_with_path(mine)}
    assert got == want
    low0, band0 = jpyannet._mel_spaced_bands(80, 16000, 50.0, 50.0)
    assert np.array_equal(mine["SincConv_0"]["low_hz"], low0)
    assert np.array_equal(mine["SincConv_0"]["band_hz"], band0)
    hh = mine["OptimizedLSTMCell_3"]["hf"]["kernel"]
    np.testing.assert_allclose(hh @ hh.T, np.eye(128), atol=1e-5)
    assert all(np.all(mine[f"LayerNorm_{i}"]["scale"] == 1) for i in range(3))


def test_frames_labels_and_episode_scores(tree):
    """n_frames and frame_labels equal; score_episode equal in length and
    within 1e-5 (1-s windows snapped to the hop, batches of 3 with the last
    one padded)."""
    for n in (1, 269, 270, 8100, 16000, 32017, 160000):
        assert pyannet.n_frames(n) == jpyannet.n_frames(n)
    bounds = [(0.1, 0.52), (0.9, 1.7), (1.95, 3.0)]
    for offset in (0.0, 0.3, 1.2):
        np.testing.assert_array_equal(pyannet.frame_labels(bounds, 32130, offset_s=offset),
                                      jpyannet.frame_labels(bounds, 32130, offset_s=offset))
    wav = _wav(1, 16000 * 7 + 811, seed=2)[0]
    want = jpyannet.score_episode(tree, wav, window_s=1.0, batch=3)
    got = pyannet.score_episode(load_pyannet(tree, "cpu"), wav, window_s=1.0, batch=3)
    assert got.shape == want.shape == (pyannet.n_frames(len(wav)),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert FRAME_HOP == jpyannet.FRAME_HOP


@pytest.mark.parametrize("onset,offset,min_on,min_off", [
    (0.52, 0.52, 0.0, 0.0), (0.52, 0.52, 0.1, 0.1), (0.6, 0.4, 0.05, 0.2),
    (0.4, 0.6, 0.3, 0.0), (0.5, 0.5, 0.0, 0.05)])
def test_binarize_matches(onset, offset, min_on, min_off):
    """Seeded scores that cross onset and offset, with gaps and regions
    shorter than the minimum durations, and a region open at the end."""
    rng = np.random.default_rng(7)
    runs = rng.integers(1, 12, 80)
    levels = np.repeat(rng.uniform(0.2, 0.8, 80), runs)
    scores = np.clip(levels + rng.normal(0, 0.08, len(levels)), 0, 1).astype(np.float32)
    scores[-5:] = 0.9
    frame_s = FRAME_HOP / 16000
    kw = dict(onset=onset, offset=offset, min_duration_on=min_on, min_duration_off=min_off)
    want = jsad.binarize(scores, frame_s, **kw)
    assert len(want) >= 1
    assert sad.binarize(scores, frame_s, **kw) == want


def test_export_corpus_writes_the_same_text(tmp_path):
    transcripts = {"ep0": [{"utterance_start": 0.5, "utterance_end": 2.25, "speaker": "ira glass"},
                           {"utterance_start": 3.0, "utterance_end": 4.125}],
                   "ep1": [{"utterance_start": 1.0, "utterance_end": 1.5, "speaker": 3}]}
    durations = {"ep0": 10.0, "ep1": 5.5}
    jsad.export_corpus(transcripts, durations, str(tmp_path / "jax"))
    sad.export_corpus(transcripts, durations, str(tmp_path / "port"))
    for name in ("corpus.rttm", "corpus.uem"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert sad.to_rttm("x", transcripts["ep0"]) == jsad.to_rttm("x", transcripts["ep0"])
    assert sad.to_uem("x", 3.14159) == jsad.to_uem("x", 3.14159)
