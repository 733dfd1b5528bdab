"""Voice activity detection and the VAD decode windows, port against JAX
package (tal_asrd_tpu/vad):

  * the energy detector's probabilities within 1e-6 and its decisions
    equal, on synthetic bursts and on the synthetic test split's episodes
    (seed 202, 4 x 180 s, made by the port's build_synth_corpus);
  * the trigger state machine (`collector_mask`) equal on drawn decision
    strings (hypothesis) at three trigger / detrigger proportions;
  * the decode windows equal, sample for sample, to the JAX CLI's on the 4
    episodes (tests/fixtures/torch_unaligned_eval_reference.json, written by
    scripts/torch_unaligned_reference.py) and to JAX's vad_decode_windows;
  * the `gmm` detector's decisions equal through the port's own build of
    native/webrtc_vad.cpp;
  * `evaluate_vad` equal, and `run_vad_directory` (threads, no joblib)
    equal to JAX's single-process run, with its incremental resume; the VAD
    CLI's scores equal the JAX CLI's."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tal_asrd_tpu.vad import VadConfig as JVadConfig
from tal_asrd_tpu.vad import collector_mask as j_collector_mask
from tal_asrd_tpu.vad import evaluate_vad as j_evaluate_vad
from tal_asrd_tpu.vad import run_vad_directory as j_run_vad_directory
from tal_asrd_tpu.vad import speech_decisions as j_speech_decisions
from tal_asrd_tpu.vad import speech_probabilities as j_speech_probabilities
from tal_asrd_tpu.vad.webrtc_gmm import available as j_gmm_available
from tal_asrd_tpu.vad.windows import vad_decode_windows as j_vad_decode_windows
from tal_asrd_tpu_torch.data.audio_io import load_audio_segment, write_wav
from tal_asrd_tpu_torch.data.synth import build_synth_corpus
from tal_asrd_tpu_torch.vad import (
    VadConfig,
    collector_mask,
    evaluate_vad,
    run_vad_directory,
    speech_decisions,
    speech_probabilities,
)
from tal_asrd_tpu_torch.vad import webrtc_gmm
from tal_asrd_tpu_torch.vad.windows import vad_decode_windows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_unaligned_eval_reference.json")
PROB_ATOL = 1e-6


def bursts(seed=0, sr=16000, spans=((1.0, 3.0), (5.0, 7.0)), total=9.0):
    """Noise floor with two speech-like bursts (a tone plus noise)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(int(total * sr)).astype(np.float32) * 0.001
    for s, e in spans:
        seg = slice(int(s * sr), int(e * sr))
        t = np.arange(x[seg].shape[0]) / sr
        x[seg] += ((np.sin(2 * np.pi * 220 * t) + rng.randn(len(t)) * 0.5) * 0.3
                   ).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    split = str(tmp_path_factory.mktemp("split"))
    build_synth_corpus(split, n_episodes=4, episode_seconds=180.0, n_speakers=8, seed=202)
    stubs = sorted(f[:-4] for f in os.listdir(split) if f.endswith(".wav"))
    return split, [load_audio_segment(os.path.join(split, f"{s}.wav"), 0.0, None)
                   for s in stubs]


@pytest.mark.parametrize("level", [0, 2, 3])
def test_energy_detector_matches_jax_on_bursts(level):
    x = bursts(seed=level)
    got = speech_probabilities(x, VadConfig(vad_level=level), device="cpu").numpy()
    ref = np.asarray(j_speech_probabilities(jnp.asarray(x), JVadConfig(vad_level=level)))
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=PROB_ATOL)
    np.testing.assert_array_equal(
        speech_decisions(x, VadConfig(vad_level=level), device="cpu"),
        np.asarray(j_speech_decisions(jnp.asarray(x), JVadConfig(vad_level=level))))


def test_energy_detector_matches_jax_on_the_episodes(episodes):
    cfg = dict(vad_level=2, prop_voice_start=0.7, prop_unvoice_end=0.7)
    for wav in episodes[1]:
        got = speech_probabilities(wav, VadConfig(**cfg), device="cpu").numpy()
        ref = np.asarray(j_speech_probabilities(jnp.asarray(wav), JVadConfig(**cfg)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=PROB_ATOL)
        np.testing.assert_array_equal(got > 0.5, ref > 0.5)


# One decision-string length: JAX compiles its scan once per (length, config).
DRAWN_FRAMES = 64


@settings(max_examples=50, deadline=None)
@given(st.lists(st.booleans(), min_size=DRAWN_FRAMES, max_size=DRAWN_FRAMES),
       st.sampled_from([(0.9, 0.9), (0.7, 0.7), (0.5, 0.8)]))
def test_collector_mask_matches_jax_on_drawn_decisions(decisions, props):
    kw = dict(prop_voice_start=props[0], prop_unvoice_end=props[1])
    d = np.asarray(decisions)
    np.testing.assert_array_equal(
        collector_mask(d, VadConfig(**kw)),
        np.asarray(j_collector_mask(jnp.asarray(d), JVadConfig(**kw))))


def test_windows_equal_the_jax_clis_on_the_episodes(episodes):
    with open(FIXTURE) as f:
        ref = json.load(f)["legs"]["vad"]["episodes"]
    assert len(ref) == len(episodes[1]) == 4
    for wav, ep in zip(episodes[1], ref):
        got = vad_decode_windows(wav, 16000, device="cpu")
        assert got == [(w["start"], w["end"]) for w in ep["windows"]]
    # and JAX's function itself, on one episode and with other knobs
    wav = episodes[1][0]
    for kw in ({}, {"max_window_s": 5.0}):
        assert vad_decode_windows(wav, 16000, device="cpu", **kw) == \
            j_vad_decode_windows(wav, 16000, **kw)


@pytest.mark.skipif(not j_gmm_available(), reason="the JAX package's native VAD did not build")
def test_gmm_decisions_match_jax_through_the_ports_build():
    assert webrtc_gmm.available()
    # the port loads its own build under tal_asrd_tpu_torch/_build/
    from tal_asrd_tpu_torch.utils import native
    assert any(k == "webrtc_vad" and v is not None for k, v in native._libs.items())
    for level in (1, 3):
        x = bursts(seed=level)
        got = speech_decisions(x, VadConfig(vad_level=level, detector="gmm"))
        ref = np.asarray(j_speech_decisions(jnp.asarray(x),
                                            JVadConfig(vad_level=level, detector="gmm")))
        assert got.any() and not got.all()
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        webrtc_gmm.WebRtcGmmVad(3).is_speech(np.zeros(100, np.int16).tobytes(), 16000)


def test_evaluate_vad_matches_jax():
    pred = [(0.5, 2.0), (3.1, 3.9), (7.0, 8.55)]
    gold = [(0.4, 1.9), (3.0, 4.0), (6.0, 7.5)]
    for duration in (9.0, 8.0):
        got, ref = evaluate_vad(pred, gold, duration), j_evaluate_vad(pred, gold, duration)
        assert (got.precision, got.recall, got.f1, got.compression) == \
            (ref.precision, ref.recall, ref.f1, ref.compression)


def test_run_vad_directory_without_joblib_matches_jax(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    for i in range(3):
        write_wav(str(data / f"ep{i}.wav"), bursts(seed=10 + i))
    got = run_vad_directory(str(data), str(tmp_path / "port"), workers=2, device="cpu")
    ref = j_run_vad_directory(str(data), str(tmp_path / "jax"), workers=1)
    assert {os.path.basename(k): v for k, v in got.items()} == \
        {os.path.basename(k): v for k, v in ref.items()}
    for i in range(3):
        assert (tmp_path / "port" / f"ep{i}.speech.wav").exists()
    # incremental resume: existing outputs are read back
    os.remove(str(data / "ep0.wav"))
    write_wav(str(data / "ep0.wav"), np.zeros(16000 * 9, np.float32))
    again = run_vad_directory(str(data), str(tmp_path / "port"), workers=1, device="cpu")
    assert again == got


def test_vad_cli_matches_jaxs(tmp_path):
    """`python -m tal_asrd_tpu_torch.cli.vad --eval-transcripts` on a split
    of one 30 s synthetic episode gives the JAX CLI's bounds and scores."""
    from tal_asrd_tpu.cli.vad import main as j_main
    from tal_asrd_tpu_torch.cli.vad import main
    split = str(tmp_path / "split")
    build_synth_corpus(split, n_episodes=1, episode_seconds=30.0, n_speakers=8, seed=202)
    flags = ["--data-dir", split, "--eval-transcripts", "--vad-level", "2",
             "--prop-start", "0.7", "--prop-end", "0.7", "--workers", "1"]
    got = main(flags + ["--out-dir", str(tmp_path / "port"), "--device", "cpu",
                        "--json-out", str(tmp_path / "port.json")])
    j_main(flags + ["--out-dir", str(tmp_path / "jax"), "--json-out", str(tmp_path / "jax.json")])
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        assert json.load(f) == json.load(g) == got["metrics"]
    assert set(got["metrics"]) == {"vad_precision_pct", "vad_recall_pct", "vad_f1_pct",
                                   "vad_compression_pct"}
    assert (tmp_path / "port" / "ep0.bounds.pkl").exists()
