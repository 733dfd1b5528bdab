"""Parity of the PyTorch port's log-mel frontend with the JAX package (CPU).

Inputs come from numpy with a fixed seed and go through both packages; the
Pallas mel-projection kernel runs in interpret mode, the port's wrapper takes
its plain version because the tensors lie on the CPU.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.core.config import FrontendConfig as JFrontendConfig
from tal_asrd_tpu.ops import logmel as jlogmel
from tal_asrd_tpu.ops.pallas_kernels import fused_logmel_project as j_fused_logmel
from tal_asrd_tpu_torch.core.config import FrontendConfig
from tal_asrd_tpu_torch.ops import logmel as tlogmel
from tal_asrd_tpu_torch.ops.cuda_kernels import (
    fused_logmel_project,
    logmel_project_plain,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((3, 8000)) * 0.1).astype(np.float32)


def test_mel_filterbank_equal():
    a = tlogmel.mel_filterbank(201, 0.0, 8000.0, 80, 16000)
    b = jlogmel.mel_filterbank(201, 0.0, 8000.0, 80, 16000)
    assert a.dtype == np.float32 and a.shape == (201, 80)
    np.testing.assert_array_equal(a, b)


def test_num_frames_and_framing(audio):
    cfg, jcfg = FrontendConfig(), JFrontendConfig()
    assert tlogmel.num_frames(8000, cfg) == jlogmel.num_frames(8000, jcfg) == 51
    ours = tlogmel.frame_signal(torch.from_numpy(audio), cfg).numpy()
    ref = np.asarray(jlogmel.frame_signal(jnp.asarray(audio), jcfg))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tlogmel._hann_periodic(400),
                                  jlogmel._hann_periodic(400))


def test_power_spectrogram_matches_jax(audio):
    ours = tlogmel.power_spectrogram(torch.from_numpy(audio), FrontendConfig()).numpy()
    ref = np.asarray(jlogmel.power_spectrogram(
        jnp.asarray(audio), JFrontendConfig(spectrum_impl="fft")))
    # two f32 FFT libraries: relative agreement, absolute floor for ~0 bins
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_lens", [False, True])
def test_log_mel_matches_jax(audio, with_lens):
    lens = np.array([8000, 6000, 4100], np.int32) if with_lens else None
    ours = tlogmel.log_mel_spectrogram(
        torch.from_numpy(audio), FrontendConfig(),
        audio_lens=None if lens is None else torch.from_numpy(lens)).numpy()
    ref = np.asarray(jlogmel.log_mel_spectrogram(
        jnp.asarray(audio), JFrontendConfig(spectrum_impl="fft"),
        audio_lens=None if lens is None else jnp.asarray(lens)))
    assert ours.shape == ref.shape == (3, 51, 80)
    # atol 1e-4: the repo's own frontend tolerance (f32 FFT + log)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_log_mel_matches_golden_fixture():
    fix = np.load(os.path.join(FIXTURES, "logmel_golden.npz"))
    ours = tlogmel.log_mel_spectrogram(
        torch.from_numpy(fix["audio"]), FrontendConfig(mean_subtract=False)).numpy()
    np.testing.assert_allclose(ours, fix["logmel"], rtol=1e-4, atol=1e-4)


def test_log_mel_accepts_1d_audio(audio):
    one = tlogmel.log_mel_spectrogram(torch.from_numpy(audio[0]), FrontendConfig())
    assert one.shape == (1, 51, 80)


def test_plain_logmel_project_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    power = (rng.standard_normal((300, 201)) ** 2).astype(np.float32)
    fb = tlogmel.mel_filterbank(201, 0.0, 8000.0, 80, 16000)
    ours = logmel_project_plain(torch.from_numpy(power), torch.from_numpy(fb), 1e-6)
    ref = np.asarray(j_fused_logmel(jnp.asarray(power), jnp.asarray(fb),
                                    eps=1e-6, interpret=True))
    # atol 1e-5: same f32 product and log, different summation order
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    # on a CPU tensor the wrapper takes the plain version and counts no launch
    before = fused_logmel_project.launches
    via_wrapper = fused_logmel_project(torch.from_numpy(power), torch.from_numpy(fb), 1e-6)
    assert fused_logmel_project.launches == before
    np.testing.assert_array_equal(via_wrapper.numpy(), ours.numpy())


def test_logmel_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        fused_logmel_project(torch.zeros(4, 200), torch.zeros(201, 80))
