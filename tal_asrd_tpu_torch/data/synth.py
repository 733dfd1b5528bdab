"""Synthetic-speech corpus generator for self-contained accuracy loops.

Counterpart of tal_asrd_tpu/data/synth.py (`build_synth_corpus`,
`build_sad_stress_corpus`, `corpus_text`): the same seed writes the same wav
bytes, transcript.pkl and speaker_map.json. The corpus has the reference corpus format
(transcript.pkl utterance dicts + speaker_map.json + episode wavs), and its
audio deterministically ENCODES the text, so a model trained on a train split
generalizes to held-out episodes and corpus WER/WDER is a real regression
number.

Audio code: each character is a short dual-tone segment (frequency keyed by
the character), words separated by brief silence; every utterance carries a
speaker-dependent fundamental hum and a speaker-dependent formant scale, so
both the text tokens and the speaker identity are recoverable from the
waveform.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tal_asrd_tpu_torch.data.audio_io import write_wav

SR = 16000
# 180 ms per character: the TDS encoder outputs one frame per 80 ms of audio
# (stride 8 over 10 ms hops), so each character spans ~2.25 encoder frames.
# (At 60 ms a character is SUB-frame and gets blended away; 120 ms = 1.5
# frames trained but converged slowly — boundary phase relative to the
# stride-8 grid leaves barely one clean frame per character.)
CHAR_SECONDS = 0.18
WORD_GAP_SECONDS = 0.04
UTT_GAP_SECONDS = 0.25

# 120 common words: sentences are random draws, so held-out episodes contain
# unseen word ORDER (and optionally unseen words) over seen acoustics.
WORDS = (
    "the of and to in is you that it he was for on are as with his they at be "
    "this have from or one had by word but not what all were we when your can "
    "said there use an each which she do how their if will up other about out "
    "many then them these so some her would make like him into time has look "
    "two more write go see number no way could people my than first water been "
    "called who oil sit now find long down day did get come made may part over "
    "new sound take only little work know place year live me back give most "
    "very after thing our just name good sentence man think say great where "
    "help through much before line right too mean old any same tell boy follow "
    "came want show also around form three small"
).split()

SPEAKER_NAMES = [
    "ira glass", "jane doe", "john smith", "mary major", "alex chen",
    "sam quinn", "ada wong", "li wei",
]
ROLES = ["host", "interviewer", "subject"]


def _char_freq(ch: str) -> float:
    """Base tone per character, RATIO-spaced (≈10%/step, like semitones) so
    adjacent characters stay separable through a mel filterbank, whose
    resolution is roughly constant in log-frequency."""
    if "a" <= ch <= "z":
        idx = ord(ch) - ord("a")
    else:
        idx = (ord(ch) * 2654435761) % 26      # fallback for rare chars
    return 300.0 * 2.0 ** (idx / 7.0)          # 300 Hz … ~3.5 kHz


def render_word(word: str, speaker_idx: int, rng: np.random.RandomState,
                sr: int = SR, hum_jitter: float = 0.0) -> np.ndarray:
    """Render one word: per-character tones + speaker hum/formant scale.

    Corpus v2: the speaker task is deliberately non-saturating so aligned
    WDER is a live regression signal. Eight
    speakers on a 15 Hz hum grid with ±5 Hz per-utterance jitter: adjacent
    speakers sit ~0.4 FFT bins apart (n_fft 400 → 40 Hz/bin), so identity
    must be read from sub-bin leakage shapes and the (small) formant scale —
    learnable but occasionally confusable.
    """
    # Speaker timbre. The per-speaker scale step must stay well under the
    # per-character ratio step (2^(1/7) ~ 10.4%, _char_freq): at a 4% step,
    # speaker 3's character i landed on speaker 0's character i+1 (1.12 vs
    # 1.104) — character identity was ambiguous without de-aliasing by
    # speaker, which plateaued training. 0.5% keeps 8 speakers inside a 3.5%
    # spread (no tone aliasing) while making timbre a weak, non-saturating
    # speaker cue.
    f_scale = 1.0 + 0.005 * speaker_idx
    hum_f = 90.0 + 15.0 * speaker_idx + hum_jitter  # speaker fundamental
    n_char = int(CHAR_SECONDS * sr)
    t = np.arange(n_char) / sr
    segs = []
    for ch in word:
        f1 = _char_freq(ch) * f_scale
        seg = (
            0.45 * np.sin(2 * np.pi * f1 * t)
            + 0.20 * np.sin(2 * np.pi * hum_f * t)
        )
        if 2 * f1 < 7600.0:                     # harmonic, kept under Nyquist
            seg = seg + 0.30 * np.sin(2 * np.pi * 2 * f1 * t)
        # Hann-ish fade to avoid clicks between characters
        ramp = min(n_char // 8, 64)
        env = np.ones(n_char)
        env[:ramp] = np.linspace(0, 1, ramp)
        env[-ramp:] = np.linspace(1, 0, ramp)
        segs.append(seg * env)
    out = np.concatenate(segs) if segs else np.zeros(0)
    out = out + rng.randn(len(out)) * 0.01
    return out.astype(np.float32)


def render_utterance(text: str, speaker_idx: int, rng: np.random.RandomState,
                     sr: int = SR) -> np.ndarray:
    gap = np.zeros(int(WORD_GAP_SECONDS * sr), np.float32)
    # Per-utterance hum jitter (stable within the utterance): brings adjacent
    # speakers within ~5 Hz worst-case, the controlled-confusability knob.
    hum_jitter = float(rng.uniform(-5.0, 5.0))
    parts: List[np.ndarray] = []
    for w in text.split():
        parts.append(render_word(w, speaker_idx, rng, sr, hum_jitter=hum_jitter))
        parts.append(gap)
    return np.concatenate(parts[:-1]) if parts else np.zeros(0, np.float32)


def random_sentence(rng: np.random.RandomState, min_words: int = 4,
                    max_words: int = 10) -> str:
    """Defaults give ~3.7-9.4 s utterances at the render rate (~0.94 s/word
    at 180 ms/char) — inside the aligned dataset's (3 s, max_secs)
    duration-pruning window."""
    n = rng.randint(min_words, max_words + 1)
    return " ".join(WORDS[i] for i in rng.randint(0, len(WORDS), n))


def build_synth_corpus(
    root: str,
    n_episodes: int = 8,
    episode_seconds: float = 120.0,
    n_speakers: int = 4,
    seed: int = 0,
    sr: int = SR,
    sentences: Optional[Sequence[str]] = None,
) -> dict:
    """Write episode wavs + transcript.pkl + speaker_map.json under `root`.

    Different seeds give disjoint sentence streams — use seed 0/1/2 for
    train/valid/test splits. Returns the transcript dict."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    speakers = SPEAKER_NAMES[:n_speakers]
    transcripts = {}
    for e in range(n_episodes):
        stub = f"ep{e}"
        chunks: List[np.ndarray] = []
        utts = []
        t = 0.3
        chunks.append(np.zeros(int(t * sr), np.float32))
        i = 0
        # Role is assigned per episode (not a global function of speaker id,
        # which would let role analysis degenerate into speaker analysis —
        # the reference's roles likewise vary per episode).
        episode_roles = [ROLES[int(rng.randint(0, len(ROLES)))]
                         for _ in range(n_speakers)]
        while t < episode_seconds - 8.0:
            text = (sentences[(seed * 1000 + e * 100 + i) % len(sentences)]
                    if sentences else random_sentence(rng))
            spk = int(rng.randint(0, n_speakers))
            wav = render_utterance(text, spk, rng, sr)
            dur = len(wav) / sr
            utts.append({
                "utterance": text,
                "speaker": speakers[spk],
                "utterance_start": float(t),
                "utterance_end": float(t + dur),
                "role": episode_roles[spk],
            })
            chunks.append(wav)
            gap = UTT_GAP_SECONDS + float(rng.rand()) * 0.2
            chunks.append(
                (rng.randn(int(gap * sr)) * 0.005).astype(np.float32)
            )
            t += dur + gap
            i += 1
        audio = np.concatenate(chunks)
        # pad/trim to the nominal episode length
        want = int(episode_seconds * sr)
        if len(audio) < want:
            audio = np.concatenate(
                [audio, (rng.randn(want - len(audio)) * 0.005).astype(np.float32)]
            )
        write_wav(os.path.join(root, stub + ".wav"), audio[:want], sr)
        transcripts[stub] = utts

    with open(os.path.join(root, "transcript.pkl"), "wb") as f:
        pickle.dump(transcripts, f)
    with open(os.path.join(root, "speaker_map.json"), "w") as f:
        json.dump({name: i for i, name in enumerate(speakers)}, f)
    return transcripts


def build_sad_stress_corpus(
    root: str,
    n_episodes: int = 6,
    episode_seconds: float = 90.0,
    n_speakers: int = 8,
    seed: int = 0,
    sr: int = SR,
    snr_db: Tuple[float, float] = (0.0, 20.0),
    noise_rms: float = 0.02,
    crossfade_s: float = 0.25,
    distractor_rate: float = 0.5,
) -> dict:
    """SAD stress corpus: the plain synthetic corpus is nearly
    energy-separable, so any detector scores F1 near 99.9. This variant
    takes the trivial cues away:

      * a continuous noise floor (`noise_rms`) instead of near-silence;
      * a per-utterance SNR drawn from `snr_db` against the floor: the
        quietest utterances sit at the floor;
      * utterance edges crossfaded by half-cosine ramps (`crossfade_s`)
        while the gold bounds stay nominal;
      * non-speech distractors between utterances, absent from the
        transcript: hum-only segments (a speaker's fundamental and two
        harmonics, no character tones) and broadband bursts, at speech-like
        energies.

    Same layout as build_synth_corpus (episode wavs + transcript.pkl +
    speaker_map.json); each utterance dict also holds its `snr_db`."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    speakers = SPEAKER_NAMES[:n_speakers]
    transcripts = {}
    n_fade = int(crossfade_s * sr)

    def _distractor() -> np.ndarray:
        dur = float(rng.uniform(0.5, 2.0))
        n = int(dur * sr)
        t = np.arange(n) / sr
        if rng.rand() < 0.5:
            # hum-only: a random speaker's fundamental + 2 harmonics
            hum_f = 90.0 + 15.0 * rng.randint(0, n_speakers) \
                + float(rng.uniform(-5.0, 5.0))
            seg = (0.5 * np.sin(2 * np.pi * hum_f * t)
                   + 0.3 * np.sin(2 * np.pi * 2 * hum_f * t)
                   + 0.15 * np.sin(2 * np.pi * 3 * hum_f * t))
        else:
            seg = rng.randn(n)  # broadband burst
        seg = seg / (np.sqrt(np.mean(seg ** 2)) + 1e-9)
        snr = float(rng.uniform(*snr_db))
        seg = seg * noise_rms * 10.0 ** (snr / 20.0)
        ramp = min(n // 4, n_fade)
        env = np.ones(n)
        env[:ramp] = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
        env[-ramp:] = env[:ramp][::-1]
        return (seg * env).astype(np.float32)

    for e in range(n_episodes):
        stub = f"ep{e}"
        chunks: List[np.ndarray] = []
        utts = []
        t = 0.5
        chunks.append((rng.randn(int(t * sr)) * noise_rms).astype(np.float32))
        while t < episode_seconds - 10.0:
            if rng.rand() < distractor_rate:
                d = _distractor()
                chunks.append(d + (rng.randn(len(d)) * noise_rms
                                   ).astype(np.float32))
                t += len(d) / sr
            text = random_sentence(rng)
            spk = int(rng.randint(0, n_speakers))
            wav = render_utterance(text, spk, rng, sr).astype(np.float64)
            # target SNR vs the noise floor
            rms = float(np.sqrt(np.mean(wav ** 2))) + 1e-9
            snr = float(rng.uniform(*snr_db))
            wav = wav * (noise_rms * 10.0 ** (snr / 20.0) / rms)
            # crossfaded edges: energy ramps across the gold boundary
            ramp = min(len(wav) // 4, n_fade)
            if ramp > 1:
                env = np.ones(len(wav))
                env[:ramp] = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
                env[-ramp:] = env[:ramp][::-1]
                wav = wav * env
            dur = len(wav) / sr
            utts.append({
                "utterance": text,
                "speaker": speakers[spk],
                "utterance_start": float(t),
                "utterance_end": float(t + dur),
                "role": ROLES[int(rng.randint(0, len(ROLES)))],
                "snr_db": snr,
            })
            chunks.append((wav + rng.randn(len(wav)) * noise_rms
                           ).astype(np.float32))
            gap = UTT_GAP_SECONDS + float(rng.rand()) * 0.6
            chunks.append((rng.randn(int(gap * sr)) * noise_rms
                           ).astype(np.float32))
            t += dur + gap
        audio = np.concatenate(chunks)
        want = int(episode_seconds * sr)
        if len(audio) < want:
            audio = np.concatenate(
                [audio,
                 (rng.randn(want - len(audio)) * noise_rms).astype(np.float32)])
        write_wav(os.path.join(root, stub + ".wav"), audio[:want], sr)
        transcripts[stub] = utts

    with open(os.path.join(root, "transcript.pkl"), "wb") as f:
        pickle.dump(transcripts, f)
    with open(os.path.join(root, "speaker_map.json"), "w") as f:
        json.dump({name: i for i, name in enumerate(speakers)}, f)
    return transcripts

def corpus_text(root: str) -> List[str]:
    """All utterance texts in a corpus (for tokenizer/LM training)."""
    with open(os.path.join(root, "transcript.pkl"), "rb") as f:
        transcripts = pickle.load(f)
    return [u["utterance"] for utts in transcripts.values() for u in utts]
