"""The port's data pipeline against the JAX package's, on a small split of
the synthetic test corpus (seed 202, one episode of 30 s, 8 speakers):
the corpus generator (the same wav bytes, transcript.pkl and
speaker_map.json), AlignedDataset's items, and BucketedCollater + DataLoader
+ ShardedSampler's batches in their order; then the upload to the device."""
import filecmp
import os

import numpy as np
import pytest
import torch

from tal_asrd_tpu.data import AlignedDataset as JAlignedDataset
from tal_asrd_tpu.data import BucketedCollater as JBucketedCollater
from tal_asrd_tpu.data import DataLoader as JDataLoader
from tal_asrd_tpu.data import ShardedSampler as JShardedSampler
from tal_asrd_tpu.data.synth import build_synth_corpus as j_build_synth_corpus
from tal_asrd_tpu.data.synth import corpus_text as j_corpus_text
from tal_asrd_tpu.text.bpe import BpeTokenizer as JBpeTokenizer
from tal_asrd_tpu_torch.data.aligned import AlignedDataset
from tal_asrd_tpu_torch.data.audio_io import get_duration, load_audio_segment, write_wav
from tal_asrd_tpu_torch.data.collate import BucketedCollater, pick_bucket
from tal_asrd_tpu_torch.data.loader import DataLoader, DevicePrefetcher, ShardedSampler, to_device
from tal_asrd_tpu_torch.data.synth import build_synth_corpus, corpus_text
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE = os.path.join(ROOT, "accuracy_release", "bpe.model")
SPLIT = dict(n_episodes=1, episode_seconds=30.0, n_speakers=8, seed=202)


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """The same split written by each package into a directory of its own
    (the index caches of the two datasets must not meet)."""
    root = tmp_path_factory.mktemp("synth")
    port, ref = str(root / "port"), str(root / "jax")
    transcripts = build_synth_corpus(port, **SPLIT)
    j_build_synth_corpus(ref, **SPLIT)
    return port, ref, transcripts


def datasets(splits, tokenizer_speakers=True):
    port, ref, _ = splits
    args = dict(num_utterances=1, min_segment_duration=3, max_segment_duration=20,
                tokenizer_speakers=tokenizer_speakers, return_spk_ids=True)
    return (AlignedDataset(port, BpeTokenizer(model_path=BPE),
                           speaker_map_loc=os.path.join(port, "speaker_map.json"), **args),
            JAlignedDataset(ref, JBpeTokenizer(model_path=BPE),
                            speaker_map_loc=os.path.join(ref, "speaker_map.json"), **args))


def test_synth_corpus_is_the_same_bytes(splits):
    port, ref, transcripts = splits
    names = sorted(os.listdir(ref))
    assert names == ["ep0.wav", "speaker_map.json", "transcript.pkl"]
    assert sorted(os.listdir(port)) == names
    for name in names:
        assert filecmp.cmp(os.path.join(port, name), os.path.join(ref, name), shallow=False), name
    assert corpus_text(port) == j_corpus_text(ref)
    assert len(transcripts["ep0"]) >= 4
    assert get_duration(os.path.join(port, "ep0.wav")) == SPLIT["episode_seconds"]


@pytest.mark.parametrize("tokenizer_speakers", [True, False])
def test_aligned_dataset_items_match_jax(splits, tokenizer_speakers):
    ds, jds = datasets(splits, tokenizer_speakers)
    assert len(ds) == len(jds) == 5
    assert ds.index == jds.index
    for i in range(len(ds)):
        wav, text, spk, idx = ds[i]
        jwav, jtext, jspk, jidx = jds[i]
        np.testing.assert_array_equal(wav, jwav)
        np.testing.assert_array_equal(text, jtext)
        np.testing.assert_array_equal(spk, jspk)
        assert idx == jidx == i and wav.dtype == np.float32 and text.dtype == np.int32
    # the tokenized stream: <EOS> text <spk> <EOS>, with the speaker token
    # in the speaker-token vocabulary
    text = ds[0][1]
    assert text[0] == text[-1] == 1 and (text[-2] >= 300) == tokenizer_speakers


def test_dataset_index_cache_round_trips(splits):
    port, _, _ = splits
    ds, _ = datasets(splits)
    assert os.path.exists(os.path.join(port, "cache_tpu_aligned_1u.pkl"))
    again, _ = datasets(splits)          # served from the cache
    assert again.index == ds.index


@pytest.mark.parametrize("batch,workers,shuffle", [(2, 0, False), (2, 2, False), (3, 2, True)])
def test_loader_gives_the_references_batches_in_order(splits, batch, workers, shuffle):
    ds, jds = datasets(splits)
    loader = DataLoader(ds, batch, BucketedCollater(2),
                        ShardedSampler(len(ds), shuffle=shuffle, seed=7), workers,
                        drop_last=False)
    jloader = JDataLoader(jds, batch, JBucketedCollater(2),
                          JShardedSampler(len(jds), shuffle=shuffle, seed=7), workers,
                          drop_last=False)
    got, ref = list(loader), list(jloader)
    assert len(got) == len(ref) == len(loader) == -(-len(ds) // batch)
    for b, jb in zip(got, ref):
        assert sorted(b) == sorted(jb)
        for key in jb:
            assert b[key].dtype == jb[key].dtype, key
            np.testing.assert_array_equal(b[key], jb[key], err_msg=key)
    assert got[-1]["audio"].shape[0] == len(ds) - batch * (len(got) - 1)   # the short tail


@pytest.mark.parametrize("shard", [0, 1, 2])
def test_sharded_sampler_matches_jax(shard):
    for drop_last in (False, True):
        for epoch in (0, 3):
            s = ShardedSampler(11, shard, 3, shuffle=True, seed=5, drop_last=drop_last)
            j = JShardedSampler(11, shard, 3, shuffle=True, seed=5, drop_last=drop_last)
            s.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(s) == list(j) and len(s) == len(j)


def test_collater_buckets_and_int16(splits):
    ds, _ = datasets(splits)
    items = [ds[i] for i in range(3)]
    for audio_int16 in (False, True):
        b = BucketedCollater(2, audio_int16=audio_int16)(items)
        jb = JBucketedCollater(2, audio_int16=audio_int16)(items)
        for key in jb:
            np.testing.assert_array_equal(b[key], jb[key], err_msg=key)
    assert b["audio"].shape[1] in (80000, 160000) and b["text"].shape[1] == 32
    assert pick_bucket(5, [4, 8]) == 8 and pick_bucket(9, [4, 8]) == 8


def test_upload_to_the_device(splits):
    """to_device / DevicePrefetcher on the CPU (the pinned, non-blocking
    upload is the CUDA branch of the same function): tensors, the same
    values, in order."""
    ds, _ = datasets(splits)
    batches = list(DataLoader(ds, 2, BucketedCollater(2), num_workers=0, drop_last=False))
    moved = list(DevicePrefetcher(iter(batches), depth=2, device="cpu"))
    assert len(moved) == len(batches)
    for b, t in zip(batches, moved):
        for key in b:
            assert isinstance(t[key], torch.Tensor) and t[key].device.type == "cpu"
            np.testing.assert_array_equal(t[key].numpy(), b[key])
    t = to_device(batches[0], "cpu")
    assert t["text"].dtype == torch.int32


def test_wav_round_trip(tmp_path):
    x = (np.sin(np.arange(16000) / 7.0) * 0.5).astype(np.float32)
    path = str(tmp_path / "x.wav")
    write_wav(path, x)
    y = load_audio_segment(path, 0.25, 0.5)
    assert y.shape == (4000,)
    np.testing.assert_allclose(y, x[4000:8000], atol=1 / 32768)


def test_word_aligned_tokenization_matches_jax():
    """tokenize_utterances_word_align: boundary utterances cut at their
    forced-alignment word times, on seeded cuts of the corpus's text."""
    from tal_asrd_tpu.data.format import tokenize_utterances_word_align as j_word_align
    from tal_asrd_tpu_torch.data.format import tokenize_utterances_word_align
    from tal_asrd_tpu_torch.data.synth import random_sentence
    tok, jtok = BpeTokenizer(model_path=BPE), JBpeTokenizer(model_path=BPE)
    rng = np.random.RandomState(9)
    t, utts = 0.0, []
    for _ in range(6):
        words = random_sentence(rng).split()
        align = [(t + 0.5 * i, t + 0.5 * i + 0.4, i) for i in range(len(words))]
        utts.append({"utterance": " ".join(words), "speaker": "jane doe",
                     "utterance_start": t, "utterance_end": t + 0.5 * len(words),
                     "alignments": align})
        t += 0.5 * len(words) + 0.3
    spk = lambda name: 301
    for trial in range(20):
        lo = int(rng.randint(0, 5))
        sel = list(enumerate(utts))[lo:lo + int(rng.randint(1, 3))]
        start = sel[0][1]["utterance_start"] + float(rng.uniform(-0.5, 2.0))
        end = sel[-1][1]["utterance_end"] - float(rng.uniform(-0.5, 2.0))
        for kw in (dict(), dict(add_eot=True, tokenize_speaker=True, speaker_to_id=spk)):
            got = tokenize_utterances_word_align(utts, sel, start, end, tok, **kw)
            assert got == j_word_align(utts, sel, start, end, jtok, **kw), (trial, kw)
