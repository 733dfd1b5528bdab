"""The shift-augmentation data of the port's training CLI against the JAX
package's: `build_episode_durations`, `SegmentDataset` items (wav sample for
sample, tokens, speaker ids, index) in random mode after `set_seed(42)` in
the loader's order, with `det_seed` and with word-aligned truncation,
`ConcatDataset` indexing, and the CLI's `build_datasets` (the
`--num-utterances 1,4` mix and the det_seed 1234 validation windows). The
tiny corpus is built once per module and given word alignments and a gap
without speech (a window there reads UNK_PHRASE); each package reads its
own copy, so neither reads the other's index cache."""
import os
import pickle
import shutil

import numpy as np
import pytest

from tal_asrd_tpu.cli import train as j_cli_train
from tal_asrd_tpu.cli.args import get_argparser as j_get_argparser
from tal_asrd_tpu.core.utils import set_seed as j_set_seed
from tal_asrd_tpu.data.segment import SegmentDataset as JSegmentDataset
from tal_asrd_tpu.data.transcript import build_episode_durations as j_build_episode_durations
from tal_asrd_tpu.text import BpeTokenizer as JBpeTokenizer
from tal_asrd_tpu_torch.cli import train as cli_train
from tal_asrd_tpu_torch.cli.args import get_argparser
from tal_asrd_tpu_torch.core.utils import set_seed
from tal_asrd_tpu_torch.data.loader import ShardedSampler
from tal_asrd_tpu_torch.data.segment import UNK_PHRASE, SegmentDataset
from tal_asrd_tpu_torch.data.synth import build_synth_corpus
from tal_asrd_tpu_torch.data.transcript import build_episode_durations
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
from tal_asrd_tpu_torch.utils.wordtok import tweet_tokenize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(ROOT, "accuracy_release", "bpe.model")
GAP = (40.0, 62.0)      # episode 0: no utterance starts or ends in here


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """{"jax": dir, "port": dir}: two copies of one corpus (3 episodes of
    90 s, 8 speakers) with word alignments and a gap in episode 0."""
    tmp = tmp_path_factory.mktemp("segment")
    port = str(tmp / "port")
    build_synth_corpus(port, n_episodes=3, episode_seconds=90.0, n_speakers=8, seed=3)
    with open(os.path.join(port, "transcript.pkl"), "rb") as f:
        transcripts = pickle.load(f)
    first = next(iter(transcripts))
    transcripts[first] = [u for u in transcripts[first]
                          if u["utterance_end"] <= GAP[0] or u["utterance_start"] >= GAP[1]]
    for utts in transcripts.values():
        for u in utts:
            words = tweet_tokenize(u["utterance"])
            step = (u["utterance_end"] - u["utterance_start"]) / len(words)
            u["alignments"] = [(u["utterance_start"] + k * step,
                                u["utterance_start"] + (k + 1) * step, k)
                               for k in range(len(words))]
    with open(os.path.join(port, "transcript.pkl"), "wb") as f:
        pickle.dump(transcripts, f)
    jax_dir = str(tmp / "jax")
    shutil.copytree(port, jax_dir)
    return {"jax": jax_dir, "port": port}


@pytest.fixture(scope="module")
def tokenizers():
    return JBpeTokenizer(model_path=TOKENIZER), BpeTokenizer(model_path=TOKENIZER)


def _assert_items_equal(mine, ref):
    assert len(mine) == len(ref)
    for n, (a, b) in enumerate(zip(mine, ref)):
        assert a[0].dtype == b[0].dtype == np.float32, n
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"wav of item {n}")
        for k in (1, 2):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"field {k} of item {n}")
        assert a[3] == b[3], n


def test_build_episode_durations_equals_the_reference(corpus):
    mine = build_episode_durations(corpus["port"])
    ref = j_build_episode_durations(corpus["jax"])
    assert mine == ref
    assert len(mine) == 3 and all(d == 90.0 for _, _, d in mine)
    # a second call reads the cache, in the reference's file and format
    assert os.path.exists(os.path.join(corpus["port"], "cache_tpu_segment.pkl"))
    assert build_episode_durations(corpus["port"]) == ref


def _items(ds, order):
    return [ds[int(i)] for i in order]


@pytest.mark.parametrize("mode", ["random", "det_seed", "aligned_truncation"])
def test_segment_items_equal_the_reference(corpus, tokenizers, mode):
    """Random mode: after set_seed(42), in the order of a shuffled sampler
    (the training loader with --num-workers 0), twice over (two epochs)."""
    j_tok, tok = tokenizers
    kw = dict(segment_size=28.5, tokenizer_speakers=True)
    if mode == "det_seed":
        kw["det_seed"] = 1234
    kw.update(aligned_truncation=True) if mode == "aligned_truncation" else kw.update(
        return_spk_ids=True)
    ref_ds = JSegmentDataset(corpus["jax"], j_tok,
                             speaker_map_loc=os.path.join(corpus["jax"], "speaker_map.json"), **kw)
    ds = SegmentDataset(corpus["port"], tok,
                        speaker_map_loc=os.path.join(corpus["port"], "speaker_map.json"), **kw)
    assert len(ds) == len(ref_ds) == 27
    sampler = ShardedSampler(len(ds), shuffle=mode != "det_seed")
    order = []
    for epoch in (0, 1):
        sampler.set_epoch(epoch)
        order += list(sampler)
    j_set_seed(42)
    ref = _items(ref_ds, order)
    set_seed(42)
    mine = _items(ds, order)
    _assert_items_equal(mine, ref)
    unk = tok.encode(UNK_PHRASE, bos_token=False, eos_token=False)
    assert any(list(t) == unk for _, t, _, _ in mine)        # a window in the gap
    if mode == "det_seed":                                   # the same every epoch
        _assert_items_equal(mine[:27], mine[27:])


def test_segment_without_det_seed_draws_from_the_global_generator(corpus, tokenizers):
    ds = SegmentDataset(corpus["port"], tokenizers[1], segment_size=28.5)
    set_seed(42)
    first = ds[5]
    set_seed(42)
    again = ds[5]
    other = ds[5]
    np.testing.assert_array_equal(first[0], again[0])
    assert len(first[0]) != len(other[0]) or not np.array_equal(first[0], other[0])


def test_concat_dataset_indexing_equals_the_reference():
    parts = [list(range(3)), list(range(10, 15)), [], list(range(20, 22))]
    mine, ref = cli_train.ConcatDataset(parts), j_cli_train.ConcatDataset(parts)
    assert len(mine) == len(ref) == 10
    assert [mine[i] for i in range(10)] == [ref[i] for i in range(10)] == \
        [0, 1, 2, 10, 11, 12, 13, 14, 20, 21]


@pytest.mark.parametrize("split", ["train", "valid"])
def test_build_datasets_equals_the_reference(corpus, tokenizers, split):
    """The CLI's datasets at --num-utterances 1,4 --shiftaug: the aligned
    parts in order, then the segment windows (validation: det_seed 1234),
    item for item after set_seed(42)."""
    def argv(d):
        return ["--train-data", d, "--valid-data", d, "--tokenizer", TOKENIZER,
                "--model-type", "1x", "--num-speakers", "8", "--max-secs", "28.5",
                "--num-utterances", "1,4", "--shiftaug", "--name", "n"]
    j_tok, tok = tokenizers
    ref = j_cli_train.build_datasets(
        j_get_argparser(is_train=True).parse_args(argv(corpus["jax"])), j_tok)
    mine = cli_train.build_datasets(
        get_argparser(is_train=True).parse_args(argv(corpus["port"])), tok)
    ref, mine = ref[split == "valid"], mine[split == "valid"]
    assert [len(d) for d in mine.datasets] == [len(d) for d in ref.datasets]
    assert [type(d).__name__ for d in mine.datasets] == \
        ["AlignedDataset", "AlignedDataset", "SegmentDataset"]
    if split == "valid":
        assert mine.datasets[-1].det_seed == ref.datasets[-1].det_seed == 1234
    j_set_seed(42)
    ref_items = [ref[i] for i in range(len(ref))]
    set_seed(42)
    _assert_items_equal([mine[i] for i in range(len(mine))], ref_items)
