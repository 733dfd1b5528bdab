"""The port's sentencepiece importer (text/spm_import.py) and GPT-2
tokenizer (text/gpt2.py) against the JAX package's: the protobuf wire
parsing, the same .model bytes imported by both packages giving equal
pieces, merges and token ids (and the `[spm_import]` warning), and
`Gpt2Tokenizer` on tests/test_tokenizer.py's local GPT-2 files giving
equal ids and decodes in both packages."""
import json

import pytest

from tal_asrd_tpu.text.bpe import BpeTokenizer as JBpeTokenizer
from tal_asrd_tpu.text.spm_import import load_sentencepiece_model as j_load
from tal_asrd_tpu_torch.text import BpeTokenizer, BpeTrainer, load_sentencepiece_model
from tal_asrd_tpu_torch.text.spm_import import (
    CONTROL,
    NORMAL,
    UNKNOWN,
    parse_model_proto,
    reconstruct_merges,
)
from tests.synthetic_corpus import SENTENCES
from tests.test_spm_import import write_fake_spm


def test_wire_parsing(tmp_path):
    p = str(tmp_path / "m.model")
    write_fake_spm(p, [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL),
                       ("a", -1.0, NORMAL), ("ü▁", -2.5, NORMAL)])
    with open(p, "rb") as f:
        entries = parse_model_proto(f.read())
    # the trailing unknown field (trainer_spec) is skipped
    assert entries == [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL),
                       ("a", -1.0, NORMAL), ("ü▁", -2.5, NORMAL)]


def test_merges_are_reconstructed_from_scores():
    pieces, merges = reconstruct_merges([("a", -9.0), ("b", -9.0), ("ab", -1.0),
                                         ("abb", -2.0), ("bb", -0.5)])
    assert pieces == ["a", "b", "bb", "ab", "abb"]
    assert merges == [("b", "b"), ("a", "b"), ("a", "bb"), ("ab", "b")]


def _spm_file(tmp_path, n_specials=4):
    native = BpeTrainer(vocab_size=160).train(SENTENCES * 20)
    merge_rank = {a + b: r for r, (a, b) in enumerate(native.merges)}
    entries = [("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
               ("<pad>", 0.0, CONTROL), ("<unk>", 0.0, UNKNOWN)][:n_specials]
    for p in native.pieces:
        score = -1000.0 - len(entries) if p not in merge_rank else -float(merge_rank[p])
        entries.append((p, score, NORMAL))
    path = str(tmp_path / "fake.model")
    write_fake_spm(path, entries)
    return native, path


def test_the_same_model_bytes_import_alike_in_both_packages(tmp_path):
    native, path = _spm_file(tmp_path)
    mine, ref = load_sentencepiece_model(path), j_load(path)
    assert mine.pieces == ref.pieces == native.pieces
    assert mine.merges == ref.merges
    a, b = BpeTokenizer(model=mine), JBpeTokenizer(model=ref)
    for text in SENTENCES:
        assert a.encode(text) == b.encode(text), text
        ids = a.encode(text, bos_token=False, eos_token=False)
        assert a.decode(ids) == b.decode(ids) == text


def test_a_model_without_the_four_control_pieces_warns_as_jax_does(tmp_path, capsys):
    _, path = _spm_file(tmp_path, n_specials=2)
    load_sentencepiece_model(path)
    mine = capsys.readouterr().out
    j_load(path)
    assert mine == capsys.readouterr().out
    assert mine.startswith("[spm_import] ") and "2 control pieces (expected 4)" in mine


def _gpt2_files(tmp_path):
    """tests/test_tokenizer.py's minimal GPT-2 byte-level BPE: the base bytes
    and a few merges, from a local directory."""
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode

    vocab = {ch: i for i, ch in enumerate(bytes_to_unicode().values())}
    nxt = len(vocab)
    merges = []
    for pair in [("t", "h"), ("th", "e"), ("h", "e"), ("Ġ", "t"), ("Ġt", "he")]:
        merges.append(f"{pair[0]} {pair[1]}")
        vocab["".join(pair)] = nxt
        nxt += 1
    vocab["<|endoftext|>"] = nxt
    d = tmp_path / "gpt2"
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "model_max_length": 1024, "tokenizer_class": "GPT2Tokenizer",
        "unk_token": "<|endoftext|>", "bos_token": "<|endoftext|>",
        "eos_token": "<|endoftext|>"}))
    return str(d)


def test_gpt2_tokenizer_equals_jax_on_local_files(tmp_path):
    pytest.importorskip("transformers")
    from tal_asrd_tpu.text.gpt2 import Gpt2Tokenizer as JGpt2Tokenizer
    from tal_asrd_tpu_torch.text.gpt2 import Gpt2Tokenizer

    d = _gpt2_files(tmp_path)
    mine, ref = Gpt2Tokenizer(d), JGpt2Tokenizer(d)
    assert len(mine) == len(ref)
    assert (mine.eot_token_id, mine.bos_token_id) == (ref.eot_token_id, ref.bos_token_id)
    assert (mine.pad_token_id, mine.eos_token_id) == (ref.pad_token_id, ref.eos_token_id)
    for text in ["the theme", "hello there, the end.", " the"]:
        ids = mine._encode(text)
        assert ids == ref._encode(text) and ids
        assert mine.decode_pieces(ids) == ref.decode_pieces(ids) == text
        assert mine.encode(text) == ref.encode(text)
        both = ids + [len(mine) + 3, mine.eos_token_id] + ids
        assert mine.decode_speakers(both) == ref.decode_speakers(both)
