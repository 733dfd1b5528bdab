"""Speaker-embedding export (eval/gen_embed.py, cli/gen_embed.py), port
against JAX package on the CPU, float32:

  * `generate_speaker_embeddings` on the tiny model pair (4 speaker tokens,
    ReZero scalars 0.4) over two batches with speaker tokens in the text,
    one of them in a padded position: rows and speaker ids in the same
    order, the rows within 1e-5;
  * `save_split` writes the JAX package's pickles byte for byte (numpy
    arrays, 80/20 in order), so each package reads the other's;
  * `python -m tal_asrd_tpu_torch.cli.gen_embed --device cpu` with the
    tracked checkpoint in float32 on the synthetic test split's first
    episode cut to 5 utterances (4 segments, one batch): rows within 1e-4
    of the JAX CLI's, the same speaker ids and speaker posteriors' argmax
    (tests/fixtures/torch_embed_reference.json, made by
    scripts/torch_embed_reference.py)."""
import functools
import json
import os
import pickle

import numpy as np
import pytest
import torch

from tal_asrd_tpu.eval.gen_embed import generate_speaker_embeddings as j_generate
from tal_asrd_tpu.eval.gen_embed import save_split as j_save_split
from tal_asrd_tpu_torch.eval.gen_embed import (
    generate_speaker_embeddings,
    save_split,
    speaker_posteriors,
)

from tests.test_torch_helpers import tiny_audio, tiny_model_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_embed_reference.json")
ARRAYS = os.path.join(ROOT, "tests", "fixtures", "torch_embed_reference_arrays.npz")
CHECKPOINT = os.path.join(ROOT, "accuracy_release", "avg_last_3.bf16.msgpack")
BPE = os.path.join(ROOT, "accuracy_release", "bpe.model")


def tiny_batches(vocab, n_speakers):
    """Two batches of 3 rows: text tokens with a speaker token before each
    EOS and one mid-row; the last row of each batch padded after its 7th
    position, with a speaker token in the padding (excluded)."""
    rng = np.random.default_rng(5)
    out = []
    for seed in (0, 1):
        audio, lens = tiny_audio(3, seed=seed)
        text = rng.integers(3, vocab, (3, 12)).astype(np.int32)
        text[:, 0] = 1
        text[:, 5] = vocab + rng.integers(0, n_speakers, 3)
        text[:, -2] = vocab + rng.integers(0, n_speakers, 3)
        text[:, -1] = 1
        mask = np.ones((3, 12), bool)
        mask[2, 7:] = False
        out.append({"audio": audio, "audio_lens": lens, "text": text, "text_mask": mask})
    return out


@pytest.fixture(scope="module")
def tiny_rows():
    jmodel, variables, tmodel = tiny_model_pair(seed=13)
    batches = tiny_batches(tmodel.cfg.vocab_size, tmodel.cfg.num_speakers)
    ref = j_generate(jmodel, variables, batches)
    return generate_speaker_embeddings(tmodel, batches), ref, tmodel, batches


def test_rows_match_jax(tiny_rows):
    (embs, sids), (j_embs, j_sids), model, batches = tiny_rows
    assert embs.shape == (2 * 3 + 2 * 2, model.cfg.embed_size) and embs.dtype == np.float32
    np.testing.assert_array_equal(sids, j_sids)
    assert sids.dtype == np.int32 and set(sids.tolist()) <= set(range(model.cfg.num_speakers))
    np.testing.assert_allclose(embs, j_embs, rtol=0, atol=1e-5)


def test_rows_are_the_posteriors_times_the_speaker_rows(tiny_rows):
    (embs, _), _, model, batches = tiny_rows
    b = batches[0]
    with torch.inference_mode():
        probs, mask, ids = speaker_posteriors(model, torch.from_numpy(b["audio"]),
                                              torch.from_numpy(b["audio_lens"]),
                                              torch.from_numpy(b["text"]).long())
    keep = mask.numpy() & b["text_mask"][:, 1:]
    want = probs.numpy()[keep] @ model.speaker_rows().detach().numpy()
    np.testing.assert_allclose(embs[:len(want)], want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(probs.numpy().sum(-1), 1.0, atol=1e-5)


def test_pickles_are_the_jax_packages(tiny_rows, tmp_path):
    (embs, sids), _, _, _ = tiny_rows
    save_split(embs, sids, str(tmp_path / "port"))
    j_save_split(embs, sids, str(tmp_path / "jax"))
    for part, n in (("train", 8), ("valid", 2)):
        with open(tmp_path / f"port.{part}.pkl", "rb") as f:
            port_bytes = f.read()
        with open(tmp_path / f"jax.{part}.pkl", "rb") as f:
            assert f.read() == port_bytes
        e, s = pickle.loads(port_bytes)
        assert type(e) is np.ndarray and type(s) is np.ndarray and len(e) == len(s) == n


def test_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    import tal_asrd_tpu_torch.eval.gen_embed as gen_embed
    from tal_asrd_tpu_torch.cli import gen_embed as cli
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus

    with open(FIXTURE) as f:
        fx = json.load(f)
    arrays = np.load(ARRAYS)
    split, out = str(tmp_path / "split"), str(tmp_path / "spk")
    transcripts = build_synth_corpus(split, **fx["splits"]["cpu"])
    with open(os.path.join(split, "transcript.pkl"), "wb") as f:
        pickle.dump({"ep0": transcripts["ep0"][:fx["cpu_utterances"]]}, f)
    captured = []

    def recording(*args, real=gen_embed.speaker_posteriors):
        probs, mask, ids = real(*args)
        captured.append(probs[mask].cpu().numpy())
        return probs, mask, ids

    monkeypatch.setattr(gen_embed, "speaker_posteriors", recording)
    monkeypatch.setattr(cli, "ASRSystem",
                        functools.partial(cli.ASRSystem, compute_dtype=torch.float32))
    embs, sids = cli.main(["--train-data", split, "--valid-data", split, "--tokenizer", BPE,
                           "--model-type", "1x", "--num-speakers", "8", "--num-workers", "0",
                           "--batch-size", str(fx["batch"]["cpu"]), "--load", CHECKPOINT,
                           "--out-path", out, "--device", "cpu"])
    want_rows, want_ids = arrays["gen_embed/cpu/rows"], arrays["gen_embed/cpu/ids"]
    assert len(embs) == fx["gen_embed"]["cpu"]["rows"] == len(want_rows) > 0
    np.testing.assert_array_equal(sids, want_ids)
    np.testing.assert_allclose(embs, want_rows, rtol=0, atol=1e-4)
    probs = np.concatenate(captured)
    np.testing.assert_array_equal(probs.argmax(-1), arrays["gen_embed/cpu/probs"].argmax(-1))
    with open(out + ".train.pkl", "rb") as f:
        e, s = pickle.load(f)
    assert len(e) == fx["gen_embed"]["cpu"]["n_train"]
    np.testing.assert_array_equal(e, embs[:len(e)])
