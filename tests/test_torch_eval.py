"""The port's scoring against the JAX package's — convert_results (the
aligned `wder-format`), corpus_wder and score_test_result give the
reference's WER and WDER exactly, on hand-made pairs and on seeded ones —
then the evaluation CLI at full width on the CPU, without JAX: the tracked
checkpoint on the first segments of the synthetic test split, each beam
score given back by teacher-forced rescoring, and the share of hypotheses
equal to the JAX CPU reference's (tests/fixtures/
torch_aligned_eval_reference.json, made by scripts/torch_eval_reference.py);
and its long-form VAD leg on the split's first episode against the JAX
CLI's windows and tokens (tests/fixtures/torch_unaligned_eval_reference.json,
made by scripts/torch_unaligned_reference.py)."""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from tal_asrd_tpu.eval.convert import convert_results as j_convert_results
from tal_asrd_tpu.eval.wder import corpus_wder as j_corpus_wder
from tal_asrd_tpu_torch.core.config import DecodeConfig
from tal_asrd_tpu_torch.eval.convert import convert_results, score_test_result
from tal_asrd_tpu_torch.eval.wder import (
    calculate_wder,
    compute_sequence_match,
    convert_to_wder_format,
    corpus_wder,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_aligned_eval_reference.json")
CHECKPOINT = os.path.join(ROOT, "accuracy_release", "avg_last_3.bf16.msgpack")
BPE = os.path.join(ROOT, "accuracy_release", "bpe.model")

HAND = [
    # all words equal, the hyp merges two speakers: WDER 0.5
    ([("a b", 0), ("c d", 1)], [("a b", 0), ("c d", 0)]),
    # the same speakers under other labels: WDER 0
    ([("a b", "jack"), ("c d", "margaret")], [("a b", 5), ("c d", 9)]),
    # a substitution, an insertion and a deletion; a None speaker filled
    # forward from the next known one
    ([("the cat sat", "x"), ("on a mat", "y")], [("the dog sat", None), ("on mat now", 3)]),
    # skipped: an empty hypothesis
    ([("lonely words", 0)], []),
    # 3-tuples with a role, and (embedding, id) hypotheses
    ([("hello world", "jane doe", "host"), ("goodbye", "ira", "subject")],
     [("hello", (np.ones(4, np.float32), 2), "host"), ("world bye", (None, 5), "subject")]),
]


def seeded_pairs(seed, n=12):
    """Random segments over a small vocabulary: substitutions, insertions,
    deletions and speaker confusions, None speakers now and then."""
    rng = np.random.default_rng(seed)
    vocab = "the of and to in is you that it he was for on are as".split()
    pairs = []
    for _ in range(n):
        ref, hyp = [], []
        for _ in range(int(rng.integers(1, 4))):
            words = [vocab[i] for i in rng.integers(0, len(vocab), rng.integers(1, 8))]
            spk = int(rng.integers(0, 3))
            ref.append((" ".join(words), f"speaker {spk}", "host"))
            noisy = [w if rng.random() > 0.3 else vocab[int(rng.integers(0, len(vocab)))]
                     for w in words if rng.random() > 0.1]
            if rng.random() < 0.2:
                noisy.append(vocab[0])
            hyp_spk = None if rng.random() < 0.15 else int((spk + (rng.random() < 0.2)) % 3)
            hyp.append((" ".join(noisy), (rng.standard_normal(4).astype(np.float32), hyp_spk),
                        "subject"))
        pairs.append((ref, hyp))
    return pairs


def assert_same_corpus_scores(got, ref):
    ref_spk, hyp_spk, wder, dist, n_words, wer = got
    j_ref_spk, j_hyp_spk, j_wder, j_dist, j_n_words, j_wer = ref
    assert (wder, wer, tuple(dist), tuple(n_words)) == (j_wder, j_wer, tuple(j_dist),
                                                        tuple(j_n_words))
    for a, b in zip(ref_spk + hyp_spk, j_ref_spk + j_hyp_spk):
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("pairs", ["hand", "seeded_0", "seeded_1"])
def test_corpus_wder_matches_jax_exactly(pairs):
    data = HAND if pairs == "hand" else seeded_pairs(int(pairs[-1]))
    for wer_only in (False, True):
        assert_same_corpus_scores(corpus_wder(data, wer_only=wer_only),
                                  j_corpus_wder(data, wer_only=wer_only, workers=1))
    wder = corpus_wder(data)[2]
    assert 0.0 < wder < 1.0


def test_metric_pieces_on_hand_fixtures():
    assert compute_sequence_match([0, 0, 1, 1], [7, 7, 7, 7])[2] == 0.5
    pairs, n = convert_to_wder_format([("hello world", None), ("bye", 3)], wer_only=False)
    assert pairs == [("hello", 0), ("world", 0), ("bye", 0)] and n == 1
    wer, dist, n_ref, wder, _, _ = calculate_wder(
        "t", [("a", 0), ("b", 0), ("c", 1)], [("a", 0), ("b", 1), ("x", 1)])
    assert dist == 1 and n_ref == 3 and abs(wder - 1 / 3) < 1e-12
    with pytest.raises(ValueError, match="all 1 segments were skipped"):
        corpus_wder([([("a", 0)], [])])
    assert corpus_wder([([("a", 0)], [])], allow_degenerate=True)[2] == 1.0


def seeded_test_result(seed):
    """A test_result.pkl structure: ref utterance dicts and hyp dicts, some
    with speakerEmbed, some with a None speakerId, one segment empty."""
    out = []
    for ref, hyp in seeded_pairs(seed):
        refs = [{"utterance": t, "speaker": s, "utterance_start": 0.0,
                 "utterance_end": 1.0, "role": r} for t, s, r in ref]
        hyps = []
        for i, (t, (emb, sid), _) in enumerate(hyp):
            h = {"utterance": t, "speakerId": sid}
            if i % 2 == 0:
                h["speakerEmbed"] = emb
            hyps.append(h)
        out.append((refs, hyps))
    out.append((out[0][0], []))
    return out


def test_convert_and_score_test_result_match_jax(tmp_path):
    results = seeded_test_result(2)
    got, ref = convert_results(results), j_convert_results(results)
    assert len(got) == len(ref)
    for (r, h), (jr, jh) in zip(got, ref):
        assert r == jr
        assert [(t, sid, role) for t, (_, sid), role in h] == \
            [(t, sid, role) for t, (_, sid), role in jh]
        for (_, (emb, _), _), (_, (jemb, _), _) in zip(h, jh):
            assert (emb is None and jemb is None) or np.array_equal(emb, jemb)
    path = str(tmp_path / "test_result.pkl")
    with open(path, "wb") as f:
        pickle.dump(results, f)
    scored = score_test_result(path)
    j = j_corpus_wder(ref, workers=1)
    assert_same_corpus_scores(tuple(scored[k] for k in (
        "ref_speakers", "hyp_speakers", "overall_wder", "dist", "n_words", "overall_wer")), j)
    assert scored["n_segments"] == len(results)


@pytest.mark.parametrize("field,value,item", [
    ("lm_weight", 0.5, "A14"), ("chunk_size", 340, "A9"), ("history_evict_block", 1, "A9"),
    ("eos_advance", True, "A9"), ("self_attn_mode", "noncausal_ref", "A11")])
def test_decode_config_refuses_what_is_not_ported(field, value, item, tmp_path):
    """Nothing is refused any more: LM fusion's weight (A14) and the state
    machine's fields (A9) are accepted at any value, each of them; the
    non-causal mode (A11) is accepted and, as in the JAX package, read by no
    runner: the eval runner's outputs on a tiny model are the same with it
    (its decode is decode/reference_mode.py, called directly)."""
    if item == "A11":
        assert DecodeConfig(**{field: value}).self_attn_mode == value
        causal, noncausal = (tiny_runner_outputs(tmp_path / mode, DecodeConfig(
            beam_size=2, **{field: mode})) for mode in ("causal", value))
        assert causal == noncausal and len(causal) == 2
        return
    if item == "A14":
        assert DecodeConfig(lm_weight=value).lm_weight == value
    elif item == "A9":
        assert getattr(DecodeConfig(**{field: value}), field) == value
        every = dict(chunk_size=100, thresh_prct=0.4, shift_prct=0.2, stall_patience=8,
                     rep_n=4, skip_prct=0.25, max_iters=500, history_evict_block=1,
                     eos_advance=True, stall_rollback=True)
        cfg = DecodeConfig(**every)
        assert {k: getattr(cfg, k) for k in every} == every
    assert DecodeConfig(beam_size=3, use_fused_decode=True).beam_size == 3


def tiny_runner_outputs(root, decode_cfg):
    """EvalRunner's aligned step on a tiny speaker-token model (seeded,
    ReZero scalars 0.4) over a 20 s split's segments in one batch: the
    step's tokens, lengths and scores and test_result.pkl, as bytes."""
    from tal_asrd_tpu_torch.core.config import ModelConfig
    from tal_asrd_tpu_torch.core.convert import load_into, params_spec
    from tal_asrd_tpu_torch.data.aligned import AlignedDataset
    from tal_asrd_tpu_torch.data.collate import BucketedCollater
    from tal_asrd_tpu_torch.data.loader import DataLoader
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.eval.runner import EvalRunner
    from tal_asrd_tpu_torch.models.asr import ASRModel
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
    from tests.test_torch_helpers import seeded_params
    split, out = str(root / "split"), str(root / "out")
    build_synth_corpus(split, n_episodes=1, episode_seconds=20.0, n_speakers=8, seed=202)
    tok = BpeTokenizer(model_path=BPE)
    model = ASRModel(ModelConfig(model_type="1x", num_speakers=8, vocab_size=len(tok),
                                 n_head=2, tds_depths=(1, 1, 1), width_mult=0.1,
                                 d_decoder_override=32), device="cpu")
    load_into(model, {"params": seeded_params(params_spec(model), 2)})
    ds = AlignedDataset(split, tok, num_utterances=1, min_segment_duration=3,
                        max_segment_duration=20,
                        speaker_map_loc=os.path.join(split, "speaker_map.json"),
                        tokenizer_speakers=True, return_spk_ids=True)
    batch = next(iter(DataLoader(ds, 8, BucketedCollater(tok.pad_token_id), num_workers=0,
                                 drop_last=False)))
    runner = EvalRunner(model, tok, decode_cfg, out_dir=out, device="cpu")
    step = runner.test_step_aligned(batch, [ds.index[int(i)][1] for i in batch["idx"]])
    with open(os.path.join(out, "test_result.pkl"), "rb") as f:
        written = f.read()
    return [[step[k].tolist() for k in ("tokens", "lengths", "scores")], written]


CLI_BASE = ["--tokenizer", BPE, "--model-type", "1x", "--num-speakers", "8",
            "--load", CHECKPOINT, "--num-workers", "0"]


def spk_reference_script():
    """scripts/torch_spk_reference.py, for `seeded_spk_tree` (numpy only)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_spk_reference", os.path.join(ROOT, "scripts", "torch_spk_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags,item", [
    (["--unaligned"], "A9"), (["--lm-path", "lm.msgpack"], "A14"),
    (["--lm-weight", "0.3"], "A14"),
    (["--spk-weight", "0.5", "--fused-decode", "--load", "SPK_TREE"], "A12.2"),
    (["--bf16-params"], "A8")])
def test_cli_refuses_what_is_not_ported(flags, item, tmp_path):
    """Nothing is refused any more: --unaligned (A9), --bf16-params (once
    parked on A8), LM fusion (A14) and the speaker head (A12.2) run on a
    split of one episode (--unaligned: 8 s, one padded window of the state
    machine; the others: the aligned leg on the first 3 utterances of a
    30 s episode, under --bf16-params every parameter bf16) and write their
    outputs. --lm-path without --lm-weight, or --lm-weight without
    --lm-path, decodes without an LM, as the reference's CLI does (the path
    is not read; tests/test_torch_lm_fusion.py runs both flags). With
    --spk-weight the CLI loads a speaker-head tree (the tracked checkpoint's
    text weights with a seeded head), decodes through the model itself even
    under --fused-decode, and writes each utterance's speaker logits."""
    from tal_asrd_tpu_torch.cli.test import main
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree, save_pytree
    d = str(tmp_path)
    if item == "A12.2":
        tree = os.path.join(d, "spk_tree.msgpack")
        save_pytree(tree, spk_reference_script().seeded_spk_tree(load_pytree(CHECKPOINT), 300,
                                                                 0, 0.4))
        flags = [tree if f == "SPK_TREE" else f for f in flags]
    argv = ["--train-data", d, "--valid-data", d, "--test-data", d, "--out-dir", d,
            "--device", "cpu"] + CLI_BASE + flags
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    transcripts = build_synth_corpus(d, n_episodes=1, n_speakers=8, seed=202,
                                     episode_seconds=8.0 if item == "A9" else 30.0)
    if item in ("A8", "A14", "A12.2"):
        with open(os.path.join(d, "transcript.pkl"), "wb") as f:
            pickle.dump({"ep0": transcripts["ep0"][:3]}, f)
    res = main(argv)
    runner = res["runner"]
    params = list(runner.model.parameters())
    assert all(p.dtype == (torch.bfloat16 if item == "A8" else torch.float32) for p in params)
    assert runner.lm is None and runner.lm_weight == 0.0
    if item == "A9":
        (step,) = res["steps"]
        assert step["idx"] == 0 and step["events"]["windows"] >= 1 and step["iters"] > 0
        assert step["num_tokens"] == len(step["tokens"]) > 1
    with open(os.path.join(d, "test_result.pkl"), "rb") as f:
        results = pickle.load(f)
    assert len(results) == len(runner.test_outputs) >= 1
    if item == "A12.2":
        assert runner.model.cfg.use_speaker_head and runner._decode_model is runner.model
        hyps = [u for _, hyp in results for u in hyp]
        assert hyps and all(u["speakerLogits"].shape[1] == 8 and "speakerEmbed" not in u
                            for u in hyps)


def test_cli_at_full_width_on_the_cpu(tmp_path, record_property):
    """`python -m tal_asrd_tpu_torch.cli.test --device cpu` with the tracked
    checkpoint on the first batch of the test split: the split's first
    episode (seed 202) cut to its first 5 utterances, of which 4 are
    segments (one is shorter than 3 s) — the full split's first 4 segments.
    Every reported beam score is given back by teacher-forced rescoring of
    its row under the unfused model within 0.05; the output files have the
    reference's format."""
    import chip_smoke
    from tal_asrd_tpu_torch.cli.test import main
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    split, out = str(tmp_path / "test"), str(tmp_path / "out")
    transcripts = build_synth_corpus(split, n_episodes=1, episode_seconds=30.0,
                                     n_speakers=8, seed=202)
    with open(os.path.join(split, "transcript.pkl"), "wb") as f:
        pickle.dump({"ep0": transcripts["ep0"][:5]}, f)
    res = main(["--train-data", split, "--valid-data", split, "--test-data", split,
                "--out-dir", out, "--device", "cpu", "--batch-size", "4"] + CLI_BASE)
    assert [len(s["idx"]) for s in res["steps"]] == [4]
    assert np.isfinite(res["test_loss"]) and res["test_loss"] < 3.0

    model = res["runner"].model
    from tal_asrd_tpu_torch.data.aligned import AlignedDataset
    from tal_asrd_tpu_torch.data.collate import BucketedCollater
    from tal_asrd_tpu_torch.data.loader import DataLoader
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
    ds = AlignedDataset(split, BpeTokenizer(model_path=BPE), num_utterances=1,
                        min_segment_duration=3, max_segment_duration=20,
                        speaker_map_loc=os.path.join(split, "speaker_map.json"),
                        tokenizer_speakers=True, return_spk_ids=True)
    gaps = []
    with torch.inference_mode():
        for batch, step in zip(DataLoader(ds, 4, BucketedCollater(2), num_workers=0,
                                          drop_last=False), res["steps"]):
            np.testing.assert_array_equal(batch["idx"], step["idx"])
            enc = model.encode(torch.from_numpy(batch["audio"]),
                               torch.from_numpy(batch["audio_lens"]))
            tokens = torch.from_numpy(step["tokens"])
            lengths = torch.from_numpy(step["lengths"])
            resc = chip_smoke.rescore(torch, model, enc, tokens, 1, lengths)
            gaps += (resc - torch.from_numpy(step["scores"])).abs().tolist()
    assert all(s["found"].all() for s in res["steps"])
    assert max(gaps) <= 0.05, gaps

    with open(FIXTURE) as f:
        ref = json.load(f)["segments"]
    hyps = [step["tokens"][i, :step["lengths"][i]].tolist()
            for step in res["steps"] for i in range(len(step["idx"]))]
    equal = sum(h == r["tokens"] for h, r in zip(hyps, ref))
    record_property("hypotheses_equal_to_the_jax_reference", f"{equal}/{len(hyps)}")
    print(f"hypotheses equal to the JAX CPU reference's: {equal}/{len(hyps)}")

    with open(os.path.join(out, "test_result.pkl"), "rb") as f:
        results = pickle.load(f)
    assert len(results) == 4
    for refs, hyp in results:
        assert refs and set(refs[0]) >= {"utterance", "speaker", "utterance_start"}
        for e in hyp:
            assert set(e) <= {"utterance", "speakerId", "speakerEmbed"}
            assert isinstance(e["speakerId"], (int, type(None)))
            if "speakerEmbed" in e:
                assert e["speakerEmbed"].dtype == np.float32 and e["speakerEmbed"].shape == (64,)
    assert any("speakerEmbed" in e for _, hyp in results for e in hyp)
    for name in ("hyp.txt", "ref.txt"):
        with open(os.path.join(out, name)) as f:
            assert len(f.read().splitlines()) == 4
    scored = score_test_result(os.path.join(out, "test_result.pkl"))
    assert 0.0 <= scored["overall_wer"] < 1.0 and scored["n_segments"] == 4


UNALIGNED_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                 "torch_unaligned_eval_reference.json")
# Share of VAD windows whose beam tokens must equal the JAX CLI's: bf16
# near-ties flip a token now and then (readings: 32 and 33 of 35 on one
# and eight threads).
MIN_EQUAL_WINDOWS = 0.8


def test_vad_windows_cli_at_full_width_on_the_cpu(tmp_path):
    """`python -m tal_asrd_tpu_torch.cli.test --unaligned --vad-windows
    --device cpu` with the tracked checkpoint on the test split's first
    episode (180 s, seed 202): its decode windows equal the JAX CLI's
    sample for sample (tests/fixtures/torch_unaligned_eval_reference.json),
    at least MIN_EQUAL_WINDOWS of them decode to the JAX CLI's tokens, and
    the outputs have the reference's format (chunkStart in encoder frames,
    a uniform attention row)."""
    from tal_asrd_tpu_torch.cli.test import main
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    split, out = str(tmp_path / "test"), str(tmp_path / "out")
    build_synth_corpus(split, n_episodes=1, episode_seconds=180.0, n_speakers=8, seed=202)
    res = main(["--train-data", split, "--valid-data", split, "--test-data", split,
                "--out-dir", out, "--device", "cpu", "--unaligned", "--vad-windows"]
               + CLI_BASE)
    (step,) = res["steps"]
    with open(UNALIGNED_FIXTURE) as f:
        ref = json.load(f)["legs"]["vad"]["episodes"][0]["windows"]
    assert step["windows"] == [(w["start"], w["end"]) for w in ref]
    want = [w["tokens"][:-1] if w["found"] and w["length"] > 1 else w["tokens"] for w in ref]
    equal = sum(a == b for a, b in zip(step["window_tokens"], want))
    print(f"VAD windows with the JAX CLI's tokens: {equal}/{len(want)}")
    assert equal >= MIN_EQUAL_WINDOWS * len(want)
    assert sum(step["buckets"].values()) == step["num_windows"] == len(ref)

    with open(os.path.join(out, "test_result.pkl"), "rb") as f:
        ((refs, hyp),) = pickle.load(f)
    assert refs and hyp and len(hyp) == step["num_utterances"]
    frame = 16000 // 100 * 8
    starts = {s // frame for s, _ in step["windows"]}
    for e in hyp:
        assert set(e) == {"utterance", "speakerId", "utteranceTokens", "attention", "chunkStart"}
        assert e["attention"].shape == (len(e["utteranceTokens"]), 1)
        assert int(e["chunkStart"][0]) in starts
    scored = score_test_result(os.path.join(out, "test_result.pkl"))
    assert 0.0 < scored["overall_wer"] < 1.0 and scored["n_segments"] == 1


def test_load_weights_is_strict_and_keeps_the_posenc_gate(tmp_path):
    """The CLI's loader: a checkpoint fills every parameter; a model with the
    enc_posenc gate takes a gate-free checkpoint and keeps the gate at 0; a
    model of other shapes is refused, or under --no-strict keeps its own
    values where the shapes differ."""
    from tal_asrd_tpu_torch.cli.test import load_weights
    from tal_asrd_tpu_torch.core.checkpoint import save_pytree
    from tal_asrd_tpu_torch.core.config import ModelConfig
    from tal_asrd_tpu_torch.core.convert import state_dict_to_params
    from tal_asrd_tpu_torch.models.asr import ASRModel

    from tests.test_torch_helpers import TINY
    src = ASRModel(ModelConfig(**TINY), device="cpu", generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "tiny.msgpack")
    save_pytree(path, {"params": state_dict_to_params(src.state_dict())})
    gated = ASRModel(ModelConfig(**TINY, enc_posenc=True), device="cpu")
    load_weights(gated, path)
    for name, t in src.state_dict().items():
        assert torch.equal(gated.state_dict()[name], t), name
    assert float(gated.mem_pos_alpha) == 0.0
    other = ASRModel(ModelConfig(**dict(TINY, d_decoder_override=16)), device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_weights(other, path)
    before = other.decoder_proj.weight.clone()
    load_weights(other, path, strict=False)
    assert torch.equal(other.decoder_proj.weight, before)            # other shape: kept
    for name, t in src.encoder.state_dict().items():                # same shape: loaded
        assert torch.equal(other.encoder.state_dict()[name], t), name
