"""LM shallow fusion, port against JAX package on the CPU (float32), on the
tiny model pair (tests/test_torch_helpers.py) and a tiny seeded LM (hidden
32, 2 layers, ReZero scalars 0.4, scripts/torch_lm_reference.py's
`seeded_lm_params`) whose weight moves the tokens (asserted: JAX's fused
tokens differ from its unfused ones in each decoder):

  * `beam_search` at beam 1 and 3, with a speaker token in the prime (it
    reaches the LM clamped), through the unfused model and through
    FusedASRDecoder (its kernel wrapper takes the plain version on CPU
    tensors): tokens, lengths and `found` equal, scores within 1e-4; an LM
    weight without an LM, or an LM at weight 0, is no fusion;
  * `unaligned_decode` and `unaligned_decode_batched` with the LM: tokens,
    num_tokens, iters, the align_chunk trajectory equal, align_attn equal
    or one bf16 step apart (tests/test_torch_unaligned.py's check); the
    fused decoder's plain path token-identical to the unfused model;
  * `EvalRunner`'s VAD leg and single-episode state machine with the LM
    (vocabulary 300, the BPE's): test_result.pkl equal to JAX's runner;
  * the eval CLI at full width with --lm-path, --lm-weight and
    --bf16-params (the seeded LM at the CLI's shape, 512 / 4 / 6): it fuses,
    and its LM stays f32.

JAX compiles each decode once, in module fixtures."""
import importlib.util
import os
import pickle
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.core.config import DecodeConfig as JDecodeConfig
from tal_asrd_tpu.core.config import LMConfig as JLMConfig
from tal_asrd_tpu.data.audio_io import load_audio_segment as j_load_audio_segment
from tal_asrd_tpu.data.synth import build_synth_corpus as j_build_synth_corpus
from tal_asrd_tpu.decode.beam import BeamSearchSpec as JBeamSearchSpec
from tal_asrd_tpu.decode.beam import beam_search as j_beam_search
from tal_asrd_tpu.decode.unaligned import UnalignedSpec as JUnalignedSpec
from tal_asrd_tpu.decode.unaligned import unaligned_decode as j_unaligned_decode
from tal_asrd_tpu.decode.unaligned import unaligned_decode_batched as j_unaligned_decode_batched
from tal_asrd_tpu.eval.runner import EvalRunner as JEvalRunner
from tal_asrd_tpu.models.asr import ASRModel as JASRModel
from tal_asrd_tpu.models.lm import DecoderLMModel as JDecoderLMModel
from tal_asrd_tpu.text.bpe import BpeTokenizer as JBpeTokenizer
from tal_asrd_tpu_torch.core.config import DecodeConfig, LMConfig
from tal_asrd_tpu_torch.core.convert import load_into
from tal_asrd_tpu_torch.data.audio_io import load_audio_segment
from tal_asrd_tpu_torch.data.synth import build_synth_corpus
from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, beam_search
from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
from tal_asrd_tpu_torch.decode.unaligned import (
    UnalignedSpec,
    unaligned_decode,
    unaligned_decode_batched,
)
from tal_asrd_tpu_torch.eval.runner import EvalRunner
from tal_asrd_tpu_torch.models.lm import DecoderLMModel
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

from tests.test_torch_helpers import tiny_audio, tiny_model_pair, to_numpy_tree
from tests.test_torch_unaligned import assert_same_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE = os.path.join(ROOT, "accuracy_release", "bpe.model")
LM_SHAPE = dict(hidden=32, layers=2)
LM_SEED, LM_SCALARS = 9, 0.4


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "torch_lm_reference", os.path.join(ROOT, "scripts", "torch_lm_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_script()


def tiny_lm(vocab):
    """(flax LM, its variables, port LM) from one seeded tree."""
    tree = REF.seeded_lm_params(vocab, LM_SEED, LM_SCALARS, **LM_SHAPE)
    cfg = dict(vocab_size=vocab, hidden_size=LM_SHAPE["hidden"], n_head=2,
               n_layers=LM_SHAPE["layers"], max_positions=64)
    tlm = load_into(DecoderLMModel(LMConfig(**cfg), device="cpu"), tree)
    return JDecoderLMModel(JLMConfig(**cfg)), {"params": tree}, tlm


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------
MAX_NEW, BATCH, BEAM_WEIGHT = 7, 3, 0.6


@pytest.fixture(scope="module")
def beam_world():
    jmodel, variables, tmodel = tiny_model_pair(seed=31)
    cfg = tmodel.cfg
    jlm, lm_vars, tlm = tiny_lm(cfg.vocab_size)
    audio, lens = tiny_audio(BATCH)
    # EOS, then a speaker token: the LM sees it clamped to text_vocab - 1
    prime = np.tile(np.asarray([[1, cfg.vocab_size + 2]], np.int32), (BATCH, 1))

    def spec(cls, k, weight):
        return cls(beam_size=k, max_new_tokens=MAX_NEW, eos_id=-1, vocab_size=cfg.num_tokens,
                   text_vocab_size=cfg.vocab_size, lm_weight=weight, force_output=True)

    j_enc = jax.jit(lambda v, a, l: jmodel.apply(v, a, l, False, method=JASRModel.encode))(
        variables, jnp.asarray(audio), jnp.asarray(lens))
    refs = {}
    for k in (1, 3):
        s = spec(JBeamSearchSpec, k, BEAM_WEIGHT)
        run = jax.jit(lambda v, e, p, lv, s=s: j_beam_search(
            jmodel, v, e, p, s, lm=jlm, lm_params=lv))
        refs[k] = jax.tree_util.tree_map(
            np.asarray, run(variables, j_enc, jnp.asarray(prime), lm_vars))
    with torch.inference_mode():
        t_enc = tmodel.encode(torch.from_numpy(audio), torch.from_numpy(lens))
    return dict(tmodel=tmodel, tlm=tlm, t_enc=t_enc, prime=torch.from_numpy(prime).long(),
                refs=refs, spec=spec)


def port_beam(w, k, weight, fused=False, lm=True):
    """The port's search; without an LM and at weight 0 it is held to JAX's
    by tests/test_torch_beam.py."""
    model = FusedASRDecoder(w["tmodel"]) if fused else w["tmodel"]
    with torch.inference_mode():
        return beam_search(model, w["t_enc"], w["prime"], w["spec"](BeamSearchSpec, k, weight),
                           lm=w["tlm"] if lm else None)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("k", [1, 3])
def test_beam_search_with_the_lm_matches_jax(beam_world, k, fused):
    out, ref = port_beam(beam_world, k, BEAM_WEIGHT, fused), beam_world["refs"][k]
    np.testing.assert_array_equal(out["found"].numpy(), ref["found"])
    np.testing.assert_array_equal(out["lengths"].numpy(), ref["lengths"])
    np.testing.assert_array_equal(out["tokens"].numpy(), ref["tokens"])
    np.testing.assert_allclose(out["scores"].numpy(), ref["scores"], rtol=0, atol=1e-4)
    # the gate is not vacuous: the LM moves the tokens
    assert not np.array_equal(ref["tokens"], port_beam(beam_world, k, 0.0, lm=False)["tokens"])


@pytest.mark.parametrize("case", ["weight_without_lm", "lm_at_weight_0"])
def test_no_fusion_without_an_lm_or_a_weight(beam_world, case):
    """As the reference: fusion needs an LM and lm_weight > 0; either alone
    decodes as without an LM, bit for bit."""
    if case == "weight_without_lm":
        out = port_beam(beam_world, 3, BEAM_WEIGHT, lm=False)
    else:
        out = port_beam(beam_world, 3, 0.0)
    ref = port_beam(beam_world, 3, 0.0, lm=False)
    for key in ("tokens", "lengths", "scores", "found"):
        assert torch.equal(out[key], ref[key]), key


# ---------------------------------------------------------------------------
# the state machine
# ---------------------------------------------------------------------------
SM_SAMPLES = 16000 * 12
SM_SPEC = dict(eos_id=1, chunk_size=24, max_positions=32, max_tokens=256, max_iters=400,
               max_outer=128, stall_patience=8, lm_weight=0.6)


@pytest.fixture(scope="module")
def machine():
    jmodel, variables, tmodel = tiny_model_pair(seed=5)
    jlm, lm_vars, tlm = tiny_lm(tmodel.cfg.vocab_size)
    kw = dict(SM_SPEC, text_vocab_size=tmodel.cfg.vocab_size)
    audio = (np.random.default_rng(0).standard_normal((3, SM_SAMPLES)) * 0.1
             ).astype(np.float32)
    encode = jax.jit(lambda v, a, n: jmodel.apply(v, a, n, False, method=JASRModel.encode))
    lens = [SM_SAMPLES - 5000, SM_SAMPLES, SM_SAMPLES]
    j_enc = encode(variables, jnp.asarray(audio[:1]), jnp.asarray(lens[:1]))
    j_len = int((~np.asarray(j_enc["encoder_padding_mask"][0])).sum())
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, e, n, lv: j_unaligned_decode(jmodel, v, e, n, JUnalignedSpec(**kw),
                                               lm=jlm, lm_variables=lv))(
        variables, j_enc, jnp.asarray(j_len), lm_vars))
    jb_enc = encode(variables, jnp.asarray(audio), jnp.asarray([SM_SAMPLES] * 3))
    jb_lens = jnp.asarray((~np.asarray(jb_enc["encoder_padding_mask"])).sum(-1), jnp.int32)
    jb = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, e, n, lv: j_unaligned_decode_batched(
            jmodel, v, e, n, JUnalignedSpec(**kw), lm=jlm, lm_variables=lv))(
        variables, jb_enc, jb_lens, lm_vars))
    with torch.inference_mode():
        t_enc = tmodel.encode(torch.from_numpy(audio[:1]), torch.tensor(lens[:1]))
        tb_enc = tmodel.encode(torch.from_numpy(audio), torch.tensor([SM_SAMPLES] * 3))
    spec = UnalignedSpec(**kw)
    port = unaligned_decode(tmodel, t_enc, j_len, spec, lm=tlm)
    # without the LM (held to JAX by tests/test_torch_unaligned.py)
    port_no_lm = unaligned_decode(tmodel, t_enc, j_len, spec)
    port_fused = unaligned_decode(FusedASRDecoder(tmodel), t_enc, j_len, spec, lm=tlm)
    tb_lens = (~tb_enc["encoder_padding_mask"]).sum(-1)
    port_b = unaligned_decode_batched(tmodel, tb_enc, tb_lens, spec, lm=tlm)
    singles = [unaligned_decode(tmodel, {"encoder_out": tb_enc["encoder_out"][i:i + 1]},
                                int(tb_lens[i]), spec, lm=tlm) for i in range(3)]
    return dict(ref=ref, jb=jb, port=port, port_no_lm=port_no_lm, port_fused=port_fused,
                port_b=port_b, singles=singles)


def test_state_machine_with_the_lm_matches_jax(machine):
    ref, no_lm = machine["ref"], machine["port_no_lm"]
    assert_same_run(machine["port"], ref)
    assert machine["port"]["events"]["windows"] > 2
    # the gate is not vacuous: the LM moves the tokens
    n = int(ref["num_tokens"])
    assert not np.array_equal(ref["tokens"][0, :n], no_lm["tokens"][0, :n].numpy())


def test_the_fused_decoder_fuses_the_lm_as_the_model_does(machine):
    a, b = machine["port"], machine["port_fused"]
    assert a["num_tokens"] == b["num_tokens"] and a["iters"] == b["iters"]
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["align_chunk"], b["align_chunk"])


def test_batched_machine_with_the_lm_matches_single_lanes_and_jax(machine):
    out = machine["port_b"]
    for lane, single in enumerate(machine["singles"]):
        assert int(out["num_tokens"][lane]) == single["num_tokens"]
        assert torch.equal(out["tokens"][lane], single["tokens"][0])
        assert_same_run(out, machine["jb"], lane)
    assert len(set(out["iters"].tolist())) > 1


# ---------------------------------------------------------------------------
# the runner's long-form legs
# ---------------------------------------------------------------------------
RUNNER_SPLIT = dict(n_episodes=1, episode_seconds=60.0, n_speakers=8, seed=202)
RUNNER_SPEC = dict(eos_id=1, chunk_size=48, max_positions=32, max_tokens=128, max_iters=300,
                   max_outer=64, stall_patience=8, text_vocab_size=300)
RUNNER_WEIGHT = 0.2     # 0.6 drowns the tiny model: every VAD window ends at once


@pytest.fixture(scope="module")
def runner_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm_runner")
    jmodel, variables, tmodel = tiny_model_pair(seed=1, vocab_size=300, num_speakers=8)
    params = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                    to_numpy_tree(variables["params"]))
    params["embedding"]["embedding"][300:] *= 3.0   # hypotheses carry speaker tokens
    load_into(tmodel, {"params": params})
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    jlm, lm_vars, tlm = tiny_lm(300)
    out = {}
    for side in ("port", "jax"):
        build = build_synth_corpus if side == "port" else j_build_synth_corpus
        load = load_audio_segment if side == "port" else j_load_audio_segment
        split = str(root / side / "split")
        build(split, **RUNNER_SPLIT)
        with open(os.path.join(split, "transcript.pkl"), "rb") as f:
            (stub, utts), = pickle.load(f).items()
        wav = load(os.path.join(split, f"{stub}.wav"), 0.0, None)
        res = {}
        for leg in ("vad", "sm"):
            d = str(root / side / leg)
            if side == "port":
                runner = EvalRunner(tmodel, BpeTokenizer(model_path=BPE),
                                    DecodeConfig(beam_size=3, lm_weight=RUNNER_WEIGHT),
                                    out_dir=d, device="cpu", lm=tlm)
                spec = UnalignedSpec(**RUNNER_SPEC, lm_weight=runner.lm_weight)
            else:
                runner = JEvalRunner(jmodel, jvars, JBpeTokenizer(model_path=BPE),
                                     JDecodeConfig(beam_size=3, lm_weight=RUNNER_WEIGHT),
                                     out_dir=d, lm=jlm, lm_variables=lm_vars)
                spec = JUnalignedSpec(**RUNNER_SPEC, lm_weight=RUNNER_WEIGHT)
            if leg == "vad":
                runner.test_step_unaligned_vad(wav, len(wav), utts, batch_lanes=4)
            else:
                runner.test_step_unaligned(wav, len(wav), utts, spec=spec)
            with open(os.path.join(d, "test_result.pkl"), "rb") as f:
                res[leg] = pickle.load(f)
        out[side] = res
    return out


@pytest.mark.parametrize("leg", ["vad", "sm"])
def test_runner_legs_with_the_lm_match_jax(runner_runs, leg):
    (ref_p, hyp_p), = runner_runs["port"][leg]
    (ref_j, hyp_j), = runner_runs["jax"][leg]
    assert [u["utterance"] for u in ref_p] == [u["utterance"] for u in ref_j]
    assert len(hyp_p) == len(hyp_j) > 0
    for a, b in zip(hyp_p, hyp_j):
        assert (a["utterance"], a["speakerId"]) == (b["utterance"], b["speakerId"])
        assert list(a["utteranceTokens"]) == [int(t) for t in b["utteranceTokens"]]
        np.testing.assert_array_equal(np.asarray(a["chunkStart"]), np.asarray(b["chunkStart"]))


def test_runner_reads_the_weight_only_with_an_lm(tmp_path):
    tok = BpeTokenizer(model_path=BPE)
    model = tiny_model_pair(seed=1, vocab_size=300, num_speakers=8)[2]
    cfg = DecodeConfig(lm_weight=0.3)
    with_lm = EvalRunner(model, tok, cfg, out_dir=str(tmp_path / "a"), device="cpu",
                         lm=tiny_lm(300)[2])
    without = EvalRunner(model, tok, cfg, out_dir=str(tmp_path / "b"), device="cpu")
    assert (with_lm.lm_weight, without.lm_weight) == (0.3, 0.0)
    assert with_lm._default_unaligned_spec().lm_weight == 0.3
    assert without._default_unaligned_spec().lm_weight == 0.0


# ---------------------------------------------------------------------------
# the eval CLI
# ---------------------------------------------------------------------------
CHECKPOINT = os.path.join(ROOT, "accuracy_release", "avg_last_3.bf16.msgpack")


@pytest.fixture(scope="module")
def seeded_lm_path(tmp_path_factory):
    """The LM at the eval CLI's shape (512 / 4 / 6), seeded as the fixture's."""
    from tal_asrd_tpu_torch.core.checkpoint import save_pytree
    path = str(tmp_path_factory.mktemp("seeded_lm") / "lm.msgpack")
    save_pytree(path, REF.seeded_lm_params(300, REF.SEEDED_SEED, REF.SEEDED_SCALARS))
    return path


def test_cli_fuses_the_lm(tmp_path, seeded_lm_path):
    """The aligned leg of the first 3 utterances of a 30 s episode at full
    width with the seeded LM and --bf16-params: the LM steps beside the
    decoder (its decode_step counted) and stays f32 while the ASR weights
    are cast, and the outputs are written."""
    from tal_asrd_tpu_torch.cli.test import main
    d = str(tmp_path)
    transcripts = build_synth_corpus(d, n_episodes=1, n_speakers=8, seed=202,
                                     episode_seconds=30.0)
    with open(os.path.join(d, "transcript.pkl"), "wb") as f:
        pickle.dump({"ep0": transcripts["ep0"][:3]}, f)
    argv = ["--train-data", d, "--valid-data", d, "--test-data", d, "--out-dir", d,
            "--device", "cpu", "--tokenizer", BPE, "--model-type", "1x", "--num-speakers",
            "8", "--load", CHECKPOINT, "--num-workers", "0", "--lm-path", seeded_lm_path,
            "--lm-weight", str(REF.SEEDED_WEIGHT), "--bf16-params"]
    with mock.patch.object(DecoderLMModel, "decode_step", autospec=True,
                           side_effect=DecoderLMModel.decode_step) as step:
        res = main(argv)
    runner = res["runner"]
    assert isinstance(runner.lm, DecoderLMModel) and runner.lm_weight == REF.SEEDED_WEIGHT
    assert runner.lm.cfg == LMConfig(vocab_size=300)
    assert all(p.dtype == torch.float32 for p in runner.lm.parameters())
    assert all(p.dtype == torch.bfloat16 for p in runner.model.parameters())
    assert step.call_count > 3
    with open(os.path.join(d, "test_result.pkl"), "rb") as f:
        assert len(pickle.load(f)) == len(runner.test_outputs) >= 1


def test_the_fixture_seeded_lm_is_this_script_s_and_moves_words():
    """The fixture's seeded LM is the one the reference script and
    chip_smoke.py rebuild, and on the JAX side it changes at least 2 % of
    the aligned leg's hypothesis words (else parity would test nothing)."""
    import json
    with open(os.path.join(ROOT, "tests", "fixtures", "torch_lm_reference.json")) as f:
        seeded = json.load(f)["seeded_eval"]
    assert (seeded["lm"]["seed"], seeded["lm"]["scalars"], seeded["lm"]["weight"]) == (
        REF.SEEDED_SEED, REF.SEEDED_SCALARS, REF.SEEDED_WEIGHT)
    assert seeded["compute_dtype"] == "float32"
    assert seeded["words_changed_share"] >= 0.02
    assert set(seeded["legs"]) == {"aligned", "sm", "vad"}
