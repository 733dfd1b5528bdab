"""The serving path as a whole: the port's `generate` (encode + beam search)
against the JAX package's `beam_search` on the same tiny model, weights and
audio (CPU, float32) — through the unfused model and through the fused
decoder (whose kernel wrapper takes its plain version on CPU tensors)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.decode.beam import BeamSearchSpec as JBeamSearchSpec
from tal_asrd_tpu.decode.beam import beam_search as j_beam_search
from tal_asrd_tpu.models.asr import ASRModel as JASRModel
from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, beam_search, make_generate_fn
from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder

from tests.test_torch_helpers import tiny_audio, tiny_model_pair

MAX_NEW = 7
BATCH = 3
# (beam size, force_output, use the EOS token picked by the fixture)
CASES = [(1, True, False), (3, True, False), (1, False, True),
         (3, False, True), (3, True, True)]


@pytest.fixture(scope="module")
def world():
    jmodel, variables, tmodel = tiny_model_pair(seed=31)
    audio, lens = tiny_audio(BATCH)
    prime = np.ones((BATCH, 1), np.int32)
    cfg = tmodel.cfg

    def spec(cls, k, force, eos):
        return cls(beam_size=k, max_new_tokens=MAX_NEW, eos_id=eos,
                   vocab_size=cfg.num_tokens, text_vocab_size=cfg.vocab_size,
                   force_output=force)

    # An EOS id that greedy decoding really emits mid-sequence in lane 0, so
    # that retirement, the finished pool and `found` are exercised.
    free = make_generate_fn(tmodel, spec(BeamSearchSpec, 1, True, -1), device="cpu")(
        audio, lens, prime)
    eos = int(free["tokens"][0, 3])

    j_enc = jax.jit(lambda v, a, l: jmodel.apply(v, a, l, False, method=JASRModel.encode))(
        variables, jnp.asarray(audio), jnp.asarray(lens))
    refs = {}
    for k, force, use_eos in CASES:
        s = spec(JBeamSearchSpec, k, force, eos if use_eos else -1)
        run = jax.jit(lambda v, e, p, s=s: j_beam_search(jmodel, v, e, p, s))
        refs[(k, force, use_eos)] = jax.tree_util.tree_map(
            np.asarray, run(variables, j_enc, jnp.asarray(prime)))
    return dict(tmodel=tmodel, audio=audio, lens=lens, prime=prime, eos=eos,
                refs=refs, spec=spec)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("k,force,use_eos", CASES)
def test_generate_matches_jax_beam_search(world, k, force, use_eos, fused):
    w = world
    spec = w["spec"](BeamSearchSpec, k, force, w["eos"] if use_eos else -1)
    decoder = FusedASRDecoder(w["tmodel"]) if fused else None
    out = make_generate_fn(w["tmodel"], spec, decoder=decoder, device="cpu")(
        w["audio"], w["lens"], w["prime"])
    ref = w["refs"][(k, force, use_eos)]
    np.testing.assert_array_equal(out["found"].numpy(), ref["found"])
    np.testing.assert_array_equal(out["lengths"].numpy(), ref["lengths"])
    np.testing.assert_array_equal(out["tokens"].numpy(), ref["tokens"])
    # scores: sums of <= 7 f32 log-probabilities, length-normalized
    np.testing.assert_allclose(out["scores"].numpy(), ref["scores"], rtol=0, atol=1e-4)
    assert out["tokens"].shape == (BATCH, 1 + MAX_NEW)


def test_eos_case_really_terminates(world):
    ref = world["refs"][(1, False, True)]
    assert ref["found"][0] and ref["lengths"][0] < 1 + MAX_NEW


def test_beam_search_takes_encoder_out_directly(world):
    tm = world["tmodel"]
    spec = world["spec"](BeamSearchSpec, 2, True, -1)
    with torch.no_grad():
        enc = tm.encode(torch.from_numpy(world["audio"]), torch.from_numpy(world["lens"]))
        a = beam_search(tm, enc, torch.from_numpy(world["prime"]).long(), spec)
        b = beam_search(FusedASRDecoder(tm), enc, torch.from_numpy(world["prime"]).long(), spec)
    np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"].numpy())
    assert bool(torch.isfinite(a["scores"]).all())


@pytest.mark.parametrize("field", ["lm_weight", "collect_spk", "collect_spk_embed"])
def test_unported_beam_options_raise(world, field):
    """Every option is ported. The speaker-head track (its parity with JAX:
    tests/test_torch_spk_decode.py) refuses a model without the head and, on
    the same weights with a seeded head, keeps [B, max_new, S] bf16 rows
    and leaves the tokens as they are. The speaker-embedding track
    (tests/test_torch_runner.py) runs when the spec names the model's
    speakers and refuses a spec that does not. LM fusion is ported
    (tests/test_torch_lm_fusion.py): an LM weight without an LM is inert, as
    in the reference, and gives JAX's tokens."""
    spec = world["spec"](BeamSearchSpec, 1, True, -1)
    setattr(spec, field, 0.5 if field == "lm_weight" else True)
    gen = make_generate_fn(world["tmodel"], spec, device="cpu")
    args = (world["audio"], world["lens"], world["prime"])
    if field == "lm_weight":
        out = gen(*args)
        np.testing.assert_array_equal(out["tokens"].numpy(), world["refs"][(1, True, False)]["tokens"])
        return
    if field == "collect_spk":
        with pytest.raises(ValueError, match="speaker head"):
            gen(*args)
        head = head_twin(world["tmodel"])
        spec.vocab_size = head.cfg.num_tokens
        spec.num_speakers = head.cfg.num_speakers
        out = make_generate_fn(head, spec, device="cpu")(*args)
        assert out["spk"].shape == (BATCH, MAX_NEW, head.cfg.num_speakers)
        assert out["spk"].dtype == torch.bfloat16 and bool(out["spk"].abs().sum() > 0)
        spec.collect_spk = False
        plain = make_generate_fn(head, spec, device="cpu")(*args)
        np.testing.assert_array_equal(out["tokens"].numpy(), plain["tokens"].numpy())
        return
    with pytest.raises(ValueError, match="num_speakers"):
        gen(*args)
    spec.num_speakers = world["tmodel"].cfg.num_speakers
    out = make_generate_fn(world["tmodel"], spec, device="cpu")(*args)
    assert out["spk_embed"].shape == (BATCH, MAX_NEW, 64)


def head_twin(model):
    """The same text weights with a seeded speaker head (ReZero scalars
    0.4) and the speaker tokens' rows dropped from the embedding."""
    from dataclasses import replace

    from tal_asrd_tpu_torch.models.asr import ASRModel
    cfg = replace(model.cfg, use_speaker_head=True)
    head = ASRModel(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    own = model.state_dict()
    with torch.no_grad():
        for name, p in head.state_dict().items():
            if name == "embedding.weight":
                p.copy_(own[name][:cfg.num_tokens])
            elif name in own:
                p.copy_(own[name])
            elif p.dim() == 0:
                p.fill_(0.4)
    return head


def test_generate_defaults_to_cuda():
    import inspect
    assert inspect.signature(make_generate_fn).parameters["device"].default == "cuda"


def test_top_k_puts_the_lower_index_first_among_equal_scores():
    """ROADMAP C9: bf16 logits make equal scores common, and the order of
    the chosen beams decides their slots. The selection equals lax.top_k's,
    ties included (torch.topk returned [2, 4, 1] for [1, 3, 3, 2, 3])."""
    from tal_asrd_tpu_torch.decode.beam import top_k
    rng = np.random.default_rng(0)
    for shape, k in (((4, 40), 5), ((3, 1540), 5), ((2, 7), 7)):
        x = rng.integers(0, 6, shape).astype(np.float32)
        x[0, :3] = -1e30                     # dead beams' entries tie too
        values, index = top_k(torch.from_numpy(x), k)
        j_values, j_index = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(index.numpy(), np.asarray(j_index))
        np.testing.assert_array_equal(values.numpy(), np.asarray(j_values))
    values, index = top_k(torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]]), 3)
    assert index.tolist() == [[1, 2, 4]]
