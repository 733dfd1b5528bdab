"""The separate speaker head of the port's ASRModel against the JAX
package's (CPU, float32, tiny width, every ReZero scalar bumped to 0.4):
the forward's speaker logits, a chain of cached decode steps with the
speaker track, the converter both ways on the head's leaves, and the
partial loads that warm-start a head model. The JAX side is computed once,
in the module's fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.core.checkpoint import load_params_partial as j_load_params_partial
from tal_asrd_tpu.models.asr import ASRModel as JASRModel
from tal_asrd_tpu_torch.core.checkpoint import LeafSpec, load_params_partial, tree_leaves
from tal_asrd_tpu_torch.core.convert import (
    load_partial_into,
    params_spec,
    params_to_state_dict,
    state_dict_to_params,
)

from tests.test_torch_helpers import tiny_audio, tiny_model_pair, to_numpy_tree

ATOL = 1e-5
N_STEPS = 6
HEAD = ("spk_enc_proj", "spk_decoder", "speaker_head_1", "speaker_head_2")


@pytest.fixture(scope="module")
def world():
    jmodel, variables, tmodel = tiny_model_pair(seed=21, use_speaker_head=True)
    audio, lens = tiny_audio(3)
    rng = np.random.default_rng(7)
    y = rng.integers(0, tmodel.cfg.num_tokens, size=(3, N_STEPS)).astype(np.int32)
    (j_lm, j_spk), j_enc = jax.jit(lambda v, a, t, n: jmodel.apply(v, a, t, n))(
        variables, jnp.asarray(audio), jnp.asarray(y), jnp.asarray(lens))
    j_state = jmodel.apply(variables, j_enc, 3, N_STEPS + 2,
                           method=JASRModel.init_decode_state)
    j_step = jax.jit(lambda v, tok, st: jmodel.apply(v, tok, st, method=JASRModel.decode_step))
    j_steps = []
    for i in range(N_STEPS):
        logits, spk, _, j_state = j_step(variables, jnp.asarray(y[:, i:i + 1]), j_state)
        j_steps.append((np.asarray(logits), np.asarray(spk)))
    return dict(jmodel=jmodel, variables=variables, tmodel=tmodel, audio=audio, lens=lens,
                y=y, j_lm=np.asarray(j_lm), j_spk=np.asarray(j_spk), j_steps=j_steps,
                j_spk_caches=jax.tree_util.tree_map(np.asarray, j_state["spk_caches"]))


def test_forward_gives_the_references_speaker_logits(world):
    tm = world["tmodel"]
    assert len(tm.spk_decoder.layers) == tm.cfg.n_decoder_layers // 2 == 2
    with torch.no_grad():
        (lm, spk), enc = tm(torch.from_numpy(world["audio"]), torch.from_numpy(world["y"]).long(),
                            torch.from_numpy(world["lens"]))
    assert spk.shape == (3, N_STEPS, tm.cfg.num_speakers) and enc["speaker_out"] is not None
    assert lm.shape[-1] == tm.cfg.vocab_size                # no speaker tokens in the vocab
    np.testing.assert_allclose(spk.numpy(), world["j_spk"], rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(lm.numpy(), world["j_lm"], rtol=ATOL, atol=ATOL)
    assert np.abs(world["j_spk"]).max() > 0.1               # the head is not multiplied away


def test_decode_step_carries_the_speaker_track_as_the_reference(world):
    tm = world["tmodel"]
    with torch.no_grad():
        enc = tm.encode(torch.from_numpy(world["audio"]), torch.from_numpy(world["lens"]))
        state = tm.init_decode_state(enc, 3, N_STEPS + 2)
        assert len(state["spk_caches"]) == 2 and len(state["spk_mem_kvs"]) == 2
        for i, (j_logits, j_spk) in enumerate(world["j_steps"]):
            logits, spk, _, state = tm.decode_step(
                torch.from_numpy(world["y"][:, i:i + 1]).long(), state)
            np.testing.assert_allclose(spk.numpy(), j_spk, rtol=ATOL, atol=ATOL)
            np.testing.assert_allclose(logits.numpy(), j_logits, rtol=ATOL, atol=ATOL)
        # the stepped speaker logits are the teacher-forced ones
        np.testing.assert_allclose(spk.numpy(), world["j_spk"][:, -1], rtol=ATOL, atol=ATOL)
        for ours, ref in zip(state["spk_caches"], world["j_spk_caches"]):
            for key in ("k", "v"):
                np.testing.assert_allclose(ours[key].numpy(), ref[key], rtol=ATOL, atol=ATOL)
        # a state without the head's caches (the state machine's) steps without it
        bare = {k: v for k, v in state.items() if not k.startswith("spk_")}
        _, spk, _, after = tm.decode_step(torch.zeros((3, 1), dtype=torch.long), bare)
        assert spk is None and "spk_caches" not in after


def test_converter_carries_the_head_both_ways(world):
    params = to_numpy_tree(world["variables"]["params"])
    sd = params_to_state_dict(params)
    own = world["tmodel"].state_dict()
    assert set(sd) == set(own)
    for prefix in HEAD:
        assert any(k.startswith(prefix + ".") for k in sd)
    assert sd["spk_decoder.layers.1.cross_attn.kv.weight"].shape == (64, 32)
    back = dict(tree_leaves(state_dict_to_params(own)))
    want = dict(tree_leaves(params))
    assert set(back) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(back[path], v)


def test_partial_loads_warm_start_the_head(world):
    """A headless speaker-token tree (vocabulary + 4 speaker rows) into the
    head model, not strict (scripts/accuracy.sh warm-starts a decoder so):
    its leaves land, the embedding cut to the text rows; the head keeps its
    own values. The same tree as the JAX package's load_params_partial."""
    tm = world["tmodel"]
    j_headless, vars_headless, _ = tiny_model_pair(seed=3)
    donor = to_numpy_tree(vars_headless["params"])
    spec = params_spec(tm)
    kw = dict(strict=False, expand_embeddings_to=tm.cfg.num_tokens)
    got = load_params_partial(spec, donor, **kw)
    ref = j_load_params_partial(to_numpy_tree(world["variables"]["params"]), donor, **kw)
    leaves = dict(tree_leaves(got))
    for path, v in tree_leaves(ref):
        if path[0] in HEAD:
            assert isinstance(leaves[path], LeafSpec)
        else:
            np.testing.assert_array_equal(leaves[path], np.asarray(v))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    try:
        load_partial_into(tm, got)
        after, want = tm.state_dict(), params_to_state_dict(to_numpy_tree(ref))
        assert set(after) == set(want)
        for k, v in after.items():
            assert torch.equal(v, want[k]), k
            if k.startswith(HEAD):
                assert torch.equal(v, before[k]), k
        np.testing.assert_array_equal(after["embedding.weight"].numpy(),
                                      donor["embedding"]["embedding"][:tm.cfg.num_tokens])
    finally:
        tm.load_state_dict(before)


def test_reset_parameters_draws_the_head_after_the_decoder():
    """The head's modules are registered after the decoder, so they draw
    last and a headless model draws what it drew before them; with one seed
    the two models agree up to the embedding table (the head model's has no
    speaker rows). The head's ReZero scalars start at zero (probes bump
    them)."""
    from tal_asrd_tpu_torch.core.config import ModelConfig
    from tal_asrd_tpu_torch.models.asr import ASRModel

    from tests.test_torch_helpers import TINY
    plain = ASRModel(ModelConfig(**TINY), device="cpu", generator=torch.Generator().manual_seed(4))
    head = ASRModel(ModelConfig(use_speaker_head=True, **TINY), device="cpu",
                    generator=torch.Generator().manual_seed(4))
    shared = dict(plain.named_parameters())
    for k, v in head.named_parameters():
        if k == "embedding.weight":
            break
        assert torch.equal(v, shared[k]), k
    names = [n for n, _ in head.named_parameters()]
    assert names[:len(shared)] == list(shared)
    assert names.index("spk_enc_proj.weight") > max(i for i, n in enumerate(names)
                                                     if n.startswith("decoder."))
    assert all(float(p.detach()) == 0.0 for n, p in head.named_parameters()
               if n.startswith("spk_decoder") and p.dim() == 0)
