"""Beam search with the separate speaker head, port against JAX package on
the CPU (float32, tiny width, every ReZero scalar 0.4): `collect_spk` at
beam 1 and 3, with and without `force_output`, and with the seeded tiny LM
of tests/test_torch_lm_fusion.py — tokens, lengths and `found` equal, the
bf16 speaker track `spk` within 1e-2; and the tokens equal those of the
same text weights without the head. The runner's legs:
tests/test_torch_spk_runner.py. JAX compiles each search once, in the
module's fixture."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.decode.beam import BeamSearchSpec as JBeamSearchSpec
from tal_asrd_tpu.decode.beam import beam_search as j_beam_search
from tal_asrd_tpu.models.asr import ASRModel as JASRModel
from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, beam_search
from tal_asrd_tpu_torch.models.asr import ASRModel

from tests.test_torch_helpers import tiny_audio, tiny_model_pair
from tests.test_torch_lm_fusion import tiny_lm

MAX_NEW, BATCH, LM_WEIGHT = 7, 3, 0.6
TRACK_ATOL = 1e-2          # the track is stored in bf16 by both packages
# (beam, force_output, with the LM)
CASES = [(1, True, False), (3, True, False), (3, False, False), (3, True, True)]


def headless_twin(model):
    """The same text weights without the head: no speakers at all, so the
    vocabulary (and the embedding table) is the head model's."""
    cfg = replace(model.cfg, use_speaker_head=False, num_speakers=0)
    twin = ASRModel(cfg, device="cpu")
    own = model.state_dict()
    twin.load_state_dict({k: v for k, v in own.items() if k in twin.state_dict()})
    return twin


@pytest.fixture(scope="module")
def beam_world():
    jmodel, variables, tmodel = tiny_model_pair(seed=31, use_speaker_head=True)
    cfg = tmodel.cfg
    jlm, lm_vars, tlm = tiny_lm(cfg.vocab_size)
    audio, lens = tiny_audio(BATCH)
    prime = np.ones((BATCH, 1), np.int32)

    def spec(cls, k, force, eos, weight=0.0):
        return cls(beam_size=k, max_new_tokens=MAX_NEW, eos_id=eos, vocab_size=cfg.num_tokens,
                   text_vocab_size=cfg.vocab_size, force_output=force, collect_spk=True,
                   num_speakers=cfg.num_speakers, lm_weight=weight)

    with torch.inference_mode():
        t_enc = tmodel.encode(torch.from_numpy(audio), torch.from_numpy(lens))
        # an EOS id that greedy decoding emits mid-sequence in lane 0, so that
        # retirement copies the track into the finished pool
        free = beam_search(tmodel, t_enc, torch.from_numpy(prime).long(),
                           spec(BeamSearchSpec, 1, True, -1))
    eos = int(free["tokens"][0, 3])
    j_enc = jax.jit(lambda v, a, l: jmodel.apply(v, a, l, False, method=JASRModel.encode))(
        variables, jnp.asarray(audio), jnp.asarray(lens))
    refs = {}
    for k, force, with_lm in CASES:
        s = spec(JBeamSearchSpec, k, force, -1 if force else eos, LM_WEIGHT if with_lm else 0.0)
        run = jax.jit(lambda v, e, p, lv, s=s, with_lm=with_lm: j_beam_search(
            jmodel, v, e, p, s, lm=jlm if with_lm else None, lm_params=lv))
        refs[(k, force, with_lm)] = jax.tree_util.tree_map(
            np.asarray, run(variables, j_enc, jnp.asarray(prime), lm_vars))
    return dict(tmodel=tmodel, tlm=tlm, t_enc=t_enc, prime=torch.from_numpy(prime).long(),
                refs=refs, spec=spec, eos=eos)


def port_search(w, k, force, with_lm, model=None, collect=True):
    s = w["spec"](BeamSearchSpec, k, force, -1 if force else w["eos"],
                  LM_WEIGHT if with_lm else 0.0)
    s.collect_spk = collect
    with torch.inference_mode():
        return beam_search(model or w["tmodel"], w["t_enc"], w["prime"], s,
                           lm=w["tlm"] if with_lm else None)


@pytest.mark.parametrize("k,force,with_lm", CASES)
def test_speaker_track_matches_jax(beam_world, k, force, with_lm):
    out, ref = port_search(beam_world, k, force, with_lm), beam_world["refs"][(k, force, with_lm)]
    np.testing.assert_array_equal(out["found"].numpy(), ref["found"])
    np.testing.assert_array_equal(out["lengths"].numpy(), ref["lengths"])
    np.testing.assert_array_equal(out["tokens"].numpy(), ref["tokens"])
    assert out["spk"].dtype == torch.bfloat16
    assert out["spk"].shape == (BATCH, MAX_NEW, beam_world["tmodel"].cfg.num_speakers)
    np.testing.assert_allclose(out["spk"].float().numpy(), ref["spk"].astype(np.float32),
                               rtol=0, atol=TRACK_ATOL)
    assert float(out["spk"].float().abs().max()) > 0.1       # the track is live
    if not force:      # some rows retired at EOS: the finished pool holds their track
        assert (ref["found"] & (ref["lengths"] < 1 + MAX_NEW)).any()


@pytest.mark.parametrize("k,with_lm", [(1, False), (3, False), (3, True)])
def test_the_head_never_moves_the_search(beam_world, k, with_lm):
    """The same text weights without the head, and the head model without
    its track, give the head model's tokens."""
    out = port_search(beam_world, k, True, with_lm)
    twin = port_search(beam_world, k, True, with_lm, model=headless_twin(beam_world["tmodel"]),
                       collect=False)
    for key in ("tokens", "lengths", "found", "scores"):
        assert torch.equal(out[key], twin[key]), key
