"""The batch split over devices (decode/sharded.py) on two CPU "devices",
float32, on the tiny model pair (ReZero scalars 0.4), with audio lengths
that differ between the two parts, so that each part's own frontend mean,
and under `pad_mask_mode="batch_max"` its own longest audio, would change
its input:

  * the port's two-part beam search and state machine give the tokens and
    lengths (the machine: num_tokens, tokens, iters) of the JAX package's
    `make_sharded_decode` / `make_sharded_unaligned` on a one-device CPU
    mesh (the beam search at beam 3), run once per mode in the module's
    fixture;
  * and the port's unsharded decode's, with the scores within 1e-5;
  * the parts' encoder outputs equal the unsplit batch's within 1e-5
    (relative and absolute; a naive split's do not), the first part's
    features the unsplit batch's exactly; one part is the unsplit encode
    exactly; a batch that does not split evenly raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.decode.beam import BeamSearchSpec as JBeamSearchSpec
from tal_asrd_tpu.decode.sharded import make_sharded_decode as j_make_sharded_decode
from tal_asrd_tpu.decode.sharded import make_sharded_unaligned as j_make_sharded_unaligned
from tal_asrd_tpu.decode.unaligned import UnalignedSpec as JUnalignedSpec
from tal_asrd_tpu.parallel.mesh import make_mesh

from tal_asrd_tpu_torch.decode.beam import BeamSearchSpec, beam_search
from tal_asrd_tpu_torch.decode.sharded import (
    default_devices,
    encode_sharded,
    make_sharded_decode,
    make_sharded_unaligned,
    sharded_features,
)
from tal_asrd_tpu_torch.decode.unaligned import UnalignedSpec, unaligned_decode_batched

from tests.test_torch_helpers import TINY_SAMPLES, tiny_model_pair

DEVICES = ["cpu", "cpu"]
# the first part long, the second short: their log-mel means and longest
# audio differ from the whole batch's
LENS = np.array([TINY_SAMPLES, 40000, 30000, 24000], np.int32)
SEED = 7


def tiny_batch():
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal((len(LENS), TINY_SAMPLES)) * 0.1).astype(np.float32)
    for i, n in enumerate(LENS):
        audio[i, n:] = 0.0
        audio[i, :n] *= 1.0 + i          # louder rows later: the parts' means part
    return audio, LENS


BEAMS = (1, 3)
JAX_BEAM = 3          # one JAX compile a beam size: the reference runs at the wider one
SM_SPEC = dict(eos_id=1, chunk_size=16, max_positions=32, stall_patience=4,
               max_tokens=48, max_iters=120, max_outer=24)


def beam_spec(cls, cfg, k):
    return cls(beam_size=k, max_new_tokens=8, eos_id=1, vocab_size=cfg.num_tokens,
               text_vocab_size=cfg.vocab_size, force_output=True)


@pytest.fixture(scope="module", params=["buffer", "batch_max"])
def world(request):
    jmodel, variables, model = tiny_model_pair(seed=SEED, pad_mask_mode=request.param)
    audio, lens = tiny_batch()
    prime = np.ones((len(LENS), 1), np.int32)
    with torch.inference_mode():
        enc = model.encode(torch.from_numpy(audio), torch.from_numpy(lens))
    # the JAX package's sharded functions on a one-device CPU mesh
    mesh = make_mesh(devices=jax.devices("cpu")[:1])
    ja, jl, jp = jnp.asarray(audio), jnp.asarray(lens), jnp.asarray(prime)
    numpy_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    jax_beam = numpy_tree(j_make_sharded_decode(
        jmodel, beam_spec(JBeamSearchSpec, jmodel.cfg, JAX_BEAM), mesh)(variables, ja, jl, jp))
    jax_sm = numpy_tree(j_make_sharded_unaligned(jmodel, JUnalignedSpec(**SM_SPEC), mesh)(
        variables, ja, jl))
    # the port's two-part decodes
    port_beam = {k: make_sharded_decode(model, beam_spec(BeamSearchSpec, model.cfg, k),
                                        DEVICES)(audio, lens, prime) for k in BEAMS}
    port_sm = make_sharded_unaligned(model, UnalignedSpec(**SM_SPEC), DEVICES)(audio, lens)
    return dict(model=model, audio=audio, lens=lens, prime=prime, enc=enc,
                mode=request.param, jax_beam=jax_beam, jax_sm=jax_sm,
                port_beam=port_beam, port_sm=port_sm)


def test_parts_see_the_whole_batch(world):
    model, audio, lens, enc = world["model"], world["audio"], world["lens"], world["enc"]
    with torch.inference_mode():
        parts = encode_sharded([model, model], DEVICES, audio, lens)
        naive = [model.encode(torch.from_numpy(audio[i:i + 2]), torch.from_numpy(lens[i:i + 2]))
                 for i in (0, 2)]
    got = torch.cat([p["encoder_out"] for p in parts])
    np.testing.assert_allclose(got.numpy(), enc["encoder_out"].numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(torch.cat([p["encoder_padding_mask"] for p in parts]),
                       enc["encoder_padding_mask"])
    off = float((torch.cat([p["encoder_out"] for p in naive]) - enc["encoder_out"]).abs().max())
    assert off > 1e-3, off
    if world["mode"] == "batch_max":
        assert not torch.equal(naive[1]["encoder_padding_mask"],
                               enc["encoder_padding_mask"][2:])
    # the first part's features are the unsplit batch's: the whole batch's
    # log-mel and mean, taken on the first device
    with torch.inference_mode():
        feats = sharded_features([model, model], DEVICES, audio, lens)
        whole = model.extract_features(torch.from_numpy(audio), torch.from_numpy(lens))
    assert torch.equal(feats[0][0], whole[:2])


def test_one_part_is_the_unsplit_encode(world):
    with torch.inference_mode():
        (part,) = encode_sharded([world["model"]], ["cpu"], world["audio"], world["lens"])
    assert torch.equal(part["encoder_out"], world["enc"]["encoder_out"])


@pytest.mark.parametrize("k", BEAMS)
def test_sharded_beam_search_matches_unsharded(world, k):
    model = world["model"]
    spec = beam_spec(BeamSearchSpec, model.cfg, k)
    got = world["port_beam"][k]
    with torch.inference_mode():
        want = beam_search(model, world["enc"], torch.from_numpy(world["prime"]).long(), spec)
    assert set(got) == set(want)
    for key in ("tokens", "lengths", "found"):
        assert torch.equal(got[key], want[key]), key
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"].numpy(), atol=1e-5)
    assert len(set(got["tokens"][:, 1:].flatten().tolist())) > 2


def test_sharded_beam_search_matches_jax(world):
    got, ref = world["port_beam"][JAX_BEAM], world["jax_beam"]
    np.testing.assert_array_equal(got["lengths"].numpy(), ref["lengths"])
    np.testing.assert_array_equal(got["tokens"].numpy(), ref["tokens"])
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"], rtol=0, atol=1e-4)


def test_sharded_state_machine_matches_unsharded(world):
    model = world["model"]
    got = world["port_sm"]
    enc = world["enc"]
    ns = (~enc["encoder_padding_mask"]).sum(-1)
    with torch.inference_mode():
        want = unaligned_decode_batched(model, enc, ns, UnalignedSpec(**SM_SPEC))
    assert torch.equal(got["num_tokens"], want["num_tokens"])
    assert torch.equal(got["tokens"], want["tokens"])
    assert torch.equal(got["iters"], want["iters"])
    assert got["events"] == want["events"]
    assert int(want["num_tokens"].min()) > 1


def test_sharded_state_machine_matches_jax(world):
    got, ref = world["port_sm"], world["jax_sm"]
    np.testing.assert_array_equal(got["num_tokens"].numpy(), ref["num_tokens"])
    np.testing.assert_array_equal(got["iters"].numpy(), ref["iters"])
    for lane, n in enumerate(ref["num_tokens"]):
        np.testing.assert_array_equal(got["tokens"][lane, :n].numpy(), ref["tokens"][lane, :n])


def test_uneven_batch_raises(world):
    spec = BeamSearchSpec(beam_size=1, max_new_tokens=4, eos_id=1,
                          vocab_size=world["model"].cfg.num_tokens,
                          text_vocab_size=world["model"].cfg.vocab_size)
    run = make_sharded_decode(world["model"], spec, ["cpu"] * 3)
    with pytest.raises(ValueError, match="does not split evenly"):
        run(world["audio"], world["lens"], np.ones((len(LENS), 1), np.int32))
    run_u = make_sharded_unaligned(world["model"], UnalignedSpec(eos_id=1), ["cpu"] * 3)
    with pytest.raises(ValueError, match="does not split evenly"):
        run_u(world["audio"], world["lens"])


def test_default_devices_are_the_cuda_devices():
    if torch.cuda.is_available():
        assert default_devices() == [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_devices()


def test_each_distinct_device_runs_its_parts_on_a_host_thread_of_its_own():
    """per_device: one thread a distinct device (the parts of a device in
    order on it), inference mode in each, the results in part order, a
    part's exception raised; one distinct device runs on the calling
    thread."""
    import threading

    from tal_asrd_tpu_torch.decode.sharded import per_device
    seen = []

    def work(i):
        seen.append((i, threading.current_thread(), torch.is_inference_mode_enabled()))
        return i * 10

    assert per_device(["cpu", "cuda:0", "cpu", "cuda:0"], work) == [0, 10, 20, 30]
    threads = {i: t for i, t, _ in seen}
    assert threads[0] is threads[2] and threads[1] is threads[3]
    assert threads[0] is not threads[1]
    assert threading.current_thread() not in threads.values()
    assert all(mode for _, _, mode in seen)
    order = [i for i, _, _ in seen]
    assert order.index(0) < order.index(2) and order.index(1) < order.index(3)
    seen.clear()
    assert per_device(["cpu", "cpu"], work) == [0, 10]
    assert all(t is threading.current_thread() for _, t, _ in seen)

    def fails(i):
        raise ValueError(f"part {i}")
    with pytest.raises(ValueError, match="part"):
        per_device(["cpu", "cuda:1"], fails)
