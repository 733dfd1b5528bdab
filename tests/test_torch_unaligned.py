"""The unaligned state machine (decode/unaligned.py), port against JAX
package (tal_asrd_tpu/decode/unaligned.py), on the tiny model pair
(tests/test_torch_helpers.py: float32, ReZero scalars bumped) over 12 s of
seeded noise: 133 encoder frames, windows of 24 frames, a history of 32 (16)
tokens.

  * single lane, in each configuration: tokens, num_tokens, iters and the
    align_chunk trajectory equal; align_attn (bf16 in both) equal or one
    bf16 step apart where the two f32 sources round to either side;
  * every event is reached, asserted from the trajectories and the event
    counts: shift, stall reset, repetition reset with rollback, eviction at
    blocks 1 and 8, termination by a reset inside the last window,
    eos_advance, stall_rollback, the short episode's padded window;
  * the batched form: each lane equals its single-lane run and JAX's vmapped
    machine, with lanes that finish at different steps;
  * the fused decoder's plain path (per layer, and kv8 with its scales per
    lane) against the port's unfused model; the pad bias rebuilt for each
    window's mask (ROADMAP C2).

JAX runs once per configuration, in one module fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.decode.unaligned import UnalignedSpec as JUnalignedSpec
from tal_asrd_tpu.decode.unaligned import unaligned_decode as j_unaligned_decode
from tal_asrd_tpu.decode.unaligned import unaligned_decode_batched as j_unaligned_decode_batched
from tal_asrd_tpu.models.asr import ASRModel as JASRModel
import tal_asrd_tpu_torch.decode.fused_step as fused_step_mod
from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
from tal_asrd_tpu_torch.decode.unaligned import (
    UnalignedSpec,
    unaligned_decode,
    unaligned_decode_batched,
)
from tal_asrd_tpu_torch.ops.cuda_decode import quantize_mem_kv

from tests.test_torch_helpers import tiny_model_pair

SEED = 5                 # the tiny pair's weights: its output is varied enough
SAMPLES = 16000 * 12     # 12 s -> 133 encoder frames
AUDIO_LEN = SAMPLES - 5000
BASE = dict(eos_id=1, chunk_size=24, max_positions=32, max_tokens=256, max_iters=400,
            max_outer=128)
# each configuration and what it reaches (asserted below)
CONFIGS = {
    "defaults": {},                                        # shifts, repetition resets
    "stall": dict(stall_patience=4, rep_n=12),             # stall resets
    "terminate": dict(rep_n=3),                            # a reset in the last window
    "evict1": dict(rep_n=12, stall_patience=40, max_positions=16, history_evict_block=1),
    "evict8": dict(rep_n=12, stall_patience=40, max_positions=16, history_evict_block=8),
    "eos_advance": dict(eos_advance=True, eos_id=55),      # 55: a token the model emits
    "stall_rollback": dict(stall_patience=4, rep_n=12, stall_rollback=True),
    "short": dict(chunk_size=160),                         # chunk > S: a padded window
}
BATCH_CONFIG = dict(stall_patience=8)


def spec_kw(name):
    return dict(BASE, **CONFIGS[name])


@pytest.fixture(scope="module")
def runs():
    jmodel, variables, tmodel = tiny_model_pair(seed=SEED)
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((3, SAMPLES)) * 0.1).astype(np.float32)
    encode = jax.jit(lambda v, a, n: jmodel.apply(v, a, n, False, method=JASRModel.encode))

    # one episode, AUDIO_LEN valid samples
    j_enc = encode(variables, jnp.asarray(audio[:1]), jnp.asarray([AUDIO_LEN]))
    j_len = int((~np.asarray(j_enc["encoder_padding_mask"][0])).sum())
    with torch.inference_mode():
        t_enc = tmodel.encode(torch.from_numpy(audio[:1]), torch.tensor([AUDIO_LEN]))
    t_len = int((~t_enc["encoder_padding_mask"][0]).sum())
    assert j_len == t_len
    ref = {}
    for name in CONFIGS:
        spec = JUnalignedSpec(**spec_kw(name))
        out = jax.jit(lambda v, e, n, s=spec: j_unaligned_decode(jmodel, v, e, n, s))(
            variables, j_enc, jnp.asarray(j_len))
        ref[name] = jax.tree_util.tree_map(np.asarray, out)
    port = {name: unaligned_decode(tmodel, t_enc, t_len, UnalignedSpec(**spec_kw(name)))
            for name in CONFIGS}

    # three equal-length episodes, encoded together
    jb_enc = encode(variables, jnp.asarray(audio), jnp.asarray([SAMPLES] * 3))
    jb_lens = jnp.asarray((~np.asarray(jb_enc["encoder_padding_mask"])).sum(-1), jnp.int32)
    bspec = dict(BASE, **BATCH_CONFIG)
    jb = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, e, n: j_unaligned_decode_batched(
            jmodel, v, e, n, JUnalignedSpec(**bspec)))(variables, jb_enc, jb_lens))
    with torch.inference_mode():
        tb_enc = tmodel.encode(torch.from_numpy(audio), torch.tensor([SAMPLES] * 3))
    tb_lens = (~tb_enc["encoder_padding_mask"]).sum(-1)
    return dict(tmodel=tmodel, t_enc=t_enc, t_len=t_len, ref=ref, port=port,
                jb=jb, tb_enc=tb_enc, tb_lens=tb_lens, bspec=bspec)


def assert_same_run(got, ref, lane=None):
    """tokens, num_tokens, iters, align_chunk equal; align_attn equal or one
    bf16 step apart (a rounding boundary between two f32 sources that agree
    to ~1e-6)."""
    pick = (lambda t: np.asarray(t)) if lane is None else (lambda t: np.asarray(t)[lane])
    n = int(pick(ref["num_tokens"]))
    got_n = int(got["num_tokens"] if lane is None else got["num_tokens"][lane])
    assert got_n == n
    ref_tok = pick(ref["tokens"])
    ref_tok = ref_tok[0] if ref_tok.ndim == 2 else ref_tok
    got_tok = got["tokens"][0] if lane is None else got["tokens"][lane]
    np.testing.assert_array_equal(got_tok[:n].numpy(), ref_tok[:n])
    assert int(got["iters"] if lane is None else got["iters"][lane]) == int(pick(ref["iters"]))
    got_chunk = got["align_chunk"] if lane is None else got["align_chunk"][lane]
    np.testing.assert_array_equal(got_chunk[: n - 1].numpy(), pick(ref["align_chunk"])[: n - 1])
    got_attn = (got["align_attn"] if lane is None else got["align_attn"][lane])[: n - 1]
    ref_attn = torch.from_numpy(pick(ref["align_attn"])[: n - 1].astype(np.float32)
                                ).to(torch.bfloat16)
    far = got_attn.float() != ref_attn.float()
    assert bool((torch.nextafter(got_attn, ref_attn) == ref_attn)[far].all())
    assert int(far.sum()) <= 0.01 * far.numel() + 1


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_machine_matches_jax(runs, name):
    assert_same_run(runs["port"][name], runs["ref"][name])


def moves(out):
    """The window's moves read from the align_chunk trajectory."""
    n = out["num_tokens"]
    chunks = out["align_chunk"][: n - 1].tolist()
    return [b - a for a, b in zip(chunks[:-1], chunks[1:]) if b != a]


def test_each_event_is_reached(runs):
    port, t_len = runs["port"], runs["t_len"]
    chunk = BASE["chunk_size"]
    shift, skip = int(chunk * 0.25), int(chunk * 0.1)
    last_start = t_len - chunk
    ev = {name: out["events"] for name, out in port.items()}

    # shifts and repetition resets: moves by the shift and the skip amount,
    # and tokens rolled back (fewer tokens than steps)
    assert shift in moves(port["defaults"]) and ev["defaults"]["shifts"] > 0
    assert ev["defaults"]["repeat_resets"] > 0 and skip in moves(port["defaults"])
    d = port["defaults"]
    assert d["num_tokens"] - 1 < d["iters"]
    # stall resets (no repetition at rep_n 12), no rollback without the extension
    assert ev["stall"]["stall_resets"] > 0 and ev["stall"]["repeat_resets"] == 0
    assert port["stall"]["num_tokens"] - 1 == port["stall"]["iters"]
    # stall_rollback: the same resets now roll their stall tokens back
    sr = port["stall_rollback"]
    assert ev["stall_rollback"]["stall_resets"] > 0 and sr["num_tokens"] - 1 < sr["iters"]
    # eviction at blocks 1 and 8: the history hits max_positions, windows
    # that do not move the window are prefills again
    for name, block in (("evict1", 1), ("evict8", 8)):
        assert ev[name]["evictions"] > 0
        assert ev[name]["windows"] > ev[name]["shifts"] + ev[name]["stall_resets"] + 1
    assert ev["evict1"]["evictions"] > ev["evict8"]["evictions"]
    # termination by a reset in the last window, inside the budgets
    t = port["terminate"]
    assert ev["terminate"]["terminations"] == 1 and t["iters"] < BASE["max_iters"]
    assert t["align_chunk"][t["num_tokens"] - 2] == last_start
    # eos_advance: window moves by other amounts than shift and skip
    assert ev["eos_advance"]["eos_advances"] > 0
    assert any(m not in (shift, skip) for m in moves(port["eos_advance"])[:-1])
    # the short episode: one padded window at 0, terminated
    s = port["short"]
    assert ev["short"]["windows"] == 1 and ev["short"]["terminations"] == 1
    assert not s["align_chunk"][: s["num_tokens"] - 1].any()


def test_batched_lanes_equal_single_lanes_and_jax(runs):
    tmodel, tb_enc, tb_lens = runs["tmodel"], runs["tb_enc"], runs["tb_lens"]
    spec = UnalignedSpec(**runs["bspec"])
    out = unaligned_decode_batched(tmodel, tb_enc, tb_lens, spec)
    for lane in range(3):
        single = unaligned_decode(
            tmodel, {"encoder_out": tb_enc["encoder_out"][lane:lane + 1]},
            int(tb_lens[lane]), spec)
        n = single["num_tokens"]
        assert int(out["num_tokens"][lane]) == n and int(out["iters"][lane]) == single["iters"]
        assert torch.equal(out["tokens"][lane], single["tokens"][0])
        assert torch.equal(out["align_chunk"][lane], single["align_chunk"])
        assert torch.equal(out["align_attn"][lane], single["align_attn"])
        assert out["events"][lane] == single["events"]
        assert_same_run(out, runs["jb"], lane)
    # the lanes finish at different steps
    assert len(set(out["iters"].tolist())) > 1


class DequantizedCrossKV:
    """The unfused model on kv8's int8 cross K/V: each window's K/V
    quantized as FusedASRDecoder(kv8=True) quantizes them, then dequantized
    for the model's own decode path."""

    def __init__(self, model):
        self.model = model
        self.decode_prefill = model.decode_prefill
        self.decode_step = model.decode_step

    def precompute_mem_kvs(self, memory):
        out = []
        for kv in self.model.precompute_mem_kvs(memory):
            b, s, h, dh = kv["k"].shape
            k8, sk, v8, sv = quantize_mem_kv(kv["k"].reshape(b, s, h * dh),
                                             kv["v"].reshape(b, s, h * dh))
            out.append({"k": (k8.float() * sk).reshape(b, s, h, dh),
                        "v": (v8.float() * sv).reshape(b, s, h, dh)})
        return tuple(out)


@pytest.mark.parametrize("config", ["per_layer", "kv8"])
def test_fused_plain_path_matches_the_unfused_model(runs, config):
    """The fused decoder on CPU tensors (the kernels' plain versions)
    against the unfused model: per layer, and kv8 against the unfused model
    on the same int8 K/V. Equal tokens, iters and trajectory; attention
    rows within 1e-5 (f32 attention, stored bf16: or one bf16 step)."""
    tmodel, t_enc, t_len = runs["tmodel"], runs["t_enc"], runs["t_len"]
    fused = FusedASRDecoder(tmodel, kv8=config == "kv8")
    unfused = tmodel if config == "per_layer" else DequantizedCrossKV(tmodel)
    for name in ("defaults", "evict8", "eos_advance"):
        spec = UnalignedSpec(**spec_kw(name))
        got = unaligned_decode(fused, t_enc, t_len, spec)
        want = unaligned_decode(unfused, t_enc, t_len, spec)
        n = want["num_tokens"]
        assert got["num_tokens"] == n and got["iters"] == want["iters"]
        assert torch.equal(got["tokens"], want["tokens"])
        assert torch.equal(got["align_chunk"], want["align_chunk"])
        a, b = got["align_attn"][: n - 1], want["align_attn"][: n - 1]
        far = (a.float() - b.float()).abs() > 1e-5
        assert bool((torch.nextafter(a, b) == b)[far].all())


def test_kv8_scales_are_per_lane_in_the_batched_machine(runs, monkeypatch):
    """JAX's vmapped machine quantizes each lane's window alone; so does the
    port's: every quantize_mem_kv call sees one lane, a lane's batched run
    equals its single-lane kv8 run, and its scales differ from scales over
    the group's windows."""
    tmodel, tb_enc, tb_lens = runs["tmodel"], runs["tb_enc"], runs["tb_lens"]
    spec = UnalignedSpec(**runs["bspec"])
    seen = []

    def recording(k, v):
        seen.append(k.shape[0])
        return quantize_mem_kv(k, v)

    monkeypatch.setattr(fused_step_mod, "quantize_mem_kv", recording)
    fused = FusedASRDecoder(tmodel, kv8=True)
    out = unaligned_decode_batched(fused, tb_enc, tb_lens, spec)
    assert seen and set(seen) == {1}
    for lane in range(3):
        single = unaligned_decode(
            fused, {"encoder_out": tb_enc["encoder_out"][lane:lane + 1]},
            int(tb_lens[lane]), spec)
        assert torch.equal(out["tokens"][lane], single["tokens"][0])
        assert int(out["iters"][lane]) == single["iters"]
    # per-lane scales are not the group's
    window = tb_enc["encoder_out"][:, :spec.chunk_size]
    d = tmodel.cfg.d_decoder
    with torch.inference_mode():
        kv = tmodel.decoder.layers[0].cross_attn.kv(window)
        _, sk_lane, _, _ = quantize_mem_kv(kv[:1, :, :d], kv[:1, :, d:])
        _, sk_group, _, _ = quantize_mem_kv(kv[..., :d], kv[..., d:])
        assert not torch.equal(sk_lane, sk_group)
        assert torch.equal(fused.precompute_mem_kvs(window[:1])[0]["sk"], sk_lane)


def test_fused_decoder_rebuilds_the_pad_bias_for_each_window(runs, monkeypatch):
    """ROADMAP C2 in the machine: each window event starts a state with the
    window's own pad mask, and the fused decoder builds its pad bias from
    it. Two short episodes (encoder lengths below the chunk: every window
    padded, at another frame in each) decoded one after the other by ONE
    FusedASRDecoder: each bias masks exactly its episode's padding, and the
    tokens equal the unfused model's."""
    tmodel, t_enc = runs["tmodel"], runs["t_enc"]
    spec = UnalignedSpec(**spec_kw("short"))
    fused = FusedASRDecoder(tmodel)
    biases = []
    build = FusedASRDecoder._pad_bias

    def recording(mask, b, s, device):
        bias = build(mask, b, s, device)
        biases.append(bias)
        return bias

    monkeypatch.setattr(FusedASRDecoder, "_pad_bias", staticmethod(recording))
    for enc_len in (100, 60):
        biases.clear()
        got = unaligned_decode(fused, t_enc, enc_len, spec)
        want = unaligned_decode(tmodel, t_enc, enc_len, spec)
        assert torch.equal(got["tokens"], want["tokens"]) and got["iters"] == want["iters"]
        assert len(biases) == got["events"]["windows"] >= 1
        for bias in biases:
            assert bias.shape == (1, spec.chunk_size)
            assert bool((bias[0, enc_len:] == -1e9).all()) and not bias[0, :enc_len].any()
