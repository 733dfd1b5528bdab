#!/usr/bin/env python3
"""Where the two packages' bfloat16 logits part (ROADMAP C16), on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_c16_probe.py [--tokens 24] \
        [--out out/c16_probe/report.json]

The case: episode 1 of the synthetic test split (seed 202, 4 x 180 s, as
scripts/ensure_corpus.sh makes it), the tracked checkpoint, the first window
of the sliding-window state machine (encoder frames [0, 357), where its
first 24 tokens are emitted), and the seeded LM of
scripts/torch_lm_reference.py. Three runs take the same inputs: the port in
float32 (the yardstick: in f32 both packages agree to 5e-6), the port in
bfloat16 and the JAX package in bfloat16, each with float32 parameters that
hold the checkpoint's values, as the eval CLIs build them. The four
episodes are encoded together, as `--unaligned` encodes a group.

Every intermediate is compared in path order, on episode 1:
  1. the frontend's log-mel;
  2. the output of each TDS group's stride-2 conv and of each TDS block;
  3. `decoder_proj` (the encoder output);
  4. the window's cross-attention K/V (`precompute_mem_kvs`);
  5. the prefill over the history slice (its logits at position 0, the
     first token's);
  6. each decoder layer's output at each of the next decode steps, teacher
     forced with the JAX CLI's float32 tokens of that episode
     (tests/fixtures/torch_lm_reference.json);
  7. the head's logits at each step;
  8. the LM's logits (float32 in both packages).

For each tensor it reports, per bf16 run, the largest and the RMS distance
from the port's f32 tensor, and the largest distance between the two bf16
runs. Then, at the step whose logits part most, it reruns each decoder layer
of the f32 port with one operand rounded to bf16 and everything else f32 —
the layer's input, the cross-attention K, the cross-attention V — and
reports how far each rounding alone moves the layer's output and its
sub-layers (`conditioning`). Last, it reruns the JAX output head's bf16
matmuls with an f32 accumulator (`preferred_element_type`) beside the
model's own, to see whether XLA's CPU bf16 dot accumulates in bf16. Writes
one JSON report.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = "accuracy_release/avg_last_3.bf16.msgpack"
TOKENIZER = "accuracy_release/bpe.model"
EVAL_SPLIT = dict(n_episodes=4, episode_seconds=180.0, n_speakers=8, seed=202)
LM_FIXTURE = os.path.join("tests", "fixtures", "torch_lm_reference.json")
EPISODE, CHUNK, P_MAX = 1, 357, 512


def bf16_step(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at |x| (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


def compare(f32, port, jax_):
    """Distances of the two bf16 runs from f32 (steps: in bf16 steps at the
    tensor's largest magnitude)."""
    f32, port, jax_ = (np.asarray(a, np.float32) for a in (f32, port, jax_))
    step = float(bf16_step(np.abs(f32).max()))
    dp, dj = np.abs(port - f32), np.abs(jax_ - f32)
    return {"shape": list(f32.shape), "f32_absmax": float(np.abs(f32).max()),
            "port_max_err": float(dp.max()), "jax_max_err": float(dj.max()),
            "port_max_steps": float(dp.max()) / step, "jax_max_steps": float(dj.max()) / step,
            "port_rms_err": float(np.sqrt((dp ** 2).mean())),
            "jax_rms_err": float(np.sqrt((dj ** 2).mean())),
            "port_vs_jax_max": float(np.abs(port - jax_).max())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--split", default=None, help="an existing split directory")
    ap.add_argument("--out", default=os.path.join(ROOT, "out", "c16_probe", "report.json"))
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    os.chdir(ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from tal_asrd_tpu.cli.args import build_configs as j_build_configs
    from tal_asrd_tpu.cli.args import get_argparser as j_get_argparser
    from tal_asrd_tpu.core.config import LMConfig as JLMConfig
    from tal_asrd_tpu.models.asr import ASRModel as JASRModel
    from tal_asrd_tpu.models.lm import DecoderLMModel as JLM
    from tal_asrd_tpu.train import ASRSystem as JASRSystem
    from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
    from tal_asrd_tpu_torch.cli.test import load_weights
    from tal_asrd_tpu_torch.core.checkpoint import load_pytree, tree_from_leaves, tree_leaves
    from tal_asrd_tpu_torch.core.config import LMConfig
    from tal_asrd_tpu_torch.core.convert import load_into, to_tensor
    from tal_asrd_tpu_torch.data.aligned import AlignedDataset
    from tal_asrd_tpu_torch.data.audio_io import load_audio_segment
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.models.lm import DecoderLMModel
    from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
    from tal_asrd_tpu_torch.train.system import ASRSystem
    from torch_lm_reference import seeded_lm_params

    t0 = time.perf_counter()
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    split = args.split or os.path.join(ROOT, "out", "c16_probe", "test")
    if not os.path.exists(os.path.join(split, "transcript.pkl")):
        build_synth_corpus(split, **EVAL_SPLIT)
    tok = BpeTokenizer(model_path=TOKENIZER)
    ds = AlignedDataset(split, tok, num_utterances=None, min_segment_duration=None,
                        max_segment_duration=None,
                        speaker_map_loc=os.path.join(split, "speaker_map.json"),
                        tokenizer_speakers=True, return_spk_ids=True)
    wavs = [load_audio_segment(os.path.join(split, f"{stub}.wav"), 0.0, None)
            for stub, _ in ds.index]
    n = len(wavs[0])
    assert all(len(w) == n for w in wavs), "the episodes are of one length"
    audio = np.stack(wavs).astype(np.float32)
    lens = np.full((len(wavs),), n, np.int32)
    with open(os.path.join(ROOT, LM_FIXTURE)) as f:
        ref = json.load(f)["seeded_eval"]
    gen = ref["legs"]["sm"]["episodes"][EPISODE]["tokens"]
    chunk0 = ref["legs"]["sm"]["episodes"][EPISODE]["align_chunk"][:args.tokens]
    assert set(chunk0) == {0}, f"the first {args.tokens} tokens leave window 0: {chunk0}"
    lm_cfg = ref["lm"]
    lm_tree = seeded_lm_params(lm_cfg["vocab"], lm_cfg["seed"], lm_cfg["scalars"],
                               hidden=lm_cfg["hidden"], layers=lm_cfg["layers"])
    argv = ["--train-data", split, "--valid-data", split, "--test-data", split,
            "--tokenizer", TOKENIZER, "--model-type", "1x", "--num-speakers", "8",
            "--load", CHECKPOINT, "--unaligned"]
    report = {"what": "ROADMAP C16 probe (scripts/torch_c16_probe.py)", "episode": EPISODE,
              "tokens": args.tokens, "teacher_forced_with": "JAX CLI f32 tokens, LM fixture",
              "stages": []}

    def add(stage, f32, port, jax_, **extra):
        rec = dict(stage=stage, **compare(f32, port, jax_), **extra)
        report["stages"].append(rec)
        print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in rec.items() if k != "shape"}), flush=True)

    # ---- the port, f32 and bf16 ---------------------------------------------------
    model_cfg, train_cfg, _ = build_configs(get_argparser().parse_args(argv + ["--device", "cpu"]),
                                            tok)
    ports = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        system = ASRSystem(model_cfg, train_cfg, device="cpu", compute_dtype=dt)
        load_weights(system.model, CHECKPOINT)
        ports[name] = system.model.eval()

    def port_encode(model):
        acts, hooks = {}, []
        enc_mod = model.encoder
        names = [nm for nm, _ in enc_mod.named_children() if nm.startswith(("down_", "group_"))]
        for nm in names:
            hooks.append(getattr(enc_mod, nm).register_forward_hook(
                lambda m, i, o, nm=nm: acts.__setitem__(nm, o[EPISODE].float().numpy())))
        with torch.inference_mode():
            a, l_ = torch.from_numpy(audio), torch.from_numpy(lens).long()
            mel = model.extract_features(a, audio_lens=l_)
            enc = model.encode(a, l_)
        for h in hooks:
            h.remove()
        return mel[EPISODE].float().numpy(), names, acts, enc

    port_out = {k: port_encode(m) for k, m in ports.items()}
    print(f"port encodes: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- the JAX package, bf16 ----------------------------------------------------
    j_cfg, j_train, _ = j_build_configs(j_get_argparser(is_train=False).parse_args(argv), tok)
    jsys = JASRSystem(j_cfg, j_train)
    jmodel = jsys.model
    loaded = {}
    for path, value in tree_leaves(load_pytree(CHECKPOINT)):
        loaded[path] = jnp.asarray(to_tensor(value).float().numpy())
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, 16000)), jnp.zeros((1, 4), jnp.int32),
                                                jnp.asarray([16000])))["params"]
    want = {tuple(getattr(k, "key", k) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    for path, spec in want.items():
        if path not in loaded:
            loaded[path] = jnp.zeros(spec.shape, jnp.float32)      # mem_pos_alpha
        assert tuple(loaded[path].shape) == tuple(spec.shape), path
    jvars = {"params": tree_from_leaves(loaded.items())}
    ja, jl = jnp.asarray(audio), jnp.asarray(lens)
    jmel = jmodel.apply(jvars, ja, False, True, jl, method=JASRModel.extract_features)
    jenc, inter = jmodel.apply(jvars, ja, jl, False, method=JASRModel.encode,
                               capture_intermediates=True, mutable=["intermediates"])
    jinter = inter["intermediates"]["encoder"]
    print(f"JAX encode: {time.perf_counter() - t0:.1f} s", flush=True)

    f32_mel, names, f32_acts, f32_enc = port_out["f32"]
    b16_mel, _, b16_acts, b16_enc = port_out["bf16"]
    add("1 log-mel", f32_mel, b16_mel, np.asarray(jmel[EPISODE], np.float32))
    for nm in names:
        add(f"2 encoder/{nm}", f32_acts[nm], b16_acts[nm],
            np.asarray(jinter[nm]["__call__"][0][EPISODE], np.float32))
    add("3 decoder_proj", f32_enc["encoder_out"][EPISODE].numpy(),
        b16_enc["encoder_out"][EPISODE].float().numpy(),
        np.asarray(jenc["encoder_out"][EPISODE], np.float32))

    # ---- the first window: cross K/V, prefill, teacher-forced steps --------------
    hist = np.zeros((1, P_MAX), np.int64)
    hist[0, :len(gen)] = np.asarray(gen[:P_MAX])
    hist[0, 1:] = 0
    hist[0, 0] = gen[0]                        # the machine's first window: [EOS], zeros
    enc_len = int((~f32_enc["encoder_padding_mask"][EPISODE]).sum())
    wmask_np = (np.arange(CHUNK) >= enc_len)[None]

    def port_window(model, enc):
        window = enc["encoder_out"][EPISODE:EPISODE + 1, :CHUNK]
        wmask = torch.from_numpy(wmask_np)
        layer_out = []
        hooks = [layer.register_forward_hook(
            lambda m, i, o: layer_out.append(o[0][0, -1].float().numpy()))
            for layer in model.decoder.layers]
        with torch.inference_mode():
            mem_kvs = model.precompute_mem_kvs(window)
            logits_all, _, caches = model.decode_prefill(torch.from_numpy(hist), mem_kvs,
                                                         wmask, P_MAX)
            layer_out.clear()
            steps, layers = [logits_all[0, 0].float().numpy()], []
            state = {"mem_kvs": mem_kvs, "caches": caches, "index": 1, "mask": wmask}
            for t in range(2, args.tokens + 1):
                layer_out.clear()
                y = torch.tensor([[gen[t - 1]]])
                logits, _, _, state = model.decode_step(y, dict(state, index=t - 1))
                steps.append(logits[0].float().numpy())
                layers.append([x.copy() for x in layer_out])
        for h in hooks:
            h.remove()
        kv = [(d["k"][0].float().numpy(), d["v"][0].float().numpy()) for d in mem_kvs]
        return kv, steps, layers

    pw = {k: port_window(ports[k], e) for k, e in (("f32", f32_enc), ("bf16", b16_enc))}

    jwindow = jenc["encoder_out"][EPISODE:EPISODE + 1, :CHUNK]
    jmask = jnp.asarray(wmask_np)
    jkvs = jmodel.apply(jvars, jwindow, method=JASRModel.precompute_mem_kvs)
    jlog_all, _, jcaches = jmodel.apply(jvars, jnp.asarray(hist, jnp.int32), jkvs, jmask, P_MAX,
                                        method=JASRModel.decode_prefill)
    jsteps, jlayers = [np.asarray(jlog_all[0, 0], np.float32)], []
    jstate = {"mem_kvs": jkvs, "caches": jcaches, "index": jnp.int32(1), "mask": jmask}
    for t in range(2, args.tokens + 1):
        y = jnp.asarray([[gen[t - 1]]], jnp.int32)
        (logits, _, _, jstate), inter = jmodel.apply(
            jvars, y, dict(jstate, index=jnp.int32(t - 1)), method=JASRModel.decode_step,
            capture_intermediates=True, mutable=["intermediates"])
        jsteps.append(np.asarray(logits[0], np.float32))
        dec = inter["intermediates"]["decoder"]
        jlayers.append([np.asarray(dec[f"layers_{i}"]["__call__"][0][0][0, -1], np.float32)
                        for i in range(len(pw["f32"][2][0]))])
    print(f"windows: {time.perf_counter() - t0:.1f} s", flush=True)

    for li, ((fk, fv), (pk, pv), jd) in enumerate(zip(pw["f32"][0], pw["bf16"][0], jkvs)):
        add(f"4 mem_kvs layer {li} k", fk, pk, np.asarray(jd["k"][0], np.float32))
        add(f"4 mem_kvs layer {li} v", fv, pv, np.asarray(jd["v"][0], np.float32))
    add("5 prefill logits (token 1)", pw["f32"][1][0], pw["bf16"][1][0], jsteps[0])
    for t in range(2, args.tokens + 1):
        for li in range(len(jlayers[0])):
            add(f"6 step token {t} layer {li}", pw["f32"][2][t - 2][li],
                pw["bf16"][2][t - 2][li], jlayers[t - 2][li])
        add(f"7 logits token {t}", pw["f32"][1][t - 1], pw["bf16"][1][t - 1], jsteps[t - 1])

    # ---- the LM (f32 in both) ----------------------------------------------------
    port_lm = load_into(DecoderLMModel(LMConfig(vocab_size=lm_cfg["vocab"]), device="cpu"),
                        lm_tree)
    jlm = JLM(JLMConfig(vocab_size=lm_cfg["vocab"]))
    jlm_vars = {"params": jax.tree_util.tree_map(jnp.asarray, lm_tree)}
    lm_in = np.minimum(hist, lm_cfg["vocab"] - 1)
    with torch.inference_mode():
        p_all, p_caches = port_lm.decode_prefill(torch.from_numpy(lm_in), P_MAX)
        p_lm = [p_all[0, 0].numpy()]
        for t in range(2, args.tokens + 1):
            lo, p_caches = port_lm.decode_step(torch.tensor([[min(gen[t - 1], 299)]]),
                                               p_caches, t - 1)
            p_lm.append(lo[0].numpy())
    j_all, j_caches = jlm.apply(jlm_vars, jnp.asarray(lm_in, jnp.int32), P_MAX,
                                method=JLM.decode_prefill)
    j_lm = [np.asarray(j_all[0, 0])]
    for t in range(2, args.tokens + 1):
        lo, j_caches = jlm.apply(jlm_vars, jnp.asarray([[min(gen[t - 1], 299)]], jnp.int32),
                                 j_caches, jnp.int32(t - 1), method=JLM.decode_step)
        j_lm.append(np.asarray(lo[0]))
    for t in range(1, args.tokens + 1):
        add(f"8 LM logits token {t}", p_lm[t - 1], p_lm[t - 1], j_lm[t - 1])

    # ---- the head's matmuls: the JAX bf16 dot against an f32 accumulator -----------
    # Recompute the JAX output head on JAX's own last-layer state at each step,
    # once as the model does (bf16 x bf16 -> bf16 dots) and once with
    # preferred_element_type=float32, both rounded to bf16 at the end.
    p = jvars["params"]
    proj = p["embedding_proj"].astype(jnp.bfloat16)
    table = p["embedding"]["embedding"].astype(jnp.bfloat16)
    worst = {"as_model": 0.0, "f32_accumulator": 0.0}
    for t in range(2, args.tokens + 1):
        h = jnp.asarray(jlayers[t - 2][-1], jnp.bfloat16)[None]
        e = h @ proj.T
        as_model = np.asarray((e @ table.T)[0], np.float32)
        e32 = jnp.dot(h, proj.T, preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        acc32 = np.asarray(jnp.dot(e32, table.T, preferred_element_type=jnp.float32)
                           .astype(jnp.bfloat16)[0], np.float32)
        exact = np.asarray(h, np.float32) @ np.asarray(proj, np.float32).T
        exact = np.asarray(jnp.asarray(exact, jnp.bfloat16), np.float32) @ np.asarray(
            table, np.float32).T
        worst["as_model"] = max(worst["as_model"], float(np.abs(as_model - exact).max()))
        worst["f32_accumulator"] = max(worst["f32_accumulator"],
                                       float(np.abs(acc32 - exact).max()))
    report["jax_head_matmul_vs_exact_max"] = worst
    print(json.dumps({"jax_head_matmul_vs_exact_max": worst}), flush=True)

    # ---- conditioning at the worst step: f32 arithmetic, only the input rounded --
    # At the step whose logits part most, rerun each decoder layer of the f32
    # port on its own f32 input and on that input rounded to bf16, everything
    # else f32 (the same caches and cross K/V): how far a rounding of the
    # layer's input alone moves its output and its sub-layers, and the
    # cross-attention weights it computes.
    errs = [s for s in report["stages"] if s["stage"].startswith("7 logits")]
    worst_t = int(max(errs, key=lambda s: s["jax_max_err"])["stage"].split()[-1])
    model = ports["f32"]
    window = f32_enc["encoder_out"][EPISODE:EPISODE + 1, :CHUNK]
    wmask = torch.from_numpy(wmask_np)
    seen = []
    hooks = [layer.register_forward_pre_hook(
        lambda m, a, kw, li=li: seen.append((li, a[0].clone(), {
            k: ({"k": v["k"].clone(), "v": v["v"].clone()} if k == "self_cache" else v)
            for k, v in kw.items()})), with_kwargs=True)
        for li, layer in enumerate(model.decoder.layers)]
    with torch.inference_mode():
        mem_kvs = model.precompute_mem_kvs(window)
        _, _, caches = model.decode_prefill(torch.from_numpy(hist), mem_kvs, wmask, P_MAX)
        state = {"mem_kvs": mem_kvs, "caches": caches, "index": 1, "mask": wmask}
        for t in range(2, worst_t + 1):
            seen.clear()
            _, _, _, state = model.decode_step(torch.tensor([[gen[t - 1]]]),
                                               dict(state, index=t - 1))
        for h in hooks:
            h.remove()
        cond = []
        for li, tgt, kw in seen:
            layer = model.decoder.layers[li]

            def parts(x, mem_kv=None):
                cache = {"k": kw["self_cache"]["k"].clone(), "v": kw["self_cache"]["v"].clone()}
                sa, _, _ = layer.self_attn(x, cache=cache, cache_index=kw["cache_index"])
                x1 = x + sa * layer.resweight
                ca, w = layer.cross_attn(x1, None, key_padding_mask=kw["memory_key_padding_mask"],
                                         mem_kv=mem_kv or kw["mem_kv"])
                x2 = x1 + ca * layer.resweight_src
                ff = layer.linear2(torch.relu(layer.linear1(x2)))
                return {"self_attn": sa, "cross_attn": ca, "ff": ff,
                        "out": x2 + ff * layer.resweight}, w[0, -1]
            ref_parts, w_ref = parts(tgt)
            rounded = tgt.to(torch.bfloat16).float()
            got_parts, w_got = parts(rounded)
            top = torch.topk(w_ref, 2).values
            mkv = kw["mem_kv"]
            k_parts, _ = parts(tgt, {"k": mkv["k"].to(torch.bfloat16).float(), "v": mkv["v"]})
            v_parts, _ = parts(tgt, {"k": mkv["k"], "v": mkv["v"].to(torch.bfloat16).float()})
            cond.append({
                "resweight": float(layer.resweight), "resweight_src": float(layer.resweight_src),
                "cross_k_rounded_out_moved_max": float((k_parts["out"] - ref_parts["out"])
                                                       .abs().max()),
                "cross_v_rounded_out_moved_max": float((v_parts["out"] - ref_parts["out"])
                                                       .abs().max()),
                "layer": li, "input_rounding_max": float((rounded - tgt).abs().max()),
                **{f"{k}_moved_max": float((got_parts[k] - ref_parts[k]).abs().max())
                   for k in ref_parts},
                "cross_attn_weight_top2": [float(v) for v in top],
                "cross_attn_weights_moved_max": float((w_got - w_ref).abs().max())})
            print(json.dumps(cond[-1]), flush=True)
    report["conditioning"] = {"token": worst_t, "layers": cond}

    report["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
