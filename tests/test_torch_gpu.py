"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc. They carry the
marker `gpu` and skip on a machine without a card; whether there is one is
decided inside the test, never while the module is imported.

    python -m pytest tests/test_torch_gpu.py -m gpu
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
def test_kernels_build_and_match_their_plain_versions_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--phases", "kernels"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "kernel checks passed" in res.stdout


@pytest.mark.gpu
def test_k4_equals_its_plain_version_and_counts_its_launches():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    from tal_asrd_tpu_torch.core.config import SpecAugmentConfig
    from tal_asrd_tpu_torch.ops.specaug import (
        draw_seeds, spec_augment, spec_augment_seeded, specaug_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, cfg in (((8, 301, 80), SpecAugmentConfig()),
                       ((3, 37, 8), SpecAugmentConfig(freq_mask_param=4))):
        spec = torch.randn(shape, device="cuda", generator=gen, requires_grad=True)
        seeds = draw_seeds(shape[0], gen, "cuda")
        before = (spec_augment.launches, spec_augment.backward_launches)
        out = spec_augment_seeded(seeds, spec, cfg)
        assert spec_augment.launches == before[0] + 1
        assert torch.equal(out, specaug_plain(seeds, spec.detach(), cfg))
        g = torch.randn_like(out)
        out.backward(g)
        assert spec_augment.backward_launches == before[1] + 1
        assert torch.equal(spec.grad, specaug_plain(seeds, g, cfg))
    # the kernel moves rows as float4: other widths raise, nothing falls back
    spec = torch.randn((3, 37, 6), device="cuda", generator=gen)
    with pytest.raises(ValueError):
        spec_augment_seeded(draw_seeds(3, gen, "cuda"), spec, SpecAugmentConfig(freq_mask_param=4))


@pytest.mark.gpu
def test_k2_matches_its_plain_version_at_ragged_row_counts():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project, logmel_project_plain
    from tal_asrd_tpu_torch.ops.logmel import mel_filterbank
    gen = torch.Generator(device="cuda").manual_seed(0)
    fb = torch.from_numpy(mel_filterbank(201, 0.0, 8000.0, 80, 16000)).cuda()
    for n in (1, 3, 63, 64, 65, 1003, 9000):
        power = torch.rand((n, 201), device="cuda", generator=gen) ** 2
        before = fused_logmel_project.launches
        out = fused_logmel_project(power, fb, 1e-6)
        assert fused_logmel_project.launches == before + 1
        ref = logmel_project_plain(power, fb, 1e-6)
        assert float((out - ref).abs().max()) <= 1e-5, n


@pytest.mark.gpu
def test_k3_is_deterministic_and_fills_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    from tal_asrd_tpu_torch.ops.cuda_decode import quantize_mem_kv, quantize_packed
    from tal_asrd_tpu_torch.ops.cuda_decode_stacked import stack_packed, stacked_decoder_step
    gen = torch.Generator(device="cuda").manual_seed(1)
    n_layers, b, d, h, s, cap = 2, 32, 512, 4, 340, 40
    shapes = {"wqkv": (d, 3 * d), "wso": (d, d), "wcq": (d, d), "wco": (d, d),
              "wf1": (d, 4 * d), "wf2": (4 * d, d)}

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    for w8, kv8 in ((False, False), (True, True)):
        layers = []
        for _ in range(n_layers):
            w = {k: (randn(*sh) / sh[0] ** 0.5).to(torch.bfloat16) for k, sh in shapes.items()}
            w.update({"b" + k[1:]: randn(sh[1]) * 0.1 for k, sh in shapes.items()})
            w["rw"] = torch.full((2,), 0.3, device="cuda")
            layers.append(quantize_packed(w) if w8 else w)
        stacked = stack_packed(layers)
        mk, mv = (randn(n_layers, b, s, d).to(torch.bfloat16) for _ in range(2))
        sk = sv = None
        if kv8:
            qs = [quantize_mem_kv(mk[li], mv[li]) for li in range(n_layers)]
            mk, sk, mv, sv = (torch.stack([q[i] for q in qs]) for i in range(4))
        ck, cv = (randn(n_layers, b, cap, d).to(torch.bfloat16) for _ in range(2))
        x = (randn(b, d) * 0.5).to(torch.bfloat16)
        bias = torch.zeros((b, s), device="cuda")
        runs = [stacked_decoder_step(x, stacked, ck.clone(), cv.clone(), mk, mv, bias, cap - 2,
                                     h, sk, sv) for _ in range(2)]
        for a, r in zip(*runs):
            assert torch.equal(a, r)
        # every cluster slot the card reports is used, in one wave
        plan = stacked_decoder_step.last_plan
        assert plan.clusters == min(plan.slots, b) and plan.waves == 1


@pytest.mark.gpu
def test_k1_matches_its_plain_version_in_every_mode_and_is_deterministic():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    b, d, h, s, l_buf = 40, 256, 4, 340, 33       # the beam's lanes at 1x
    inp = cs.seeded_decoder_inputs(torch, "cuda", 11, b, d, s, l_buf)
    for dt in (torch.float32, torch.bfloat16):
        for mode in cs.MODES:
            op = cs.realize(torch, inp, dt, mode)
            kernel, plain = cs.k1_step(op)
            before = fused_layer_step.launches
            errs, _ = cs.chained_errors(torch, kernel, plain, op["xs"], op["ck"][0], op["cv"][0],
                                        h, l_buf - 4, dt)
            assert fused_layer_step.launches == before + 3
            for key, tol in cs.TOL[("K1", str(dt).replace("torch.", ""))].items():
                assert errs[key] <= tol, (dt, mode, key, errs[key])
            runs = [kernel(op["xs"][0], op["ck"][0].clone(), op["cv"][0].clone(), l_buf - 2, h)
                    for _ in range(2)]
            assert all(torch.equal(a, r) for a, r in zip(*runs)), (dt, mode)
    plan = fused_layer_step.last_plan
    assert plan.waves == 1 and plan.clusters == min(plan.slots, b)


@pytest.mark.gpu
def test_eval_cli_runs_eight_segments_through_k1_and_k2(tmp_path):
    """`python -m tal_asrd_tpu_torch.cli.test --fused-decode` on the card, with
    the tracked checkpoint, on the first 8 segments of the synthetic test
    split: the reference's output files, finite loss, every row ended in
    EOS, K2 twice a batch and K1 four times a decode step."""
    import pickle

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    from tal_asrd_tpu_torch.cli.test import main
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    split, out = str(tmp_path / "test"), str(tmp_path / "out")
    transcripts = build_synth_corpus(split, n_episodes=1, episode_seconds=60.0, n_speakers=8,
                                     seed=202)
    with open(os.path.join(split, "transcript.pkl"), "wb") as f:
        # 11 utterances, 3 of them shorter than 3 s: 8 segments
        pickle.dump({"ep0": transcripts["ep0"][:11]}, f)
    fused_layer_step.launches = fused_logmel_project.launches = 0
    res = main(["--train-data", split, "--valid-data", split, "--test-data", split,
                "--tokenizer", os.path.join(ROOT, "accuracy_release", "bpe.model"),
                "--model-type", "1x", "--num-speakers", "8", "--fused-decode",
                "--load", os.path.join(ROOT, "accuracy_release", "avg_last_3.bf16.msgpack"),
                "--out-dir", out])
    assert [len(s["idx"]) for s in res["steps"]] == [8]
    assert res["steps"][0]["found"].all() and torch.isfinite(torch.tensor(res["test_loss"]))
    assert fused_logmel_project.launches == 2
    assert fused_layer_step.launches > 0 and fused_layer_step.launches % 4 == 0
    with open(os.path.join(out, "test_result.pkl"), "rb") as f:
        assert len(pickle.load(f)) == 8
    for name in ("hyp.txt", "ref.txt"):
        with open(os.path.join(out, name)) as f:
            assert len(f.read().splitlines()) == 8


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["state_machine", "vad_windows"])
def test_long_form_cli_runs_one_episode_through_k1_and_k2(tmp_path, leg):
    """`python -m tal_asrd_tpu_torch.cli.test --unaligned [--vad-windows]
    --fused-decode` on the card, with the tracked checkpoint, on one 60 s
    episode of the synthetic test split: the reference's output files, the
    machine inside its budget, K1 four times a fused decode step, K2 at
    every encode (one for the episode; one a batch of VAD windows)."""
    import pickle

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    from tal_asrd_tpu_torch.cli.test import main
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.decode.fused_step import FusedASRDecoder
    from tal_asrd_tpu_torch.ops.cuda_decode import fused_layer_step
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    split, out = str(tmp_path / "test"), str(tmp_path / "out")
    build_synth_corpus(split, n_episodes=1, episode_seconds=60.0, n_speakers=8, seed=202)
    steps = [0]
    step_of = FusedASRDecoder.decode_step

    def counted(self, *args, **kwargs):
        steps[0] += 1
        return step_of(self, *args, **kwargs)

    fused_layer_step.launches = fused_logmel_project.launches = 0
    FusedASRDecoder.decode_step = counted
    try:
        res = main(["--train-data", split, "--valid-data", split, "--test-data", split,
                    "--tokenizer", os.path.join(ROOT, "accuracy_release", "bpe.model"),
                    "--model-type", "1x", "--num-speakers", "8", "--fused-decode",
                    "--unaligned", "--load",
                    os.path.join(ROOT, "accuracy_release", "avg_last_3.bf16.msgpack"),
                    "--out-dir", out] + (["--vad-windows"] if leg == "vad_windows" else []))
    finally:
        FusedASRDecoder.decode_step = step_of
    (step,) = res["steps"]
    assert steps[0] > 0 and fused_layer_step.launches == 4 * steps[0]
    if leg == "vad_windows":
        assert fused_logmel_project.launches == sum(
            -(-n // 16) for n in step["buckets"].values())
    else:
        assert fused_logmel_project.launches == 1 and 0 < step["iters"] < 100000
    with open(os.path.join(out, "test_result.pkl"), "rb") as f:
        ((refs, hyp),) = pickle.load(f)
    assert refs and hyp
    for name in ("hyp.txt", "ref.txt"):
        with open(os.path.join(out, name)) as f:
            assert len(f.read().splitlines()) == 1
