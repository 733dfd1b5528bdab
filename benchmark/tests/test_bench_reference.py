"""The plain reference against the program at small widths on the CPU, in
float32: the frontend, SpecAugment's spans, the encoder, the teacher-forced
decoder, the loss and the LAMB step. And the control: the reference in fp8
in the program's place reads far above what the program reads."""
import numpy as np
import pytest
import torch

import tiny
from benchmark import build, drive_generate, drive_train, reference

F32 = reference.Precision("float32")
CPU = torch.device("cpu")


def small_model(seed=3, **kw):
    cfg = tiny.config(compute_dtype="float32", **kw)
    names = build.shapes_of(cfg)
    w = build.draw_weights(names, seed, CPU, cfg["embed_size"])
    return cfg, w, build.serving_model(cfg, w)


def audio(rows=3, n=48000, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, n), generator=g) * 0.1
    lens = torch.tensor([n, n - 3000, n // 2][:rows])
    for i, n_i in enumerate(lens.tolist()):
        x[i, n_i:] = 0
    return x, lens


def test_frontend_and_specaug():
    from tal_asrd_tpu_torch.core.config import SpecAugmentConfig
    from tal_asrd_tpu_torch.ops.logmel import log_mel_spectrogram
    from tal_asrd_tpu_torch.ops.specaug import specaug_plain
    x, lens = audio()
    ours = reference.features(x, lens)
    theirs = log_mel_spectrogram(x, audio_lens=lens)
    assert torch.allclose(ours, theirs, atol=2e-4, rtol=1e-5)
    seeds = torch.tensor([5, -7, 2 ** 31 - 1], dtype=torch.int32)
    keep = reference.specaug_keep(seeds, ours.shape[1], 80)
    assert torch.equal(ours * keep, specaug_plain(seeds, ours, SpecAugmentConfig()))
    assert not bool(keep.all())


def test_encoder_and_decoder():
    cfg, w, model = small_model()
    x, lens = audio()
    with torch.no_grad():
        feats = reference.features(x, lens)
        mem = reference.encode(w, feats, cfg["tds_depths"], cfg["n_mels"], F32, reference.Drops())
        enc = model.encode(x, lens)
        assert torch.allclose(mem, enc["encoder_out"], atol=1e-4, rtol=1e-4)
        mask = reference.padding_mask(lens, x.shape[1], mem.shape[1])
        assert torch.equal(mask, enc["encoder_padding_mask"])
        toks = torch.randint(0, 66, (3, 9), generator=torch.Generator().manual_seed(1))
        ours = reference.decoder_logits(w, toks, mem, mask, 4, cfg["n_head"], F32,
                                        reference.Drops())
        theirs, _ = model.decode(toks, enc)
        assert torch.allclose(ours, theirs, atol=1e-4, rtol=1e-4)


def test_loss_and_lamb():
    from tal_asrd_tpu_torch.train.losses import masked_token_loss
    from tal_asrd_tpu_torch.train.optimizers import LAMB
    g = torch.Generator().manual_seed(2)
    logits = torch.randn((2, 5, 11), generator=g)
    targets = torch.randint(0, 11, (2, 5), generator=g)
    mask = torch.rand((2, 5), generator=g) > 0.3
    for s in (0.0, 0.1):
        assert torch.allclose(reference.token_loss(logits, targets, mask, s),
                              masked_token_loss(logits, targets, mask, s), atol=1e-6)
    params = {"a": torch.randn((4, 3), generator=g), "b": torch.zeros(3)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in params.items()} for _ in range(3)]
    theirs = {k: torch.nn.Parameter(v.clone()) for k, v in params.items()}
    opt = LAMB(list(theirs.items()), 8e-4)
    ours, state = {k: v.clone() for k, v in params.items()}, {}
    for grad in grads:
        for k, p in theirs.items():
            p.grad = grad[k].clone()
        opt.step()
        reference.lamb_step(ours, grad, state, 8e-4)
    for k in params:
        assert torch.allclose(ours[k], theirs[k].detach(), atol=1e-7, rtol=1e-6)


def test_training_steps_follow_the_program():
    """Three steps of the program (float32 compute, dropout 0.2 recorded,
    SpecAugment, token replacement) and of the reference agree to rounding."""
    run = drive_train.Run(tiny.config(compute_dtype="float32"), tiny.mix("train-b64x20s"),
                          11, CPU)
    run.setup()
    run.release()
    out = run.check()
    assert out["loss_gap"] < 1e-5
    assert out["grad_gap"] < 2e-3 and out["change_gap"] < 2e-3


@pytest.mark.parametrize("traffic", ["eval-beam5", "serve-greedy-b128"])
def test_control_reads_above_the_program(traffic):
    """The program in bf16 against the fp8 reference in its place, a few seeds
    at a small size: the control's median of every number is at least 3 x
    the program's. (The limits are set from readings at the cells' sizes.)"""
    prog, ctrl = {}, {}
    for seed in (21, 22, 23):
        run = drive_generate.Run(tiny.config(), tiny.mix(traffic, max_new_tokens=16), seed, CPU)
        run.setup()
        run.window(0.0)
        run.release()
        for out, res in ((prog, run.check()), (ctrl, run.check(control=True))):
            for k, v in res.items():
                out[k] = out.get(k, []) + [v]
    for k in prog:
        assert np.median(ctrl[k]) >= 3 * np.median(prog[k]), (k, prog[k], ctrl[k])


def test_training_control_reads_above_the_program():
    prog, ctrl = [], []
    for seed in (31, 32, 33):
        run = drive_train.Run(tiny.config(), tiny.mix("train-b64x20s"), seed, CPU)
        run.setup()
        run.release()
        prog.append(run.check()["loss_gap"])
        ctrl.append(run.check(control=True)["loss_gap"])
    assert np.median(ctrl) >= 3 * np.median(prog), (prog, ctrl)
    assert np.isfinite(prog).all()
