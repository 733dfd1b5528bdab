"""Training the separate speaker head: the port's `ASRSystem.loss_fn` (lm_loss,
spk_loss, the weighted sum and every gradient) against the JAX package's at
a tiny width in f32, at train=False and with label smoothing; and the
port's training CLI at TAL_TINY_ARCH with --spk-weight 0.5 against the JAX
CLI's figures in tests/fixtures/torch_spk_reference.json
(scripts/torch_spk_reference.py, section tiny_cli), with the tolerances of
tests/test_torch_train_cli.py."""
import json
import os
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.core.config import FrontendConfig as JFrontendConfig
from tal_asrd_tpu.core.config import ModelConfig as JModelConfig
from tal_asrd_tpu.core.config import SpecAugmentConfig as JSpecAugmentConfig
from tal_asrd_tpu.core.config import TrainConfig as JTrainConfig
from tal_asrd_tpu.train import ASRSystem as JASRSystem
from tal_asrd_tpu_torch.cli import train as cli_train
from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
from tal_asrd_tpu_torch.core.checkpoint import load_pytree, save_pytree
from tal_asrd_tpu_torch.core.convert import params_spec
from tal_asrd_tpu_torch.data.synth import build_synth_corpus
from tal_asrd_tpu_torch.models.asr import ASRModel
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
from tal_asrd_tpu_torch.train.loop import Trainer, TrainerConfig
from tal_asrd_tpu_torch.train.system import ASRSystem

from tests.test_torch_helpers import seeded_like, seeded_params, to_numpy_tree
from tests.test_torch_train import FRONTEND, NO_AUG, TINY, TRAIN, port_system
from tests.test_torch_train_cli import _f32_no_noise, _fill, _flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_spk_reference.json")
ARRAYS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_spk_reference_arrays.npz")
HEAD = dict(use_speaker_head=True)
SMOOTHING = 0.1


def head_batch(b=4, t=3200, l=12, vocab=32, n_spk=4, seed=0):
    """Text without speaker tokens (a head model's vocabulary is the text's)
    and a speaker id per token; the last two positions of one row are
    padding (pad id 2 in both text and spk_ids)."""
    rng = np.random.RandomState(seed)
    batch = {"audio": (rng.randn(b, t) * 0.1).astype(np.float32),
             "audio_lens": np.full((b,), t, np.int32),
             "text": rng.randint(0, vocab, (b, l)).astype(np.int32),
             "text_mask": np.ones((b, l), bool),
             "spk_ids": rng.randint(0, n_spk, (b, l)).astype(np.int32)}
    batch["text"][1, -2:] = batch["spk_ids"][1, -2:] = 2
    batch["text_mask"][1, -2:] = False
    return batch


@pytest.fixture(scope="module")
def ref():
    """The JAX system with the speaker head on seeded parameters (every
    ReZero scalar 0.4): metrics and gradients of loss_fn at train=False and
    at train=True with smoothing (no dropout, no token replacement, no
    SpecAugment span: the same function)."""
    out = {}
    batch = head_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0)
    jsys = JASRSystem(JModelConfig(conv_impl="xla", **TINY, **HEAD),
                      JTrainConfig(**dict(TRAIN, spk_weight=0.5)),
                      JFrontendConfig(**FRONTEND), JSpecAugmentConfig(**NO_AUG),
                      dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jsys.init_state(rng, jbatch).params)
    out["params"] = seeded_like(shapes, 9)
    for smoothing in (0.0, SMOOTHING):
        train = smoothing > 0
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p: jsys.loss_fn(p, jbatch, rng, train, smoothing=smoothing), has_aux=True))
        (_, metrics), grads = grad_fn(out["params"])
        out[smoothing] = {"metrics": {k: float(v) for k, v in metrics.items()},
                          "grads": to_numpy_tree(grads)}
    out["params"] = to_numpy_tree(out["params"])
    out["batch"] = batch
    return out


@pytest.mark.parametrize("smoothing", [0.0, SMOOTHING])
def test_loss_fn_and_every_gradient_match_jax(ref, smoothing):
    from tests.test_torch_train import _grads_tree
    tsys = port_system(ref["params"], model=HEAD,
                       train={"spk_weight": 0.5, "smoothing": smoothing})
    loss, metrics = tsys.loss_fn(ref["batch"], smoothing > 0)
    loss.backward()
    want = ref[smoothing]["metrics"]
    for key in ("loss", "lm_loss", "spk_loss"):
        assert float(metrics[key].detach()) == pytest.approx(want[key], rel=1e-5, abs=1e-5), key
    assert want["loss"] == pytest.approx(want["lm_loss"] + 0.5 * want["spk_loss"], rel=1e-6)
    assert want["spk_loss"] > 0.5
    ours, theirs = dict(_flat(_grads_tree(tsys))), dict(_flat(ref[smoothing]["grads"]))
    assert sorted(ours) == sorted(theirs)
    for key, g in ours.items():
        np.testing.assert_allclose(g, theirs[key], rtol=1e-4, atol=1e-5, err_msg=key)
    head_grads = [np.abs(g).max() for k, g in ours.items() if k.startswith("speaker_head")]
    assert min(head_grads) > 1e-3          # the speaker loss reaches the head


def test_the_speaker_loss_leaves_speaker_tokens_unclamped(ref):
    """With a speaker loss the text is not clamped to the last speaker id:
    a token beyond the vocabulary reaches the model (and is out of range of
    its embedding), where a speaker-token model would clamp it."""
    batch = dict(ref["batch"], text=ref["batch"]["text"].copy())
    batch["text"][0, 3] = 40
    tsys = port_system(ref["params"], model=HEAD, train={"spk_weight": 0.5})
    with pytest.raises(IndexError):
        tsys.loss_fn(batch, False)


# ---------------------------------------------------------------------------
# the tiny training CLI against the JAX CLI
@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)["tiny_cli"]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory, fixture):
    """The port's CLI on the fixture's flags, patched as the reference's
    child is, with each validation's batch metrics recorded."""
    tmp = str(tmp_path_factory.mktemp("spk_train_cli"))
    paths = {k: os.path.join(tmp, k.lower()) for k in ("TRAIN", "VALID", "CKPTS", "OUT")}
    paths["INIT"] = os.path.join(tmp, "init.msgpack")
    for name, split in fixture["splits"].items():
        build_synth_corpus(paths[name.upper()], **split)
    vals = []
    validate, eval_step = Trainer._validate, ASRSystem.eval_step

    def recording_validate(self, val_loader, step, n_batches=None):
        vals.append({"step": step, "batches": []})
        return validate(self, val_loader, step, n_batches)

    def recording_eval_step(self, batch):
        m = eval_step(self, batch)
        vals[-1]["batches"].append({k: float(m[k]) for k in ("loss", "lm_loss", "spk_loss")})
        return m

    with mock.patch.dict(os.environ, {"TAL_TINY_ARCH": "1"}), \
            mock.patch.object(cli_train, "build_configs", _f32_no_noise(build_configs)), \
            mock.patch.object(cli_train, "ASRSystem",
                              partial(ASRSystem, compute_dtype=torch.float32)), \
            mock.patch.object(cli_train, "TrainerConfig",
                              partial(TrainerConfig, log_every=1)), \
            mock.patch.object(Trainer, "_validate", recording_validate), \
            mock.patch.object(ASRSystem, "eval_step", recording_eval_step):
        args = get_argparser(is_train=True).parse_args(_fill(fixture["argv"], paths))
        model_cfg = build_configs(args, BpeTokenizer(model_path=os.path.join(
            ROOT, "accuracy_release", "bpe.model")))[0]
        init = seeded_params(params_spec(ASRModel(model_cfg, device="cpu")),
                             fixture["init_seed"], scalar_bump=fixture["init_scalars"])
        save_pytree(paths["INIT"], init)
        cwd = os.getcwd()
        os.chdir(ROOT)
        try:
            out = cli_train.main(_fill(fixture["argv"], paths) + ["--device", "cpu"])
        finally:
            os.chdir(cwd)
    with open(os.path.join(paths["OUT"], "tiny.metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    ckpt_dir = os.path.join(paths["CKPTS"], "tiny")
    return {"records": recs, "vals": vals, "system": out["system"], "init": init,
            "ckpt_dir": ckpt_dir, "checkpoints": sorted(
                n for n in os.listdir(ckpt_dir) if n.startswith("ckpt_"))}


def test_the_cli_trains_the_head_as_the_jax_cli(port_run, fixture):
    assert port_run["system"].model.cfg.use_speaker_head
    steps = [[r["step"], r["loss"], r["lm_loss"], r["spk_loss"]]
             for r in port_run["records"] if "loss" in r]
    want = fixture["step_losses"]
    assert [s[0] for s in steps] == [s[0] for s in want]
    np.testing.assert_allclose([s[1:] for s in steps], [s[1:] for s in want], rtol=1e-4)
    vals = [{k: float(np.mean([b[k] for b in v["batches"]]))
             for k in ("loss", "lm_loss", "spk_loss")} for v in port_run["vals"]]
    assert [v["step"] for v in port_run["vals"]] == [v["step"] for v in fixture["validations"]]
    for got, ref in zip(vals, fixture["validations"]):
        for k in got:
            assert got[k] == pytest.approx(ref[k], rel=1e-4), k
    assert fixture["validations"][-1]["spk_loss"] < fixture["validations"][0]["spk_loss"]
    gens = [[r["step"], r["ref"], r["hyp"]] for r in port_run["records"]
            if r.get("type") == "generation"]
    assert gens == fixture["generations"]


def test_the_cli_checkpoint_matches_the_jax_cli(port_run, fixture):
    assert port_run["checkpoints"] == fixture["checkpoints"]
    deltas = np.load(ARRAYS_NPZ)
    init = dict(_flat(port_run["init"]))
    tree = dict(_flat(load_pytree(os.path.join(port_run["ckpt_dir"], fixture["last_checkpoint"]))))
    assert set(tree) == set(init)
    assert any(k.startswith("speaker_head_2") for k in tree)
    for path, value in tree.items():
        want = init[path] + deltas["tiny_cli/" + path].astype(np.float32)
        np.testing.assert_allclose(value, want, rtol=0, atol=1e-4, err_msg=path)


def test_an_unknown_speaker_id_is_out_of_the_heads_range():
    """ROADMAP C17: an unknown speaker's id is one past the speaker map
    (data/transcript.py SpeakerIds), out of the head's num_speakers logits.
    The reference's take_along_axis fills NaN there and its loss is NaN
    (even under the mask: NaN x 0); the port's gather refuses the id."""
    from tal_asrd_tpu.train.losses import masked_token_loss as j_masked_token_loss
    from tal_asrd_tpu_torch.train.losses import masked_token_loss
    logits = np.zeros((1, 2, 8), np.float32)
    targets = np.asarray([[0, 8]], np.int32)
    mask = np.asarray([[True, False]])
    assert np.isnan(float(j_masked_token_loss(jnp.asarray(logits), jnp.asarray(targets),
                                              jnp.asarray(mask))))
    with pytest.raises((IndexError, RuntimeError)):
        masked_token_loss(torch.from_numpy(logits), torch.from_numpy(targets).long(),
                          torch.from_numpy(mask))
