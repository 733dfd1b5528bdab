"""The speaker baseline: the port's SDModel, SDSystem, SDUtteranceDataset,
SDCollater and the training CLI (tal_asrd_tpu_torch/models/sd.py,
baseline/sd_system.py, data/baseline_speaker.py, data/collate.py,
cli/train_sd.py) against the JAX package's on the CPU, in float32, at the
tiny sizes of the JAX package's own tests."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.baseline import SDSystem as JSDSystem
from tal_asrd_tpu.core.config import FrontendConfig as JFrontendConfig
from tal_asrd_tpu.core.config import SDModelConfig as JSDModelConfig
from tal_asrd_tpu.core.config import SpecAugmentConfig as JSpecAugmentConfig
from tal_asrd_tpu.core.config import TrainConfig as JTrainConfig
from tal_asrd_tpu.data import SDCollater as JSDCollater
from tal_asrd_tpu.data import SDUtteranceDataset as JSDUtteranceDataset
from tal_asrd_tpu.models.sd import SDModel as JSDModel
from tal_asrd_tpu_torch.baseline import SDSystem
from tal_asrd_tpu_torch.cli import train_sd as cli_train_sd
from tal_asrd_tpu_torch.core.checkpoint import load_pytree
from tal_asrd_tpu_torch.core.config import FrontendConfig, SDModelConfig, SpecAugmentConfig
from tal_asrd_tpu_torch.core.config import TrainConfig
from tal_asrd_tpu_torch.core.convert import load_into, state_dict_to_params
from tal_asrd_tpu_torch.data import SDCollater, SDUtteranceDataset
from tal_asrd_tpu_torch.data.synth import build_synth_corpus
from tal_asrd_tpu_torch.models.sd import SDModel

from tests.test_torch_helpers import seeded_like, to_numpy_tree

# tests/test_models.py:153 and tests/test_runner_embed_baseline.py:156
MODEL = dict(num_speakers=12, n_mels=8, dropout=0.0, embed_size=16, tds_depths=(1, 1, 1),
             tds_kernel=5)
FRONTEND = dict(n_mels=8, n_fft=64, win_length=64, hop_length=32)
NO_AUG = dict(num_freq_masks=0, num_time_masks=0)


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its seeded params, the port's model holding them)."""
    jmodel = JSDModel(JSDModelConfig(**MODEL), JFrontendConfig(**FRONTEND))
    audio = jnp.zeros((2, 3200), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), audio,
                                                jnp.array([3200, 1600]), train=False))
    params = to_numpy_tree(seeded_like(shapes["params"], 3))
    tmodel = SDModel(SDModelConfig(**MODEL), FrontendConfig(**FRONTEND), device="cpu")
    load_into(tmodel, {"params": params})
    return jmodel, params, tmodel


_FORWARDS = {}


def _jax_forward(jmodel):
    """JAX's (logits, encoder output, embeddings), jitted once."""
    if jmodel not in _FORWARDS:
        def forward(params, audio, lens):
            logits, enc = jmodel.apply({"params": params}, audio, lens)
            return logits, enc, jmodel.apply({"params": params}, enc, method=JSDModel.embed)
        _FORWARDS[jmodel] = jax.jit(forward)
    return _FORWARDS[jmodel]


@pytest.mark.parametrize("lens", [(3200, 3200), (3200, 2111), (2500, 1601)])
def test_sd_model_matches(pair, lens):
    """Logits, embeddings and the padding mask within 1e-5 in f32, with
    ragged audio_lens (the batch mean over real frames only)."""
    jmodel, params, tmodel = pair
    audio = (np.random.default_rng(1).standard_normal((2, 3200)) * 0.1).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    logits, enc, emb = _jax_forward(jmodel)(params, jnp.asarray(audio), jnp.asarray(lens))
    with torch.no_grad():
        tl, tenc = tmodel(torch.from_numpy(audio), torch.from_numpy(lens))
        temb = tmodel.embed(tenc)
    np.testing.assert_array_equal(tenc["encoder_padding_mask"].numpy(),
                                  np.asarray(enc["encoder_padding_mask"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(temb.numpy(), np.asarray(emb), rtol=0, atol=1e-5)


def test_int16_audio_reaches_the_model_unscaled(pair):
    """SDModel casts audio to float32 as it is, as JAX's does: int16 PCM
    (SDCollater(audio_int16=True)) is not divided by 32768 (ROADMAP C32)."""
    jmodel, params, tmodel = pair
    audio = np.random.default_rng(2).integers(-3000, 3000, (2, 3200)).astype(np.int16)
    lens = np.asarray([3200, 2900], np.int32)
    logits, _, _ = _jax_forward(jmodel)(params, jnp.asarray(audio), jnp.asarray(lens))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(audio), torch.from_numpy(lens))[0]
        as_float = tmodel(torch.from_numpy(audio.astype(np.float32)), torch.from_numpy(lens))[0]
    assert torch.equal(got, as_float)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=1e-5, atol=1e-4)


def test_sd_tree_round_trips_bit_for_bit(pair):
    """flax tree -> the port's SDModel -> flax tree: the same names and
    shapes and the same bits, with the TDS names the ASR converter maps."""
    _, params, tmodel = pair
    back = dict(_flat(state_dict_to_params(tmodel.state_dict())))
    want = dict(_flat(params))
    assert back.keys() == want.keys()
    assert {k.split("/")[0] for k in want} == {"encoder", "spk_embed_proj", "spk_logit_proj"}
    for k, v in want.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes(), k


def test_sd_system_steps_match():
    """10 LAMB steps (tests/test_runner_embed_baseline.py:156's setup: 5
    speakers, B = 2 x 0.5 s, lr 2e-4, max_steps 50, no SpecAugment, f32)
    from JAX's PRNGKey(0) initial tree: losses within 1e-5 relative,
    accuracies equal."""
    cfg = dict(MODEL, num_speakers=5)
    tc = dict(batch_size=2, lr=2e-4, max_steps=50)
    rng = np.random.RandomState(0)
    batch = {"audio": rng.randn(2, 8000).astype(np.float32) * 0.1,
             "audio_lens": np.full((2,), 8000, np.int32),
             "speaker": np.array([1, 3], np.int32)}
    jsys = JSDSystem(JSDModelConfig(**cfg), JTrainConfig(**tc), JFrontendConfig(**FRONTEND),
                     JSpecAugmentConfig(**NO_AUG), dtype=jnp.float32)
    state = jax.jit(jsys.init_state)(jax.random.PRNGKey(0), batch)
    port = SDSystem(SDModelConfig(**cfg), TrainConfig(**tc), FrontendConfig(**FRONTEND),
                    SpecAugmentConfig(**NO_AUG), compute_dtype=torch.float32, device="cpu")
    port.load_params(to_numpy_tree(state.params))
    step = jsys.make_train_step()
    want, want_acc, got, got_acc = [], [], [], []
    for i in range(10):
        state, metrics = step(state, batch, jax.random.PRNGKey(i))
        want.append(float(metrics["loss"]))
        want_acc.append(float(metrics["spk_acc"]))
        m = port.train_step(batch)
        got.append(float(m["loss"]))
        got_acc.append(float(m["spk_acc"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got_acc == want_acc and got[-1] < got[0]
    ev = port.eval_step(batch)
    jev = jsys.make_eval_step()(state, batch)
    np.testing.assert_allclose(float(ev["loss"]), float(jev["loss"]), rtol=1e-5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sd") / "train")
    build_synth_corpus(root, n_episodes=2, episode_seconds=40.0, n_speakers=4, seed=0)
    return root


@pytest.mark.parametrize("int16", [False, True])
def test_dataset_and_collater_match(corpus, int16):
    """SDUtteranceDataset's index (first utterance of each one-utterance
    item, at least 3 s and under max_segment_duration), items and
    num_speakers equal to the JAX package's; SDCollater's batches equal,
    float32 and int16."""
    kw = dict(speaker_map_loc=os.path.join(corpus, "speaker_map.json"),
              max_segment_duration=5.5)
    jds, ds = JSDUtteranceDataset(corpus, **kw), SDUtteranceDataset(corpus, **kw)
    assert ds.index == jds.index and ds.num_speakers == jds.num_speakers == 5
    assert 4 <= len(ds) < len(SDUtteranceDataset(corpus, speaker_map_loc=kw["speaker_map_loc"]))
    for i in range(len(ds)):
        (w, s, j), (jw, js, jj) = ds[i], jds[i]
        assert w.tobytes() == jw.tobytes() and s == js and j == jj
    for items in ([0, 1, 2], [3, 1], [len(ds) - 1]):
        got = SDCollater(audio_int16=int16)([ds[i] for i in items])
        want = JSDCollater(audio_int16=int16)([jds[i] for i in items])
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_train_sd_cli_quick_test_writes_the_jax_systems_tree(corpus, tmp_path, capsys):
    """`cli.train_sd --quick-test --device cpu` at the full width (6008
    speakers) takes one step and writes ckpt_00000001.msgpack, whose leaves
    have the names and shapes of JAX's SDSystem.init_state (jax.eval_shape,
    nothing compiled), and latest.json with the epoch."""
    out = cli_train_sd.main(["--train-data", corpus, "--valid-data", "never-read",
                             "--name", "sd", "--checkpoint-path", str(tmp_path),
                             "--batch-size", "2", "--max-secs", "5", "--num-workers", "0",
                             "--quick-test", "--device", "cpu"])
    assert out["steps"] == 1 and np.isfinite(out["losses"]).all()
    assert "step 1: loss" in capsys.readouterr().out
    tree = load_pytree(os.path.join(tmp_path, "sd", "ckpt_00000001.msgpack"))
    jsys = JSDSystem(JSDModelConfig())
    example = {"audio": jnp.zeros((2, 80000)), "audio_lens": jnp.full((2,), 80000)}
    want = jax.eval_shape(lambda: jsys.init_state(jax.random.PRNGKey(0), example).params)
    got = {k: v.shape for k, v in _flat(tree)}
    assert got == {"/".join(k.key for k in p): v.shape
                   for p, v in jax.tree_util.tree_leaves_with_path(want)}
    assert all(v.dtype == np.float32 for _, v in _flat(tree))
    with open(os.path.join(tmp_path, "sd", "latest.json")) as f:
        assert '"epoch": 0' in f.read()
    assert cli_train_sd.get_parser().parse_args(
        ["--train-data", "a", "--valid-data", "b", "--name", "n"]).device == "cuda"
