"""The port's checkpoint reader and weight converter on the tracked
checkpoint (accuracy_release/avg_last_3.bf16.msgpack, model `1x`): the
pure-Python msgpack reader against flax's, every leaf placed, and one
teacher-forced forward against the JAX model on the same weights."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tal_asrd_tpu.core.config import ModelConfig as JModelConfig
from tal_asrd_tpu.models.asr import ASRModel as JASRModel
from tal_asrd_tpu_torch.core import checkpoint as tckpt
from tal_asrd_tpu_torch.core.config import ModelConfig
from tal_asrd_tpu_torch.core.convert import load_into, params_to_state_dict, to_tensor
from tal_asrd_tpu_torch.models.asr import ASRModel

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "accuracy_release", "avg_last_3.bf16.msgpack")
CFG = dict(model_type="1x", num_speakers=8, vocab_size=300)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def trees():
    with open(CKPT, "rb") as f:
        data = f.read()
    return tckpt.msgpack_restore(data), serialization.msgpack_restore(data)


def test_reader_returns_the_same_151_arrays_bit_for_bit(trees):
    ours, ref = dict(_flat(trees[0])), dict(_flat(trees[1]))
    assert len(ours) == len(ref) == 151
    assert list(ours) == list(ref)                   # same keys, same order
    for key, a in ours.items():
        b = np.asarray(ref[key])
        assert a.shape == b.shape, key
        assert b.dtype.name == "bfloat16" and tckpt.is_bfloat16_bits(a), key
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16), err_msg=key)


def test_load_pytree_reads_the_file(trees):
    tree = tckpt.load_pytree(CKPT)
    assert set(tree) == set(trees[0])
    assert tree["decoder_proj"]["kernel"].shape == (1440, 256)


def test_bfloat16_bits_become_torch_bfloat16(trees):
    a = trees[0]["embedding_proj"]
    t = to_tensor(a)
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (64, 256)
    ref = np.asarray(trees[1]["embedding_proj"]).astype(np.float32)
    np.testing.assert_array_equal(t.float().numpy(), ref)
    s = to_tensor(trees[0]["decoder"]["layers_0"]["resweight"])
    assert s.dim() == 0 and s.dtype == torch.bfloat16
    # a third-party bfloat16 array (as flax returns it) converts the same way
    np.testing.assert_array_equal(
        to_tensor(np.asarray(trees[1]["embedding_proj"])).float().numpy(), ref)


def test_converter_places_every_leaf(trees):
    sd = params_to_state_dict(trees[0])
    assert len(sd) == 151
    model = ASRModel(ModelConfig(**CFG), dtype=torch.bfloat16, device="cpu")
    assert set(sd) == set(model.state_dict())
    load_into(model, {"params": trees[0]})            # with the wrapper too
    w = model.encoder.down_1.weight.detach()                   # conv [K, C/G, C_out] -> [C_out, C/G, K]
    ref = np.asarray(trees[1]["encoder"]["down_1"]["kernel"]).astype(np.float32)
    np.testing.assert_array_equal(w.float().numpy(), ref.transpose(2, 1, 0))
    fc = model.encoder.group_0_block_0.fc1.weight.detach()     # 1x1 conv [1, in, out] -> [out, in]
    ref = np.asarray(trees[1]["encoder"]["group_0_block_0"]["fc1"]["kernel"]).astype(np.float32)
    np.testing.assert_array_equal(fc.float().numpy(), ref[0].T)
    assert float(model.decoder.layers[2].resweight_src.detach()) == float(
        np.asarray(trees[1]["decoder"]["layers_2"]["resweight_src"]).astype(np.float32))


def test_converter_raises_on_leftover_and_on_missing(trees):
    model = ASRModel(ModelConfig(**CFG), dtype=torch.float32, device="cpu")
    extra = dict(trees[0], stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError):
        load_into(model, extra)
    missing = {k: v for k, v in trees[0].items() if k != "decoder_proj"}
    with pytest.raises(RuntimeError):
        load_into(model, missing)
    wrong = ASRModel(ModelConfig(model_type="1x", num_speakers=9, vocab_size=300),
                     dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError):
        load_into(wrong, trees[0])                    # embedding rows disagree


def test_reader_rejects_truncated_and_trailing_data():
    with pytest.raises(ValueError):
        tckpt.msgpack_restore(b"\x81\xa1a")
    with pytest.raises(ValueError):
        tckpt.msgpack_restore(b"\x01\x02")


def test_reader_handles_the_scalar_and_container_types_flax_emits():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "n": {"i": 7, "f": 0.5,
            "s": "txt", "neg": -3, "big": 70000, "t": True, "none": None,
            "sc": np.float32(1.5), "l": [1, 2, 3]}}
    got = tckpt.msgpack_restore(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["n"]["i"] == 7 and got["n"]["f"] == 0.5 and got["n"]["s"] == "txt"
    assert got["n"]["neg"] == -3 and got["n"]["big"] == 70000 and got["n"]["t"] is True
    assert got["n"]["none"] is None and got["n"]["sc"] == np.float32(1.5)
    assert got["n"]["l"] == [1, 2, 3]


def test_teacher_forced_forward_matches_jax_on_the_checkpoint(trees):
    """2 s of audio through both full-width 1x models in float32, the weights
    being the checkpoint's bf16 values cast up. atol 2e-3: logits span tens of
    units after 11 TDS blocks and 4 decoder layers of f32 sums taken in
    different orders."""
    rng = np.random.default_rng(0)
    t = np.arange(32000, dtype=np.float32) / 16000.0
    audio = (rng.standard_normal((2, 32000)) * 0.02
             + 0.1 * np.sin(2 * np.pi * 440.0 * t)[None]).astype(np.float32)
    lens = np.array([32000, 25000], np.int32)
    y = rng.integers(0, 308, size=(2, 6)).astype(np.int32)

    params32 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), trees[1])
    jmodel = JASRModel(JModelConfig(conv_impl="xla", **CFG), dtype=jnp.float32)
    fwd = jax.jit(lambda p, a, yy, l: jmodel.apply({"params": p}, a, yy, l)[0][0])
    ref = np.asarray(fwd(params32, jnp.asarray(audio), jnp.asarray(y), jnp.asarray(lens)))

    tmodel = ASRModel(ModelConfig(**CFG), dtype=torch.float32, device="cpu")
    load_into(tmodel, trees[0])
    with torch.no_grad():
        (ours, _), _ = tmodel(torch.from_numpy(audio), torch.from_numpy(y).long(),
                              torch.from_numpy(lens))
    assert ours.shape == ref.shape == (2, 6, 308)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=2e-3)
    np.testing.assert_array_equal(ours.numpy().argmax(-1), ref.argmax(-1))


# ---------------------------------------------------------------------------
# The writer, the manager and the trainer's files
# ---------------------------------------------------------------------------
def test_writer_emits_the_bytes_flax_writes():
    with open(CKPT, "rb") as f:
        data = f.read()
    assert tckpt.msgpack_serialize(tckpt.msgpack_restore(data)) == data
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "n": {"i": 7, "f": 0.5, "s": "txt" * 20, "neg": -300, "big": 70000,
                  "t": True, "none": None, "sc": np.float32(1.5), "l": [1, [2, 3]],
                  "z": np.zeros((), np.int32), "u": np.arange(300, dtype=np.uint8)},
            "m": {str(i): i for i in range(20)}}
    assert tckpt.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)


def _train_tiny():
    from tests.test_torch_train import FRONTEND, NO_AUG, TINY
    from tal_asrd_tpu_torch.core.config import (
        FrontendConfig, SpecAugmentConfig, TrainConfig)
    from tal_asrd_tpu_torch.train.system import ASRSystem

    def make(**train):
        tsys = ASRSystem(ModelConfig(**TINY),
                         TrainConfig(**dict(batch_size=4, lr=1e-3, max_steps=20, **train)),
                         FrontendConfig(**FRONTEND), SpecAugmentConfig(),
                         compute_dtype=torch.float32, device="cpu")
        tsys.init_state(torch.Generator().manual_seed(3))
        with torch.no_grad():
            for p in tsys.model.parameters():
                if p.dim() == 0:
                    p.fill_(0.4)          # ReZero scalars: let every branch count
        return tsys
    return make


def test_port_written_params_give_jax_the_port_logits(tmp_path):
    """The port writes its parameters; the JAX package reads the file with
    its own load_pytree and its model gives the port's logits."""
    from tal_asrd_tpu.core.checkpoint import load_pytree as j_load_pytree
    from tests.test_torch_train import FRONTEND, TINY, tiny_batch
    from tal_asrd_tpu.core.config import FrontendConfig as JFrontendConfig

    tsys = _train_tiny()()
    path = str(tmp_path / "params.msgpack")
    tckpt.save_pytree(path, tsys.params_tree())
    params = j_load_pytree(path)
    batch = tiny_batch(b=2)
    y = batch["text"][:, :-1]
    jmodel = JASRModel(JModelConfig(conv_impl="xla", **TINY),
                       JFrontendConfig(**FRONTEND), dtype=jnp.float32)
    (ref, _), _ = jmodel.apply({"params": params}, jnp.asarray(batch["audio"]),
                               jnp.asarray(y), jnp.asarray(batch["audio_lens"]))
    with torch.no_grad():
        (ours, _), _ = tsys.model(torch.from_numpy(batch["audio"]),
                                  torch.from_numpy(y).long(),
                                  torch.from_numpy(batch["audio_lens"]))
    assert float(np.abs(np.asarray(ref)).max()) > 1.0
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_resume_from_a_state_checkpoint_equals_an_uninterrupted_run(tmp_path):
    """2 steps + save + load into a fresh system + 1 step == 3 steps (f32,
    dropout off, SpecAugment and token replacement on: their draws follow
    the step)."""
    from tests.test_torch_train import tiny_batch
    make = _train_tiny()
    batches = [tiny_batch(seed=s) for s in range(3)]
    straight = make()
    for b in batches:
        straight.train_step(b)

    first = make()
    for b in batches[:2]:
        first.train_step(b)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save_state(first.step, first.state_tree())
    assert mgr.latest_state_step() == 2
    resumed = make()
    resumed.init_state(torch.Generator().manual_seed(99))   # other weights first
    resumed.load_state_tree(mgr.load_state())
    assert resumed.step == 2
    resumed.train_step(batches[2])
    for (n, a), b in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), n
    for p, q in zip(straight.model.parameters(), resumed.model.parameters()):
        sa, sb = straight.optimizer.state[p], resumed.optimizer.state[q]
        assert sa["step"] == sb["step"] == 3
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


def test_trainer_quick_test_writes_params_state_and_latest(tmp_path):
    from tal_asrd_tpu_torch.train.loop import Trainer, TrainerConfig
    from tal_asrd_tpu_torch.utils.logging import MetricsLogger
    from tests.test_torch_train import tiny_batch
    import json
    tsys = _train_tiny()()
    logger = MetricsLogger(out_dir=str(tmp_path / "logs"), name="t")
    trainer = Trainer(tsys, TrainerConfig(quick_test=True,
                                          checkpoint_dir=str(tmp_path / "ckpt")), logger)
    trainer.fit([tiny_batch(), tiny_batch(seed=1)], [tiny_batch(seed=2)])
    logger.close()
    files = sorted(os.listdir(tmp_path / "ckpt"))
    assert files == ["ckpt_00000001.msgpack", "latest.json", "state_00000001.msgpack"]
    latest = json.load(open(tmp_path / "ckpt" / "latest.json"))
    assert latest["step"] == 1 and latest["path"] == "ckpt_00000001.msgpack"
    assert np.isfinite(latest["val_loss"])
    state = tckpt.CheckpointManager(str(tmp_path / "ckpt")).load_state()
    assert set(state) == {"step", "params", "opt_state"} and int(state["step"]) == 1
    assert set(state["opt_state"]) == {"count", "mu", "nu"}
    records = [json.loads(l) for l in open(tmp_path / "logs" / "t.metrics.jsonl")]
    assert records[0]["step"] == 1 and np.isfinite(records[0]["loss"])


def test_average_last_means_the_trees(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16).view(
        tckpt.BFLOAT16_BITS)
    for step, v in ((1, 1.0), (2, 2.0), (3, 4.0)):
        mgr.save(step, {"w": np.full((2, 2), v, np.float32), "b": bf(np.full(3, v))})
    assert mgr.steps() == [1, 2, 3]
    avg = mgr.average_last(2)
    np.testing.assert_array_equal(avg["w"], np.full((2, 2), 3.0, np.float32))
    assert tckpt.is_bfloat16_bits(avg["b"])
    np.testing.assert_array_equal(to_tensor(avg["b"]).float().numpy(), np.full(3, 3.0))
    np.testing.assert_array_equal(mgr.load()["w"], np.full((2, 2), 4.0, np.float32))


# ---------------------------------------------------------------------------
# Partial loads and the checkpoint tools, against the JAX package's
# ---------------------------------------------------------------------------
def _tree(seed, rows=12, posenc=False):
    """A small parameter tree in the model's naming (f32)."""
    rng = np.random.RandomState(seed)
    tree = {"embedding": {"embedding": rng.randn(rows, 4).astype(np.float32)},
            "encoder": {"down_0": {"kernel": rng.randn(3, 2, 5).astype(np.float32),
                                   "bias": rng.randn(5).astype(np.float32)}},
            "decoder": {"layers_0": {"resweight": np.asarray(0.25, np.float32)}}}
    if posenc:
        tree["mem_pos_alpha"] = np.zeros((), np.float32)
    return tree


def _jax_partial(target, ckpt, **kw):
    from tal_asrd_tpu.core.checkpoint import load_params_partial as j_load
    return j_load(target, ckpt, **kw)


def _assert_trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


@pytest.mark.parametrize("case", ["missing", "shape"])
def test_strict_partial_load_raises_as_the_reference(case):
    target, ckpt = _tree(0), _tree(1)
    if case == "missing":
        del ckpt["encoder"]["down_0"]["bias"]
    else:
        ckpt["embedding"]["embedding"] = ckpt["embedding"]["embedding"][:5]
    err = KeyError if case == "missing" else ValueError
    with pytest.raises(err):
        _jax_partial(target, ckpt)
    with pytest.raises(err):
        tckpt.load_params_partial(target, ckpt)


def test_no_strict_keeps_the_target_leaf_as_the_reference():
    target, ckpt = _tree(0), _tree(1)
    del ckpt["encoder"]["down_0"]["bias"]
    ckpt["embedding"]["embedding"] = ckpt["embedding"]["embedding"][:5]
    mine = tckpt.load_params_partial(target, ckpt, strict=False)
    _assert_trees_equal(mine, _jax_partial(target, ckpt, strict=False))
    np.testing.assert_array_equal(mine["encoder"]["down_0"]["bias"],
                                  target["encoder"]["down_0"]["bias"])
    np.testing.assert_array_equal(mine["encoder"]["down_0"]["kernel"],
                                  ckpt["encoder"]["down_0"]["kernel"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_speaker_embedding_expansion_is_bit_equal_to_the_reference(dtype):
    """New rows uniform(+-1/sqrt(d)) from RandomState(seed), as JAX's (a bf16
    table: rows rounded to bf16, as ml_dtypes rounds them)."""
    from tal_asrd_tpu.core.checkpoint import expand_speaker_embeddings as j_expand
    emb = np.random.RandomState(5).randn(300, 64).astype(np.float32)
    if dtype == "bfloat16":
        j_emb = np.asarray(jnp.asarray(emb, jnp.bfloat16))
        emb = j_emb.view(np.uint16).view(tckpt.BFLOAT16_BITS)
    else:
        j_emb = emb
    for n in (308, 300, 290):
        mine = tckpt.expand_speaker_embeddings(emb, n)
        ref = j_expand(j_emb, n)
        assert mine.shape == ref.shape == (n, 64)
        assert tckpt.is_bfloat16_bits(mine) == (dtype == "bfloat16")
        np.testing.assert_array_equal(mine.view(np.uint16) if dtype == "bfloat16" else mine,
                                      ref.view(np.uint16) if dtype == "bfloat16" else ref)


def test_load_decoder_expands_into_the_target_as_the_reference():
    """--load-decoder: not strict, the donor's table grown to the target's
    rows before the shape check."""
    target, donor = _tree(0, rows=12), _tree(1, rows=9)
    mine = tckpt.load_params_partial(target, donor, strict=False, expand_embeddings_to=12)
    _assert_trees_equal(mine, _jax_partial(target, donor, strict=False,
                                           expand_embeddings_to=12))
    np.testing.assert_array_equal(mine["embedding"]["embedding"][:9],
                                  donor["embedding"]["embedding"])


@pytest.mark.parametrize("strict", [True, False])
def test_mem_pos_alpha_stays_zero_when_the_donor_lacks_it(strict):
    target, ckpt = _tree(0, posenc=True), _tree(1)
    mine = tckpt.load_params_partial(target, ckpt, strict=strict)
    _assert_trees_equal(mine, _jax_partial(target, ckpt, strict=strict))
    assert float(mine["mem_pos_alpha"]) == 0.0


def test_bf16_checkpoint_leaves_widen_exactly_into_f32_targets(trees):
    """The tracked checkpoint's bf16 leaves into an f32 target (its shapes,
    float32 LeafSpecs): every value exact, as JAX's np.asarray(cv, float32)."""
    spec = tckpt.tree_from_leaves((k, tckpt.LeafSpec(v.shape, np.dtype(np.float32)))
                                  for k, v in tckpt.tree_leaves(trees[0]))
    ours = dict(_flat(tckpt.load_params_partial(spec, trees[0])))
    ref = dict(_flat(_jax_partial(spec, trees[1])))
    assert sorted(ours) == sorted(ref) and len(ours) == 151
    for k, a in ours.items():
        assert a.dtype == np.float32, k
        np.testing.assert_array_equal(a, np.asarray(ref[k]), err_msg=k)


def test_params_spec_names_the_models_tree_without_its_values():
    from tal_asrd_tpu_torch.core.convert import params_spec, state_dict_to_params
    cfg = ModelConfig(model_type="1x", num_speakers=4, vocab_size=32, tds_depths=(1, 1, 1),
                      width_mult=0.1, d_decoder_override=32)
    model = ASRModel(cfg, dtype=torch.float32, device="cpu")
    spec = dict(_flat(params_spec(model)))
    tree = dict(_flat(state_dict_to_params(model.state_dict())))
    assert list(spec) == list(tree)
    for k, v in tree.items():
        assert isinstance(spec[k], tckpt.LeafSpec) and spec[k].shape == v.shape, k
        assert spec[k].dtype == v.dtype == np.float32, k
    model.to(torch.bfloat16)
    assert all(tckpt.is_bfloat16_bits(np.empty(0, s.dtype))
               for s in dict(_flat(params_spec(model))).values())


def test_load_encoder_replaces_only_the_encoder(tmp_path):
    """--load-encoder through the CLI's load_weights: encoder parameters
    from the donor, everything else as it was; merge_subtree and
    filter_subtree as the reference's."""
    from tal_asrd_tpu.core.checkpoint import filter_subtree as j_filter
    from tal_asrd_tpu.core.checkpoint import merge_subtree as j_merge
    from tal_asrd_tpu_torch.cli.train import load_weights
    from tal_asrd_tpu_torch.core.config import TrainConfig
    from tal_asrd_tpu_torch.train.system import ASRSystem
    from tests.test_torch_helpers import seeded_params

    a, b = _tree(0), _tree(1)
    _assert_trees_equal(tckpt.merge_subtree(a, "encoder", tckpt.filter_subtree(b, "encoder")),
                        j_merge(a, "encoder", j_filter(b, "encoder")))
    cfg = ModelConfig(model_type="1x", num_speakers=4, vocab_size=32, tds_depths=(1, 1, 1),
                      width_mult=0.1, d_decoder_override=32)
    system = ASRSystem(cfg, TrainConfig(), device="cpu", compute_dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in system.model.state_dict().items()}
    donor = seeded_params(system.params_spec(), 3)
    path = str(tmp_path / "donor.msgpack")
    tckpt.save_pytree(path, donor)

    class Args:
        load, load_decoder, load_encoder, no_strict = None, None, path, False
    load_weights(Args, system, cfg.num_tokens)
    want = params_to_state_dict(donor)
    for name, t in system.model.state_dict().items():
        expect = want[name] if name.startswith("encoder.") else before[name]
        assert torch.equal(t, expect), name
    assert any(n.startswith("encoder.") for n in want)


@pytest.mark.parametrize("cmd", ["average-ckpt", "expand-speakers"])
def test_tools_write_the_reference_tools_leaves(tmp_path, cmd):
    """The port's cli.tools and the JAX package's on the same two tiny
    checkpoints: every output leaf bit-equal (f32 leaves; expand-speakers
    also the bf16 one), average-ckpt equal to average_params."""
    from tal_asrd_tpu.cli.tools import main as j_tools
    from tal_asrd_tpu_torch.cli.tools import main as tools
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16).view(
        tckpt.BFLOAT16_BITS)
    ckpts = tmp_path / "run"
    mgr = tckpt.CheckpointManager(str(ckpts))
    for step, seed in ((10, 0), (20, 1)):
        tree = _tree(seed)
        tree["encoder"]["down_0"]["bias"] = bf(tree["encoder"]["down_0"]["bias"] * 1.37)
        mgr.save(step, tree)
    outs = {}
    for name, main in (("port", tools), ("jax", j_tools)):
        out = str(tmp_path / f"{name}.msgpack")
        if cmd == "average-ckpt":
            main(["average-ckpt", "--ckpt-dir", str(ckpts), "--last-k", "3", "--out", out])
        else:
            main(["expand-speakers", "--ckpt", str(ckpts / "ckpt_00000020.msgpack"),
                  "--num-tokens", "20", "--out", out])
        outs[name] = tckpt.load_pytree(out)
    mine, ref = dict(_flat(outs["port"])), dict(_flat(outs["jax"]))
    assert sorted(mine) == sorted(ref)
    bf16_leaf = "encoder/down_0/bias"
    if cmd == "average-ckpt":
        # The reference averages a bfloat16 leaf in its integer branch
        # (ml_dtypes' bfloat16 is no np.floating): the sum is rounded to
        # bfloat16, then divided into a float32 leaf (ROADMAP C11). The port
        # keeps the leaf's dtype: the exact mean, rounded once.
        a, b = mine.pop(bf16_leaf), ref.pop(bf16_leaf)
        assert tckpt.is_bfloat16_bits(a) and b.dtype == np.float32
        leaves = [to_tensor(mgr.load(s)["encoder"]["down_0"]["bias"]).double()
                  for s in (10, 20)]
        assert torch.equal(to_tensor(a), ((leaves[0] + leaves[1]) / 2).to(torch.bfloat16))
    for k, a in mine.items():
        assert a.dtype == ref[k].dtype and a.shape == ref[k].shape, k
        assert a.tobytes() == ref[k].tobytes(), k
    if cmd == "average-ckpt":
        avg = dict(_flat(tckpt.average_params([mgr.load(10), mgr.load(20)])))
        for k, a in mine.items():
            assert a.tobytes() == avg[k].tobytes(), k
    else:
        assert outs["port"]["embedding"]["embedding"].shape == (20, 4)


@pytest.mark.parametrize("cmd,item", [
    ("convert-audio", "A16"), ("merge-outputs", "A16"), ("librispeech-format", "A16"),
    ("wder-format", "A16"), ("diar-features", "A17"), ("synth-sad-stress", "A18")])
def test_unported_tools_exit_naming_their_item(cmd, item):
    """Every subcommand is ported (A16's, A17's diar-features, A18's
    synth-sad-stress) and parses its own arguments: argparse exits 2 on
    the ones left out and on an unknown one."""
    from tal_asrd_tpu_torch.cli.tools import main as tools
    with pytest.raises(SystemExit) as e:
        tools([cmd, "--out-dir", "x", "--no-such-flag"])
    assert e.value.code == 2
