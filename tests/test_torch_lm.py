"""The port's shallow-fusion LM and its training against the JAX package on
the CPU, f32, at a tiny shape with the ReZero scalars at 0.4 (at their
initial 0 every block would add nothing and a broken block would pass):
`DecoderLMModel`'s forward, decode_step (past max_positions too) and
decode_prefill within 1e-5; the converter both ways; `LMTextDataset` rows
and `batch_iterator` order, equal; five `LMSystem` steps and the perplexity
from one initial tree within 1e-5; `cli.train_lm` against the JAX CLI's
figures in tests/fixtures/torch_lm_reference.json (per-step losses,
perplexities and every checkpoint leaf within 1e-5), its checkpoints read by
the JAX `load_pytree`; the parser against the reference's."""
import importlib.util
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu_torch.cli import train_lm as cli_train_lm
from tal_asrd_tpu_torch.cli.args import get_lm_argparser
from tal_asrd_tpu_torch.core.checkpoint import load_pytree, tree_from_leaves, tree_leaves
from tal_asrd_tpu_torch.core.config import LMConfig
from tal_asrd_tpu_torch.core.convert import load_into, params_spec, state_dict_to_params
from tal_asrd_tpu_torch.data.synth import build_synth_corpus
from tal_asrd_tpu_torch.models.lm import DecoderLMModel
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
from tal_asrd_tpu_torch.train.lm_system import LMSystem, LMTextDataset, batch_iterator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(ROOT, "accuracy_release", "bpe.model")
TINY = dict(vocab_size=40, hidden_size=32, n_head=2, n_layers=2, max_positions=16)


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "torch_lm_reference", os.path.join(ROOT, "scripts", "torch_lm_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_script()


@pytest.fixture(scope="module")
def pair():
    """(flax LM, its params, port LM) from one seeded tree."""
    from tal_asrd_tpu.core.config import LMConfig as JLMConfig
    from tal_asrd_tpu.models.lm import DecoderLMModel as JDecoderLMModel
    tree = REF.seeded_lm_params(TINY["vocab_size"], 3, 0.4, hidden=TINY["hidden_size"],
                                layers=TINY["n_layers"])
    tmodel = load_into(DecoderLMModel(LMConfig(**TINY), device="cpu"), tree)
    return JDecoderLMModel(JLMConfig(**TINY)), tree, tmodel


def assert_params_close(got, want, key_bias_atol, atol=1e-5):
    """Trees within atol, leaf by leaf, but for the key third of each qkv
    bias: a constant added to every key cancels in the softmax, so its true
    gradient is 0 and Adam (eps 1e-8) turns the rounding noise of both
    implementations into steps of up to lr a step. Those slices are held to
    each other within `key_bias_atol` (2 x lr x steps) instead."""
    got = dict(tree_leaves(got))
    for path, ref in tree_leaves(want):
        mine = np.asarray(got[path])
        if path[-2:] == ("qkv", "bias"):
            d = mine.shape[0] // 3
            np.testing.assert_allclose(mine[d:2 * d], ref[d:2 * d], rtol=0,
                                       atol=key_bias_atol, err_msg="/".join(path))
            mine, ref = np.delete(mine, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        np.testing.assert_allclose(mine, ref, rtol=0, atol=atol, err_msg="/".join(path))


def tokens(b=3, l=10, seed=0):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, l))


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax(pair, causal):
    jm, tree, tm = pair
    toks = tokens()
    ref = np.asarray(jm.apply({"params": tree}, jnp.asarray(toks), causal=causal))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks), causal=causal).numpy()
    assert got.shape == (3, 10, TINY["vocab_size"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_decode_steps_match_jax_past_max_positions(pair):
    """24 KV-cached steps over a cache of 24 with a table of 16 positions:
    from step 16 on both take the table's last row (JAX's dynamic_slice
    clamps; the port copies the clamp)."""
    from tal_asrd_tpu.models.lm import DecoderLMModel as JDecoderLMModel
    jm, tree, tm = pair
    toks = tokens(l=24, seed=1)
    step = jax.jit(lambda y, c, i: jm.apply({"params": tree}, y, c, i,
                                            method=JDecoderLMModel.decode_step))
    jc = jm.apply({"params": tree}, 3, 24, method=JDecoderLMModel.init_cache)
    tc = tm.init_cache(3, 24)
    assert tuple(tc[0]["k"].shape) == (3, 24, 2, 16)
    for i in range(24):
        jl, jc = step(jnp.asarray(toks[:, i:i + 1]), jc, jnp.asarray(i))
        with torch.no_grad():
            tl, tc = tm.decode_step(torch.from_numpy(toks[:, i:i + 1]), tc, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5,
                                   err_msg=f"step {i}")
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[1][key].numpy(), np.asarray(jc[1][key]), rtol=0,
                                   atol=1e-5)


def test_decode_prefill_matches_jax(pair):
    from tal_asrd_tpu.models.lm import DecoderLMModel as JDecoderLMModel
    jm, tree, tm = pair
    toks = tokens(l=16, seed=2)
    jl, jc = jm.apply({"params": tree}, jnp.asarray(toks), 16,
                      method=JDecoderLMModel.decode_prefill)
    with torch.no_grad():
        tl, tc = tm.decode_prefill(torch.from_numpy(toks), 16)
        full = tm(torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), full.numpy(), rtol=0, atol=1e-5)
    for layer in range(TINY["n_layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[layer][key].numpy(), np.asarray(jc[layer][key]),
                                       rtol=0, atol=1e-5)


def test_converter_carries_the_flax_tree_both_ways(pair):
    """Every leaf of the flax init tree has a port parameter of its shape, and
    state_dict -> tree -> state_dict gives the same tensors back."""
    jm, tree, tm = pair
    flax_tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 8), jnp.int32)))["params"]
    flax_shapes = {p: tuple(v.shape) for p, v in tree_leaves(jax.tree_util.tree_map(
        lambda x: x, flax_tree.unfreeze() if hasattr(flax_tree, "unfreeze") else flax_tree))}
    port_shapes = {p: tuple(v.shape) for p, v in tree_leaves(params_spec(tm))}
    assert port_shapes == flax_shapes
    back = state_dict_to_params(tm.state_dict())
    assert {p: v.tobytes() for p, v in tree_leaves(back)} == \
        {p: np.asarray(v).tobytes() for p, v in tree_leaves(tree)}
    again = load_into(DecoderLMModel(LMConfig(**TINY), device="cpu"), back)
    for (name, a), (_, b) in zip(tm.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.fixture(scope="module")
def tokenizers():
    from tal_asrd_tpu.text import BpeTokenizer as JBpeTokenizer
    return BpeTokenizer(model_path=TOKENIZER), JBpeTokenizer(model_path=TOKENIZER)


@pytest.mark.parametrize("max_len,n_texts", [(8, 12), (16, 40), (512, 5)])
def test_dataset_rows_and_batch_order_equal_the_reference(tokenizers, max_len, n_texts):
    """Rows (the tail dropped; one row when the stream is short) and the
    batches of batch_iterator (RandomState order, tail batch dropped)."""
    from tal_asrd_tpu.train.lm_system import LMTextDataset as JDataset
    from tal_asrd_tpu.train.lm_system import batch_iterator as j_batch_iterator
    from tal_asrd_tpu_torch.data.synth import random_sentence
    rng = np.random.RandomState(n_texts)
    texts = [random_sentence(rng) for _ in range(n_texts)]
    mine, ref = LMTextDataset(texts, tokenizers[0], max_len), JDataset(texts, tokenizers[1], max_len)
    assert mine.rows == ref.rows and len(mine) == len(ref) >= 1
    for i in range(len(ref)):
        for a, b in zip(mine[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    for seed in (0, 3):
        got = list(batch_iterator(mine, 3, seed=seed, epochs=2))
        want = list(j_batch_iterator(ref, 3, seed=seed, epochs=2))
        assert len(got) == len(want)
        for (t, m), (jt, jm) in zip(got, want):
            np.testing.assert_array_equal(t, jt)
            np.testing.assert_array_equal(m, jm)


def test_five_steps_and_perplexity_match_the_reference(tokenizers):
    """Adam at lr * sqrt(batch) on the masked next-token loss, no dropout."""
    from tal_asrd_tpu.core.config import LMConfig as JLMConfig
    from tal_asrd_tpu.train.lm_system import LMSystem as JLMSystem
    from tal_asrd_tpu_torch.data.synth import random_sentence
    rng = np.random.RandomState(7)
    texts = [random_sentence(rng) for _ in range(60)]
    ds = LMTextDataset(texts, tokenizers[0], 16)
    cfg = dict(TINY, vocab_size=len(tokenizers[0]))
    tree = REF.seeded_lm_params(cfg["vocab_size"], 4, 0.4, hidden=32, layers=2)
    ref = JLMSystem(JLMConfig(**cfg), lr=1e-3, batch_size=4)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ref.state = ref.state.replace(params=params, opt_state=ref.tx.init(params))
    mine = LMSystem(LMConfig(**cfg), lr=1e-3, batch_size=4, device="cpu")
    load_into(mine.model, tree)
    batches = list(batch_iterator(ds, 4, seed=1))[:5]
    assert len(batches) == 5
    np.testing.assert_allclose(mine.fit(iter(batches)), ref.fit(iter(batches)), rtol=0, atol=1e-5)
    assert mine.step == 5
    valid = list(batch_iterator(ds, 4, seed=2))
    np.testing.assert_allclose(mine.perplexity(iter(valid)), ref.perplexity(iter(valid)),
                               rtol=1e-5)
    assert_params_close(mine.params(), jax.tree_util.tree_map(np.asarray, ref.state.params),
                        key_bias_atol=2 * 1e-3 * np.sqrt(4) * 5)


@pytest.fixture(scope="module")
def fixture():
    with open(os.path.join(ROOT, "tests", "fixtures", "torch_lm_reference.json")) as f:
        return json.load(f)["tiny_cli"]


@pytest.fixture(scope="module")
def port_cli(tmp_path_factory, fixture):
    """The port's cli.train_lm at the fixture's flags on the CPU, from the
    fixture's seeded initial tree (the reference ignores --load)."""
    tmp = str(tmp_path_factory.mktemp("train_lm"))
    paths = {k: os.path.join(tmp, "tiny_" + k.lower()) for k in ("TRAIN", "VALID", "CKPTS")}
    for name, split in REF.TINY_SPLITS.items():
        build_synth_corpus(paths[name.upper()], **split)
    init = REF.seeded_lm_params(300, REF.TINY_SEED, REF.TINY_SCALARS, **REF.TINY_SHAPE)

    class SeededLMSystem(LMSystem):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            load_into(self.model, init)

    cwd = os.getcwd()
    try:
        os.chdir(ROOT)
        with mock.patch.object(cli_train_lm, "LMSystem", SeededLMSystem):
            out = cli_train_lm.main(REF.fill(REF.TINY_ARGV, paths) + ["--device", "cpu"])
    finally:
        os.chdir(cwd)
    return dict(out, ckpt_dir=os.path.join(paths["CKPTS"], "tiny"))


def test_the_fixture_ran_these_flags(fixture):
    assert fixture["argv"] == REF.TINY_ARGV
    assert fixture["splits"] == json.loads(json.dumps(REF.TINY_SPLITS))
    assert (fixture["init_seed"], fixture["init_scalars"]) == (REF.TINY_SEED, REF.TINY_SCALARS)


def test_cli_losses_and_perplexities_match_the_jax_cli(port_cli, fixture):
    got = port_cli["epochs"]
    assert [e["step"] for e in got] == [2, 4, 6]
    assert len(got) == len(fixture["epochs"])
    for mine, ref in zip(got, fixture["epochs"]):
        np.testing.assert_allclose(mine["losses"], ref["losses"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(mine["ppl"], ref["ppl"], rtol=1e-5, atol=0)


def test_cli_checkpoints_match_the_jax_cli_and_jax_reads_them(port_cli, fixture):
    from tal_asrd_tpu.core.checkpoint import load_pytree as j_load_pytree
    names = sorted(n for n in os.listdir(port_cli["ckpt_dir"]) if n.startswith("ckpt_"))
    assert names == fixture["checkpoints"]
    with open(os.path.join(port_cli["ckpt_dir"], "latest.json")) as f:
        latest = json.load(f)
    assert latest["step"] == fixture["latest"]["step"] and latest["path"] == names[-1]
    np.testing.assert_allclose(latest["ppl"], fixture["latest"]["ppl"], rtol=1e-5)
    npz = np.load(REF.CKPTS_NPZ)
    state = dict(tree_leaves(port_cli["system"].params()))
    for name in names:
        path = os.path.join(port_cli["ckpt_dir"], name)
        mine = dict(tree_leaves(load_pytree(path)))
        theirs = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, j_load_pytree(path))))
        assert set(mine) == set(theirs) == {tuple(k.split("/")[1:]) for k in npz.files
                                            if k.startswith(name + "/")}
        for leaf, value in mine.items():
            np.testing.assert_array_equal(theirs[leaf], value)
        assert_params_close(load_pytree(path), tree_from_leaves(
                                (leaf, npz[name + "/" + "/".join(leaf)]) for leaf in mine),
                            key_bias_atol=2 * 1e-3 * np.sqrt(4) * latest["step"])
        if name == names[-1]:
            for leaf, value in mine.items():
                np.testing.assert_array_equal(value, state[leaf])


def test_the_lm_parser_takes_every_flag_of_the_reference():
    from tal_asrd_tpu.cli.args import get_lm_argparser as j_get_lm_argparser
    req = ["--train-data", "d", "--valid-data", "d", "--tokenizer", "t", "--name", "n"]
    ref, mine = j_get_lm_argparser(), get_lm_argparser()
    flags = lambda p: {s for a in p._actions for s in a.option_strings}
    assert flags(mine) - flags(ref) == {"--device"} and flags(ref) <= flags(mine)
    assert {k: v for k, v in vars(mine.parse_args(req)).items()
            if k != "device"} == vars(ref.parse_args(req))
    assert mine.parse_args(req).device == "cuda"


def test_lm_config_equals_the_reference():
    from tal_asrd_tpu.core.config import LMConfig as JLMConfig
    assert vars(LMConfig()) == vars(JLMConfig())


def test_perplexity_of_a_split_shorter_than_a_batch_is_nan_as_the_reference(tokenizers):
    """ROADMAP C14: batch_iterator drops the tail batch, so a validation
    split of fewer rows than one batch gives no loss and exp(mean([])),
    NaN, on both sides."""
    from tal_asrd_tpu.core.config import LMConfig as JLMConfig
    from tal_asrd_tpu.train.lm_system import LMSystem as JLMSystem
    cfg = dict(TINY, vocab_size=len(tokenizers[0]))
    ds = LMTextDataset(["one two three"], tokenizers[0], 16)
    assert len(ds) == 1
    mine = LMSystem(LMConfig(**cfg), batch_size=4, device="cpu")
    ref = JLMSystem(JLMConfig(**cfg), batch_size=4)
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        got = mine.perplexity(batch_iterator(ds, 4))
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        want = ref.perplexity(batch_iterator(ds, 4))
    assert np.isnan(got) and np.isnan(want)
