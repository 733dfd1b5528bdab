"""The neural SAD's training and CLI: the port's Adam steps against the JAX
CLI's step function along its trajectory from JAX's own initial tree on the
same batches, and the CLI's loop (`train_steps`) free-running; both CLIs
scoring and binarizing from one pyannet.msgpack (each package loading the
file the other wrote); and
`build_sad_stress_corpus` byte for byte against the JAX package's."""
import functools
import json
import os
import pickle
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tal_asrd_tpu.cli import sad as jax_cli_sad
from tal_asrd_tpu.data.synth import build_sad_stress_corpus as jax_stress_corpus
from tal_asrd_tpu.vad.pyannet import PyanNet as JPyanNet
from tal_asrd_tpu_torch.cli import sad as cli_sad
from tal_asrd_tpu_torch.cli.tools import main as tools_main
from tal_asrd_tpu_torch.data.synth import build_sad_stress_corpus
from tal_asrd_tpu_torch.vad.pyannet import (
    FRAME_HOP,
    load_pyannet,
    params_to_state_dict,
    state_dict_to_params,
)

STEPS, BATCH, WINDOW_S, LR = 5, 2, 0.5, 1e-3
STRESS = dict(n_episodes=2, episode_seconds=12.0)


@pytest.fixture(scope="module", autouse=True)
def jitted_init():
    """flax's PyanNet.init, jitted: op by op it takes 10 s on the CPU (the
    values are the same)."""
    real = JPyanNet.init
    compiled = {}

    def init(self, rng, x):
        key = (self, x.shape)
        if key not in compiled:
            compiled[key] = jax.jit(lambda r, v: real(self, r, v))
        return compiled[key](rng, x)

    with mock.patch.object(JPyanNet, "init", init):
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("sad")
    train, test = str(root / "train"), str(root / "test")
    build_sad_stress_corpus(train, seed=0, **STRESS)
    build_sad_stress_corpus(test, seed=99, **STRESS)
    return root, train, test


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def test_adam_steps_match_the_jax_cli_step(corpus):
    """5 Adam steps (optax.adam(1e-3), the mean sigmoid BCE) along the JAX
    CLI's trajectory (its jitted step) from JAX's PRNGKey(0) initial tree, on
    the batches default_rng(0) draws. At each step the port starts from
    JAX's parameters and Adam state: its loss is within 1e-5 relative of
    JAX's and each gradient leaf within 1e-3 of the leaf's largest gradient
    (a bias gradient is a sum with cancellation) but the SincConv cut-offs':
    XLA's fused gradient of them lies 2e-3 to 2e-2 (of the leaf's largest)
    from a float64 gradient, where JAX's op-by-op gradient and the port's
    lie within 3e-6 of it (ROADMAP C25; tests/test_torch_pyannet.py holds
    them to the op-by-op one). The port's Adam step given
    the CLI's gradient lands every parameter within 1e-6 of JAX's. Then the
    CLI's own loop (`train_steps`) runs the 5 steps free. Adam amplifies
    rounding step by step: an entry whose gradient is near 0 gets its sign
    from rounding and moves by up to lr, and a one-ulp change of one JAX
    leaf moves JAX's own loss by 1e-3 within 20 steps (ROADMAP C24), so the
    free trajectory is held within 1e-3 relative."""
    _, train_dir, _ = corpus
    train = cli_sad.load_split(train_dir)
    win = FRAME_HOP * round(WINDOW_S * 16000 / FRAME_HOP)
    model = JPyanNet()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, win), jnp.float32))["params"]
    init = jax.tree_util.tree_map(np.asarray, params)
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)

    def loss_fn(p, x, y):
        return optax.sigmoid_binary_cross_entropy(model.apply({"params": p}, x), y).mean()

    @jax.jit
    def step(params, opt_state, x, y):        # tal_asrd_tpu/cli/sad.py's step
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    rng = np.random.default_rng(0)
    want = []
    for i in range(STEPS):
        x, y = cli_sad.sample_batch(train, rng, BATCH, win)
        port = load_pyannet(as_np(params), "cpu")
        opt = torch.optim.Adam(port.trainable_parameters(), lr=LR, betas=(0.9, 0.999),
                               eps=1e-8)
        adam = opt_state[0]
        if i:
            mu, nu = params_to_state_dict(as_np(adam.mu)), params_to_state_dict(as_np(adam.nu))
            for name, p in port.named_parameters():
                if p.requires_grad:
                    opt.state[p] = {"step": torch.tensor(float(adam.count)),
                                    "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        params, opt_state, loss, grads = step(params, opt_state, jnp.asarray(x),
                                              jnp.asarray(y))
        want.append(float(loss))
        got = torch.nn.functional.binary_cross_entropy_with_logits(
            port(torch.from_numpy(x)), torch.from_numpy(y))
        got.backward()
        assert abs(got.item() - want[-1]) <= 1e-5 * want[-1], (i, got.item(), want[-1])
        mine = dict(_flat(state_dict_to_params(
            {n: p.grad if p.requires_grad else torch.zeros_like(p)
             for n, p in port.named_parameters()})))
        for name, g in _flat(as_np(grads)):
            if not name.startswith("SincConv_0"):
                err = np.abs(mine[name] - g).max() / np.abs(g).max()
                assert err <= 1e-3, (i, name, err)
        jax_grads = params_to_state_dict(as_np(grads))
        for name, p in port.named_parameters():
            p.grad = jax_grads[name] if p.requires_grad else None
        opt.step()
        mine = dict(_flat(state_dict_to_params(port.state_dict())))
        for name, value in _flat(as_np(params)):
            np.testing.assert_allclose(mine[name], value, rtol=0, atol=1e-6,
                                       err_msg=f"step {i} {name}")

    free = cli_sad.train_steps(load_pyannet(init, "cpu"), train, STEPS, BATCH, win, LR,
                               seed=0, log=lambda _: None)
    np.testing.assert_allclose(free, want, rtol=1e-3)


def test_both_clis_load_each_others_msgpack(corpus, tmp_path):
    """The JAX CLI trains 2 steps and writes pyannet.msgpack; the port's
    CLI --load of it writes the same sad_bounds.pkl and JSON. Then the
    port's CLI trains and writes its own; the JAX CLI --load of it writes
    the port's bounds and JSON."""
    _, train, test = corpus
    common = ["--train-data", train, "--test-data", test, "--batch-size", str(BATCH),
              "--window-secs", str(WINDOW_S), "--steps", "2"]

    def run(cli, name, load=None, device=True):
        out = str(tmp_path / name)
        argv = common + ["--out-dir", out, "--json-out", out + ".json"]
        argv += ["--load", load] if load else []
        argv += ["--device", "cpu"] if device else []
        cli.main(argv)
        with open(os.path.join(out, "sad_bounds.pkl"), "rb") as f:
            bounds = pickle.load(f)
        with open(out + ".json") as f:
            metrics = json.load(f)
        return out, bounds, metrics

    jax_out, jax_bounds, jax_metrics = run(jax_cli_sad, "jax_trained", device=False)
    _, bounds, metrics = run(cli_sad, "port_loads_jax", os.path.join(jax_out, "pyannet.msgpack"))
    assert bounds == jax_bounds and metrics == jax_metrics
    assert sum(len(b) for b in bounds.values()) > 0

    port_out, port_bounds, port_metrics = run(cli_sad, "port_trained")
    _, bounds, metrics = run(jax_cli_sad, "jax_loads_port",
                             os.path.join(port_out, "pyannet.msgpack"), device=False)
    assert bounds == port_bounds and metrics == port_metrics
    for name in ("corpus.rttm", "corpus.uem"):
        with open(os.path.join(jax_out, name)) as a, open(os.path.join(port_out, name)) as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("seed", [0, 99])
def test_stress_corpus_is_byte_equal(tmp_path, seed):
    """build_sad_stress_corpus at 2 x 10 s: every wav, transcript.pkl and
    speaker_map.json byte for byte as the JAX package's; the tools CLI's
    synth-sad-stress writes the same files."""
    kw = dict(n_episodes=2, episode_seconds=10.0, seed=seed)
    jax_stress_corpus(str(tmp_path / "jax"), **kw)
    tr = build_sad_stress_corpus(str(tmp_path / "port"), **kw)
    tools_main(["synth-sad-stress", "--out-dir", str(tmp_path / "cli"), "--episodes", "2",
                "--episode-seconds", "10", "--seed", str(seed)])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["ep0.wav", "ep1.wav", "speaker_map.json", "transcript.pkl"]
    for other in ("port", "cli"):
        assert sorted(os.listdir(tmp_path / other)) == names
        for name in names:
            assert (tmp_path / other / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert all("snr_db" in u for utts in tr.values() for u in utts)


def test_the_sad_cli_defaults_to_cuda_and_never_runs_on_the_cpu_unasked(corpus):
    """--device defaults to cuda; on a machine without a GPU the CLI fails
    there instead of training on the CPU."""
    _, train, test = corpus
    assert cli_sad.get_parser().parse_args(
        ["--train-data", "a", "--test-data", "b", "--out-dir", "c"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises((RuntimeError, AssertionError)):
        cli_sad.main(["--train-data", train, "--test-data", test, "--out-dir",
                      os.path.join(os.path.dirname(train), "nocuda"), "--steps", "1"])
