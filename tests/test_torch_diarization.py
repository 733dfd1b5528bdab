"""First diarization: the port's GRU, UIS-RNN, evaluation, experiment
runners and CLIs (tal_asrd_tpu_torch/diarization, cli/uisrnn.py,
cli/tools.py diar-features) against the JAX package's on the CPU, in
float32, at a tiny width (observations 8, hidden 16, two layers) on
well-separated seeded speakers."""
import contextlib
import importlib.util
import io
import os
import pickle
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.cli import tools as jtools
from tal_asrd_tpu.cli import uisrnn as jcli
from tal_asrd_tpu.core.checkpoint import load_pytree as jload_pytree
from tal_asrd_tpu.diarization import evals as jevals
from tal_asrd_tpu.diarization import experiment as jexperiment
from tal_asrd_tpu.diarization import gru as jgru
from tal_asrd_tpu.diarization import uisrnn as juisrnn
from tal_asrd_tpu_torch.cli import tools
from tal_asrd_tpu_torch.cli import uisrnn as cli
from tal_asrd_tpu_torch.core.checkpoint import load_pytree
from tal_asrd_tpu_torch.diarization import evals, experiment, gru, uisrnn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(observation_dim=8, rnn_hidden_size=16, rnn_depth=2)
TRAIN = dict(batch_size=4, num_permutations=2)
TOL = 1e-5


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "torch_diar_reference", os.path.join(ROOT, "scripts", "torch_diar_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _episodes(n=4, t=24, seed=0, speakers=4, d=8, balanced=True):
    """n sequences of t observations from `speakers` centres 3 apart (sd
    0.3) and their label lists; `balanced`: each speaker t / speakers times
    (every training subsequence one length: JAX compiles its step once)."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((speakers, d)) * 3
    out = []
    for _ in range(n):
        lab = (rng.permutation(np.repeat(np.arange(speakers), t // speakers)) if balanced
               else rng.integers(0, speakers, t))
        out.append((centres[lab] + 0.3 * rng.standard_normal((t, d)), [str(x) for x in lab]))
    return out


def _jax_init(cfg, seed):
    """JAX's initial `params` of UISRNN(cfg, seed), numpy."""
    return jax.tree_util.tree_map(np.asarray, juisrnn.UISRNN(cfg, seed=seed).params)


@contextlib.contextmanager
def _jax_initial_draws():
    """The port's UISRNN starts from JAX's initial draw of the same seed."""
    with mock.patch.object(uisrnn, "init_params", lambda cfg, seed=0: _jax_init(
            juisrnn.UISRNNConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}),
            seed)):
        yield


def _quiet(fn, *a, **k):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    return out, buf.getvalue()


def _max_rel(a, b):
    leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda x, y: float(np.abs(np.asarray(x) - np.asarray(y)).max()
                           / max(np.abs(np.asarray(x)).max(), 1e-30)), a, b))
    return max(leaves)


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's five fit steps from seed 0, each recorded (state in, batch,
    gradients, loss, state out)."""
    eps = _episodes()
    model = juisrnn.UISRNN(juisrnn.UISRNNConfig(**TINY), seed=0)
    args = juisrnn.UISRNNTrainConfig(train_iteration=5, log_iter=100, **TRAIN)
    steps, _ = _quiet(_reference_script().record_fit, model, [s for s, _ in eps],
                      [i for _, i in eps], args)
    return steps


@pytest.fixture(scope="module")
def jax_trained():
    """A tiny UIS-RNN trained 60 iterations by JAX, saved, and its traces of
    two held-out sequences (beam 4, look-ahead 1 and 2)."""
    import tempfile
    eps = _episodes(n=6, seed=1)
    model = juisrnn.UISRNN(juisrnn.UISRNNConfig(**TINY), seed=3)
    _quiet(model.fit, [s for s, _ in eps[:4]], [i for _, i in eps[:4]],
           juisrnn.UISRNNTrainConfig(train_iteration=60, log_iter=100, **TRAIN))
    path = os.path.join(tempfile.mkdtemp(), "jax_uisrnn.msgpack")
    model.save(path)
    traces = {la: [model.predict_single(s[:12], juisrnn.UISRNNInferenceConfig(
        beam_size=4, look_ahead=la, test_iteration=2)) for s, _ in eps[4:]]
        for la in (1, 2)}
    return {"path": path, "traces": traces, "test": eps[4:]}


def _assert_step_close(want, got):
    """The moments and the trainable leaves within 1e-5 of each leaf's
    largest value; an element whose root mean square gradient is under 100
    Adam epsilons (its step decided by the gradient's rounding) within lr
    (scripts/torch_diar_reference.py `step_gaps`)."""
    gaps = _reference_script().step_gaps(want, got, uisrnn.UISRNNTrainConfig().learning_rate)
    assert max(gaps["trainable"], gaps["mu"], gaps["nu"]) <= TOL, gaps
    assert gaps["noise_abs"] <= gaps["noise_bound"], gaps


def _port_model(cfg=TINY, seed=0):
    return uisrnn.UISRNN(uisrnn.UISRNNConfig(**cfg), seed=seed, device="cpu")


def _fit_step(model):
    return uisrnn.FitStep(model, uisrnn.UISRNNTrainConfig(**TRAIN))


# ---------------------------------------------------------------------------
# GRU and CoreRNN
# ---------------------------------------------------------------------------
def test_gru_matches_the_torch_golden_and_jax():
    """nn.GRU with the golden's weights gives its outputs and final states
    (tests/fixtures/gru_golden.npz); the same weights as flax leaves give
    JAX's GRU the same, within 1e-5."""
    fix = np.load(os.path.join(ROOT, "tests", "fixtures", "gru_golden.npz"))
    x = fix["x"]
    port = gru.GRU(6, 8, 2)
    port.rnn.load_state_dict({k: torch.from_numpy(fix[k]) for k in port.rnn.state_dict()})
    with torch.no_grad():
        out, h = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), fix["out"], rtol=0, atol=TOL)
    np.testing.assert_allclose(h.numpy(), fix["h"], rtol=0, atol=TOL)
    leaves = gru.gru_state_dict_to_params(port.rnn.state_dict(), 2)
    out_j, h_j = jgru.GRU(hidden_size=8, depth=2).apply({"params": leaves}, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=0, atol=TOL)


@pytest.mark.parametrize("which", ["prefix", "holes"])
def test_masked_steps_keep_the_carried_state(which):
    """The plain cell loop keeps JAX's masked semantics for any mask (here
    one with holes) within 1e-5; with a prefix mask, as UIS-RNN's batches
    have, nn.GRU without a mask gives JAX's outputs on every real step."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 6, 5)).astype(np.float32)
    h0 = rng.standard_normal((2, 3, 7)).astype(np.float32)
    lens = np.array([6, 4, 1])
    mask = np.arange(6)[None, :] < lens[:, None]
    if which == "holes":
        mask = rng.random((3, 6)) < 0.6
    net = jgru.GRU(hidden_size=7, depth=2)
    params = jax.tree_util.tree_map(np.asarray, net.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    out_j, h_j = net.apply({"params": params}, jnp.asarray(x), jnp.asarray(h0),
                           jnp.asarray(mask))
    out_j, h_j = np.asarray(out_j), np.asarray(h_j)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    out_l, h_l = gru.gru_loop(tp, torch.from_numpy(x), 2, torch.from_numpy(h0),
                              torch.from_numpy(mask))
    np.testing.assert_allclose(out_l.numpy(), out_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(h_l.numpy(), h_j, rtol=0, atol=TOL)
    if which == "prefix":
        port = gru.GRU(5, 7, 2)
        port.rnn.load_state_dict(gru.gru_params_to_state_dict(params, 2))
        with torch.no_grad():
            out, _ = port(torch.from_numpy(x), torch.from_numpy(h0))
        np.testing.assert_allclose(out.numpy()[mask], out_j[mask], rtol=0, atol=TOL)


def test_core_rnn_matches_jax():
    """CoreRNN's means and final states within 1e-5 of JAX's on the same
    tree; the tree crosses to the state_dict and back bit for bit."""
    cfg = juisrnn.UISRNNConfig(**TINY)
    params = _jax_init(cfg, 4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 3, 16)).astype(np.float32)
    mean_j, h_j = juisrnn.CoreRNN(16, 2, 8).apply({"params": params}, jnp.asarray(x),
                                                  jnp.asarray(h0))
    core = uisrnn.CoreRNN(16, 2, 8)
    core.load_state_dict(uisrnn.params_to_state_dict(params, 2))
    with torch.no_grad():
        mean, h = core(torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=0, atol=TOL)
    back = uisrnn.state_dict_to_params(core.state_dict(), 2)
    flat = lambda t: {"/".join(k.key for k in p): np.asarray(v)
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys() and all(a[k].tobytes() == b[k].tobytes() for k in a)


def test_initial_draw_has_flax_shapes_and_scales():
    """`init_params` (a CPU generator: JAX's draws cannot be reproduced)
    has JAX's leaves and shapes, zero biases and lecun_normal kernels:
    std 1/sqrt(fan_in), nothing beyond 2.28/sqrt(fan_in)."""
    cfg = uisrnn.UISRNNConfig(observation_dim=64, rnn_hidden_size=128, rnn_depth=2)
    mine = uisrnn.init_params(cfg, 0)
    want = _jax_init(juisrnn.UISRNNConfig(observation_dim=64, rnn_hidden_size=128,
                                          rnn_depth=2), 0)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mine),
                            jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32, path
        if a.ndim == 1:
            assert not a.any(), path
        else:
            s = np.sqrt(a.shape[0])
            assert abs(a.std() * s - 1) < 0.05 and np.abs(a).max() * s < 2.28, path
    again = uisrnn.init_params(cfg, 0)
    assert all(np.array_equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(mine),
                                                    jax.tree_util.tree_leaves(again)))


# ---------------------------------------------------------------------------
# Data shaping, losses, the training step
# ---------------------------------------------------------------------------
def test_data_shaping_is_the_reference_call_for_call():
    """resize_sequence (with and without permutations), pack_batch,
    estimate_transition_bias, concatenate_training_data: equal outputs."""
    eps = _episodes(n=3, t=25, seed=5, balanced=False)
    seqs, ids = [s for s, _ in eps], [i for _, i in eps]
    assert uisrnn.estimate_transition_bias(ids) == juisrnn.estimate_transition_bias(ids)
    seq, cid = uisrnn.concatenate_training_data(seqs, ids)
    seq_j, cid_j = juisrnn.concatenate_training_data(seqs, ids)
    assert np.array_equal(seq, seq_j) and np.array_equal(cid, cid_j)
    for perms in (None, 1, 3):
        sub, lens = uisrnn.resize_sequence(seq, cid, perms, seed=2)
        sub_j, lens_j = juisrnn.resize_sequence(seq, cid, perms, seed=2)
        assert lens == lens_j and all(np.array_equal(a, b) for a, b in zip(sub, sub_j))
        idx = np.sort(np.random.RandomState(0).choice(len(sub), 4, replace=False))
        for a, b in zip(uisrnn.pack_batch(sub, lens, idx, 8),
                        juisrnn.pack_batch(sub_j, lens_j, idx, 8)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_one_train_step_loss_gradients_and_update(jax_steps):
    """JAX's first step: the loss terms and the gradients of every parameter
    leaf, init_hidden and sigma2 within 1e-5; the clipped Adam update as
    `_assert_step_close` holds it."""
    s = jax_steps[0]
    fit = _fit_step(_port_model())
    fit.set_state(s["state"])
    loss, aux, grads = fit.grads(torch.from_numpy(s["x"]), torch.from_numpy(s["truth"]))
    assert abs(float(loss) - s["loss"]) <= TOL * abs(s["loss"])
    for a, b in zip(aux, s["aux"]):
        assert abs(float(a) - b) <= TOL * max(abs(b), 1e-3), (aux, s["aux"])
    g = fit._tree(grads)
    assert set(g) == {"init_hidden", "params", "sigma2"}
    assert _max_rel(s["grads"], g) <= TOL
    fit.update(grads)
    st = fit.state()
    assert st["count"] == s["out"]["count"] == 1
    _assert_step_close(s["out"], st)


@pytest.mark.parametrize("i", range(5))
def test_fit_steps_one_at_a_time_along_jax_trajectory(jax_steps, i):
    """Step i from JAX's state i on JAX's batch i lands on JAX's state i + 1
    (`_assert_step_close`; Adam turns rounding into moves of lr, so the
    steps are held one at a time, not along the port's own trajectory)."""
    s = jax_steps[i]
    fit = _fit_step(_port_model())
    fit.set_state(s["state"])
    loss, _ = fit.step(torch.from_numpy(s["x"]), torch.from_numpy(s["truth"]))
    assert abs(float(loss) - s["loss"]) <= TOL * abs(s["loss"])
    _assert_step_close(s["out"], fit.state())


def test_sigma2_at_its_floor_takes_half_the_gradient():
    """With sigma2 exactly at the 1e-6 floor, the floor's maximum splits the
    gradient 0.5 / 0.5 (jnp.maximum and torch.maximum alike); the port's
    sigma2 gradient is JAX's within 1e-5, and half of what a clamp passes."""
    eps = _episodes(n=2, seed=6)
    model = juisrnn.UISRNN(juisrnn.UISRNNConfig(**TINY), seed=0)
    model.sigma2 = jnp.full((8,), 1e-6, jnp.float32)
    steps, _ = _quiet(_reference_script().record_fit, model, [s for s, _ in eps],
                      [i for _, i in eps], juisrnn.UISRNNTrainConfig(
                          train_iteration=1, log_iter=100, **TRAIN))
    s = steps[0]
    fit = _fit_step(_port_model())
    fit.set_state(s["state"])
    _, _, grads = fit.grads(torch.from_numpy(s["x"]), torch.from_numpy(s["truth"]))
    got, want = fit._tree(grads)["sigma2"], s["grads"]["sigma2"]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    with mock.patch.object(torch, "maximum", lambda a, b: torch.clamp(a, min=float(b))):
        _, _, clamped = fit.grads(torch.from_numpy(s["x"]), torch.from_numpy(s["truth"]))
    np.testing.assert_allclose(fit._tree(clamped)["sigma2"], 2 * want, rtol=1e-4, atol=0)


def test_fit_equals_jax_fit_from_the_same_draw(jax_steps):
    """fit's losses over JAX's five steps from JAX's initial draw, the
    transition bias and its denominator; the trained leaves within 1e-4."""
    eps = _episodes()
    jm = juisrnn.UISRNN(juisrnn.UISRNNConfig(**TINY), seed=0)
    with _jax_initial_draws():
        pm = _port_model()
    args = dict(train_iteration=5, log_iter=100, **TRAIN)
    jl, _ = _quiet(jm.fit, [s for s, _ in eps], [i for _, i in eps],
                   juisrnn.UISRNNTrainConfig(**args))
    pl, _ = _quiet(pm.fit, [s for s, _ in eps], [i for _, i in eps],
                   uisrnn.UISRNNTrainConfig(**args))
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert (pm.transition_bias, pm.transition_bias_denominator) == \
           (jm.transition_bias, jm.transition_bias_denominator)
    assert _max_rel(jax.tree_util.tree_map(np.asarray, jm.params), pm.params) <= 1e-4


# ---------------------------------------------------------------------------
# Inference, persistence
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("look_ahead", [1, 2])
def test_predict_single_traces_equal_jax(jax_trained, look_ahead):
    """The beam search (beam 4, 2 test iterations) on JAX's trained tree,
    loaded from JAX's file: the traces of both held-out sequences equal."""
    m = _port_model()
    m.load(jax_trained["path"])
    got = m.predict([s[:12] for s, _ in jax_trained["test"]], uisrnn.UISRNNInferenceConfig(
        beam_size=4, look_ahead=look_ahead, test_iteration=2))
    assert got == jax_trained["traces"][look_ahead]
    assert len(set(got[0])) > 1


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_both_ways_bit_for_bit(jax_trained, tmp_path, direction):
    """A save of either package loads in the other with bit-equal leaves
    (params, init_hidden, sigma2, the transition bias, its denominator,
    crp_alpha)."""
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    if direction == "jax_to_port":
        src = jax_trained["path"]
        m = _port_model()
        m.load(src)
        out = str(tmp_path / "port.msgpack")
        m.save(out)
        want = flat(jload_pytree(src))
        got = flat(load_pytree(out))
    else:
        m = _port_model(seed=7)
        _quiet(m.fit, *zip(*[(s, i) for s, i in _episodes(n=2, seed=8)]),
               uisrnn.UISRNNTrainConfig(train_iteration=3, log_iter=100, **TRAIN))
        src = str(tmp_path / "port.msgpack")
        m.save(src)
        j = juisrnn.UISRNN(juisrnn.UISRNNConfig(**TINY))
        j.load(src)
        want = flat(load_pytree(src))
        got = flat({"params": j.params, "init_hidden": j.init_hidden, "sigma2": j.sigma2,
                    "transition_bias": np.float64(j.transition_bias),
                    "transition_bias_denominator": np.float64(j.transition_bias_denominator),
                    "crp_alpha": np.float64(j.crp_alpha)})
        assert m.transition_bias == j.transition_bias
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and want[k].tobytes() == got[k].tobytes(), k


# ---------------------------------------------------------------------------
# Evaluation, experiments, CLIs
# ---------------------------------------------------------------------------
def test_evals_and_output_result_match():
    rng = np.random.default_rng(9)
    for _ in range(5):
        a, b = list(rng.integers(0, 4, 30)), list(rng.integers(0, 5, 30))
        assert evals.evaluate_result(a, b) == jevals.evaluate_result(a, b)
        assert evals.diarization_error_rate(a, b) == jevals.diarization_error_rate(a, b)
    rec = [(0.5, 10), (0.75, 4)]
    assert uisrnn.output_result(uisrnn.UISRNNConfig(), uisrnn.UISRNNTrainConfig(), rec) == \
        juisrnn.output_result(juisrnn.UISRNNConfig(), juisrnn.UISRNNTrainConfig(), rec)


def _write_feature_files(root, n=4, seed=10):
    os.makedirs(root, exist_ok=True)
    paths = []
    for k, (s, i) in enumerate(_episodes(n=n, t=20, seed=seed)):
        paths.append(os.path.join(root, f"ep{k}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump((s.astype(np.float32), i), f)
    return paths


def test_cli_quick_test_line_equals_jax(tmp_path):
    """`cli.uisrnn --quick-test` (k 2, beam 3) from JAX's initial draws:
    the per-fold accuracies and the `mean accuracy: ... (DER ...)` line
    equal the JAX CLI's."""
    _write_feature_files(str(tmp_path))
    argv = ["--features", str(tmp_path / "*.pkl"), "--observation-dim", "8",
            "--rnn-hidden-size", "16", "--rnn-depth", "2", "--k-folds", "2",
            "--beam-size", "3", "--quick-test"]
    _, want = _quiet(jcli.main, argv)
    with _jax_initial_draws():
        _, got = _quiet(cli.main, argv + ["--device", "cpu"])
    keep = lambda t: [ln for ln in t.splitlines() if not ln.startswith("[uisrnn]")]
    assert keep(got) == keep(want)
    assert keep(got)[-1].startswith("mean accuracy: ")


def test_streaming_fit_checkpoints_and_resumes(tmp_path):
    """streaming_fit over 3 files, one a batch, stopped after the first
    batch and run again: it resumes from the checkpoint at batch 1 (the
    `.progress` marker) and ends with JAX's resumed run's leaves (1e-4)."""
    paths = _write_feature_files(str(tmp_path / "f"), n=3)
    cfg_kw = dict(TINY)
    args = dict(train_iteration=4, log_iter=100, **TRAIN)

    def run(mod, model_cfg, train_cfg, ckpt, **kw):
        real_fit, calls = mod.UISRNN.fit, []

        def stop_after_one(self, *a):
            if len(calls) == 1:
                raise KeyboardInterrupt
            calls.append(1)
            return real_fit(self, *a)
        with mock.patch.object(mod.UISRNN, "fit", stop_after_one):
            with pytest.raises(KeyboardInterrupt):
                _quiet(mod.streaming_fit, paths, model_cfg, train_cfg, ckpt,
                       files_per_batch=1, **kw)
        with open(ckpt + ".progress") as f:
            assert f.read() == "1"
        return _quiet(mod.streaming_fit, paths, model_cfg, train_cfg, ckpt,
                      files_per_batch=1, **kw)

    jm, jout = run(jexperiment, juisrnn.UISRNNConfig(**cfg_kw),
                   juisrnn.UISRNNTrainConfig(**args), str(tmp_path / "j.msgpack"))
    with _jax_initial_draws():
        pm, pout = run(experiment, uisrnn.UISRNNConfig(**cfg_kw),
                       uisrnn.UISRNNTrainConfig(**args), str(tmp_path / "p.msgpack"),
                       device="cpu")
    assert "resuming from batch 1" in pout and "resuming from batch 1" in jout
    with open(str(tmp_path / "p.msgpack.progress")) as f:
        assert f.read() == "3"
    assert _max_rel(jax.tree_util.tree_map(np.asarray, jm.params), pm.params) <= 1e-4
    assert abs(pm.transition_bias - jm.transition_bias) < 1e-12


def test_kfold_experiment_quick_test_records_equal_jax():
    """kfold_experiment with quick_test (k 2 over 3 episodes: the first 2,
    folds episodes[i::2], model seed 0 + i, 20 observations a test episode)
    from JAX's initial draws: the records equal JAX's."""
    eps = _episodes(n=3, t=24, seed=11)
    kw = dict(k=2, quick_test=True, seed=0)
    infer = dict(beam_size=3, look_ahead=1, test_iteration=1)
    (jacc, jrec), _ = _quiet(jexperiment.kfold_experiment, eps, juisrnn.UISRNNConfig(**TINY),
                             juisrnn.UISRNNTrainConfig(**TRAIN),
                             juisrnn.UISRNNInferenceConfig(**infer), **kw)
    with _jax_initial_draws():
        (acc, rec), _ = _quiet(experiment.kfold_experiment, eps, uisrnn.UISRNNConfig(**TINY),
                               uisrnn.UISRNNTrainConfig(**TRAIN),
                               uisrnn.UISRNNInferenceConfig(**infer), device="cpu", **kw)
    assert rec == jrec and acc == jacc
    assert [n for _, n in rec] == [20] * 2


def test_diar_features_logmel_pickles_equal_jax(tmp_path):
    """`cli.tools diar-features --features logmel` on a 2-episode corpus with
    one utterance under 400 samples (skipped by both): the same episodes,
    speaker ids and [utterances, 160] float32 features within 1e-4 of the
    JAX CLI's (the port's through `fused_logmel_project`, one call an
    episode)."""
    from tal_asrd_tpu_torch.data.synth import build_synth_corpus
    from tal_asrd_tpu_torch.ops import cuda_kernels

    data = str(tmp_path / "data")
    tr = build_synth_corpus(data, n_episodes=2, episode_seconds=14.0, n_speakers=3, seed=4)
    tr["ep1"].insert(1, dict(tr["ep1"][0], utterance_end=tr["ep1"][0]["utterance_start"]
                             + 0.02, speaker="short"))
    with open(os.path.join(data, "transcript.pkl"), "wb") as f:
        pickle.dump(tr, f)
    _quiet(jtools.main, ["diar-features", "--data", data, "--out-dir", str(tmp_path / "j")])
    real = cuda_kernels.logmel_project_plain
    calls = []
    with mock.patch.object(cuda_kernels, "logmel_project_plain",
                           lambda *a, **k: calls.append(1) or real(*a, **k)):
        _, out = _quiet(tools.main, ["diar-features", "--data", data, "--out-dir",
                                     str(tmp_path / "p"), "--device", "cpu"])
    assert len(calls) == 2 and "wrote 2 episode feature files" in out
    for stub in ("ep0", "ep1"):
        with open(tmp_path / "j" / f"{stub}.pkl", "rb") as f:
            want, want_ids = pickle.load(f)
        with open(tmp_path / "p" / f"{stub}.pkl", "rb") as f:
            got, got_ids = pickle.load(f)
        assert got_ids == want_ids and "short" not in got_ids
        assert got.dtype == np.float32 and got.shape == want.shape and got.shape[1] == 160
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
