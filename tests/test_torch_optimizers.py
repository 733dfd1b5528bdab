"""RAdam, Adafactor, Lookahead (and LAMB) of the port against the JAX
package's optax transformations (tal_asrd_tpu/train/optimizers.py) on the
CPU: 8 steps on a tree in the model's layouts (a TDS grouped-conv kernel
[21, 2, 6], a pointwise kernel [1, 4, 6], a Dense kernel, a bias and a
0-dim ReZero scalar) with seeded numpy gradients, parameters and states
held leaf for leaf in the reference's shapes within 1e-6 of each leaf's
largest magnitude; Lookahead's first-step sync; a None gradient; one step
of a tiny ASRSystem through `_make_optimizer`; and the card phase's replay
of tests/fixtures/torch_optim_reference.* (scripts/torch_optim_reference.py)
with the plain CPU tensors. JAX runs once a module, in the `jax_runs` and
`system_case` fixtures."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tal_asrd_tpu.train import optimizers as jopt
from tal_asrd_tpu.train.schedules import linear_decay_schedule as j_linear_decay
from tal_asrd_tpu_torch.core.config import (
    FrontendConfig,
    ModelConfig,
    SpecAugmentConfig,
    TrainConfig,
)
from tal_asrd_tpu_torch.core.convert import params_to_state_dict, state_dict_to_params
from tal_asrd_tpu_torch.train import LAMB, Adafactor, ASRSystem, Lookahead, RAdam
from tal_asrd_tpu_torch.train.schedules import linear_decay_schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 8
TOL = 1e-6          # of each leaf's largest magnitude

# the reference's layouts: grouped conv, pointwise, Dense, bias, ReZero scalar
SHAPES = {"encoder/down_0/kernel": (21, 2, 6),
          "encoder/group_0_block_0/fc1/kernel": (1, 4, 6),
          "decoder/layers_0/linear1/kernel": (3, 5),
          "decoder/layers_0/linear1/bias": (5,),
          "decoder/layers_0/resweight": ()}
LR = 1e-2


def _tree(flat):
    out = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


def _flat(tree, prefix=""):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def _init_params():
    rng = np.random.RandomState(0)
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32) for k, s in SHAPES.items()}


def _grads(step, none=()):
    rng = np.random.RandomState(100 + step)
    drawn = {k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in SHAPES.items()}
    return {k: np.zeros_like(v) if k in none else v for k, v in drawn.items()}


# name -> (JAX transformation, port optimizer on named parameters)
def _j_sched():
    return j_linear_decay(LR, STEPS + 2)


def _t_sched():
    return linear_decay_schedule(LR, STEPS + 2)


CASES = {
    "radam_sched": (lambda: jopt.radam(_j_sched()), lambda n: RAdam(n, _t_sched())),
    "radam_sched_wd": (lambda: jopt.radam(_j_sched(), weight_decay=0.01),
                       lambda n: RAdam(n, _t_sched(), weight_decay=0.01)),
    "radam_const_wd": (lambda: jopt.radam(LR, weight_decay=0.01),
                       lambda n: RAdam(n, LR, weight_decay=0.01)),
    "adafactor": (lambda: jopt.adafactor(), lambda n: Adafactor(n)),
    "adafactor_b1": (lambda: jopt.adafactor(beta1=0.9), lambda n: Adafactor(n, beta1=0.9)),
    "adafactor_wd": (lambda: jopt.adafactor(weight_decay=0.01),
                     lambda n: Adafactor(n, weight_decay=0.01)),
    "adafactor_sched_b1_wd": (
        lambda: jopt.adafactor(_j_sched(), relative_step=False, beta1=0.9,
                               weight_decay=0.01),
        lambda n: Adafactor(n, _t_sched(), relative_step=False, beta1=0.9,
                            weight_decay=0.01)),
    "adafactor_const_wd": (
        lambda: jopt.adafactor(1e-3, relative_step=False, weight_decay=0.01),
        lambda n: Adafactor(n, 1e-3, relative_step=False, weight_decay=0.01)),
    "adafactor_warmup": (lambda: jopt.adafactor(warmup_init=True),
                         lambda n: Adafactor(n, warmup_init=True)),
    "adafactor_no_scale": (lambda: jopt.adafactor(scale_parameter=False, weight_decay=0.01),
                           lambda n: Adafactor(n, scale_parameter=False, weight_decay=0.01)),
    "adafactor_no_scale_const": (
        lambda: jopt.adafactor(1e-3, relative_step=False, scale_parameter=False,
                               weight_decay=0.01),
        lambda n: Adafactor(n, 1e-3, relative_step=False, scale_parameter=False,
                            weight_decay=0.01)),
    "lookahead_lamb": (lambda: jopt.lookahead(jopt.lamb(_j_sched()), k=3),
                       lambda n: Lookahead(LAMB(n, _t_sched()), k=3)),
    "lookahead_radam": (lambda: jopt.lookahead(jopt.radam(_j_sched(), weight_decay=0.01)),
                        lambda n: Lookahead(RAdam(n, _t_sched(), weight_decay=0.01))),
    "lookahead_adafactor": (lambda: jopt.lookahead(jopt.adafactor(beta1=0.9), k=2,
                                                   alpha=0.3),
                            lambda n: Lookahead(Adafactor(n, beta1=0.9), k=2, alpha=0.3)),
    "lamb": (lambda: jopt.lamb(_j_sched(), weight_decay=0.01),
             lambda n: LAMB(n, _t_sched(), weight_decay=0.01)),
}
NONE_GRAD = "decoder/layers_0/linear1/kernel"


def _jax_run(tx, none=()):
    params = {k: jnp.asarray(v) for k, v in _init_params().items()}
    state = tx.init(params)
    traj = []
    for s in range(STEPS):
        g = {k: jnp.asarray(v) for k, v in _grads(s, none).items()}
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
        traj.append(({k: np.asarray(v) for k, v in params.items()}, _flat(state)))
    return traj


def _port_params():
    sd = params_to_state_dict(_tree(_init_params()))
    return [(n, torch.nn.Parameter(t.clone())) for n, t in sd.items()]


def _set_grads(named, step, none=()):
    grads = params_to_state_dict(_tree(_grads(step)))
    none_names = set(params_to_state_dict(_tree({k: np.zeros(SHAPES[k], np.float32)
                                                 for k in none})))
    for n, p in named:
        p.grad = None if n in none_names else grads[n].clone()


def _port_run(make, none=()):
    named = _port_params()
    opt = make(named)
    traj = []
    for s in range(STEPS):
        _set_grads(named, s, none)
        opt.step()
        params = {"/".join(k.split("/")): v for k, v in _flat(
            state_dict_to_params({n: p.detach() for n, p in named})).items()}
        traj.append((params, _flat(opt.reference_state())))
    return traj


@pytest.fixture(scope="module")
def jax_runs():
    runs = {name: _jax_run(j()) for name, (j, _) in CASES.items()}
    for name in ("radam_sched_wd", "adafactor_b1", "lookahead_lamb", "lamb"):
        runs[name + "/none"] = _jax_run(CASES[name][0](), none=(NONE_GRAD,))
    return runs


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iu":
        assert np.array_equal(got, want), what
        return
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want))) if want.size else 0.0
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def _hold(port, ref):
    for s, ((pp, ps), (jp, js)) in enumerate(zip(port, ref), 1):
        assert set(pp) == set(jp)
        for k in jp:
            _close(pp[k], jp[k], f"step {s} params {k}")
        assert set(ps) == set(js), (sorted(ps), sorted(js))
        for k in js:
            _close(ps[k], js[k], f"step {s} state {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_optimizer_matches_optax_over_eight_steps(name, jax_runs):
    _hold(_port_run(CASES[name][1]), jax_runs[name])


@pytest.mark.parametrize("name", ["radam_sched_wd", "adafactor_b1", "lookahead_lamb", "lamb"])
def test_a_none_gradient_is_stepped_as_zero(name, jax_runs):
    """JAX gives every leaf a gradient; the port steps a parameter whose
    .grad is None as if it were zero (moments decay, weight decay and the
    sync move it)."""
    _hold(_port_run(CASES[name][1], none=(NONE_GRAD,)), jax_runs[name + "/none"])


def test_radam_switches_to_the_rectified_step_at_t6():
    """N_sma in float32 crosses 5 at t = 6 (6.0005 there; 5.9942 in float64):
    steps 1-5 take the plain branch, 6 on the rectified one; the radicand is
    negative at t = 3, 4, and the NaN root is never taken."""
    branches = [RAdam.step_scalars(c, 1e-3, 0.9, 0.999)[0] for c in range(8)]
    assert branches == [False] * 5 + [True] * 3
    _, scale, _ = RAdam.step_scalars(5, 1e-3, 0.9, 0.999)
    assert np.isfinite(scale) and scale < 0


def test_adafactor_factors_in_the_reference_layout():
    """The grouped-conv weight [C_out=6, C_in/G=2, K=21] is factored as the
    reference's kernel [21, 2, 6]: vr [21, 2], vc [21, 6]; the pointwise
    [1, 4, 6] as vr [1, 4], vc [1, 6]; the Dense [3, 5] as vr [3], vc [5]."""
    named = _port_params()
    opt = Adafactor(named, beta1=0.9)
    _set_grads(named, 0)
    opt.step()
    moments = _flat(opt.reference_state()["moments"])
    assert moments["encoder/down_0/kernel/vr"].shape == (21, 2)
    assert moments["encoder/down_0/kernel/vc"].shape == (21, 6)
    assert moments["encoder/down_0/kernel/m"].shape == (21, 2, 6)
    assert moments["encoder/group_0_block_0/fc1/kernel/vr"].shape == (1, 4)
    assert moments["encoder/group_0_block_0/fc1/kernel/vc"].shape == (1, 6)
    assert moments["decoder/layers_0/linear1/kernel/vr"].shape == (3,)
    assert moments["decoder/layers_0/linear1/kernel/vc"].shape == (5,)
    assert moments["decoder/layers_0/resweight/v"].shape == ()
    conv = dict(named)["encoder.down_0.weight"]
    assert tuple(conv.shape) == (6, 2, 21) and tuple(opt.state[conv]["vr"].shape) == (21, 2)
    # before a step, the reference's init: zeros in the same shapes
    fresh = _flat(Adafactor(_port_params()).reference_state())
    assert fresh["moments/encoder/down_0/kernel/vc"].shape == (21, 6)
    assert not fresh["moments/encoder/down_0/kernel/vc"].any() and fresh["count"] == 0


def test_lookahead_first_step_sync_quirk():
    """tests/test_optimizers.py's figures, around torch's SGD: syncs after
    steps 1, k+1, ... (k = 4, alpha 0.5, a constant inner step d)."""
    k, alpha, d = 4, 0.5, 0.1
    p = torch.nn.Parameter(torch.zeros(1))
    tx = Lookahead(torch.optim.SGD([p], lr=1.0), k=k, alpha=alpha)
    vals = []
    for _ in range(k + 2):
        p.grad = torch.full((1,), -d)
        tx.step()
        vals.append(float(p.detach()[0]))
    np.testing.assert_allclose(vals[0], alpha * d, rtol=1e-6)
    np.testing.assert_allclose(vals[1], alpha * d + d, rtol=1e-6)
    np.testing.assert_allclose(vals[k - 1], alpha * d + (k - 1) * d, rtol=1e-5)
    fast_before = alpha * d + k * d
    np.testing.assert_allclose(vals[k], alpha * d + alpha * (fast_before - alpha * d),
                               rtol=1e-5)


def test_lookahead_takes_its_slow_copy_at_the_first_step():
    """The slow weights are the weights the first step starts from (a
    checkpoint loaded after the optimizer was built), not those at
    construction."""
    p = torch.nn.Parameter(torch.zeros(2))
    tx = Lookahead(torch.optim.SGD([p], lr=1.0), k=2, alpha=0.5)
    with torch.no_grad():
        p.fill_(3.0)                    # "loaded" after construction
    p.grad = torch.full((2,), -1.0)
    tx.step()
    assert p.tolist() == [3.5, 3.5]     # slow 3 + 0.5 (4 - 3)


# ---------------------------------------------------------------------------
# one tiny ASRSystem step through _make_optimizer, against optax on the
# system's own gradients, over every parameter of the model
# ---------------------------------------------------------------------------
TINY = dict(model_type="1x", num_speakers=4, n_mels=8, vocab_size=32, n_head=2,
            max_positions=64, dropout=0.0, embed_size=16, tds_depths=(1, 1, 1),
            tds_kernel=5, tds_dropout=0.0)
SYSTEM_OPTS = {
    "radam": (lambda s: jopt.radam(s), lambda n, s: RAdam(n, s)),
    "adafactor": (lambda s: jopt.adafactor(beta1=0.9, weight_decay=0.01),
                  lambda n, s: Adafactor(n, beta1=0.9, weight_decay=0.01)),
    "lookahead_lamb": (lambda s: jopt.lookahead(jopt.lamb(s)),
                       lambda n, s: Lookahead(LAMB(n, s))),
    "lookahead_radam": (lambda s: jopt.lookahead(jopt.radam(s)),
                        lambda n, s: Lookahead(RAdam(n, s))),
}


def _system(name):
    make = SYSTEM_OPTS[name][1]

    class System(ASRSystem):
        def _make_optimizer(self):
            return make(self.model.named_parameters(), self._schedule())

    return System(ModelConfig(**TINY),
                  TrainConfig(batch_size=4, lr=1e-3, max_steps=50, smoothing=0.0,
                              token_replace_prob=0.0),
                  FrontendConfig(n_mels=8, n_fft=64, win_length=64, hop_length=32),
                  SpecAugmentConfig(num_freq_masks=0, num_time_masks=0),
                  compute_dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(0))


def _batch():
    rng = np.random.RandomState(0)
    return {"audio": (rng.randn(4, 3200) * 0.1).astype(np.float32),
            "audio_lens": np.full((4,), 3200, np.int32),
            "text": rng.randint(0, 36, (4, 12)).astype(np.int32),
            "text_mask": np.ones((4, 12), bool),
            "spk_ids": rng.randint(0, 4, (4, 12)).astype(np.int32)}


@pytest.fixture(scope="module")
def system_case():
    """Each optimizer's system after one train_step, beside optax's update
    of the same parameters with the gradients the system computed."""
    from tal_asrd_tpu.train.schedules import linear_decay_schedule as jsched
    out = {}
    for name, (jmake, _) in SYSTEM_OPTS.items():
        system = _system(name)
        before = system.params_tree()
        system.compute_grads(_batch())
        grads = state_dict_to_params({n: p.grad for n, p in system.model.named_parameters()})
        # the step train_step takes, with these gradients
        system.optimizer.step()
        system.step += 1
        tx = jmake(jsched(system.train_cfg.scaled_lr, system.train_cfg.max_steps))
        jp = {k: jnp.asarray(v) for k, v in _flat(before).items()}
        jg = {k: jnp.asarray(v) for k, v in _flat(grads).items()}
        upd, state = jax.jit(tx.update)(jg, tx.init(jp), jp)  # one program, not 95 x op by op
        out[name] = (system, {k: np.asarray(v) for k, v in
                              optax.apply_updates(jp, upd).items()}, _flat(state))
    return out


@pytest.mark.parametrize("name", list(SYSTEM_OPTS))
def test_asr_system_steps_through_make_optimizer(name, system_case):
    """Parameters and `state_tree()["opt_state"]` after one step equal
    optax's, leaf for leaf; `load_state_tree` restores LAMB's state alone."""
    system, want, want_state = system_case[name]
    got = _flat(system.params_tree())
    assert set(got) == set(want) and len(want) == 95
    for k in want:
        _close(got[k], want[k], k)
    assert system.update_count() == 1
    got_state = _flat(system.state_tree()["opt_state"])
    assert set(got_state) == set(want_state)
    for k in want_state:
        _close(got_state[k], want_state[k], f"opt_state {k}")
    with pytest.raises(TypeError, match=type(system.optimizer).__name__):
        system.load_state_tree({})
    system.init_state(torch.Generator().manual_seed(1))
    assert system.update_count() == 0 and not system.optimizer.state
    if isinstance(system.optimizer, Lookahead):
        assert not system.optimizer.inner.state


def test_trainer_fit_saves_the_full_state_of_any_optimizer(tmp_path):
    """Trainer.fit with another optimizer writes its last epoch's parameters
    and full state, the optimizer's JAX state layout, as the reference's
    Trainer does for any optimizer."""
    from tal_asrd_tpu_torch.core.checkpoint import CheckpointManager
    from tal_asrd_tpu_torch.train import Trainer, TrainerConfig
    from tal_asrd_tpu_torch.utils.logging import MetricsLogger
    system = _system("lookahead_radam")
    logger = MetricsLogger(out_dir=str(tmp_path / "logs"), name="t")
    Trainer(system, TrainerConfig(quick_test=True, checkpoint_dir=str(tmp_path / "ckpt")),
            logger).fit([_batch()], [_batch()])
    logger.close()
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "ckpt_00000001.msgpack", "latest.json", "state_00000001.msgpack"]
    saved = _flat(CheckpointManager(str(tmp_path / "ckpt")).load_state())
    want = _flat(system.state_tree())
    assert set(saved) == set(want)
    assert {"opt_state/counter", "opt_state/inner/count", "step"} <= set(saved)
    for k in want:
        _close(np.asarray(saved[k]), want[k], k)


def test_the_default_optimizer_is_lamb_on_named_parameters():
    system = ASRSystem(ModelConfig(**TINY), device="cpu", compute_dtype=torch.float32)
    assert type(system.optimizer) is LAMB
    assert system.optimizer.param_groups[0]["param_names"][0] == next(
        iter(system.model.state_dict()))
    assert set(system.state_tree()["opt_state"]) == {"count", "mu", "nu"}


# ---------------------------------------------------------------------------
def test_fixture_replay_of_the_card_phase_on_the_cpu():
    """chip_smoke.py's replay of the JAX fixture (the tracked checkpoint's
    leaves, 8 steps of each configuration the card phase trains with), run
    with CPU tensors: every final leaf within 1e-5 of its largest magnitude,
    every step's update within 1e-5 of JAX's largest beside the
    parameter's rounding."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    worst = chip_smoke.replay_optim_fixture(torch, "cpu", ROOT)
    assert set(worst) == {"radam", "adafactor", "adafactor_b1_wd", "lookahead_lamb",
                          "lookahead_radam"}
    assert max(err for err, _ in worst.values()) <= 1e-5, worst
