"""Data- and tensor-parallel training of the port (ASRSystem with a mesh,
parallel/tensor.py, the sharded optimizers) on gloo groups of 2 and 4 CPU
processes, against the JAX package's `make_train_step(mesh)` on the same
mesh of virtual CPU devices and against the port's one-process step on the
same global batch. Tiny configuration, float32, dropout 0.

JAX's own mesh step departs from its one-device step where both mesh axes
exceed 1: at (2, 2) the gradients of the encoder's grouped convolutions
(`encoder/down_*/kernel`, `encoder/group_*_block_*/conv/kernel`) come out
off by up to 1.6 (its loss agrees; tests/test_train.py checks only the
loss). The port is held to JAX's
one-device step on every leaf and to its mesh step on the leaves where
that agrees with its one-device step.

Tolerances: the loss within rtol 1e-5 of both. The parameters after the
step within 1e-6 of the one-process step, and the JAX mesh step's within
1e-5 (the one-device parity tolerance of tests/test_torch_train.py), except
the attention projections' biases: LAMB's m / (sqrt(v) + 1e-6) turns the
rounding of a near-zero gradient (the key bias's true gradient is zero)
into a step of up to lr, so a different summation order moves them by a
few 1e-6; they are held within 1e-5.

One group a world size (2 and 4 processes) is spawned once per module and
runs its meshes one after another (parallel/launch.py, file rendezvous,
joined with a timeout); the tests read the results.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tal_asrd_tpu.core.config import FrontendConfig as JFrontendConfig
from tal_asrd_tpu.core.config import ModelConfig as JModelConfig
from tal_asrd_tpu.core.config import SpecAugmentConfig as JSpecAugmentConfig
from tal_asrd_tpu.core.config import TrainConfig as JTrainConfig
from tal_asrd_tpu.parallel import mesh as jmesh
from tal_asrd_tpu.train import ASRSystem as JASRSystem
from tal_asrd_tpu.train.system import TrainState as JTrainState
from tal_asrd_tpu_torch.parallel.launch import build_system, sequence_worker, start_group, train_steps

from tests.test_torch_helpers import seeded_like, to_numpy_tree

TINY = dict(model_type="1x", num_speakers=4, n_mels=8, vocab_size=32, n_head=2,
            max_positions=64, dropout=0.0, embed_size=16, tds_depths=(1, 1, 1),
            tds_kernel=5, tds_dropout=0.0)
FRONTEND = dict(n_mels=8, n_fft=64, win_length=64, hop_length=32)
NO_AUG = dict(num_freq_masks=0, num_time_masks=0)
TRAIN = dict(batch_size=8, lr=1e-3, max_steps=50, smoothing=0.0, token_replace_prob=0.0)
MESHES = [(2, 1), (1, 2), (2, 2)]
AUG = dict(freq_mask_param=3, time_mask_param=20)
OPTIMIZERS = {"adafactor": dict(beta1=0.9, weight_decay=0.01), "radam": {},
              "lookahead": dict(k=1)}
BIASES = ("qkv/bias", "kv/bias", "/q/bias")
TIMEOUT = 240


def tiny_batch(b=8, t=3200, l=12, vocab=32, n_spk=4, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(l // 2, l + 1, b)
    return {
        "audio": (rng.randn(b, t) * 0.1).astype(np.float32),
        "audio_lens": rng.randint(t // 2, t + 1, b).astype(np.int32),
        "text": rng.randint(0, vocab + n_spk, (b, l)).astype(np.int32),
        "text_mask": np.arange(l)[None, :] < lens[:, None],
        "spk_ids": rng.randint(0, n_spk, (b, l)).astype(np.int32),
    }


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


def close(ours, theirs, atol, bias_atol=1e-5, rtol=0.0, skip=(), without_fused_bias=False):
    """Every float leaf of `theirs` (less `skip`) matched in `ours`; with
    `without_fused_bias`, less the fused qkv / kv biases and their state."""
    ours = dict(flat(ours))
    n = 0
    for key, want in flat(theirs):
        if want.dtype.kind != "f" or key in skip or (
                without_fused_bias and re.search(r"(qkv|kv)/bias(/\w+)?$", key)):
            continue
        tol = bias_atol if key.endswith(BIASES) else atol
        np.testing.assert_allclose(ours[key], want, rtol=rtol, atol=tol, err_msg=key)
        n += 1
    return n


@pytest.fixture(scope="module")
def ref():
    """JAX's mesh steps and the port's one-process step and N-process
    groups, one LAMB step of seeded parameters on one global batch."""
    jsys = JASRSystem(JModelConfig(conv_impl="xla", **TINY), JTrainConfig(**TRAIN),
                      JFrontendConfig(**FRONTEND), JSpecAugmentConfig(**NO_AUG),
                      dtype=jnp.float32)
    batch, val = tiny_batch(seed=0), tiny_batch(seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jsys.init_state(rng, jbatch).params)
    params = seeded_like(shapes, 7)
    spec = dict(model=TINY, frontend=FRONTEND, specaug=NO_AUG, train=TRAIN,
                params=to_numpy_tree(params), batches=[batch], eval_batch=val)
    variants = {shape: dict(spec, mesh=shape) for shape in MESHES}
    # SpecAugment (K4's plain version here), token replacement and grad_acc 2
    variants["aug"] = dict(spec, mesh=(2, 2), specaug=AUG, eval_batch=None,
                           train=dict(TRAIN, token_replace_prob=0.5, grad_acc=2),
                           batches=[batch, tiny_batch(seed=1)])
    # the other optimizers on a sharded model, two steps
    for name, kwargs in OPTIMIZERS.items():
        variants[name] = dict(spec, mesh=(1, 2), optimizer=name, optimizer_kwargs=kwargs,
                              eval_batch=None, batches=[batch, tiny_batch(seed=1)])
    # one group a world size, its runs one after another
    worlds = {}
    for key, v in variants.items():
        worlds.setdefault(v["mesh"][0] * v["mesh"][1], []).append((key, "train_worker", v))
    groups = [start_group(sequence_worker, world, {"sequence": seq}, timeout=TIMEOUT)
              for world, seq in worlds.items()]
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=jsys.tx.init(params))
    jax_steps = {}
    for shape in [None] + MESHES:
        if shape is None:
            new, metrics = jsys.make_train_step(donate=False)(state, jbatch, rng)
        else:
            m = jmesh.make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])
            new, metrics = jsys.make_train_step(m, donate=False)(
                jsys.shard_state(m, state), jmesh.shard_batch(m, jbatch), rng)
        jax_steps[shape] = {"loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "params": to_numpy_tree(jax.device_get(new.params))}
    ones = {}
    for key in ["plain", "aug"] + list(OPTIMIZERS):
        v = spec if key == "plain" else variants[key]
        one = build_system(v, "cpu")
        ones[key] = train_steps(one, v["batches"], "cpu")
        if v.get("eval_batch") is not None:
            ones[key]["eval"] = {k: float(x) for k, x in one.eval_step(val).items()}
        ones[key]["state"] = one.state_tree()
    results = {}
    for group in groups:
        for rank in group.wait():
            for key, out in rank.items():
                results.setdefault(key, []).append(out)
    return {"jax": jax_steps, "one": ones["plain"], "ones": ones, "groups": results}


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_step_loss_matches_jax_and_one_process(ref, shape):
    ranks = ref["groups"][shape]
    for out in ranks:                         # every process reports the global loss
        loss = out["metrics"][0]["loss"]
        assert loss == pytest.approx(ref["jax"][shape]["loss"], rel=1e-5)
        assert loss == pytest.approx(ref["one"]["metrics"][0]["loss"], rel=1e-5)
        assert out["metrics"][0]["grad_norm"] == pytest.approx(
            ref["one"]["metrics"][0]["grad_norm"], rel=1e-5)
        assert out["metrics"][0]["grad_norm"] == pytest.approx(
            ref["jax"][None]["grad_norm"], rel=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_step_leaves_match_jax_and_one_process(ref, shape):
    state = ref["groups"][shape][0]["state"]
    assert int(state["step"]) == 1
    assert close(state["params"], ref["one"]["state"]["params"], 1e-6) > 40
    assert close(state["params"], ref["jax"][None]["params"], 1e-5) > 40
    # JAX's mesh step, where it agrees with its own one-device step
    jax_one, jax_mesh = dict(flat(ref["jax"][None]["params"])), ref["jax"][shape]["params"]
    apart = {k for k, v in flat(jax_mesh) if np.abs(v - jax_one[k]).max() > 1e-5}
    assert all(re.fullmatch(r"encoder/(down_\d|group_\d_block_\d/conv)/kernel", k)
               for k in apart), apart
    assert close(state["params"], jax_mesh, 1e-5, skip=apart) > 40


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_moments_gather_to_the_one_process_moments(ref, shape):
    """LAMB's mu and nu, sharded like their parameters, gathered whole."""
    ours, theirs = ref["groups"][shape][0]["state"]["opt_state"], ref["one"]["state"]["opt_state"]
    assert int(ours["count"]) == int(theirs["count"]) == 1
    assert close(ours["mu"], theirs["mu"], 1e-7, 1e-7, rtol=1e-4) > 40
    assert close(ours["nu"], theirs["nu"], 1e-9, 1e-9, rtol=1e-4) > 40


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_validation_metrics_are_global(ref, shape):
    for out in ref["groups"][shape]:
        for k, v in ref["one"]["eval"].items():
            assert out["eval"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k


def test_augmented_accumulated_step_equals_the_one_process_step(ref):
    """SpecAugment and token replacement drawn for the global batch and
    sliced, and grad_acc 2 (each micro-batch split over the data axes), on
    (2, 2): two steps equal the one-process steps."""
    one = ref["ones"]["aug"]
    for out in ref["groups"]["aug"]:
        for ours, theirs in zip(out["metrics"], one["metrics"]):
            assert ours["loss"] == pytest.approx(theirs["loss"], rel=1e-5)
            assert ours["grad_norm"] == pytest.approx(theirs["grad_norm"], rel=1e-5)
    plain = ref["one"]["metrics"][0]["loss"]
    assert abs(one["metrics"][0]["loss"] - plain) > 1e-3     # the draws changed the step
    state = ref["groups"]["aug"][0]["state"]
    assert int(state["step"]) == 2
    assert close(state["params"], one["state"]["params"], 1e-6) > 40


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_other_optimizers_on_a_sharded_model_equal_the_unsharded_step(ref, name):
    """Adafactor (factored means over the sharded axis, whole-leaf RMS),
    RAdam and Lookahead(LAMB) on (1, 2): two steps' parameters and the
    gathered optimizer state equal the one-process run's. Adafactor scales
    each element by its own gradient's root mean square, so the key third
    of a fused bias (zero true gradient: rounding noise) steps by its
    noise's sign, and the leaf's RMS clip carries that into the rest of
    the leaf: for Adafactor the fused biases and their moments are left
    out."""
    one, state = ref["ones"][name], ref["groups"][name][0]["state"]
    for ours, theirs in zip(ref["groups"][name][0]["metrics"], one["metrics"]):
        assert ours["loss"] == pytest.approx(theirs["loss"], rel=1e-5)
    noise = name == "adafactor"
    assert close(state["params"], one["state"]["params"], 1e-6,
                 without_fused_bias=noise) > 40
    assert close(state["opt_state"], one["state"]["opt_state"], 1e-7, 1e-7, rtol=1e-4,
                 without_fused_bias=noise) > 80
