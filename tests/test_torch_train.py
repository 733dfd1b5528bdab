"""The training path of the port (tal_asrd_tpu_torch/train) against the JAX
package's: losses, schedules, LAMB, the loss and every gradient of
`ASRSystem.loss_fn`, one full `train_step`, gradient accumulation, the
unknown-speaker clamp, rematerialisation and dropout. The JAX reference is
computed once per module, at the TINY configuration of tests/test_train.py,
in float32."""
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
from tal_asrd_tpu.train import lamb as j_lamb
from tal_asrd_tpu.train.losses import log_softmax_cross_entropy as j_ce
from tal_asrd_tpu.train.losses import masked_accuracy as j_masked_accuracy
from tal_asrd_tpu.train.losses import masked_token_loss as j_masked_token_loss
from tal_asrd_tpu.train.schedules import (
    constant_schedule as j_constant,
    inv_sqrt_schedule as j_inv_sqrt,
    linear_decay_schedule as j_linear_decay,
    triangle_schedule as j_triangle,
)
from tal_asrd_tpu.train.system import TrainState as JTrainState
from tal_asrd_tpu_torch.core.config import (
    FrontendConfig,
    ModelConfig,
    SpecAugmentConfig,
    TrainConfig,
)
from tal_asrd_tpu_torch.core.convert import params_to_state_dict, state_dict_to_params
from tal_asrd_tpu_torch.models.decoder import _attend
from tal_asrd_tpu_torch.train.losses import (
    log_softmax_cross_entropy,
    masked_accuracy,
    masked_token_loss,
)
from tal_asrd_tpu_torch.train.optimizers import LAMB
from tal_asrd_tpu_torch.train.schedules import (
    constant_schedule,
    inv_sqrt_schedule,
    linear_decay_schedule,
    triangle_schedule,
)
from tal_asrd_tpu_torch.train.system import ASRSystem

from tests.test_torch_helpers import seeded_like, to_numpy_tree

# tests/test_train.py's TINY model and frontend, with the encoder's dropout
# (tds_dropout, 0.2 there) off as well, so that training is deterministic
TINY = dict(model_type="1x", num_speakers=4, n_mels=8, vocab_size=32, n_head=2,
            max_positions=64, dropout=0.0, embed_size=16, tds_depths=(1, 1, 1),
            tds_kernel=5, tds_dropout=0.0)
FRONTEND = dict(n_mels=8, n_fft=64, win_length=64, hop_length=32)
NO_AUG = dict(num_freq_masks=0, num_time_masks=0)
TRAIN = dict(batch_size=4, lr=1e-3, max_steps=50, smoothing=0.0, token_replace_prob=0.0)


def tiny_batch(b=4, t=3200, l=12, vocab=32, n_spk=4, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "audio": (rng.randn(b, t) * 0.1).astype(np.float32),
        "audio_lens": np.full((b,), t, np.int32),
        "text": rng.randint(0, vocab + n_spk, (b, l)).astype(np.int32),
        "text_mask": np.ones((b, l), bool),
        "spk_ids": rng.randint(0, n_spk, (b, l)).astype(np.int32),
    }


def port_system(params_np, model=None, train=None, frontend=None, specaug=None):
    tsys = ASRSystem(ModelConfig(**dict(TINY, **(model or {}))),
                     TrainConfig(**dict(TRAIN, **(train or {}))),
                     FrontendConfig(**dict(FRONTEND, **(frontend or {}))),
                     SpecAugmentConfig(**(NO_AUG if specaug is None else specaug)),
                     compute_dtype=torch.float32, device="cpu")
    tsys.model.load_state_dict(params_to_state_dict(params_np), strict=True)
    return tsys


@pytest.fixture(scope="module")
def ref():
    """The JAX system on seeded parameters (ReZero scalars 0.4): its loss and
    gradients on one batch, and the parameters after one train_step."""
    jsys = JASRSystem(JModelConfig(conv_impl="xla", **TINY), JTrainConfig(**TRAIN),
                      JFrontendConfig(**FRONTEND), JSpecAugmentConfig(**NO_AUG),
                      dtype=jnp.float32)
    batch = tiny_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jsys.init_state(rng, jbatch).params)
    params = seeded_like(shapes, 7)
    loss, grads = jax.value_and_grad(
        lambda p: jsys.loss_fn(p, jbatch, rng, True)[0])(params)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        opt_state=jsys.tx.init(params))
    new_state, metrics = jsys.make_train_step(donate=False)(state, jbatch, rng)
    return {"jsys": jsys, "batch": batch, "params": to_numpy_tree(params),
            "loss": float(loss), "grads": to_numpy_tree(grads),
            "new_params": to_numpy_tree(new_state.params),
            "grad_norm": float(metrics["grad_norm"])}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


def _grads_tree(tsys):
    return state_dict_to_params({n: p.grad for n, p in tsys.model.named_parameters()})


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_losses_match_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 11)) * 3).astype(np.float32)
    targets = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) < 0.7
    tl, tt, tm = torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(mask)
    jl, jt, jm = jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask)
    np.testing.assert_allclose(log_softmax_cross_entropy(tl, tt, smoothing).numpy(),
                               np.asarray(j_ce(jl, jt, smoothing)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(masked_token_loss(tl, tt, tm, smoothing)),
                               float(j_masked_token_loss(jl, jt, jm, smoothing)),
                               rtol=0, atol=1e-6)
    assert float(masked_accuracy(tl, tt, tm)) == pytest.approx(
        float(j_masked_accuracy(jl, jt, jm)), abs=1e-7)


def test_schedules_match_jax():
    pairs = [(linear_decay_schedule(0.8, 100), j_linear_decay(0.8, 100)),
             (linear_decay_schedule(8e-4, 10), j_linear_decay(8e-4, 10)),
             (constant_schedule(1e-3), j_constant(1e-3)),
             (triangle_schedule(0.5, 10, 100), j_triangle(0.5, 10, 100)),
             (inv_sqrt_schedule(0.5, 10), j_inv_sqrt(0.5, 10))]
    for ours, theirs in pairs:
        for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 1000):
            assert ours(step) == float(theirs(step)), step


@pytest.mark.parametrize("weight_decay,always_adam", [(0.0, False), (0.01, False),
                                                      (0.01, True)])
def test_lamb_matches_jax_over_three_steps(weight_decay, always_adam):
    """Includes a zero weight (trust ratio 1), a zero gradient after step 1
    and a scalar, under a decaying learning rate."""
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "z": np.zeros((4,), np.float32),
          "s": np.asarray(0.7, np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    grads[1]["w"][:] = 0.0
    tx = j_lamb(j_linear_decay(0.05, 4), weight_decay=weight_decay,
                always_adam=always_adam)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = LAMB(tp.values(), linear_decay_schedule(0.05, 4), weight_decay=weight_decay,
               always_adam=always_adam)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, updates)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6, err_msg=k)


def test_loss_and_every_gradient_match_jax(ref):
    tsys = port_system(ref["params"])
    loss, _ = tsys.loss_fn(ref["batch"], True)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(ref["loss"], rel=1e-5)
    ours, theirs = dict(_flat(_grads_tree(tsys))), dict(_flat(ref["grads"]))
    assert sorted(ours) == sorted(theirs) and len(ours) > 40
    for key, g in ours.items():
        np.testing.assert_allclose(g, theirs[key], rtol=1e-4, atol=1e-6, err_msg=key)
    assert max(np.abs(g).max() for g in ours.values()) > 1e-2   # not all vanishing


def test_train_step_matches_jax(ref):
    tsys = port_system(ref["params"])
    metrics = tsys.train_step(ref["batch"])
    assert tsys.step == 1
    assert float(metrics["loss"]) == pytest.approx(ref["loss"], rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(ref["grad_norm"], rel=1e-5)
    ours = dict(_flat(tsys.params_tree()))
    moved = 0
    for key, want in _flat(ref["new_params"]):
        np.testing.assert_allclose(ours[key], want, rtol=0, atol=1e-5, err_msg=key)
        moved += int(not np.array_equal(want, dict(_flat(ref["params"]))[key]))
    assert moved == len(ours)


def test_grad_acc_two_equals_one(ref):
    """With dropout off, grad_acc=2 gives the loss and gradients of
    grad_acc=1 on the same batch, SpecAugment and token replacement on (their
    draws are made for the whole batch before the split). As in
    tests/test_train.py, the frontend's batch-wide mean subtraction is off
    and both halves hold the same number of real tokens: a masked mean over
    each half averages to the full batch's only then."""
    batch = tiny_batch()
    batch["text_mask"][:, 9:] = False
    kw = dict(frontend={"mean_subtract": False},
              specaug={"freq_mask_param": 3, "time_mask_param": 20},
              train={"token_replace_prob": 0.2})
    one = port_system(ref["params"], **kw)
    two = port_system(ref["params"], **dict(kw, train={"token_replace_prob": 0.2,
                                                       "grad_acc": 2}))
    m1, m2 = one.compute_grads(batch), two.compute_grads(batch)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    for (n, p1), p2 in zip(one.model.named_parameters(), two.model.parameters()):
        diff = float((p1.grad - p2.grad).norm())
        assert diff <= 1e-4 * float(p1.grad.norm()) + 1e-7, n


def test_unknown_speaker_ids_are_clamped_to_the_last_speaker(ref):
    batch = tiny_batch()
    batch["text"][0, 3] = 32 + 4 + 7            # beyond vocab + num_speakers - 1
    clamped = dict(batch, text=np.minimum(batch["text"], 32 + 4 - 1))
    tsys = port_system(ref["params"])
    with torch.no_grad():
        loss, _ = tsys.loss_fn(batch, True)
        loss_c, _ = tsys.loss_fn(clamped, True)
    assert float(loss) == float(loss_c)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = ref["jsys"].loss_fn(jax.tree_util.tree_map(jnp.asarray, ref["params"]),
                                  jbatch, jax.random.PRNGKey(0), True)
    assert float(loss) == pytest.approx(float(want), rel=1e-5)


def test_remat_gives_the_same_gradients_with_dropout(ref):
    grads = []
    for remat in (False, True):
        tsys = port_system(ref["params"], model={"remat": remat, "dropout": 0.3,
                                                 "tds_dropout": 0.3})
        torch.manual_seed(5)
        loss, _ = tsys.loss_fn(ref["batch"], True)
        loss.backward()
        grads.append([p.grad.clone() for p in tsys.model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_dropout_is_active_in_train_and_absent_in_eval(ref):
    tsys = port_system(ref["params"], model={"dropout": 0.3, "tds_dropout": 0.3})
    plain = port_system(ref["params"])
    batch = tiny_batch()
    with torch.no_grad():
        l_eval = [float(tsys.loss_fn(batch, False)[0]) for _ in range(2)]
        l_plain = float(plain.loss_fn(batch, False)[0])
        l_train = [float(tsys.loss_fn(batch, True)[0]) for _ in range(2)]
    assert l_eval[0] == l_eval[1] == l_plain
    assert l_train[0] != l_train[1] and l_train[0] != l_eval[0]
    # every dropout of the model is reached by .train()
    drops = [m for m in tsys.model.modules() if isinstance(m, torch.nn.Dropout)]
    attn = [m for m in tsys.model.modules() if hasattr(m, "dropout")
            and not isinstance(m, torch.nn.Dropout)]
    assert drops and len(attn) == 8 and all(m.dropout == 0.3 for m in attn)
    tsys.model.train()
    assert all(m.training for m in drops + attn)


def test_attention_drops_probabilities_after_the_head_mean():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 5, 2, 4, generator=g) for _ in range(3))
    out_e, w_e = _attend(q, k, v, None, 0.5, training=False)
    torch.manual_seed(1)
    out_t, w_t = _attend(q, k, v, None, 0.5, training=True)
    assert torch.equal(w_t, w_e)                 # the returned mean is undropped
    assert not torch.allclose(out_t, out_e)


def test_speaker_loss_is_not_ported():
    """The speaker loss is ported (its parity with JAX:
    tests/test_torch_spk_train.py): with the head, one train_step gives
    loss = lm_loss + spk_weight * spk_loss and moves the head; a speaker
    loss without the head is refused."""
    batch = tiny_batch()
    batch["text"] = np.minimum(batch["text"], 31)         # no speaker tokens
    tsys = ASRSystem(ModelConfig(use_speaker_head=True, **TINY), TrainConfig(**dict(
        TRAIN, spk_weight=0.5)), FrontendConfig(**FRONTEND), SpecAugmentConfig(**NO_AUG),
        compute_dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(0))
    before = tsys.model.speaker_head_2.weight.detach().clone()
    m = {k: float(v) for k, v in tsys.train_step(batch).items()}
    assert m["spk_loss"] > 0 and np.isfinite(m["loss"])
    assert m["loss"] == pytest.approx(m["lm_loss"] + 0.5 * m["spk_loss"], rel=1e-6)
    assert not torch.equal(before, tsys.model.speaker_head_2.weight.detach())
    with pytest.raises(ValueError, match="use_speaker_head"):
        ASRSystem(ModelConfig(**TINY), TrainConfig(spk_weight=0.5), device="cpu")


def test_train_config_scaling_matches_jax():
    for kw in ({}, {"batch_size": 32, "grad_acc": 2}, {"lr": None}):
        ours, theirs = TrainConfig(**kw), JTrainConfig(**kw)
        assert ours.effective_batch_size == theirs.effective_batch_size
        assert ours.scaled_lr == theirs.scaled_lr
