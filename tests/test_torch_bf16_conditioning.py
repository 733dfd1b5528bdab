"""Two properties of bf16 arithmetic in the two packages, pinned at a tiny
width.

ROADMAP C16: where the two packages' bf16 logits part, a cross-attention
head is tied between two memory frames at a logit scale where one bf16
rounding of its keys decides the winner (scripts/torch_c16_probe.py finds
such a head in layer 3 of the tracked checkpoint at episode 1's 17th
state-machine token). Neither package rounds differently from the other
there: both accumulate the attention logits and the bf16 matmuls in f32.

ROADMAP C18: XLA's CPU backend sums a bf16 reduction in bf16. The gradient
of a ReZero scalar (or a bias) is such a sum over every element it scales,
and in the JAX package's bf16 training on the CPU it saturates; PyTorch
sums in f32 and rounds once."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tal_asrd_tpu.models.decoder import _attend as j_attend
from tal_asrd_tpu_torch.models.decoder import _attend


def tied_head():
    """One query, one head of width 8, six memory frames. Frames 0 and 1 tie
    within 0.05 of a key entry at magnitude 256, where bf16's step is 2:
    in f32 frame 0 wins (its logit is 18 higher), after the keys are rounded
    to bf16 frame 1 wins (by 308). Their values differ by 10."""
    q = np.zeros((1, 1, 1, 8), np.float32)
    q[..., :2] = 1024.0
    k = np.zeros((1, 6, 1, 8), np.float32)
    k[0, 0, 0, :2] = (256.9, 0.0)        # bf16: (256, 0)
    k[0, 1, 0, :2] = (255.0, 1.85)       # bf16: (255, 1.8515625)
    v = np.zeros((1, 6, 1, 8), np.float32)
    v[0, 0], v[0, 1] = 5.0, -5.0
    return q, k, v


def both(q, k, v, dtype):
    """The head's output from each package on the same operands in `dtype`."""
    jd = {np.float32: jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {np.float32: torch.float32, "bf16": torch.bfloat16}[dtype]
    j_out, _ = j_attend(*(jnp.asarray(a, jd) for a in (q, k, v)), None, 0.0, False,
                        dtype=jd)
    t_out, _ = _attend(*(torch.from_numpy(a).to(td) for a in (q, k, v)), None)
    return np.asarray(j_out, np.float32), t_out.float().numpy()


def test_one_bf16_rounding_of_the_keys_flips_a_tied_head_in_both_packages():
    q, k, v = tied_head()
    j32, t32 = both(q, k, v, np.float32)
    np.testing.assert_allclose(t32, j32, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t32[0, 0, 0], v[0, 0, 0], atol=1e-6)     # frame 0 wins
    # the same operands in bf16: both packages pick frame 1, to the bit
    j16, t16 = both(q, k, v, "bf16")
    np.testing.assert_array_equal(t16, j16)
    np.testing.assert_allclose(t16[0, 0, 0], v[0, 1, 0], atol=1e-6)     # frame 1 wins
    # the keys alone rounded, the arithmetic f32: the output moves by |V0 - V1|
    k16 = torch.from_numpy(k).to(torch.bfloat16).float().numpy()
    _, t_k16 = both(q, k16, v, np.float32)
    assert np.abs(t_k16 - t32).max() == 10.0


def test_xla_cpu_bf16_matmul_accumulates_in_f32():
    """The output head's bf16 dot (tal_asrd_tpu/models/asr.py:198-202) gives
    what an f32 accumulator rounded once to bf16 gives: no bf16 accumulation
    on XLA's CPU backend, at the head's shapes cut to a tiny width."""
    rng = np.random.default_rng(0)
    h = jnp.asarray(rng.standard_normal((3, 256)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((256, 300)) / 16, jnp.bfloat16)
    as_model = np.asarray(h @ w, np.float32)
    f32_acc = np.asarray(jnp.dot(h, w, preferred_element_type=jnp.float32)
                         .astype(jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(as_model, f32_acc)
    # and the port's bf16 matmul on the CPU agrees within one bf16 step
    ours = (torch.from_numpy(np.asarray(h, np.float32)).to(torch.bfloat16)
            @ torch.from_numpy(np.asarray(w, np.float32)).to(torch.bfloat16)).float().numpy()
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(f32_acc), 1e-30))) - 7)
    assert np.all(np.abs(ours - f32_acc) <= step)


def test_xla_cpu_sums_the_gradient_of_a_bf16_scalar_in_bf16():
    """The flax pattern `x + rw.astype(bf16) * h`: the cotangent of rw is
    sum(ct * h) over all of h's elements. Over 2 M values near 1 the JAX
    package's sum stalls at 65536 (bf16's step there swallows each term);
    the port's is within 1e-4 of the exact sum."""
    rng = np.random.default_rng(0)
    h = jnp.asarray(rng.random((64, 1000, 32)) + 0.5, jnp.bfloat16)
    ct = jnp.asarray(rng.random((64, 1000, 32)) + 0.5, jnp.bfloat16)
    exact = float((np.asarray(h, np.float64) * np.asarray(ct, np.float64)).sum())
    _, vjp = jax.vjp(lambda rw: rw.astype(jnp.bfloat16) * h, jnp.float32(0.4))
    assert float(vjp(ct)[0]) < 0.05 * exact
    rw = torch.tensor(0.4, requires_grad=True)
    (rw.to(torch.bfloat16) * torch.from_numpy(np.asarray(h, np.float32)).to(torch.bfloat16)
     ).backward(torch.from_numpy(np.asarray(ct, np.float32)).to(torch.bfloat16))
    assert abs(float(rw.grad) - exact) <= 1e-4 * exact
