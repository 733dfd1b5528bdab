"""The n-gram repetition mask, port against JAX package
(tal_asrd_tpu/ops/ngram.py): seeded and hypothesis-drawn token buffers,
with and without `valid_len` (its edges 0, n, L and beyond L included), and
the state machine's incremental counter (`RepeatCounter`) against the
mask's sum. Integer outputs: equal, no tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tal_asrd_tpu.ops.ngram import ngram_repeat_mask as j_ngram_repeat_mask
from tal_asrd_tpu_torch.ops.ngram import RepeatCounter, ngram_repeat_mask


def both(xs: np.ndarray, n: int, valid=None):
    ref = np.asarray(j_ngram_repeat_mask(
        jnp.asarray(xs), n, None if valid is None else jnp.asarray(valid)))
    got = ngram_repeat_mask(torch.from_numpy(xs), n,
                            None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.int32
    return got.numpy(), ref


@pytest.mark.parametrize("seed", range(6))
def test_mask_matches_jax_on_seeded_buffers(seed):
    rng = np.random.default_rng(seed)
    b, l = 3, int(rng.integers(6, 48))
    n = int(rng.integers(1, 6))
    xs = rng.integers(0, 3 + seed, (b, l)).astype(np.int32)
    got, ref = both(xs, n)
    np.testing.assert_array_equal(got, ref)
    # valid_len at its edges: nothing valid, exactly n, the whole buffer, beyond it
    for valid in ([0, n, l], [l + 3, n - 1, l // 2]):
        v = np.asarray(valid, np.int32)
        got, ref = both(xs, n, v)
        np.testing.assert_array_equal(got, ref)


def test_mask_flags_a_known_repeat_and_not_the_first_occurrence():
    xs = np.asarray([[7, 8, 9, 7, 8, 9, 1, 2]], np.int32)
    got, ref = both(xs, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], [0, 0, 0, 1, 1, 1, 0, 0])
    # a buffer no longer than n flags nothing
    got, ref = both(xs[:, :3], 3)
    assert not got.any() and not ref.any()


# One buffer length for the drawn cases: JAX compiles once per (shape, n).
DRAWN_L = 32


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 5), st.integers(1, 4),
       st.lists(st.integers(0, 3), min_size=DRAWN_L, max_size=DRAWN_L),
       st.integers(0, DRAWN_L + 4))
def test_mask_matches_jax_on_drawn_buffers(n, vocab, tokens, valid):
    xs = (np.asarray(tokens, np.int32) % vocab)[None]
    got, ref = both(xs, n, np.asarray([valid], np.int32))
    np.testing.assert_array_equal(got, ref)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 6), st.lists(st.integers(0, 2), min_size=1, max_size=40))
def test_repeat_counter_equals_the_mask_sum_as_the_buffer_grows(n, tokens):
    xs = torch.tensor([tokens], dtype=torch.int32)
    counter = RepeatCounter(n, len(tokens))
    for valid in range(len(tokens) + 1):
        want = int(ngram_repeat_mask(xs, n, torch.tensor([valid])).sum())
        assert counter.count(tokens, valid, key="one buffer") == want
    # another key or a shorter buffer starts over
    assert counter.count(tokens, 1, key="other") == 0
