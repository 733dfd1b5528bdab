"""SpecAugment of the port (ops/specaug.py; kernel K4 on the card) against
the JAX `spec_augment`: the spans stay in bounds and are fixed by the seeds,
masks built from the same spans equal the JAX masks bit for bit, and the
distribution of masked frames and mels agrees with jax.random's draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.core.config import SpecAugmentConfig as JSpecAugmentConfig
from tal_asrd_tpu.ops.specaug import _span_mask as j_span_mask
from tal_asrd_tpu.ops.specaug import spec_augment as j_spec_augment
from tal_asrd_tpu_torch.core.config import SpecAugmentConfig
from tal_asrd_tpu_torch.ops.specaug import (
    draw_seeds,
    sample_spans,
    span_mask,
    spec_augment,
    spec_augment_seeded,
    specaug_plain,
)

CFG = SpecAugmentConfig()


def _seeds(n, seed=0):
    return draw_seeds(n, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("param,dim", [(27, 80), (100, 2001), (100, 37), (7, 7)])
def test_spans_are_fixed_by_the_seeds_and_stay_in_bounds(param, dim):
    seeds = _seeds(3000)
    start, end = sample_spans(seeds, 2, param, dim)
    again = sample_spans(seeds.clone(), 2, param, dim)
    assert torch.equal(start, again[0]) and torch.equal(end, again[1])
    assert start.dtype == torch.int64 and start.shape == (3000, 2)
    assert bool((start >= 0).all() and (start <= end).all() and (end <= dim).all())
    # width < param, so a span is shorter than param - 1
    assert int((end - start).max()) <= param - 2
    # other mask indices draw other spans
    other = sample_spans(seeds, 2, param, dim, first_mask=2)
    assert not torch.equal(start, other[0])
    if dim > param:     # start ~ U{0..dim-width-1}: the whole range is used
        assert int(start.max()) >= dim - param - 1 and int(start.min()) == 0


def test_plain_version_is_deterministic_per_seed():
    spec = torch.randn(4, 150, 80, generator=torch.Generator().manual_seed(1))
    seeds = _seeds(4, 3)
    a, b = specaug_plain(seeds, spec, CFG), specaug_plain(seeds, spec, CFG)
    assert torch.equal(a, b)
    c = specaug_plain(_seeds(4, 4), spec, CFG)
    assert not torch.equal(a, c)
    kept = a != 0
    assert torch.equal(a[kept], spec[kept])          # kept values are untouched


def test_span_mask_and_select_equal_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    b, n, dim = 64, 3, 90
    start = rng.integers(-10, dim + 5, (b, n))
    end = start + rng.integers(-3, 40, (b, n))
    ours = span_mask(torch.from_numpy(start), torch.from_numpy(end), dim).numpy()
    ref = np.asarray(j_span_mask(jnp.asarray(start, jnp.int32),
                                 jnp.asarray(end, jnp.int32), dim))
    np.testing.assert_array_equal(ours, ref)
    # the select, on the same spans, with negative values and -0.0 in spec
    spec = rng.standard_normal((b, 50, dim)).astype(np.float32)
    spec[:, :3] = -0.0
    t_s, t_e = rng.integers(0, 50, (b, 2)), rng.integers(0, 50, (b, 2))
    keep_t = span_mask(torch.from_numpy(t_s), torch.from_numpy(t_e), 50)
    keep = keep_t[:, :, None] & torch.from_numpy(ours)[:, None, :]
    got = torch.where(keep, torch.from_numpy(spec), torch.zeros(())).numpy()
    j_keep = (j_span_mask(jnp.asarray(t_s, jnp.int32), jnp.asarray(t_e, jnp.int32), 50)
              [:, :, None] & jnp.asarray(ref)[:, None, :])
    want = np.asarray(jnp.where(j_keep, jnp.asarray(spec), jnp.zeros((), jnp.float32)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_masked_frames_and_mels_match_jax_in_distribution():
    """4000 examples of each: the mean masked frames (rows all zero) and
    mels (columns all zero) agree within 5 standard errors. T=300 keeps two
    time spans (< 100 each) from covering a column, and two frequency spans
    (< 27 each) cannot cover a row of 80."""
    n, chunk, t, m = 4000, 500, 300, 80
    ones = np.ones((chunk, t, m), np.float32)
    jfn = jax.jit(lambda k, x: j_spec_augment(k, x, JSpecAugmentConfig()))
    gen = torch.Generator().manual_seed(11)
    stats = {"jax": ([], []), "port": ([], [])}
    for i in range(n // chunk):
        j_out = np.asarray(jfn(jax.random.PRNGKey(i), jnp.asarray(ones)))
        p_out = spec_augment(torch.from_numpy(ones), CFG, gen).numpy()
        for key, out in (("jax", j_out), ("port", p_out)):
            stats[key][0].append((out.sum(axis=2) == 0).sum(axis=1))
            stats[key][1].append((out.sum(axis=1) == 0).sum(axis=1))
    for axis in (0, 1):
        a = np.concatenate(stats["jax"][axis]).astype(np.float64)
        b = np.concatenate(stats["port"][axis]).astype(np.float64)
        se = np.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) < 5 * se, (axis, a.mean(), b.mean(), se)
        assert a.mean() > 5          # the masks are not empty


def test_short_axis_clips_the_span_to_it():
    """dim <= width: the start is 0 and the span is clipped to dim. Pinned
    values: the kernel draws the same ones, and a change of the hash shows."""
    seeds = torch.tensor([0, 1, -7, 2 ** 31 - 1], dtype=torch.int32)
    # the time masks of the default config (mask indices 2 and 3), T = 5
    start, end = sample_spans(seeds, 2, 100, 5, first_mask=2)
    assert start.tolist() == [[0, 0], [0, 0], [0, 0], [0, 0]]
    assert end.tolist() == [[5, 5], [5, 5], [5, 3], [5, 5]]
    s2, e2 = sample_spans(seeds, 2, 27, 80)
    assert s2.tolist() == [[19, 19], [30, 65], [21, 29], [30, 35]]
    assert e2.tolist() == [[19, 19], [44, 75], [36, 47], [30, 36]]
    spec = torch.randn(4, 5, 80)
    out = specaug_plain(seeds, spec, CFG)
    assert (out == 0).all(dim=2).all(dim=1).all()      # every row of every example


def test_zero_masks_leave_the_features_as_they_are():
    spec = torch.randn(3, 37, 80)
    off = SpecAugmentConfig(num_freq_masks=0, num_time_masks=0)
    out = spec_augment_seeded(_seeds(3), spec, off)
    assert torch.equal(out, spec)
    ref = j_spec_augment(jax.random.PRNGKey(0), jnp.asarray(spec.numpy()),
                         JSpecAugmentConfig(num_freq_masks=0, num_time_masks=0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gradient_is_the_masked_gradient():
    spec = torch.randn(2, 40, 80, requires_grad=True)
    seeds = _seeds(2, 5)
    out = spec_augment_seeded(seeds, spec, CFG)
    g = torch.randn_like(out)
    out.backward(g)
    keep = specaug_plain(seeds, torch.ones(2, 40, 80), CFG) != 0
    assert torch.equal(spec.grad, torch.where(keep, g, torch.zeros(())))


def test_spec_augment_checks_its_inputs():
    with pytest.raises(ValueError):
        spec_augment_seeded(_seeds(3), torch.randn(2, 10, 80), CFG)
    with pytest.raises(ValueError):
        sample_spans(_seeds(2), 2, 0, 80)
