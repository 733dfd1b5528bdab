"""Parity of the PyTorch port's grouped conv and TDS encoder with the JAX
package (CPU, float32). Weights are made with numpy from a seed, given to the
flax module as they are and to the port through `params_to_state_dict`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tal_asrd_tpu.models.tds import TDS as JTDS
from tal_asrd_tpu.models.tds import tds_output_length as j_tds_output_length
from tal_asrd_tpu.ops.grouped_conv import GroupedConv1D as JGroupedConv1D
from tal_asrd_tpu_torch.core.convert import params_to_state_dict
from tal_asrd_tpu_torch.models.tds import TDS, tds_output_length
from tal_asrd_tpu_torch.ops.grouped_conv import GroupedConv1D

from tests.test_torch_helpers import seeded_like, to_numpy_tree

# f32 convolutions in two libraries: different summation order over
# kernel * channels-per-group <= 21 * 18 terms of O(0.1)
ATOL = 1e-4


@pytest.mark.parametrize("padding,stride,c_in,c_out,groups", [
    ("SAME", 1, 32, 32, 8),      # TDSBlock conv: 4 channels per group
    ("VALID", 2, 8, 24, 8),      # first down conv: 1 channel per group
    ("VALID", 2, 24, 40, 8),     # later down conv: 3 -> 5 per group
    ("VALID", 1, 16, 16, 4),
])
def test_grouped_conv_matches_jax(padding, stride, c_in, c_out, groups):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 50, c_in)).astype(np.float32)
    jmod = JGroupedConv1D(c_out, 21, groups, stride=stride, padding=padding,
                          impl="xla")
    import jax
    params = seeded_like(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))

    tmod = GroupedConv1D(c_in, c_out, 21, groups, stride=stride, padding=padding)
    tmod.load_state_dict(params_to_state_dict(to_numpy_tree(params)), strict=True)
    with torch.no_grad():
        ours = tmod(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_grouped_conv_same_needs_stride_one():
    with pytest.raises(NotImplementedError):
        GroupedConv1D(8, 8, 21, 8, stride=2, padding="SAME")


@pytest.fixture(scope="module")
def tds_pair():
    import jax
    n_mels, sizes, depths = 8, (8, 8, 16, 16), (1, 1, 1)   # width_mult 0.1 plan
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 240, n_mels)).astype(np.float32)
    jmod = JTDS(input_size=n_mels, sizes=sizes, depths=depths, kernel=21,
                dropout=0.2, conv_impl="xla")
    params = seeded_like(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 3)
    tmod = TDS(n_mels, sizes, depths, kernel=21, dropout=0.2)
    tmod.load_state_dict(params_to_state_dict(to_numpy_tree(params)), strict=True)
    return jmod, params, tmod, x


@pytest.mark.parametrize("stage", ["all", "extract", "aggregate"])
def test_tds_matches_jax(tds_pair, stage):
    jmod, params, tmod, x = tds_pair
    if stage == "aggregate":   # aggregate consumes the extract stage's output
        x = np.array(jmod.apply({"params": params}, jnp.asarray(x), stage="extract"))
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), stage=stage))
    with torch.no_grad():
        ours = tmod(torch.from_numpy(x), stage=stage).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_tds_is_in_eval_mode_and_output_length(tds_pair):
    _, _, tmod, x = tds_pair
    assert not tmod.training
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    assert out.shape[1] == tds_output_length(240) == j_tds_output_length(240)
    assert tds_output_length(2857) == 340
    with pytest.raises(ValueError):
        tmod(torch.from_numpy(x), stage="nope")
