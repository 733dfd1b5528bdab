"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
seeded parameter trees and a tiny model pair built from the same numbers."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

TINY = dict(model_type="1x", num_speakers=4, vocab_size=60, n_head=2,
            tds_depths=(1, 1, 1), width_mult=0.1, d_decoder_override=32)
TINY_SAMPLES = 48000     # 3 s -> 301 frames -> 21 encoder frames


def seeded_like(tree, seed, scalar_bump=0.4):
    """A parameter tree of the same structure as `tree` (a flax init result),
    refilled from numpy with a fixed seed so that both packages get the same
    numbers whatever their own initialisers do: matrices and kernels normal
    with std 1/sqrt(fan_in), vectors small normal, and every 0-dim leaf (the
    ReZero scalars, which initialise to 0 and would multiply every residual
    branch away) set to `scalar_bump`."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = []
    for leaf in leaves:
        shape = np.shape(leaf)
        if len(shape) == 0:
            out.append(np.asarray(scalar_bump, np.float32))
        elif len(shape) == 1:
            out.append((rng.standard_normal(shape) * 0.1).astype(np.float32))
        else:
            fan_in = int(np.prod(shape[:-1]))
            out.append((rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_audio(batch=3, seed=0):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((batch, TINY_SAMPLES)) * 0.1).astype(np.float32)
    lens = np.linspace(TINY_SAMPLES, TINY_SAMPLES * 0.6, batch).astype(np.int32)
    return audio, lens


def tiny_model_pair(seed=0, **overrides):
    """(flax model, flax variables, port model) at a tiny size, float32, the
    port filled from the flax tree through the converter."""
    from tal_asrd_tpu.core.config import ModelConfig as JModelConfig
    from tal_asrd_tpu.models.asr import ASRModel as JASRModel
    from tal_asrd_tpu_torch.core.config import ModelConfig
    from tal_asrd_tpu_torch.core.convert import load_into
    from tal_asrd_tpu_torch.models.asr import ASRModel

    kw = dict(TINY, **overrides)
    jmodel = JASRModel(JModelConfig(conv_impl="xla", **kw), dtype=jnp.float32)
    audio, lens = tiny_audio(2)
    # only the tree's structure and shapes are needed: seeded_like refills it
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(audio),
        jnp.zeros((2, 4), jnp.int32), jnp.asarray(lens)))
    params = seeded_like(variables["params"], seed)
    tmodel = ASRModel(ModelConfig(**kw), dtype=torch.float32, device="cpu")
    load_into(tmodel, {"params": to_numpy_tree(params)})
    return jmodel, {"params": params}, tmodel


def test_seeded_like_is_deterministic_and_bumps_scalars():
    tree = {"a": {"kernel": np.zeros((3, 4)), "bias": np.zeros(4)}, "rw": np.zeros(())}
    one, two = seeded_like(tree, 5), seeded_like(tree, 5)
    np.testing.assert_array_equal(one["a"]["kernel"], two["a"]["kernel"])
    assert float(one["rw"]) == np.float32(0.4) and one["a"]["kernel"].std() > 0


def seeded_params(spec, seed, scalar_bump=0.4):
    """A parameter tree (nested dicts) of the shapes of `spec`'s leaves
    (anything with .shape: arrays, LeafSpecs), filled as `seeded_like` fills
    a flax tree, leaf by leaf in sorted key order, in float32: the same
    numbers for the same shapes whichever package produced `spec`."""
    rng = np.random.default_rng(seed)

    def fill(node):
        out = {}
        for key in sorted(node):
            value = node[key]
            if isinstance(value, dict):
                out[key] = fill(value)
                continue
            shape = tuple(value.shape)
            if len(shape) == 0:
                out[key] = np.asarray(scalar_bump, np.float32)
            elif len(shape) == 1:
                out[key] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
            else:
                fan_in = int(np.prod(shape[:-1]))
                out[key] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        return out

    return fill(spec)
