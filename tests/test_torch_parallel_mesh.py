"""The port's mesh plan (tal_asrd_tpu_torch/parallel/mesh.py) against the
JAX package's (tal_asrd_tpu/parallel/mesh.py), with no process group: the
batch rows of each rank against `batch_sharding(...).devices_indices_map`
on the 8 virtual CPU devices, every parameter's placement and shard against
`param_shardings` at the tiny and the 1x configurations, the 54 parameter
and 108 moment leaves the tiny configuration shards on a 4 x 2 mesh, and
the warning on an indivisible leaf."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from tal_asrd_tpu.core.config import ModelConfig as JModelConfig
from tal_asrd_tpu.core.config import TrainConfig as JTrainConfig
from tal_asrd_tpu.parallel import mesh as jmesh
from tal_asrd_tpu.train import ASRSystem as JASRSystem
from tal_asrd_tpu_torch.core.config import MeshConfig, ModelConfig
from tal_asrd_tpu_torch.core.convert import params_to_state_dict, unconvert_entry
from tal_asrd_tpu_torch.models.asr import ASRModel
from tal_asrd_tpu_torch.parallel import mesh as pmesh
from tal_asrd_tpu_torch.parallel.tensor import ModelShards, fused_perm
from tal_asrd_tpu_torch.train.optimizers import LAMB

from tests.test_torch_helpers import seeded_like, to_numpy_tree

TINY = dict(model_type="1x", num_speakers=4, n_mels=8, vocab_size=32, n_head=2,
            max_positions=64, dropout=0.0, embed_size=16, tds_depths=(1, 1, 1),
            tds_kernel=5, tds_dropout=0.0)
ONE_X = dict(model_type="1x", num_speakers=8, vocab_size=1000)
SHAPES = {"2x2": (2, 2), "4x2": (4, 2), "dcn2x2x2": (2, 2, 2)}


def j_mesh(shape):
    devices = jax.devices()[:int(np.prod(shape))]
    if len(shape) == 3:
        return jmesh.make_multislice_mesh(*shape, devices=devices)
    return jmesh.make_mesh(*shape, devices=devices)


def p_layout(shape):
    names = ("dcn", "data", "model") if len(shape) == 3 else ("data", "model")
    return pmesh.MeshLayout(names, tuple(shape))


def test_mesh_config_defaults_are_the_references():
    from tal_asrd_tpu.core.config import MeshConfig as JMeshConfig
    assert MeshConfig() == MeshConfig(**vars(JMeshConfig()))


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("ndim", [1, 2])
def test_batch_rows_follow_jax_device_order(name, ndim):
    shape = SHAPES[name]
    jm, lay = j_mesh(shape), p_layout(shape)
    b = 16
    full = (b,) + (3,) * (ndim - 1)
    jmap = jmesh.batch_sharding(jm, ndim).devices_indices_map(full)
    sharding = pmesh.batch_sharding(lay, ndim)
    assert sharding.spec == tuple(jmesh.batch_sharding(jm, ndim).spec)
    for rank, dev in enumerate(jax.devices()[:lay.size]):
        want = jmap[dev][0]
        got = sharding.rows(b, rank=rank)
        assert (got.start, got.stop) == (want.start or 0, want.stop or b), (rank, dev)
        rows = pmesh.shard_batch(lay, {"x": np.arange(b)}, rank=rank)["x"]
        assert rows.tolist() == list(range(b))[want]
    with pytest.raises(ValueError, match="does not split"):
        sharding.rows(b + 1, rank=0)


def test_mesh_sizes_resolve_and_refuse_as_jax_does():
    assert pmesh._resolve(8, (-1, 2)) == (4, 2)
    with pytest.raises(ValueError, match="mesh 3x2 != 8"):
        pmesh._resolve(8, (3, 2))
    with pytest.raises(ValueError):
        pmesh._resolve(8, (-1, 3))
    with pytest.raises(RuntimeError, match="torchrun"):
        pmesh.make_mesh(2, 1)          # no process group here


def _jax_tree(cfg_kw):
    jsys = JASRSystem(JModelConfig(conv_impl="xla", **cfg_kw), JTrainConfig(batch_size=2),
                      dtype=jnp.float32)
    batch = {"audio": jnp.zeros((2, 3200)), "audio_lens": jnp.full((2,), 3200, jnp.int32),
             "text": jnp.zeros((2, 8), jnp.int32), "text_mask": jnp.ones((2, 8), bool),
             "spk_ids": jnp.zeros((2, 8), jnp.int32)}
    return jsys, jax.eval_shape(lambda: jsys.init_state(jax.random.PRNGKey(0), batch))


@pytest.fixture(scope="module")
def plans():
    """Per configuration: the JAX state's shapes, its param and LAMB-state
    specs on the 4 x 2 mesh, and the port model."""
    out = {}
    for name, kw in (("tiny", TINY), ("1x", ONE_X)):
        jsys, state = _jax_tree(kw)
        jm = j_mesh((4, 2))
        p_sh = jmesh.param_shardings(jm, state.params)
        o_sh = jmesh.opt_state_shardings(jm, state.opt_state, state.params, p_sh)
        model = ASRModel(ModelConfig(**kw), device="cpu", generator=torch.Generator())
        out[name] = {"state": state, "p_sh": p_sh, "o_sh": o_sh, "model": model}
    return out


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("config", ["tiny", "1x"])
def test_every_placement_is_the_jax_spec_in_torch_layout(plans, config):
    """Each parameter's port shard (torch layout) is the JAX device's block
    of the same leaf (reference layout); the fused qkv / kv projections
    hold their heads' rows instead, and gather back to the same leaf."""
    p = plans[config]
    lay = p_layout((4, 2))
    port = pmesh.param_plan(lay, p["model"])
    jspecs = {path: s.spec for path, s in _flat(jax.tree_util.tree_map(
        lambda s: s, p["p_sh"].unfreeze() if hasattr(p["p_sh"], "unfreeze") else p["p_sh"],
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))}
    assert len(port) == len(jspecs)
    values = seeded_like(p["state"].params, 3)
    sd = params_to_state_dict(to_numpy_tree(values))
    jm = j_mesh((4, 2))
    for name, plan in port.items():
        path = tuple(plan.path.split("/"))
        assert plan.spec == tuple(jspecs[path]), name
        full = sd[name]
        if plan.dim is None:
            assert isinstance(plan.placement, Replicate)
            continue
        assert plan.placement == Shard(plan.dim)
        ref = np.asarray(unconvert_entry(name, full)[1])
        jmap = jax.sharding.NamedSharding(jm, jspecs[path]).devices_indices_map(ref.shape)
        locals_ = []
        for rank, dev in enumerate(jax.devices()[:8]):
            shards = ModelShards(port, None, 2, lay.model_index(rank))
            local = shards.local(name, full)
            locals_.append(local)
            if fused_perm(name, full.shape[0], 2) is None:
                np.testing.assert_array_equal(
                    np.asarray(unconvert_entry(name, local)[1]), ref[jmap[dev]], err_msg=name)
        joined = torch.cat(locals_[:2], dim=plan.dim)
        perm = fused_perm(name, full.shape[plan.dim], 2)
        if perm is not None:
            joined = joined.index_select(plan.dim, torch.argsort(perm))
        assert torch.equal(joined, full), name


def _count_sharded(tree):
    return sum(1 for _, v in _flat(tree) if not isinstance(v, Replicate))


def test_tiny_plan_shards_54_parameters_and_108_moments(plans):
    """MULTICHIP_r05.json's counts at mesh {'data': 4, 'model': 2}."""
    p = plans["tiny"]
    jparams = sum(1 for s in jax.tree_util.tree_leaves(
        p["p_sh"], is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
        if s.spec != jax.sharding.PartitionSpec())
    jopt = sum(1 for s in jax.tree_util.tree_leaves(
        p["o_sh"], is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
        if s.spec != jax.sharding.PartitionSpec())
    lay = p_layout((4, 2))
    placements = pmesh.param_shardings(lay, p["model"])
    opt = LAMB(p["model"].named_parameters(), 1e-3)
    o_port = pmesh.opt_state_shardings(lay, opt, p["model"])
    assert (jparams, jopt) == (54, 108)
    assert sum(not isinstance(v, Replicate) for v in placements.values()) == 54
    assert _count_sharded(o_port["mu"]) + _count_sharded(o_port["nu"]) == 108
    assert isinstance(o_port["count"], Replicate)


def test_an_indivisible_leaf_is_replicated_with_one_warning(caplog):
    """37 tokens on a model axis of 2: the JAX package and the port warn
    about the same leaf, once, and replicate it."""
    kw = dict(TINY, num_speakers=5)          # 37 tokens: the embedding does not split
    jsys, state = _jax_tree(kw)
    with caplog.at_level(logging.WARNING):
        jmesh.param_shardings(j_mesh((4, 2)), state.params)
    jwarned = sorted(r.args[0] for r in caplog.records if "indivisible" in r.getMessage())
    caplog.clear()
    model = ASRModel(ModelConfig(**kw), device="cpu", generator=torch.Generator())
    with caplog.at_level(logging.WARNING, logger="tal_asrd_tpu_torch.parallel.mesh"):
        plan = pmesh.param_plan(p_layout((4, 2)), model)
    warned = sorted(r.args[0] for r in caplog.records if "indivisible" in r.getMessage())
    assert warned == jwarned == ["embedding/embedding"]
    assert plan["embedding.weight"].dim is None
