"""The port's ShardedCheckpointManager (core/checkpoint.py, on
torch.distributed.checkpoint): a tensor-parallel training state saved
asynchronously by a gloo group of 2 CPU processes and restored into the
state of another system, bit for bit with its placements; and the
manager's bookkeeping in one process. The JAX package's manager writes
orbax's format; the two packages exchange msgpack files instead, so there
is no JAX counterpart to run here."""
import os

import numpy as np
import pytest
import torch

from tal_asrd_tpu_torch.core.checkpoint import ShardedCheckpointManager
from tal_asrd_tpu_torch.parallel.launch import fit_twice, sequence_worker, start_group

from tests.test_torch_parallel_train import FRONTEND, NO_AUG, TINY, TRAIN, tiny_batch


SPEC = dict(model=TINY, frontend=FRONTEND, specaug=NO_AUG, train=TRAIN, resweight=0.4,
            mesh=(1, 2), batches=[tiny_batch(seed=0), tiny_batch(seed=1)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One group of 2 processes on (1, 2): the sharded checkpoint, then
    Trainer.fit for an epoch and a resumed fit; the same fits in one
    process meanwhile."""
    d = str(tmp_path_factory.mktemp("sharded_ckpt"))
    group = start_group(sequence_worker, 2, {"sequence": [
        ("saved", "checkpoint_worker", dict(SPEC, dir=d)),
        ("resumed", "trainer_worker", dict(SPEC, dir=str(tmp_path_factory.mktemp("fit2")))),
        ("synced", "sync_worker", SPEC)]},
        timeout=180)
    one = fit_twice(dict(SPEC, dir=str(tmp_path_factory.mktemp("fit1"))), "cpu")
    ranks = group.wait()
    return {"saved": ([r["saved"] for r in ranks], d),
            "resumed": ([r["resumed"] for r in ranks], one),
            "synced": [r["synced"] for r in ranks]}


@pytest.fixture(scope="module")
def saved(runs):
    return runs["saved"]


@pytest.fixture(scope="module")
def resumed(runs):
    return runs["resumed"]


def test_async_save_and_restore_is_bit_exact(saved):
    ranks, _ = saved
    for r in ranks:
        assert r["bit_equal"], r
        assert r["save_return_s"] >= 0 and r["wait_s"] >= 0


def test_restore_keeps_the_placements(saved):
    """Every sharded leaf (54 parameters at the tiny configuration on a
    model axis of 2, and LAMB's two moments of each) comes back a DTensor
    with the template's placements."""
    ranks, _ = saved
    for r in ranks:
        assert r["placements_kept"]
        assert r["sharded_leaves"] == 54 * 3


def test_the_checkpoint_is_one_directory_per_step(saved):
    ranks, d = saved
    assert [r["steps"] for r in ranks] == [[1], [1]]
    assert sorted(os.listdir(d)) == ["state_00000001"]


def test_manager_bookkeeping_in_one_process(tmp_path):
    """state_steps lists the finished saves only; load_state waits for a
    pending save and fills the template in place."""
    manager = ShardedCheckpointManager(str(tmp_path), async_save=False)
    assert manager.latest_state_step() is None
    with pytest.raises(FileNotFoundError):
        manager.load_state({"w": torch.zeros(3)})
    manager.save_state(3, {"w": torch.arange(3.0), "step": torch.tensor(3)})
    os.makedirs(tmp_path / "state_00000009")          # no metadata: an unfinished save
    assert manager.state_steps() == [3]
    late = ShardedCheckpointManager(str(tmp_path), async_save=True)
    late.save_state(5, {"w": torch.arange(3.0) * 2, "step": torch.tensor(5)})
    template = {"w": torch.zeros(3), "step": torch.tensor(0)}
    assert late.load_state(template) is template       # waits for step 5 first
    assert torch.equal(template["w"], torch.tensor([0.0, 2.0, 4.0]))
    assert int(template["step"]) == 5 and late.latest_state_step() == 5
    manager.load_state(template, step=3)
    assert torch.equal(template["w"], torch.arange(3.0))
    late.close()


def test_a_resumed_fit_on_a_mesh_agrees_across_ranks_and_with_one_process(resumed):
    """Every rank finds process 0's state file, restores it into its shards
    and trains on to the same step; the result is the one-process run's
    within test_torch_train_cli.py's 1e-4 (four LAMB steps)."""
    ranks, one = resumed
    assert [r["steps"] for r in ranks] == [one["steps"]] * 2 == [[2, 4]] * 2
    want = dict(_flat(one["params"]))
    for path, value in _flat(ranks[0]["params"]):
        np.testing.assert_allclose(value, want[path], rtol=0, atol=1e-4, err_msg=path)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


def test_sync_replicas_gives_every_process_the_first_ones_copy(runs):
    """A replicated parameter and its moment moved on the second process
    (as the card's nondeterministic kernels can part them) come back as the
    first process's; `sharded_state` runs this before every save."""
    first, second = runs["synced"]
    assert not torch.equal(first["before"][0], second["before"][0])
    for i in range(2):
        assert torch.equal(second["after"][i], first["before"][i])
        assert torch.equal(first["after"][i], first["before"][i])
