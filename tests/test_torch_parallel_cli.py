"""The port's training CLI on a 2 x 2 mesh (`--mesh-data 2 --mesh-model
2`, a gloo group of 4 CPU processes) against the JAX CLI's figures in
tests/fixtures/torch_parallel_cli_reference.json
(scripts/torch_parallel_reference.py): run 1 of tests/test_torch_train_cli.py's
tiny runs, with its patches (f32, dropout 0, token replacement 0, every step
logged). Per-step and validation losses within 1e-4 relative, every leaf of
the last checkpoint within 1e-4, spot-check texts equal, the same files.

The reference is the JAX CLI on 2 x 1: its 2 x 2 mesh step departs from its
one-device step in the encoder's grouped-convolution gradients
(tests/test_torch_parallel_train.py), while tensor parallelism changes
nothing of the math; the fixture's 2 x 2 run is held to the 2 x 1 run's
losses within the same 1e-4. Also: the learning rate scaled by the data
axis as the JAX CLI scales it, and only process 0 writes."""
import json
import os

import numpy as np
import pytest

from tal_asrd_tpu.core.config import TrainConfig as JTrainConfig
from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
from tal_asrd_tpu_torch.core.checkpoint import load_pytree, save_pytree
from tal_asrd_tpu_torch.core.convert import params_spec
from tal_asrd_tpu_torch.data.synth import build_synth_corpus
from tal_asrd_tpu_torch.models.asr import ASRModel
from tal_asrd_tpu_torch.parallel.launch import cli_worker, run_group
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer

from tests.test_torch_helpers import seeded_params
from tests.test_torch_train_cli import (ROOT, TINY_INIT_SEED, TINY_RUNS, TINY_SCALARS,
                                        TINY_SPLITS, TOKENIZER, _fill, _flat)

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_parallel_cli_reference.json")
CKPTS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_parallel_cli_reference_ckpts.npz")
MESH = ["--mesh-data", "2", "--mesh-model", "2"]


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel_cli"))
    paths = {k: os.path.join(tmp, k.lower()) for k in ("TRAIN", "VALID", "CKPTS", "OUT")}
    paths["INIT"] = os.path.join(tmp, "init.msgpack")
    for name, split in TINY_SPLITS.items():
        build_synth_corpus(paths[name.upper()], **split)
    os.environ["TAL_TINY_ARCH"] = "1"
    try:
        args = get_argparser(is_train=True).parse_args(_fill(TINY_RUNS["run1"], paths))
        model_cfg = build_configs(args, BpeTokenizer(model_path=os.path.join(ROOT, TOKENIZER)))[0]
    finally:
        del os.environ["TAL_TINY_ARCH"]
    init = seeded_params(params_spec(ASRModel(model_cfg, device="cpu")), TINY_INIT_SEED,
                         scalar_bump=TINY_SCALARS)
    save_pytree(paths["INIT"], init)
    argv = _fill(TINY_RUNS["run1"], paths) + MESH + ["--device", "cpu"]
    ranks = run_group(cli_worker, 4, {"argv": argv, "cwd": ROOT, "log_every": 1,
                                      "env": {"TAL_TINY_ARCH": "1"}, "f32_no_noise": True},
                      timeout=150)
    with open(os.path.join(paths["OUT"], "tiny.metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    ckpt_dir = os.path.join(paths["CKPTS"], "tiny")
    return {"ranks": ranks, "records": recs, "ckpt_dir": ckpt_dir, "init": init,
            "files": sorted(os.listdir(ckpt_dir)), "out_files": sorted(os.listdir(paths["OUT"]))}


def test_the_fixture_ran_these_flags(fixture):
    assert fixture["runs"]["mesh_2x2"]["argv"] == TINY_RUNS["run1"] + MESH
    assert fixture["runs"]["mesh_2x1"]["argv"] == TINY_RUNS["run1"] + [
        "--mesh-data", "2", "--mesh-model", "1"]
    assert fixture["init_seed"] == TINY_INIT_SEED and fixture["init_scalars"] == TINY_SCALARS
    assert {k: {f: s[f] for f in TINY_SPLITS[k]} for k, s in fixture["splits"].items()} \
        == TINY_SPLITS
    assert fixture["float16_storage_max_abs_err"] < 1e-6
    a, b = (fixture["runs"][k]["step_losses"] for k in ("mesh_2x2", "mesh_2x1"))
    np.testing.assert_allclose([v for _, v in a], [v for _, v in b], rtol=1e-4)


@pytest.mark.parametrize("kind", ["step_losses", "val_losses"])
def test_losses_match_the_jax_cli_on_a_mesh(mesh_run, fixture, kind):
    key = "loss" if kind == "step_losses" else "val_loss"
    got = [[r["step"], r[key]] for r in mesh_run["records"] if key in r]
    want = fixture["runs"]["mesh_2x1"][kind]
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4)


def test_spot_check_texts_and_files_equal_the_jax_cli(mesh_run, fixture):
    ref = fixture["runs"]["mesh_2x1"]
    got = [[r["step"], r["ref"], r["hyp"]] for r in mesh_run["records"]
           if r.get("type") == "generation"]
    assert got == ref["generations"] and all(g for _, g, _ in got)
    assert [n for n in mesh_run["files"] if n.startswith("ckpt_")] == ref["checkpoints"]
    assert [n for n in mesh_run["files"] if n.startswith("state_")] == ref["states"]


def test_last_checkpoint_leaves_match_the_jax_cli(mesh_run, fixture):
    name = fixture["runs"]["mesh_2x1"]["checkpoints"][-1]
    deltas = np.load(CKPTS_NPZ)
    init = dict(_flat(mesh_run["init"]))
    tree = dict(_flat(load_pytree(os.path.join(mesh_run["ckpt_dir"], name))))
    assert set(tree) == set(init)
    for path, value in tree.items():
        ref = init[path] + deltas[f"mesh_2x1:{path}"].astype(np.float32)
        np.testing.assert_allclose(value, ref, rtol=0, atol=1e-4, err_msg=path)


def test_the_learning_rate_scales_with_the_data_axis_as_the_jax_cli(mesh_run):
    """The JAX CLI sets num_data_shards to the data axis and scales the
    rate by sqrt(num_data_shards x --batch-size x --grad-acc), although
    its global batch is --batch-size rows: the port keeps that rule."""
    want = JTrainConfig(lr=1e-4, batch_size=4, grad_acc=1, num_data_shards=2).scaled_lr
    for rank in mesh_run["ranks"]:
        assert rank["num_data_shards"] == 2 and rank["step"] == 8
        assert rank["scaled_lr"] == pytest.approx(want, rel=1e-12)


def test_only_process_0_writes(mesh_run):
    steps = [r["step"] for r in mesh_run["records"] if "loss" in r]
    assert steps == list(range(1, 9))                    # each step logged once
    assert [r["metrics_path"] is not None for r in mesh_run["ranks"]] == [True] + [False] * 3
    assert mesh_run["out_files"] == ["tiny.config.json", "tiny.metrics.jsonl"]
