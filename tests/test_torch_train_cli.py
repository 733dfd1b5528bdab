"""The port's training CLI (`python -m tal_asrd_tpu_torch.cli.train`) against
the JAX CLI's figures in tests/fixtures/torch_train_cli_reference.json
(scripts/torch_train_reference.py): two runs at TAL_TINY_ARCH on a tiny
synthetic corpus from a seeded initial checkpoint, the second resuming from
the first's last checkpoint with the step counter restored. Both CLIs are
patched at run time to f32 compute with dropout 0 and token replacement 0
(as tests/test_torch_train.py's TINY / TRAIN are), and log every step.
Per-step and validation losses within 1e-4 relative, every leaf of every
checkpoint within 1e-4, spot-check texts equal. Also: the restored step
(the first update after it at schedule(0)), the refused flags, the
learning rate's scaling by the data axis, and the parser against the
reference's."""
import json
import os
import re
from dataclasses import replace
from functools import partial
from unittest import mock

import numpy as np
import pytest
import torch

from tal_asrd_tpu_torch.cli import train as cli_train
from tal_asrd_tpu_torch.cli.args import build_configs, get_argparser
from tal_asrd_tpu_torch.core.checkpoint import load_pytree, save_pytree
from tal_asrd_tpu_torch.core.config import ModelConfig, TrainConfig
from tal_asrd_tpu_torch.core.convert import params_spec
from tal_asrd_tpu_torch.data.synth import build_synth_corpus
from tal_asrd_tpu_torch.models.asr import ASRModel
from tal_asrd_tpu_torch.text.bpe import BpeTokenizer
from tal_asrd_tpu_torch.train.loop import TrainerConfig
from tal_asrd_tpu_torch.train.system import ASRSystem

from tests.test_torch_helpers import seeded_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_train_cli_reference.json")
CKPTS_NPZ = os.path.join(ROOT, "tests", "fixtures", "torch_train_cli_reference_ckpts.npz")
TOKENIZER = "accuracy_release/bpe.model"
# the flags of scripts/torch_train_reference.py's tiny runs (the fixture
# records them; test_the_fixture_ran_these_flags holds them equal)
TINY_SPLITS = {"train": dict(n_episodes=2, episode_seconds=40.0, n_speakers=8, seed=0),
               "valid": dict(n_episodes=1, episode_seconds=40.0, n_speakers=8, seed=101)}
TINY_INIT_SEED = 11
TINY_SCALARS = 0.1       # the ReZero scalars of the initial tree
TINY_COMMON = ["--train-data", "TRAIN", "--valid-data", "VALID", "--tokenizer", TOKENIZER,
               "--model-type", "1x", "--num-speakers", "8", "--batch-size", "4",
               "--max-secs", "12", "--num-workers", "0", "--max-epochs", "2",
               "--no-specaug", "--shiftaug", "--cache-items", "--audio-int16",
               "--ckpt-every", "1", "--name", "tiny", "--checkpoint-path", "CKPTS",
               "--out-dir", "OUT"]
TINY_RUNS = {"run1": TINY_COMMON + ["--load", "INIT"],
             "run2": TINY_COMMON + ["--load", "CKPTS/tiny/ckpt_00000008.msgpack",
                                    "--max-steps", "12"]}
PORT_ONLY = ["--device", "cpu"]


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)["tiny_cli"]


def _fill(argv, paths):
    out = []
    for a in argv:
        for key, path in paths.items():
            if a == key or a.startswith(key + "/"):
                a = path + a[len(key):]
        out.append(a)
    return out


def _f32_no_noise(build):
    def build_configs_f32(args, tokenizer=None):
        model_cfg, train_cfg, decode_cfg = build(args, tokenizer)
        return (replace(model_cfg, dropout=0.0, tds_dropout=0.0),
                replace(train_cfg, token_replace_prob=0.0), decode_cfg)
    return build_configs_f32


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's CLI, both runs, on the CPU: {run: {records, checkpoints,
    states, stdout-free result}} plus the paths and the initial tree."""
    tmp = str(tmp_path_factory.mktemp("train_cli"))
    paths = {k: os.path.join(tmp, k.lower()) for k in ("TRAIN", "VALID", "CKPTS", "OUT")}
    paths["INIT"] = os.path.join(tmp, "init.msgpack")
    for name, split in TINY_SPLITS.items():
        build_synth_corpus(paths[name.upper()], **split)
    with mock.patch.dict(os.environ, {"TAL_TINY_ARCH": "1"}), \
            mock.patch.object(cli_train, "build_configs", _f32_no_noise(build_configs)), \
            mock.patch.object(cli_train, "ASRSystem",
                              partial(ASRSystem, compute_dtype=torch.float32)), \
            mock.patch.object(cli_train, "TrainerConfig",
                              partial(TrainerConfig, log_every=1)):
        args = get_argparser(is_train=True).parse_args(_fill(TINY_RUNS["run1"], paths))
        model_cfg = build_configs(args, BpeTokenizer(model_path=os.path.join(ROOT, TOKENIZER)))[0]
        init = seeded_params(params_spec(ASRModel(model_cfg, device="cpu")), TINY_INIT_SEED,
                             scalar_bump=TINY_SCALARS)
        save_pytree(paths["INIT"], init)
        metrics = os.path.join(paths["OUT"], "tiny.metrics.jsonl")
        ckpt_dir = os.path.join(paths["CKPTS"], "tiny")
        runs = {}
        try:
            cwd = os.getcwd()
            os.chdir(ROOT)
            for name, argv in TINY_RUNS.items():
                seen = os.path.getsize(metrics) if os.path.exists(metrics) else 0
                before = set(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else set()
                out = cli_train.main(_fill(argv, paths) + PORT_ONLY)
                with open(metrics) as f:
                    f.seek(seen)
                    recs = [json.loads(line) for line in f if line.strip()]
                new = sorted(set(os.listdir(ckpt_dir)) - before)
                runs[name] = {"records": recs, "system": out["system"],
                              "checkpoints": [n for n in new if n.startswith("ckpt_")],
                              "states": [n for n in new if n.startswith("state_")]}
        finally:
            os.chdir(cwd)
    return {"runs": runs, "ckpt_dir": ckpt_dir, "init": init}


def test_the_fixture_ran_these_flags(fixture):
    assert {k: v["argv"] for k, v in fixture["runs"].items()} == TINY_RUNS
    assert {k: {f: s[f] for f in TINY_SPLITS[k]} for k, s in fixture["splits"].items()} \
        == TINY_SPLITS
    assert fixture["init_seed"] == TINY_INIT_SEED
    assert fixture["init_scalars"] == TINY_SCALARS
    assert fixture["float16_storage_max_abs_err"] < 1e-6


@pytest.mark.parametrize("run", ["run1", "run2"])
def test_step_and_validation_losses_match_the_jax_cli(port_runs, fixture, run):
    recs, ref = port_runs["runs"][run]["records"], fixture["runs"][run]
    steps = [[r["step"], r["loss"]] for r in recs if "loss" in r]
    vals = [[r["step"], r["val_loss"]] for r in recs if "val_loss" in r]
    for got, want in ((steps, ref["step_losses"]), (vals, ref["val_losses"])):
        assert [s for s, _ in got] == [s for s, _ in want]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4)


@pytest.mark.parametrize("run", ["run1", "run2"])
def test_spot_check_texts_equal_the_jax_cli(port_runs, fixture, run):
    got = [[r["step"], r["ref"], r["hyp"]] for r in port_runs["runs"][run]["records"]
           if r.get("type") == "generation"]
    assert got == fixture["runs"][run]["generations"]
    assert all(ref for _, ref, _ in got)


@pytest.mark.parametrize("run", ["run1", "run2"])
def test_checkpoint_leaves_match_the_jax_cli(port_runs, fixture, run):
    """The same files (epoch checkpoints, the state on the last epoch),
    each leaf within 1e-4 of the JAX CLI's."""
    mine = port_runs["runs"][run]
    assert mine["checkpoints"] == fixture["runs"][run]["checkpoints"]
    assert mine["states"] == fixture["runs"][run]["states"]
    deltas = np.load(CKPTS_NPZ)
    init = dict(_flat(port_runs["init"]))
    for name in mine["checkpoints"]:
        tree = dict(_flat(load_pytree(os.path.join(port_runs["ckpt_dir"], name))))
        want = {k.split(":", 1)[1] for k in deltas.files if k.startswith(name + ":")}
        assert set(tree) == want == set(init), name
        for path, value in tree.items():
            ref = init[path] + deltas[f"{name}:{path}"].astype(np.float32)
            np.testing.assert_allclose(value, ref, rtol=0, atol=1e-4, err_msg=f"{name} {path}")


def test_the_resume_restores_the_step_and_restarts_the_schedule(port_runs, fixture):
    """Run 2 loads run 1's ckpt_8 from its own directory: the counter is 8,
    the first new checkpoint is numbered 12 (8 + one epoch of 4 steps, where
    --max-steps stops it), and its state file counts 4 LAMB updates."""
    run2 = port_runs["runs"]["run2"]
    assert [r["step"] for r in run2["records"] if "loss" in r] == [9, 10, 11, 12]
    assert run2["checkpoints"] == ["ckpt_00000012.msgpack"]
    assert run2["system"].step == 12 and run2["system"].update_count() == 4
    state = load_pytree(os.path.join(port_runs["ckpt_dir"], run2["states"][0]))
    assert int(state["step"]) == 12 and int(state["opt_state"]["count"]) == 4
    assert fixture["runs"]["run2"]["state_counts"] == [[12, 4]]


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(tree[k], np.float32)


# ---------------------------------------------------------------------------
def _args(tmp_path, *extra):
    return get_argparser(is_train=True).parse_args(
        ["--train-data", "d", "--valid-data", "d", "--tokenizer", "t", "--model-type", "1x",
         "--name", "run", "--checkpoint-path", str(tmp_path)] + list(extra))


def _tiny_system(max_steps=None):
    cfg = ModelConfig(model_type="1x", num_speakers=4, vocab_size=32, n_mels=80,
                      tds_depths=(1, 1, 1), width_mult=0.1, d_decoder_override=32)
    return ASRSystem(cfg, TrainConfig(batch_size=2, max_steps=max_steps), device="cpu",
                     compute_dtype=torch.float32,
                     generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("case", ["own_dir", "other_dir", "no_restore_step", "not_a_ckpt"])
def test_maybe_restore_step(tmp_path, case):
    own = os.path.join(str(tmp_path), "run", "ckpt_00000045.msgpack")
    load = {"own_dir": own, "no_restore_step": own,
            "other_dir": os.path.join(str(tmp_path), "phase1", "ckpt_00000045.msgpack"),
            "not_a_ckpt": os.path.join(str(tmp_path), "run", "avg_last_3.msgpack")}[case]
    extra = ["--load", load] + (["--no-restore-step"] if case == "no_restore_step" else [])
    system = _tiny_system()
    step = cli_train.maybe_restore_step(_args(tmp_path, *extra), system)
    assert step == system.step == (45 if case == "own_dir" else 0)


def test_first_update_after_a_restore_uses_schedule_zero(tmp_path):
    """A params-only warm start keeps the optimizer's count at 0: the first
    update after restoring step 45 reads lr(0), as the reference's LAMB
    reads its own opt_state.count."""
    system = _tiny_system(max_steps=60)
    cli_train.maybe_restore_step(_args(tmp_path, "--load", os.path.join(
        str(tmp_path), "run", "ckpt_00000045.msgpack")), system)
    group = system.optimizer.param_groups[0]
    counts = []
    schedule = group["lr"]
    group["lr"] = lambda count: counts.append(count) or schedule(count)
    rng = np.random.RandomState(0)
    batch = {"audio": (rng.randn(2, 48000) * 0.1).astype(np.float32),
             "audio_lens": np.full((2,), 48000, np.int32),
             "text": rng.randint(0, 36, (2, 8)).astype(np.int32),
             "text_mask": np.ones((2, 8), bool), "spk_ids": np.zeros((2, 8), np.int32)}
    system.train_step(batch)
    assert set(counts) == {0}
    assert system.step == 46 and system.update_count() == 1
    assert int(system.state_tree()["opt_state"]["count"]) == 1


@pytest.mark.parametrize("flags,item", [
    (["--spk-weight", "0.5"], "A12.2"),
    (["--mesh-data", "2", "--device", "cpu"], "mesh 2x1 != 1 processes (no process group): "
                                              "launch a mesh with torchrun"),
    (["--batch-size", "3", "--grad-acc", "2"], "--batch-size 3 does not split into "
                                               "--grad-acc 2 micro-batches")])
def test_flags_outside_the_slice_are_refused(tmp_path, flags, item):
    """A mesh of more than one process without a process group is refused,
    naming torchrun (the mesh path: tests/test_torch_parallel_*.py), and so
    is a --batch-size that --grad-acc x the data axis does not divide (the
    JAX CLI fails on it at its first step). The speaker head (A12.2) is
    ported (its parity with the JAX CLI: tests/test_torch_spk_train.py):
    --spk-weight 0.5 trains the head, here one --quick-test step at
    TAL_TINY_ARCH on a split of one 20 s episode, the text without speaker
    tokens and the step's speaker loss logged."""
    if item != "A12.2":
        argv = ["--train-data", "d", "--valid-data", "d", "--tokenizer", "t", "--model-type",
                "1x", "--name", "run", "--checkpoint-path", str(tmp_path)] + flags
        with pytest.raises(SystemExit) as e:
            cli_train.main(argv)
        assert item in str(e.value)
        return
    d = str(tmp_path / "split")
    build_synth_corpus(d, n_episodes=1, episode_seconds=20.0, n_speakers=8, seed=0)
    argv = ["--train-data", d, "--valid-data", d, "--tokenizer",
            os.path.join(ROOT, TOKENIZER), "--model-type", "1x", "--num-speakers", "8",
            "--batch-size", "2", "--max-secs", "12", "--num-workers", "0", "--quick-test",
            "--max-epochs", "1", "--no-specaug", "--name", "run", "--checkpoint-path",
            str(tmp_path / "ckpts"), "--out-dir", str(tmp_path / "out"), "--device", "cpu"]
    with mock.patch.dict(os.environ, {"TAL_TINY_ARCH": "1"}), \
            mock.patch.object(cli_train, "TrainerConfig", partial(TrainerConfig, log_every=1)):
        out = cli_train.main(argv + flags)
    system = out["system"]
    assert system.model.cfg.use_speaker_head and system.train_cfg.spk_weight == 0.5
    assert system.model.cfg.num_tokens == 300                  # no speaker tokens
    with open(out["metrics_path"]) as f:
        steps = [r for r in map(json.loads, f) if "loss" in r]
    assert steps and all(r["spk_loss"] > 0 and np.isfinite(r["loss"]) for r in steps)


def test_the_parser_takes_every_flag_of_the_reference():
    from tal_asrd_tpu.cli.args import get_argparser as j_get_argparser
    req = ["--train-data", "d", "--valid-data", "d", "--tokenizer", "t",
           "--model-type", "1x", "--name", "n"]
    ref = j_get_argparser(is_train=True)
    mine = get_argparser(is_train=True)
    flags = lambda p: {s for a in p._actions for s in a.option_strings}
    assert flags(ref) <= flags(mine)
    assert flags(mine) - flags(ref) == {"--device"}
    assert {k: v for k, v in vars(mine.parse_args(req)).items()
            if k != "device"} == vars(ref.parse_args(req))
    assert mine.parse_args(req).device == "cuda"


def test_tiny_arch_shrinks_the_model_as_the_reference_does():
    from tal_asrd_tpu.cli.args import build_configs as j_build_configs
    from tal_asrd_tpu.cli.args import get_argparser as j_get_argparser
    req = ["--train-data", "d", "--valid-data", "d", "--tokenizer", "t",
           "--model-type", "1x", "--name", "n", "--num-speakers", "8"]
    with mock.patch.dict(os.environ, {"TAL_TINY_ARCH": "1"}):
        mine = build_configs(get_argparser(is_train=True).parse_args(req))[0]
        ref = j_build_configs(j_get_argparser(is_train=True).parse_args(req))[0]
    for field in ("tds_depths", "width_mult", "d_decoder_override", "num_speakers",
                  "vocab_size", "d_decoder", "tds_channels", "num_tokens"):
        assert getattr(mine, field) == getattr(ref, field), field


def test_count_parameters_and_integer_helpers_equal_the_reference():
    from tal_asrd_tpu.core import utils as j_utils
    from tal_asrd_tpu_torch.core import utils
    system = _tiny_system()
    tree = system.params_tree()
    assert utils.count_parameters(system.model) == utils.count_parameters(tree) \
        == j_utils.count_parameters(tree) > 0
    for a, b in ((7, 3), (9, 3), (0, 4), (1, 128)):
        assert utils.cdiv(a, b) == j_utils.cdiv(a, b)
        assert utils.round_up(a, b) == j_utils.round_up(a, b)


def test_checkpoint_names_are_what_restore_reads(tmp_path):
    from tal_asrd_tpu_torch.core.checkpoint import CheckpointManager
    path = CheckpointManager(str(tmp_path)).save(45, {"a": np.zeros(2, np.float32)})
    assert re.match(r"ckpt_(\d+)\.msgpack$", os.path.basename(path)).group(1) == "00000045"
