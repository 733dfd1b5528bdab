"""The port's utilities against the JAX package's: `utils.profiling`
(`trace` writes a Chrome trace on the CPU, `StepTimer`, `sync`),
`core.utils` (`SuppressPrint`, `debug_log` printing JAX's lines for the same
values) and `core.config.to_json` (JAX's JSON for every config, less the
fields that select a TPU lowering, which the port leaves out)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tal_asrd_tpu.core.config as jconfig
import tal_asrd_tpu_torch.core.config as config
from tal_asrd_tpu.core.utils import SuppressPrint as JSuppressPrint
from tal_asrd_tpu.core.utils import debug_log as j_debug_log
from tal_asrd_tpu.utils.profiling import StepTimer as JStepTimer
from tal_asrd_tpu_torch import SuppressPrint, debug_log
from tal_asrd_tpu_torch.utils import StepTimer, sync, trace

TPU_ONLY = {"use_pallas", "spectrum_impl", "conv_impl"}


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "t" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_sync_takes_trees_and_leaves_cpu_tensors_alone(monkeypatch):
    called = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: called.append(d))
    sync({"a": [torch.ones(2), (torch.zeros(1), 3)], "b": None})
    sync([])
    assert called == []


def test_step_timer_is_the_reference_s():
    mine, ref = StepTimer(window=3), JStepTimer(window=3)
    assert np.isnan(mine.mean_s) and np.isnan(mine.throughput(1.0))
    for t in (StepTimer.__dict__, JStepTimer.__dict__):
        assert {"__enter__", "__exit__", "mean_s", "throughput", "audio_hours_per_hour"} <= set(t)
    for timer in (mine, ref):
        timer.times.extend([0.5, 0.25, 1.0, 0.25])
    assert mine.mean_s == ref.mean_s == 0.5
    assert mine.throughput(8.0) == ref.throughput(8.0) == 16.0
    assert mine.audio_hours_per_hour(30.0) == ref.audio_hours_per_hour(30.0)
    with mine:
        pass
    assert len(mine.times) == 3 and mine.times[-1] >= 0.0


def test_suppress_print_silences_stdout_and_restores_it(capsys):
    for cls in (SuppressPrint, JSuppressPrint):
        with cls():
            print("hidden")
        print("shown")
    assert capsys.readouterr().out == "shown\nshown\n"


def _values(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    bad = x.copy()
    bad[0, 0], bad[1, 2], bad[2, 3] = np.nan, np.inf, -np.inf
    return x, bad, rng.integers(0, 9, (5,)).astype(np.int32)


@pytest.mark.parametrize("case", ["tensor", "nans", "ints", "empty", "tree", "scalar", "off"])
def test_debug_log_prints_what_jax_prints(case, capsys):
    x, bad, ints = _values()
    t = torch.from_numpy
    mine, ref = {
        "tensor": (t(x), jnp.asarray(x)),
        "nans": (t(bad), jnp.asarray(bad)),
        "ints": (t(ints), jnp.asarray(ints)),
        "empty": (torch.zeros((0, 3)), jnp.zeros((0, 3))),
        "tree": ({"w": t(x), "b": [t(ints), None, (t(bad),)], "n": 3},
                 {"w": jnp.asarray(x), "b": [jnp.asarray(ints), None, (jnp.asarray(bad),)],
                  "n": 3}),
        "scalar": (2.5, 2.5),
        "off": (t(x), jnp.asarray(x)),
    }[case]
    debug = case != "off"
    debug_log(mine, "msg", debug=debug)
    got = capsys.readouterr().out
    j_debug_log(ref, "msg", debug=debug)
    want = capsys.readouterr().out
    assert got == want
    assert bool(got) == debug


def test_debug_log_moves_a_tensor_to_the_host_as_float32(capsys):
    x = torch.tensor([[1.0, 2.0], [3.0, 4.5]], dtype=torch.bfloat16)
    debug_log(x, "bf16")
    assert capsys.readouterr().out == (
        "[debug] bf16: shape=(2, 2) dtype=bfloat16 min=1 max=4.5 mean=2.625\n")


@pytest.mark.parametrize("name", ["FrontendConfig", "SpecAugmentConfig", "ModelConfig",
                                  "SDModelConfig", "LMConfig", "TrainConfig", "DecodeConfig",
                                  "MeshConfig"])
def test_to_json_equals_jax(name):
    kwargs = {"ModelConfig": dict(model_type="2x", num_speakers=8, vocab_size=300),
              "TrainConfig": dict(batch_size=16, max_steps=8)}.get(name, {})
    mine = config.to_json(getattr(config, name)(**kwargs))
    ref = json.loads(jconfig.to_json(getattr(jconfig, name)(**kwargs)))
    for k in TPU_ONLY:
        ref.pop(k, None)
    assert mine == json.dumps(ref, indent=2)
    assert "ModelConfig" in config.__dict__ and "MeshConfig" in config.__dict__


def test_set_seed_seeds_the_dropout_draws():
    """set_seed seeds PyTorch's default generator too (the training CLI's
    dropout), so two runs in fresh processes draw the same masks."""
    from tal_asrd_tpu_torch.core.utils import set_seed
    set_seed(7)
    first = torch.nn.functional.dropout(torch.ones(64), 0.5, training=True)
    set_seed(7)
    again = torch.nn.functional.dropout(torch.ones(64), 0.5, training=True)
    assert torch.equal(first, again) and 0 < int((first == 0).sum()) < 64
