"""Run a function on a group of spawned processes, and the workers that the
tests and chip_smoke.py run there.

`run_group(target, world, spec)` (or `start_group(...).wait()`, to do
other work meanwhile) spawns `world` processes (the spawn start
method: each imports this module afresh, and nothing of JAX), joins them
into one process group through a file in a fresh temporary directory (no
fixed port, so concurrent runs do not collide), calls `target(rank,
device, spec)` in each and returns their results by rank. A process that
raises sends its traceback back; if any process fails, or the group has
not reported within `timeout` seconds, every process is killed and
`run_group` raises. Every process is joined before it returns.

The workers build an `ASRSystem` on a mesh from a plain dict `spec` (see
`build_system`), so the parent computes what it compares against (the JAX
reference, the one-process step) and compares there:

  * `train_worker`: train steps on global batches; process 0 returns the
    gathered training state;
  * `checkpoint_worker`: a step, an asynchronous `ShardedCheckpointManager`
    save, and the restore into the state of another system;
  * `trainer_worker`: `Trainer.fit`, then a resumed `fit` (`fit_twice`);
  * `sync_worker`: `ASRSystem.sync_replicas` after a replica was moved;
  * `sequence_worker`: several of these in turn in one group;
  * `cli_worker`: `cli.train.main(argv)` inside the group.

Each worker also returns its own launches of K2 and K4 (the counts are per
process).
"""
from __future__ import annotations

import contextlib
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


def _child(target, rank, world, rendezvous, device, backend, threads, spec_path, results):
    try:
        torch.set_num_threads(threads)
        with open(spec_path, "rb") as f:
            spec = pickle.load(f)
        from tal_asrd_tpu_torch.parallel.mesh import init_distributed
        dev = init_distributed(device, backend=backend, init_method=f"file://{rendezvous}",
                               rank=rank, world_size=world)
        # plain pickle copies tensors by value: torch.multiprocessing's queue
        # would share their storage through a server in this process, gone
        # once it exits, which a parent that reads late then cannot reach
        results.put((rank, True, pickle.dumps(target(rank, dev, spec))))
    except BaseException:  # noqa: BLE001 - the parent reports it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Group:
    """A started group of processes (`start_group`); `wait` collects it."""

    def __init__(self, target: Callable, world: int, spec: Dict[str, Any], device: str,
                 backend: str, timeout: float, threads: int):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.results = ctx.Queue()
        self.tmp = tempfile.TemporaryDirectory()
        rendezvous = os.path.join(self.tmp.name, "rdv")
        # the spec goes through a file: a large argument would hold each start
        # until its process had imported this module and read it
        spec_path = os.path.join(self.tmp.name, "spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump(spec, f)
        self.procs = [ctx.Process(target=_child, args=(target, r, world, rendezvous, device,
                                                       backend, threads, spec_path, self.results),
                                  daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def wait(self) -> List[Any]:
        """The processes' results by rank; raises if one failed or the
        group ran past its time. Every process is joined or killed."""
        got: Dict[int, Any] = {}
        error: Optional[str] = None
        silent_dead = 0     # polls that found a process gone without its result
        try:
            while len(got) < self.world and error is None:
                try:
                    rank, ok, value = self.results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if p.exitcode is not None and r not in got]
                    silent_dead = silent_dead + 1 if dead else 0
                    if silent_dead >= 5:
                        error = (f"ranks {dead} exited (codes "
                                 f"{[self.procs[r].exitcode for r in dead]}) without a result")
                    elif time.monotonic() > self.deadline:
                        error = (f"the group did not finish within {self.timeout} s "
                                 f"(ranks done: {sorted(got)})")
                    continue
                if ok:
                    got[rank] = pickle.loads(value)
                else:
                    error = f"rank {rank} failed:\n{value}"
        finally:
            for p in self.procs:
                p.join(timeout=10 if error is None else 1)
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            self.tmp.cleanup()
        if error is not None:
            raise RuntimeError(error)
        return [got[r] for r in range(self.world)]


def start_group(target: Callable, world: int, spec: Dict[str, Any], device: str = "cpu",
                backend: str = "gloo", timeout: float = 120.0, threads: int = 1) -> Group:
    """Spawn target(rank, device, spec) on `world` processes of one group
    and return at once; `.wait()` gives their results."""
    return Group(target, world, spec, device, backend, timeout, threads)


def run_group(target: Callable, world: int, spec: Dict[str, Any], device: str = "cpu",
              backend: str = "gloo", timeout: float = 120.0, threads: int = 1) -> List[Any]:
    """target(rank, device, spec) on `world` spawned processes of one group;
    their results, by rank."""
    return start_group(target, world, spec, device, backend, timeout, threads).wait()


# ---------------------------------------------------------------------------
# Building a system from a spec
# ---------------------------------------------------------------------------
def make_mesh_of(shape, device):
    """(data, model) or (dcn, data, model) -> the DeviceMesh of `device`'s
    type."""
    from tal_asrd_tpu_torch.parallel.mesh import make_mesh, make_multislice_mesh
    kind = torch.device(device).type
    return (make_mesh(*shape, device_type=kind) if len(shape) == 2
            else make_multislice_mesh(*shape, device_type=kind))


def _optimizer(system, name: str, kwargs: Dict[str, Any]):
    from tal_asrd_tpu_torch.train import optimizers as o
    named = list(system.model.named_parameters())
    lr = system._schedule()
    if name == "adafactor":
        return o.Adafactor(named, **kwargs)
    if name == "radam":
        return o.RAdam(named, lr, **kwargs)
    if name == "lookahead":
        return o.Lookahead(o.LAMB(named, lr), **kwargs)
    return o.LAMB(named, lr, **kwargs)


def build_system(spec: Dict[str, Any], device, mesh=None):
    """An ASRSystem from `spec`: "model", "train", "frontend", "specaug"
    (config keyword dicts), "compute_dtype" ("float32" or "bfloat16"),
    "init_seed" (the CPU generator of the initial weights), "params" (a
    full parameter tree, numpy) or "load" (a msgpack checkpoint, loaded
    partially and not strictly), "resweight" (every ReZero scalar set to
    it), "optimizer" and "optimizer_kwargs" (LAMB by default)."""
    from tal_asrd_tpu_torch.core.checkpoint import load_params_partial, load_pytree
    from tal_asrd_tpu_torch.core.config import (FrontendConfig, ModelConfig,
                                                SpecAugmentConfig, TrainConfig)
    from tal_asrd_tpu_torch.core.convert import params_to_state_dict
    from tal_asrd_tpu_torch.train.system import ASRSystem

    system = ASRSystem(ModelConfig(**spec["model"]), TrainConfig(**spec.get("train", {})),
                       FrontendConfig(**spec.get("frontend", {})),
                       SpecAugmentConfig(**spec.get("specaug", {})),
                       compute_dtype=getattr(torch, spec.get("compute_dtype", "float32")),
                       device=device,
                       generator=torch.Generator().manual_seed(spec.get("init_seed", 0)),
                       mesh=mesh)
    if spec.get("params") is not None:
        system.load_state_dict_full(params_to_state_dict(spec["params"]))
    elif spec.get("load"):
        system.load_params(load_params_partial(system.params_spec(), load_pytree(spec["load"]),
                                               strict=False))
    if spec.get("resweight") is not None:
        with torch.no_grad():
            for name, p in system.model.named_parameters():
                if name.endswith(("resweight", "resweight_src")):
                    p.fill_(spec["resweight"])
    if spec.get("optimizer", "lamb") != "lamb" or spec.get("optimizer_kwargs"):
        system.optimizer = _optimizer(system, spec.get("optimizer", "lamb"),
                                      spec.get("optimizer_kwargs", {}))
        if system.shards is not None:
            system.optimizer.set_shards(system.shards)
    return system


def batches_of(spec: Dict[str, Any]) -> List[Dict[str, np.ndarray]]:
    """The global batches: spec["batches"], or the .npz at
    spec["batches_path"] (keys "<i>/<name>")."""
    if "batches" in spec:
        return spec["batches"]
    with np.load(spec["batches_path"]) as z:
        n = 1 + max(int(k.split("/")[0]) for k in z.files)
        return [{k.split("/")[1]: z[k] for k in z.files if k.split("/")[0] == str(i)}
                for i in range(n)]


def save_batches(path: str, batches: List[Dict[str, Any]]) -> None:
    np.savez(path, **{f"{i}/{k}": np.asarray(v) for i, b in enumerate(batches)
                      for k, v in b.items()})


def _counters():
    from tal_asrd_tpu_torch.ops.cuda_kernels import fused_logmel_project
    from tal_asrd_tpu_torch.ops.specaug import spec_augment
    return {"fused_logmel_project": fused_logmel_project, "spec_augment": spec_augment}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _CollectiveClock:
    """Wraps torch.distributed's all_reduce and all_gather to add up the
    seconds spent in them (the device synchronized around each call, so
    the seconds are the collective's own)."""

    NAMES = ("all_reduce", "all_gather")

    def __init__(self, device):
        self.device, self.seconds, self.calls = device, 0.0, 0
        self._orig = {}

    def __enter__(self):
        for name in self.NAMES:
            orig = self._orig[name] = getattr(dist, name)

            def timed(*args, _orig=orig, **kwargs):
                _sync(self.device)
                t0 = time.perf_counter()
                out = _orig(*args, **kwargs)
                _sync(self.device)
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                return out
            setattr(dist, name, timed)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(dist, name, orig)


def train_steps(system, batches, device, time_collectives: bool = False) -> Dict[str, Any]:
    """Each batch's train_step: the metrics (floats), each step's seconds,
    this process's K2 and K4 launches over the steps and, with
    `time_collectives`, the seconds and calls of its all-reduces and
    all-gathers."""
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    metrics, seconds = [], []
    clock = _CollectiveClock(device)
    with clock if time_collectives else contextlib.nullcontext():
        for batch in batches:
            _sync(device)
            t0 = time.perf_counter()
            m = {k: float(v) for k, v in system.train_step(batch).items()}
            _sync(device)
            seconds.append(time.perf_counter() - t0)
            metrics.append(m)
    out = {"metrics": metrics, "step_s": seconds,
           "launches": {k: fn.launches for k, fn in counters.items()}}
    if time_collectives:
        out.update(collective_s=clock.seconds, collective_calls=clock.calls)
    return out


def train_worker(rank: int, device, spec: Dict[str, Any]) -> Dict[str, Any]:
    """spec["mesh"] steps of `build_system(spec)` on `batches_of(spec)`
    (TF32 off with spec["no_tf32"]; collectives timed with
    spec["time_collectives"]); every process returns its metrics, step
    times and launches, process 0 also the gathered `state_tree()` (its
    parameters alone with spec["return"] == "params"), and `eval` metrics
    of spec["eval_batch"] when given."""
    if spec.get("no_tf32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    system = build_system(spec, device, make_mesh_of(spec["mesh"], device))
    out = train_steps(system, batches_of(spec), device, spec.get("time_collectives", False))
    out["rank"] = rank
    if spec.get("eval_batch") is not None:
        out["eval"] = {k: float(v) for k, v in system.eval_step(spec["eval_batch"]).items()}
    tree = system.params_tree() if spec.get("return") == "params" else system.state_tree()
    if rank == 0:
        out["state"] = tree
    return out


def checkpoint_worker(rank: int, device, spec: Dict[str, Any]) -> Dict[str, Any]:
    """A step of `build_system(spec)` on the first batch, its sharded state
    saved asynchronously to spec["dir"], then restored into the state of a
    second system (initial seed + 1, a step on the second batch). Returns
    whether every leaf came back bit for bit with its placement, how many
    leaves were sharded, and the times of save_state, wait_until_finished
    and load_state."""
    from torch.distributed.tensor import DTensor

    from tal_asrd_tpu_torch.core.checkpoint import ShardedCheckpointManager
    mesh = make_mesh_of(spec["mesh"], device)
    batches = batches_of(spec)
    saved = build_system(spec, device, mesh)
    saved.train_step(batches[0])
    other = build_system(dict(spec, init_seed=spec.get("init_seed", 0) + 1, params=None),
                         device, mesh)
    other.train_step(batches[1])
    manager = ShardedCheckpointManager(spec["dir"], async_save=True)
    state = saved.sharded_state()
    _sync(device)
    t0 = time.perf_counter()
    manager.save_state(saved.step, state)
    t1 = time.perf_counter()
    manager.wait_until_finished()
    t2 = time.perf_counter()
    template = other.sharded_state()
    placements = {}

    def walk(a, b, path=""):
        for k in a:
            if isinstance(a[k], dict):
                yield from walk(a[k], b[k], f"{path}{k}/")
            else:
                yield f"{path}{k}", a[k], b[k]

    for key, _, t in walk(state, template):
        if isinstance(t, DTensor):
            placements[key] = tuple(t.placements)
    manager.load_state(template)
    t3 = time.perf_counter()
    other.load_sharded_state(template)
    bit_equal, kept, sharded = True, True, 0
    for key, a, b in walk(state, template):
        if isinstance(a, DTensor):
            sharded += 1
            kept &= isinstance(b, DTensor) and tuple(b.placements) == placements[key]
            a, b = a.to_local(), b.to_local()
        bit_equal &= bool(torch.equal(a.cpu(), b.cpu()))
    restored = other.sharded_state()
    for key, a, b in walk(state, restored):
        a = a.to_local() if isinstance(a, DTensor) else a
        b = b.to_local() if isinstance(b, DTensor) else b
        bit_equal &= bool(torch.equal(a.cpu(), b.cpu()))
    manager.close()
    return {"rank": rank, "bit_equal": bit_equal, "placements_kept": kept,
            "sharded_leaves": sharded, "steps": manager.state_steps(),
            "save_return_s": t1 - t0, "wait_s": t2 - t1, "load_s": t3 - t2}


def sync_worker(rank: int, device, spec: Dict[str, Any]) -> Dict[str, Any]:
    """A step of `build_system(spec)`, then every process but the model
    axis's first moves a replicated parameter and its moment (as the card's
    nondeterministic kernels can) and `sync_replicas` runs. Returns that
    parameter and moment before and after."""
    system = build_system(spec, device, make_mesh_of(spec["mesh"], device))
    system.train_step(batches_of(spec)[0])
    p = system.model.get_parameter("decoder_proj.bias")
    m = system.optimizer.state[p]["exp_avg"]
    if system.shards.rank:
        with torch.no_grad():
            p.add_(1e-3)
            m.add_(1e-3)
    before = (p.detach().cpu().clone(), m.cpu().clone())
    system.sync_replicas()
    return {"rank": rank, "before": before, "after": (p.detach().cpu(), m.cpu())}


def fit_twice(spec: Dict[str, Any], device, mesh=None) -> Dict[str, Any]:
    """`Trainer.fit` for one epoch over `batches_of(spec)` into
    spec["dir"], then a second system (fresh weights) resumed from that
    state with `fit(resume=True)` for another epoch. Returns the steps and
    the second system's gathered parameters."""
    from tal_asrd_tpu_torch.train.loop import Trainer, TrainerConfig
    from tal_asrd_tpu_torch.utils.logging import MetricsLogger
    batches = batches_of(spec)
    lead = mesh is None or dist.get_rank() == 0
    steps = []
    for resume in (False, True):
        system = build_system(dict(spec, init_seed=spec.get("init_seed", 0) + 1, params=None)
                              if resume else spec, device, mesh)
        logger = MetricsLogger(out_dir=spec["dir"], name="fit") if lead else None
        Trainer(system, TrainerConfig(max_epochs=1, checkpoint_dir=spec["dir"]),
                logger=logger).fit(batches, batches[:1], resume=resume)
        steps.append(system.step)
    return {"steps": steps, "params": system.params_tree()}


def trainer_worker(rank: int, device, spec: Dict[str, Any]) -> Dict[str, Any]:
    """`fit_twice` on spec["mesh"]."""
    return dict(fit_twice(spec, device, make_mesh_of(spec["mesh"], device)), rank=rank)


def sequence_worker(rank: int, device, spec: Dict[str, Any]) -> Dict[str, Any]:
    """Several workers one after another in the same processes (one start
    for all): spec["sequence"] is a list of (key, worker name, its spec);
    returns {key: that worker's result}."""
    return {key: globals()[worker](rank, device, sub) for key, worker, sub in spec["sequence"]}


def cli_worker(rank: int, device, spec: Dict[str, Any]) -> Dict[str, Any]:
    """`cli.train.main(spec["argv"])` in the group, from directory
    spec["cwd"] with spec["env"] set, its trainer logging every
    spec["log_every"] steps; with spec["f32_no_noise"] the model computes
    in float32 with dropout 0 and token replacement 0 (the parity runs'
    patches). Returns this process's launches and seconds, and its
    system's step, learning rate and data shards."""
    import dataclasses
    import functools

    from tal_asrd_tpu_torch.cli import train as cli_train
    os.environ.update(spec.get("env", {}))
    if spec.get("cwd"):
        os.chdir(spec["cwd"])
    cli_train.TrainerConfig = functools.partial(cli_train.TrainerConfig,
                                                log_every=spec.get("log_every", 50))
    if spec.get("f32_no_noise"):
        build = cli_train.build_configs

        def build_configs(args, tokenizer=None):
            model_cfg, train_cfg, decode_cfg = build(args, tokenizer)
            return (dataclasses.replace(model_cfg, dropout=0.0, tds_dropout=0.0),
                    dataclasses.replace(train_cfg, token_replace_prob=0.0), decode_cfg)
        cli_train.build_configs = build_configs
        cli_train.ASRSystem = functools.partial(cli_train.ASRSystem,
                                                compute_dtype=torch.float32)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = cli_train.main(spec["argv"])
    _sync(device)
    tc = out["system"].train_cfg
    return {"rank": rank, "seconds": time.perf_counter() - t0,
            "metrics_path": out["metrics_path"], "step": out["system"].step,
            "scaled_lr": tc.scaled_lr, "num_data_shards": tc.num_data_shards,
            "launches": {k: fn.launches for k, fn in counters.items()}}
