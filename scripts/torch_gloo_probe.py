"""Which collectives a gloo group carries on CUDA tensors when its ranks
share one card, and whether the pieces the parallel path uses work there.

    python3 scripts/torch_gloo_probe.py [--world 2] [--out out/gloo_probe.json]

Spawns `--world` processes on cuda:0 in one gloo group (file rendezvous)
and tries, each in turn: all_reduce (sum, max), broadcast, all_gather,
all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single, barrier,
new_group, init_device_mesh("cuda") over that group, and a
torch.distributed.checkpoint save, async_save and load of CUDA tensors.
Then `torchrun --nproc-per-node 1` on NCCL with one all_reduce. Prints one
JSON object: each item "ok" or the error's first line. A probe: it reports
what fails instead of stopping.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import traceback


def _try(results, name, fn):
    try:
        out = fn()
        results[name] = "ok" if out is None else out
    except Exception as e:  # noqa: BLE001 - a probe records every failure
        results[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def _worker(rank, world, init_file, ckpt_dir, queue):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    dev = torch.device("cuda", 0)
    res = {}

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        assert t.device.type == "cuda" and float(t[0]) == world * (world + 1) / 2

    def all_reduce_max():
        t = torch.full((1,), float(rank), device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        assert float(t[0]) == world - 1

    def broadcast():
        t = torch.full((3,), float(rank), device=dev)
        dist.broadcast(t, 0)
        assert float(t.sum()) == 0.0

    def all_gather():
        t = torch.full((2,), float(rank), device=dev)
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t)
        assert [float(o[0]) for o in out] == list(map(float, range(world)))

    def all_gather_into_tensor():
        t = torch.full((2,), float(rank), device=dev)
        out = torch.empty(2 * world, device=dev)
        dist.all_gather_into_tensor(out, t)

    def reduce_scatter_tensor():
        t = torch.ones(2 * world, device=dev)
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, t)

    def all_to_all_single():
        t = torch.arange(world, dtype=torch.float32, device=dev)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)

    def new_group():
        g = dist.new_group(list(range(world)))
        t = torch.ones(1, device=dev)
        dist.all_reduce(t, group=g)
        assert float(t[0]) == world

    def device_mesh():
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cuda", (world, 1), mesh_dim_names=("data", "model"))
        g = mesh.get_group("data")
        t = torch.ones(1, device=dev)
        dist.all_reduce(t, group=g)
        assert float(t[0]) == world
        return f"ok backend={dist.get_backend(g)}"

    def dcp_roundtrip(async_save):
        import torch.distributed.checkpoint as dcp
        state = {"w": torch.arange(4, dtype=torch.float32, device=dev)}
        path = os.path.join(ckpt_dir, "async" if async_save else "sync")
        if async_save:
            fut = dcp.async_save(state, checkpoint_id=path)
            fut.result()
        else:
            dcp.save(state, checkpoint_id=path)
        back = {"w": torch.zeros(4, device=dev)}
        dcp.load(back, checkpoint_id=path)
        assert torch.equal(back["w"], state["w"]) and back["w"].device.type == "cuda"

    for name, fn in (("all_reduce_sum", all_reduce), ("all_reduce_max", all_reduce_max),
                     ("broadcast", broadcast), ("all_gather", all_gather),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor),
                     ("all_to_all_single", all_to_all_single), ("barrier", dist.barrier),
                     ("new_group", new_group), ("init_device_mesh", device_mesh),
                     ("dcp_save_load", lambda: dcp_roundtrip(False)),
                     ("dcp_async_save_load", lambda: dcp_roundtrip(True))):
        _try(res, name, fn)
        try:
            dist.barrier()
        except Exception:  # noqa: BLE001
            res.setdefault("barrier_after_" + name, traceback.format_exc(limit=1))
    queue.put((rank, res))
    dist.destroy_process_group()


NCCL_CHILD = """
import torch, torch.distributed as dist, os
dist.init_process_group('nccl')
torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
t = torch.ones(1, device='cuda')
dist.all_reduce(t)
print('NCCL_OK', float(t[0]), dist.get_world_size())
dist.destroy_process_group()
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--out", default=os.path.join("out", "gloo_probe.json"))
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    result = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0], "world": args.world}
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        procs = [ctx.Process(target=_worker, args=(r, args.world, os.path.join(tmp, "rdv"),
                                                   tmp, queue))
                 for r in range(args.world)]
        for p in procs:
            p.start()
        ranks = {}
        for _ in procs:
            try:
                r, res = queue.get(timeout=240)
                ranks[r] = res
            except Exception as e:  # noqa: BLE001
                ranks["missing"] = repr(e)
                break
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        result["gloo_on_cuda"] = ranks
        script = os.path.join(tmp, "nccl_child.py")
        with open(script, "w") as f:
            f.write(NCCL_CHILD)
        run = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                              "--nproc-per-node", "1", "--master-port", "29533", script],
                             capture_output=True, text=True, timeout=180)
        result["torchrun_nccl_1"] = {"rc": run.returncode,
                                     "out": run.stdout.strip()[-300:],
                                     "err": run.stderr.strip()[-600:]}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
