"""The launcher's result transport (parallel/launch.py): a group's results
are read whole after every process of the group has exited."""
import time

import torch

from tal_asrd_tpu_torch.parallel.launch import start_group


def rank_tensor(rank, device, spec):
    return torch.full((spec["n"],), float(rank))


def test_results_are_read_after_every_process_exited():
    group = start_group(rank_tensor, 2, {"n": 3}, timeout=120)
    deadline = time.monotonic() + 120
    while any(p.exitcode is None for p in group.procs) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert [p.exitcode for p in group.procs] == [0, 0]
    assert [r.tolist() for r in group.wait()] == [[0.0] * 3, [1.0] * 3]
