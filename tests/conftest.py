"""Settings and hooks for every test process of the suite under tests/.

The root conftest.py, loaded first, sets up JAX; it imports no PyTorch, so
the thread budget below is still in time for torch's first import.

Thread budget: each test process gets its share of the cores for PyTorch
(`pytest -n` sets PYTEST_XDIST_WORKER_COUNT before a worker loads this file;
a run without -n keeps every core). PyTorch's intra-op pools otherwise take
every core in each worker, and on these tests' tiny tensors the
oversubscribed threads run many times slower. OMP_NUM_THREADS is set before
torch is imported, so the processes the tests spawn (gloo groups, CLIs)
inherit the budget.

Time limit: every test, its fixtures included, runs under TIME_LIMIT, so
that a hang fails one named test instead of cutting the whole run.
"""
import contextlib
import faulthandler
import os
import signal
import sys
import tempfile
import threading
import time
import zlib

import pytest

THREADS = max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
os.environ["OMP_NUM_THREADS"] = str(THREADS)

import torch  # noqa: E402

torch.set_num_threads(THREADS)

# Seconds a test may take, its fixtures included: about 3x the slowest test
# (54 s, the module fixture of tests/test_torch_parallel_train.py) under
# `pytest -n 6 --dist loadfile` on 8 cores with JAX's compilation cache empty.
# One test runs past it: test_stacked_batch_blocks_and_w8, the JAX all-layers
# Pallas kernel in interpret mode, still running after 45 minutes.
TIME_LIMIT = 180
# Seconds past a limit before every thread's stack is dumped and the process
# ends: a hang in native code (a collective, a blocked op) never hands control
# back to the interpreter, so the TimeoutError of the limit cannot reach it.
GRACE = 30

_limits = []  # (deadline, seconds, file) of each limit in force, innermost last


def _arm():
    on_main = threading.current_thread() is threading.main_thread()
    if not _limits:
        faulthandler.cancel_dump_traceback_later()
        if on_main:
            signal.setitimer(signal.ITIMER_REAL, 0)
        return
    deadline, _, file = _limits[-1]
    left = max(deadline - time.monotonic(), 1e-3)
    faulthandler.dump_traceback_later(left + GRACE, exit=True, file=file)
    if on_main:
        signal.setitimer(signal.ITIMER_REAL, left)


def _expire(signum, frame):
    raise TimeoutError(f"the test ran past its time limit of {_limits[-1][1]} s")


@contextlib.contextmanager
def time_limit(seconds, file=None):
    """Runs the body under a limit of `seconds`. Past it, where the body runs
    on the main thread, a TimeoutError naming the limit is raised in it;
    GRACE seconds later every thread's stack is dumped to `file` (stderr by
    default) and the process exits. Limits nest: an inner one ends no later
    than the one around it, which is in force again once the inner ends."""
    entry = (time.monotonic() + seconds, seconds, sys.stderr if file is None else file)
    _limits.append(min(entry, _limits[-1], key=lambda e: e[0]) if _limits else entry)
    on_main = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGALRM, _expire) if on_main else None
    _arm()
    try:
        yield
    finally:
        _limits.pop()
        _arm()
        if on_main:
            signal.signal(signal.SIGALRM, previous)


STDERR = pytest.StashKey[int]()


def pytest_configure(config):
    # stderr itself, not the capture that takes it over during a test: the
    # dump of a test that never returns still reaches the log
    config.stash[STDERR] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[STDERR])


ENDED = pytest.StashKey[bool]()


def _ended_mark(item):
    """The file that says this test ended a worker of this xdist run, or None
    outside xdist. A test that ran on past GRACE ends its worker, and
    `--dist loadfile` gives it again to the worker that replaces it."""
    run = getattr(item.config, "workerinput", {}).get("testrunuid")
    return run and os.path.join(tempfile.gettempdir(),
                                f"ended-a-worker-{run}-{zlib.crc32(item.nodeid.encode()):08x}")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    mark = _ended_mark(item)
    item.stash[ENDED] = bool(mark) and os.path.exists(mark)
    if mark:
        open(mark, "w").close()
    with time_limit(TIME_LIMIT, item.config.stash[STDERR]):
        result = yield
    if mark:
        os.remove(mark)
    return result


def pytest_runtest_setup(item):
    if item.stash.get(ENDED, False):
        pytest.fail(f"not run again: it ran {GRACE} s past its time limit of {TIME_LIMIT} s "
                    "and ended its worker")
