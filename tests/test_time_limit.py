"""The per-test time limit of tests/conftest.py, through its helper."""
import signal
import time

import pytest

from tests.conftest import TIME_LIMIT, time_limit


def test_a_body_past_the_limit_fails_naming_it():
    with pytest.raises(TimeoutError, match="time limit of 1 s"):
        with time_limit(1):
            time.sleep(10)


def test_a_body_within_the_limit_passes():
    with time_limit(1):
        time.sleep(0.01)


def test_the_test_s_own_limit_is_in_force_again_after_a_nested_one():
    with time_limit(1):
        pass
    assert 1 < signal.getitimer(signal.ITIMER_REAL)[0] <= TIME_LIMIT
