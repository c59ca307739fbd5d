"""The time limit that the repo-root conftest.py puts on each test phase."""

import asyncio
import signal
import time

import pytest

from _time_limit import LIMIT_S, TestTimeLimitExceeded, time_limit


def _sleep():
    time.sleep(5)


def _await_what_nothing_sets():
    # The shape of a server's stop() that hangs: an await that nothing wakes.
    async def wait():
        await asyncio.Event().wait()

    asyncio.run(wait())


def _sleep_under_except_exception():
    try:
        time.sleep(5)
    except Exception:
        pass


def _hang_again_in_clean_up():
    try:
        time.sleep(5)
    finally:
        time.sleep(5)


def _raises_at_the_limit(hang):
    t0 = time.monotonic()
    with pytest.raises(TestTimeLimitExceeded, match="time limit of 1 s"):
        with time_limit(1):
            hang()
    assert time.monotonic() - t0 < 3


def test_sleep_past_the_limit_raises():
    _raises_at_the_limit(_sleep)


def test_await_that_nothing_wakes_raises():
    _raises_at_the_limit(_await_what_nothing_sets)


def test_except_exception_does_not_swallow_the_raise():
    _raises_at_the_limit(_sleep_under_except_exception)


def test_a_clean_up_that_hangs_again_is_raised_in_again():
    _raises_at_the_limit(_hang_again_in_clean_up)


def test_inner_limit_keeps_the_per_test_limit():
    handler = signal.getsignal(signal.SIGALRM)
    for hang in (_sleep, _await_what_nothing_sets):
        _raises_at_the_limit(hang)
        assert signal.getsignal(signal.SIGALRM) is handler
        left, _ = signal.getitimer(signal.ITIMER_REAL)
        # The per-test timer still runs: not disarmed, and not the 1 s one.
        assert 1 < left < LIMIT_S
