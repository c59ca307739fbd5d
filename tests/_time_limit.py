"""A time limit on a block of code, raised by SIGALRM in the main thread.

The repo-root ``conftest.py`` runs each phase of every test not marked
``slow`` under ``time_limit(LIMIT_S)``, so a test that hangs fails at its
limit and the run goes on to the next test.
"""

import contextlib
import signal
import threading
import time

# Well above the longest tier-1 test (65.69 s on an 8-core CPU host). A test
# that needs more is slow, and is no reason for a setting.
LIMIT_S = 300


class TestTimeLimitExceeded(BaseException):
    """Raised in the main thread when a time limit runs out. A
    ``BaseException``, as pytest's own outcomes are, so that code catching
    ``Exception`` cannot swallow it."""

    __test__ = False  # an exception, not a test class for pytest to collect


@contextlib.contextmanager
def time_limit(seconds):
    """Raise ``TestTimeLimitExceeded`` if the block runs past ``seconds``,
    and again every ``seconds`` after that until the block ends, so that a
    block which swallows the raise or hangs again in its clean-up still ends.

    Off the main thread, where no signal handler can be set, it does nothing.
    On exit it restores the earlier SIGALRM handler and re-arms the earlier
    timer with what is left of it, so a nested limit keeps the outer one.
    """
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _expire(signum, frame):
        raise TestTimeLimitExceeded(f"ran past its time limit of {seconds} s")

    handler = signal.signal(signal.SIGALRM, _expire)
    start = time.monotonic()
    delay, interval = signal.setitimer(signal.ITIMER_REAL, seconds, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, handler)
        if delay:
            left = delay - (time.monotonic() - start)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-6), interval)
