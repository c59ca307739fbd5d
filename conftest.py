"""Give each phase of every test not marked ``slow`` its own time limit
(``tests/_time_limit.py``).

pytest loads this file for every test below the rootdir. Arming the limit per
phase keeps its raise inside pytest's capture of that phase, so a hang is
reported as that test's failure or error. The ``slow`` tier is left out: its
tests are the ones allowed to take longer.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))

from _time_limit import LIMIT_S, time_limit


@pytest.hookimpl(hookwrapper=True)
def _phase_under_limit(item):
    if item.get_closest_marker("slow"):
        yield
        return
    with time_limit(LIMIT_S):
        yield


pytest_runtest_setup = pytest_runtest_call = pytest_runtest_teardown = _phase_under_limit
