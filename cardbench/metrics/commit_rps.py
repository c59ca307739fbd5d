"""Requests whose f + 1 reply quorum arrived inside the window, over the
window's seconds (host clock)."""

from cardbench import stats


def read(record):
    done = stats.completed_in(record["requests"], record["t0"], record["t1"])
    return len(done) / record["seconds"]
