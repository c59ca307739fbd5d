"""Median latency from a request's send to its f + 1 reply quorum, over
every request completed in the window (host clock)."""

from cardbench import stats


def read(record):
    done = stats.completed_in(record["requests"], record["t0"], record["t1"])
    return stats.percentile(stats.latencies_ms(done), 0.50) if done else None
