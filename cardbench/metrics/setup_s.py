"""Seconds from the process's start to the first timed request: the
daemon's build check and warm, the cluster's start, the client processes,
the warm-up request and the ramp of load (host clock)."""


def read(record):
    return record["setup_s"]
