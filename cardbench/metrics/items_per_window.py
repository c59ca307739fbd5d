"""Signature triples per launch window of the verify service: the window's
change in the daemon's ``items`` over its change in ``launches``."""

from cardbench import stats


def read(record):
    before, after = record["before"]["service"], record["after"]["service"]
    launches = stats.delta(after, before, "launches")
    return stats.delta(after, before, "items") / launches if launches else None
