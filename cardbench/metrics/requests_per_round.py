"""Requests per three-phase round at the primary (an honest replica):
the window's change in its ``executed`` over its change in
``rounds_executed``, from its ``/status``."""

from cardbench import stats


def read(record):
    primary = 0
    before, after = record["before"]["replicas"][primary], record["after"]["replicas"][primary]
    rounds = stats.delta(after, before, "rounds_executed")
    return stats.delta(after, before, "executed") / rounds if rounds else None
