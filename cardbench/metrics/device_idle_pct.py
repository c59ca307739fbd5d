"""The share of the profiled stretch's wall time in which no operation ran
on the card: one minus the union of device activity over the stretch, in
percent (``torch.profiler``, CUDA activities)."""


def read(record):
    prof = record["profile"]
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
