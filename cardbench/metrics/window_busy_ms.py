"""Device milliseconds of one window in the profiled stretch: the union of
device activity there over the windows it holds (each window launches the
ladder kernel once). Tracing stretches a window's wall time, not its device
time, so this stands beside ``device_idle_pct`` as the steadier reading."""


def read(record):
    prof = record["profile"]
    if not prof or not prof["ladder"] or prof["busy_s"] <= 0:
        return None
    return prof["busy_s"] * 1e3 / len(prof["ladder"])
