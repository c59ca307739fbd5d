"""Mean host-clock milliseconds of the engine's call per window: the
service trace's ``verify_batch`` ``secs`` of the windows that ended inside
the timed window, summed, over their count."""


def read(record):
    secs = [e["secs"] for e in record["service_trace"]
            if e.get("ev") == "verify_batch" and record["t0"] <= e["ts"] < record["t1"]]
    return sum(secs) / len(secs) * 1e3 if secs else None
