"""Window and percentile arithmetic of the yardstick.

The percentile is the protocol harness's nearest rank (``bench/harness.py``
``_pct``): the value at index ``int(q * n)`` of the sorted sample, capped at
the last. A request counts in the window when its reply quorum arrived
inside it, wherever it was sent.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    return vals[min(len(vals) - 1, int(q * len(vals)))]


def completed_in(records: Iterable[dict], t0: float, t1: float) -> List[dict]:
    """The records whose ``quorum`` stamp lies in [t0, t1)."""
    return [r for r in records if r.get("quorum") is not None and t0 <= r["quorum"] < t1]


def latencies_ms(records: Iterable[dict]) -> List[float]:
    return [(r["quorum"] - r["send"]) * 1e3 for r in records]


def delta(after: dict, before: dict, key: str) -> float:
    return after.get(key, 0) - before.get(key, 0)

