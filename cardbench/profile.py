"""The traced run's profiled stretch: ``torch.profiler`` (CPU and CUDA
activities) over ``STRETCH_WINDOWS`` whole windows of the cell's load, in the
process that owns the card, exported as a Chrome trace and reduced here to
what the per-layer readers and the ``breakdown`` need.

The stretch follows the timed window under the same load, so that neither
the profiler's cost (CUPTI stretches a window's wall time two- to fourfold)
nor its stop, which holds launches back for some tenths of a second a
window, falls inside the window. Nor is the profiler started before the
window (its first start takes seconds, ``START_S``): the window's own
windows run as in an untraced run. A replayed window is some 21,000 device
activities and 20 MB of trace; ``STRETCH_MAX_S`` caps a stretch whose
windows come slowly. The trace file is deleted once read. The caller starts
and stops the stretch while no window is in flight
(``deploy.Recorder.quiet``). Should the profiler hang all the same, every
thread's stack goes to standard error after ``HANG_S``.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import time
from typing import Dict, List, Optional

STRETCH_WINDOWS = 24
STRETCH_MAX_S = 8.0
START_S = 15.0
HANG_S = 120
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # PyTorch's elementwise kernels have names of 300 characters and more
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation", "python_function")


class Stretch:
    def __init__(self, trace_path: str):
        self.trace_path = trace_path
        self.prof = None
        self.wall_s = self.stop_s = self.export_s = 0.0
        self._t0 = 0.0
        self.mono0 = self.mono1 = 0.0

    @staticmethod
    def _profiler():
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        return torch.profiler.profile(activities=acts)

    def start(self) -> None:
        faulthandler.dump_traceback_later(HANG_S, repeat=True, file=sys.stderr)
        self.prof = self._profiler()
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        self.mono0 = time.monotonic()

    def stop(self) -> None:
        self.wall_s = time.perf_counter() - self._t0
        self.mono1 = time.monotonic()
        self.prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - self._t0 - self.wall_s
        faulthandler.cancel_dump_traceback_later()

    def reduce(self) -> dict:
        """Exports the stopped stretch, reads it back and reduces it."""
        t = time.perf_counter()
        self.prof.export_chrome_trace(self.trace_path)
        self.prof = None
        self.export_s = time.perf_counter() - t
        t = time.perf_counter()
        size = os.path.getsize(self.trace_path)
        with open(self.trace_path) as fh:
            trace = json.load(fh)
        os.unlink(self.trace_path)
        load_s = time.perf_counter() - t
        out = reduce_events(trace.get("traceEvents", []), self.wall_s)
        out["costs"] = {"stop_s": self.stop_s, "export_s": self.export_s, "trace_bytes": size, "load_s": load_s,
                        "reduce_s": time.perf_counter() - t - load_s}
        return out


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def reduce_events(events: List[dict], wall_s: float) -> dict:
    """Busy seconds (the union of device activity), the stretch's wall
    seconds, time by device operation, the longest idle gaps named by the
    host call under their midpoint, and each ``ladder_kernel`` launch's grid
    and seconds. Times in the trace are microseconds."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    if not device:
        return {"busy_s": 0.0, "window_s": wall_s, "device_ops": [], "idle_gaps": [], "ladder": [], "activities": 0}
    spans = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in device])
    busy_us = sum(b - a for a, b in spans)
    by_name: Dict[str, float] = {}
    for e in device:
        name = e["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + float(e.get("dur", 0)) / 1e6
    gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1], spans[i + 1][0]) for i in range(len(spans) - 1)),
                  reverse=True)[:10]
    host_sorted = sorted(host, key=lambda e: float(e["ts"]))

    def under(mid: float) -> str:
        best: Optional[dict] = None
        for e in host_sorted:
            a = float(e["ts"])
            if a > mid:
                break
            if a + float(e.get("dur", 0)) >= mid and (best is None or float(e.get("dur", 0)) < float(best.get("dur", 0))):
                best = e
        return f"host: {best['name'][:NAME_CHARS]}" if best is not None else "host: no traced call (Python, waiting for a window)"

    ladder = []
    for e in device:
        if "ladder_kernel" in e["name"]:
            grid = (e.get("args") or {}).get("grid")
            ladder.append({"grid": grid, "s": float(e.get("dur", 0)) / 1e6})
    return {
        "busy_s": busy_us / 1e6,
        "window_s": wall_s,
        "activities": len(device),
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[under((a + b) / 2), g / 1e6] for g, a, b in gaps],
        "ladder": ladder,
    }
