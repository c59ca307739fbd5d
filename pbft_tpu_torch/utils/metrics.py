"""Metrics registry, consensus-phase spans and the scrape server for the
replica runtime and the verify service (the port's copy of
``pbft_tpu/utils/metrics.py``, whole).

Same discipline as ``Tracer`` (trace.py): every record path is a plain
attribute check when disabled, and the enabled fast path is lock-free for
the single writer that owns the runtime (the asyncio loop in server.py; the
service updates its metrics under its dispatcher's lock). A concurrent
scrape thread reads ints and floats that are each updated atomically under
CPython's GIL, so a scrape may observe a histogram mid-update (count ahead
of sum by one observation), which Prometheus tolerates.

Metric names, types and bucket edges come from ``trace_schema.py``: a name
outside the manifest raises rather than minting an ad-hoc series.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from . import trace_schema
from .trace import Tracer


# -- process resource readers (the health document) -------------------------
#
# C++ mirror: read_rss_bytes/count_open_fds in core/net.cc. Both prefer
# /proc/self (live resident set, not the ru_maxrss high-water mark) and
# return 0 where /proc is absent — the detectors treat a zero reading as
# "no data", never as a leak baseline.

def read_rss_bytes() -> int:
    """Current resident set in bytes (/proc/self/statm field 2 x page)."""
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        try:
            import resource

            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except (ImportError, OSError):
            return 0


def count_open_fds() -> int:
    """Open file descriptors for this process (/proc/self/fd entries)."""
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return 0


def file_size_bytes(path: Optional[str]) -> int:
    """On-disk size of ``path`` (0 when unset/absent) — the WAL gauge."""
    if not path:
        return 0
    try:
        return os.stat(path).st_size
    except OSError:
        return 0


class Counter:
    __slots__ = ("name", "enabled", "value")

    def __init__(self, name: str, enabled: bool):
        self.name = name
        self.enabled = enabled
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if not self.enabled:
            return
        self.value += n


class Gauge:
    __slots__ = ("name", "enabled", "value")

    def __init__(self, name: str, enabled: bool):
        self.name = name
        self.enabled = enabled
        self.value = 0.0

    def set(self, v: float) -> None:
        if not self.enabled:
            return
        self.value = v


class Histogram:
    """Fixed-bucket histogram. ``edges`` are upper bounds (le semantics:
    an observation lands in the first bucket with v <= edge); counts has
    one extra slot for +Inf. Rendered cumulatively (Prometheus contract)."""

    __slots__ = ("name", "enabled", "edges", "counts", "sum", "count")

    def __init__(self, name: str, edges: Tuple[float, ...], enabled: bool):
        self.name = name
        self.enabled = enabled
        self.edges = tuple(edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        if not self.enabled:
            return
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1


class MetricsRegistry:
    """Holds one instance of each metric; renders Prometheus text format.

    ``labels`` are constant labels stamped on every sample (``replica``,
    so that the scrapes of a cluster and its service aggregate). Metrics
    are looked up by manifest name; unknown names raise."""

    _TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self, labels: Optional[Dict[str, str]] = None, enabled: bool = True):
        self.labels = dict(labels or {})
        self.enabled = enabled
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, want_type: str):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, self._TYPES[want_type]):
                raise KeyError(f"{name} is not a manifest {want_type}")
            return m
        mtype = trace_schema.METRIC_SCHEMAS.get(name, (None,))[0]
        if mtype != want_type:
            raise KeyError(f"{name} is not a manifest {want_type}")
        if want_type == "counter":
            m = Counter(name, self.enabled)
        elif want_type == "gauge":
            m = Gauge(name, self.enabled)
        else:
            m = Histogram(name, trace_schema.histogram_buckets(name), self.enabled)
        self._metrics[name] = m
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram")

    def preregister(self, emitter: Optional[str] = None) -> None:
        """Create every manifest metric (zero-valued) up front, so that every
        runtime exposes the same series set from its first scrape, even for
        events that have not happened yet. ``emitter`` restricts to that
        source's subset of the manifest."""
        for name, (kind, emitters) in trace_schema.METRIC_SCHEMAS.items():
            if emitter is None or emitter in emitters:
                self._get(name, kind)

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = enabled
        for m in self._metrics.values():
            m.enabled = enabled

    # -- rendering -----------------------------------------------------------

    def _label_str(self, extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in sorted(self.labels.items())]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    @staticmethod
    def _fmt(v: float) -> str:
        if isinstance(v, int) or (isinstance(v, float) and v == int(v)):
            return str(int(v))
        return repr(v)

    def render_prometheus(self) -> str:
        """Prometheus exposition text, deterministically ordered by name."""
        out = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out.append(f"# TYPE {name} counter")
                out.append(f"{name}{self._label_str()} {m.value}")
            elif isinstance(m, Gauge):
                out.append(f"# TYPE {name} gauge")
                out.append(f"{name}{self._label_str()} {self._fmt(m.value)}")
            else:
                out.append(f"# TYPE {name} histogram")
                cum = 0
                for edge, c in zip(m.edges, m.counts):
                    cum += c
                    le = 'le="%s"' % self._fmt(edge)
                    out.append(f"{name}_bucket{self._label_str(le)} {cum}")
                cum += m.counts[-1]
                inf = 'le="+Inf"'
                out.append(f"{name}_bucket{self._label_str(inf)} {cum}")
                out.append(f"{name}_sum{self._label_str()} {self._fmt(round(m.sum, 9))}")
                out.append(f"{name}_count{self._label_str()} {m.count}")
        return "\n".join(out) + "\n"


class ConsensusSpans:
    """Per-(view, seq) consensus-phase spans, fed by Replica.phase_hook.

    The replica state machine stays clock-free (its determinism is what
    makes it testable): it only reports *transitions*; this tracker stamps
    them with the runtime's monotonic clock. At the "executed" transition
    the span closes: phase latencies go to the manifest histograms and one
    ``consensus_span`` trace event carries the absolute stamps (comparable
    across processes on one host — CLOCK_MONOTONIC is per-boot), which is
    what scripts/consensus_timeline.py merges across replicas.

    Bounded: at most ``max_open`` open spans; a slot that never executes
    (view abandoned, replica crashed mid-protocol) is evicted oldest-first
    rather than leaking.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        tracer: Optional[Tracer] = None,
        replica: int = -1,
        clock: Callable[[], float] = time.monotonic,
        max_open: int = 4096,
    ):
        self.registry = registry
        self.tracer = tracer
        self.replica = replica
        self.clock = clock
        self.max_open = max_open
        self._open: "OrderedDict[Tuple[int, int], Dict[str, float]]" = OrderedDict()
        self._hists = {
            pair: registry.histogram(name)
            for pair, name in trace_schema.PHASE_HISTOGRAMS.items()
        }
        self._e2e = registry.histogram("pbft_request_reply_seconds")
        self._executed = registry.counter("pbft_executed_total")

    def on_phase(self, phase: str, view: int, seq: int) -> None:
        now = self.clock()
        key = (view, seq)
        span = self._open.get(key)
        if span is None:
            if phase == "executed":
                return  # span evicted or never opened: nothing to close
            if len(self._open) >= self.max_open:
                self._open.popitem(last=False)
            span = self._open[key] = {}
        span.setdefault(phase, now)
        if phase != "executed":
            return
        del self._open[key]
        self._executed.inc()
        for (a, b), hist in self._hists.items():
            ta, tb = span.get(a), span.get(b)
            if ta is not None and tb is not None:
                hist.observe(max(0.0, tb - ta))
        start = span.get("request", span.get("pre_prepare"))
        if start is not None:
            self._e2e.observe(max(0.0, now - start))
        if self.tracer is not None and self.tracer.enabled:
            fields = {
                p: round(t, 6) for p, t in span.items() if p in trace_schema.PHASES
            }
            self.tracer.event(
                "consensus_span", replica=self.replica, view=view, seq=seq, **fields
            )


def start_metrics_server(
    registry: MetricsRegistry,
    port: int,
    host: str = "127.0.0.1",
    status_fn: Optional[Callable[[], dict]] = None,
) -> ThreadingHTTPServer:
    """Serve ``registry`` as Prometheus text on ``/metrics`` (any path:
    scrapers vary) from a daemon thread. Returns the HTTPServer; the bound
    port is ``server.server_address[1]`` (useful with port=0). A port that
    cannot be bound raises here.

    With ``status_fn``, GET /status serves its dict as JSON. It runs on the
    scrape thread, so it must only read state that is safe to read from
    another thread."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server contract
            if status_fn is not None and self.path.startswith("/status"):
                body = json.dumps(status_fn()).encode()
                ctype = "application/json"
            else:
                body = registry.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapes must not spam stdout
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
