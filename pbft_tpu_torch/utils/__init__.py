"""Utilities of the port: structured JSONL tracing, the metrics registry and
its consensus-phase spans, the black-box flight recorder and the schema
manifest they share (copies of the JAX package's), the request waterfall,
and the compile step (``graphs``: CUDA graphs of fixed window shapes).

The exports are ``pbft_tpu/utils/__init__.py``'s. Importing this package
imports neither torch nor numpy (``graphs`` is imported by name where it is
used).
"""

from .flight import FlightRecorder
from .metrics import (
    ConsensusSpans,
    MetricsRegistry,
    count_open_fds,
    file_size_bytes,
    read_rss_bytes,
    start_metrics_server,
)
from .trace import Tracer, get_tracer, set_trace_file

__all__ = [
    "ConsensusSpans",
    "FlightRecorder",
    "MetricsRegistry",
    "Tracer",
    "count_open_fds",
    "file_size_bytes",
    "get_tracer",
    "read_rss_bytes",
    "set_trace_file",
    "start_metrics_server",
]
