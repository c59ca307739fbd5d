"""The schema manifest of what the port's verify service emits: its trace
events and its Prometheus metrics (the port's copy of the service's part of
``pbft_tpu/utils/trace_schema.py``).

The entries are the JAX manifest's, emitter sets included, so that a
scrape of the port's daemon and one of the JAX daemon (or of a ``pbftd``
replica, ``net.cc``) aggregate under the same names and bucket edges.
``tests/test_torch_surface.py`` pins them equal to the JAX manifest, and
pins this subset to be exactly the entries whose emitters include
``service.py`` (events) or ``service.py``/``verify_service.py`` (metrics).

Event schema entries:
    required  fields every event of this name must carry
    optional  fields an emitter may add
    emitters  the source files allowed to emit this event name
"""

from __future__ import annotations

# -- trace events (JSONL lines: {"ts": .., "ev": <name>, ...fields}) --------

EVENT_SCHEMAS = {
    "verify_batch": {
        "required": {"ts", "ev", "replica", "size", "rejected", "secs"},
        "optional": {"view", "executed", "requests"},
        "emitters": {"server.py", "service.py", "net.cc"},
    },
    "verify_window_failed": {
        "required": {"ts", "ev", "replica", "size", "requests", "rejected", "secs"},
        "optional": set(),
        "emitters": {"service.py"},
    },
    "verify_batch_error": {
        "required": {"ts", "ev", "replica", "size", "secs"},
        "optional": set(),
        "emitters": {"service.py"},
    },
}

# -- metrics (Prometheus text format at --metrics-port) ---------------------
#
# name -> (type, emitters). The service (service.py) emits the verify
# subset of the replica runtimes' set; the daemon (verify_service.py) adds
# the warm and cold compile gauges: the once-per-deploy startup cost (cold =
# kernel build, priming runs and graph captures; warm = reloads, 0 for the
# port, whose CUDA graphs are not serialized).

METRIC_SCHEMAS = {
    "pbft_verify_batches_total": ("counter", {"server.py", "service.py", "net.cc"}),
    "pbft_verify_items_total": ("counter", {"server.py", "service.py", "net.cc"}),
    "pbft_verify_rejected_total": ("counter", {"server.py", "service.py", "net.cc"}),
    "pbft_verify_queue_depth": ("gauge", {"server.py", "service.py", "net.cc"}),
    "pbft_verify_inflight_age_seconds": ("gauge", {"server.py", "service.py", "net.cc"}),
    # Launches the coalescing dispatcher shipped, items per launch window,
    # and how many client connections each merged window carried.
    "pbft_verify_service_launches_total": ("counter", {"service.py", "net.cc"}),
    "pbft_verify_service_window_size": ("histogram", {"service.py", "net.cc"}),
    "pbft_verify_service_coalesced_clients": ("histogram", {"service.py", "net.cc"}),
    "pbft_verify_service_cold_compile_seconds": ("gauge", {"verify_service.py", "net.cc"}),
    "pbft_verify_service_warm_compile_seconds": ("gauge", {"verify_service.py", "net.cc"}),
    "pbft_verify_batch_size": ("histogram", {"server.py", "service.py", "net.cc"}),
    "pbft_verify_seconds": ("histogram", {"server.py", "service.py", "net.cc"}),
}

# Fixed histogram bucket upper edges (le semantics: v <= edge), shared with
# every runtime.
LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def histogram_buckets(name: str):
    """The fixed bucket edges for a manifest histogram."""
    if METRIC_SCHEMAS[name][0] != "histogram":
        raise ValueError(f"{name} is not a histogram")
    if name in (
        "pbft_verify_batch_size",
        "pbft_verify_service_window_size",
        "pbft_verify_service_coalesced_clients",
    ):
        return BATCH_SIZE_BUCKETS
    return LATENCY_BUCKETS_S
