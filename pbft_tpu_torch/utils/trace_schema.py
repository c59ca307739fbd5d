"""The schema manifest for trace events and metrics (the port's copy of
``pbft_tpu/utils/trace_schema.py``, whole).

Every runtime (the asyncio replica ``net/server.py``, the verify service
``net/service.py`` and ``net/verify_service.py``, the gateway, and
``core/net.cc`` in C++) emits JSONL trace events and Prometheus metrics
whose names and field sets must stay identical, or a mixed-runtime
cluster's traces stop merging and its scrapes stop aggregating. This
module is the contract. Its entries are the JAX manifest's, emitter sets
included (``tests/test_torch_server.py`` pins them equal), so that a
cluster of the port's replicas, the JAX package's and ``pbftd`` scrapes
under the same names and bucket edges. The verify service registers only
the entries whose emitters name it.

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
    "view_change_start": {
        "required": {"ts", "ev", "replica", "pending_view", "backoff"},
        "optional": set(),
        "emitters": {"server.py", "net.cc"},
    },
    # One span per executed (view, seq): absolute monotonic stamps for each
    # consensus phase this replica observed. "request" is primary-only (a
    # backup's first sighting is the pre-prepare); stamps are comparable
    # across processes on one host (CLOCK_MONOTONIC is per-boot).
    "consensus_span": {
        "required": {"ts", "ev", "replica", "view", "seq", "pre_prepare", "executed"},
        "optional": {"request", "prepared", "committed"},
        "emitters": {"server.py", "net.cc"},
    },
    # The wedged-async-verifier bound (ADVICE.md core/net.cc item): the
    # inflight launch overran its deadline, the connection was dropped and
    # the batch re-verified on the CPU safety net.
    "verify_deadline_fired": {
        "required": {"ts", "ev", "replica", "size", "age_secs"},
        "optional": set(),
        "emitters": {"net.cc"},
    },
    # -- request-level latency waterfall --------------------------
    #
    # Requests are uniquely keyed by (client, req_ts) and batches by
    # (view, seq); batch_sealed carries the [client, req_ts] pairs it
    # sealed, so client-side send/recv stamps join to replica-side
    # consensus spans purely in post-processing — zero wire changes
    # (scripts/consensus_timeline.py --waterfall).
    "request_rx": {
        "required": {"ts", "ev", "replica", "client", "req_ts"},
        "optional": set(),
        "emitters": {"server.py", "net.cc"},
    },
    # The primary sealed its open batch under a sequence number. wait_s is
    # how long the first request sat in the open batch (the "batch wait"
    # waterfall segment); reqs is the ordered [[client, req_ts], ...] join
    # key list.
    "batch_sealed": {
        "required": {"ts", "ev", "replica", "view", "seq", "batch", "wait_s"},
        "optional": {"reqs"},
        "emitters": {"server.py", "net.cc"},
    },
    "reply_tx": {
        "required": {"ts", "ev", "replica", "client", "req_ts", "view"},
        "optional": set(),
        "emitters": {"server.py", "net.cc"},
    },
    # -- view-change spans ---------------------------------
    #
    # view_timer_fired (the runtime's progress timer expired) ->
    # view_change_sent (the replica broadcast VIEW-CHANGE toward
    # pending_view) -> new_view_installed (it entered the view). Ordering
    # is machine-checked by consensus_timeline.py --check-invariants
    # (consensus/invariants.py check_view_events).
    "view_timer_fired": {
        "required": {"ts", "ev", "replica", "view", "backoff"},
        "optional": set(),
        "emitters": {"server.py", "net.cc"},
    },
    "view_change_sent": {
        "required": {"ts", "ev", "replica", "pending_view"},
        "optional": set(),
        "emitters": {"server.py", "net.cc"},
    },
    "new_view_installed": {
        "required": {"ts", "ev", "replica", "view"},
        "optional": set(),
        "emitters": {"server.py", "net.cc"},
    },
    # Client-side half of the waterfall (net/client.py write_trace): send /
    # first-reply / f+1-quorum monotonic stamps per (client, req_ts).
    # Comparable to replica stamps on one host (CLOCK_MONOTONIC).
    # "overloaded" counts explicit admission-control rejections the client
    # absorbed for this request — distinct from silent timeouts.
    "client_request": {
        "required": {"ts", "ev", "client", "req_ts", "send"},
        "optional": {"first_reply", "quorum", "overloaded"},
        "emitters": {"client.py"},
    },
}

# -- metrics (Prometheus text format at --metrics-port) ---------------------
#
# name -> (type, emitters). Replica runtimes (server.py, net.cc) must emit
# the full replica set with IDENTICAL names so a mixed-runtime cluster
# scrapes uniformly; the verifier service emits the verify subset.

METRIC_SCHEMAS = {
    "pbft_frames_in_total": ("counter", {"server.py", "net.cc"}),
    "pbft_executed_total": ("counter", {"server.py", "net.cc"}),
    "pbft_view_changes_total": ("counter", {"server.py", "net.cc"}),
    "pbft_verify_batches_total": ("counter", {"server.py", "service.py", "net.cc"}),
    "pbft_verify_items_total": ("counter", {"server.py", "service.py", "net.cc"}),
    "pbft_verify_rejected_total": ("counter", {"server.py", "service.py", "net.cc"}),
    "pbft_verify_deadline_fired_total": ("counter", {"net.cc"}),
    "pbft_verify_queue_depth": ("gauge", {"server.py", "service.py", "net.cc"}),
    "pbft_verify_inflight_age_seconds": ("gauge", {"server.py", "service.py", "net.cc"}),
    # Native verify-pool surface (core/verify_pool.cc): pool width, windows
    # queued by the last dispatch, lifetime busy/(wall*threads) ratio, and
    # the per-dispatch RLC window width. C++ runtime only — the Python
    # replica verifies its windows in-process or on a verify service.
    "pbft_verify_pool_threads": ("gauge", {"net.cc"}),
    "pbft_verify_pool_queue_depth": ("gauge", {"net.cc"}),
    "pbft_verify_pool_utilization": ("gauge", {"net.cc"}),
    "pbft_verify_pool_window_size": ("histogram", {"net.cc"}),
    # Wire-codec surface: outbound frames per payload codec,
    # plus the serialize-once invariant counter — encodes are counted per
    # BROADCAST (lazy, at most once per codec), never per peer, so in a
    # single-codec cluster pbft_broadcast_encodes_total tracks the
    # broadcast count instead of broadcasts x peers.
    "pbft_codec_binary_frames_total": ("counter", {"server.py", "net.cc"}),
    "pbft_codec_json_frames_total": ("counter", {"server.py", "net.cc"}),
    "pbft_broadcast_encodes_total": ("counter", {"server.py", "net.cc"}),
    # Batching surface: requests executed vs three-phase
    # instances executed (their ratio is the batch amplification), and
    # the per-accepted-pre-prepare batch occupancy histogram. Note
    # pbft_executed_total counts per SEQUENCE (span closes), so it tracks
    # pbft_consensus_rounds_total, not requests.
    "pbft_requests_executed_total": ("counter", {"server.py", "net.cc"}),
    "pbft_consensus_rounds_total": ("counter", {"server.py", "net.cc"}),
    # Chaos/fault-injection surface: behaviors the --fault mode
    # actually fired (corrupted signatures, equivocating pre-prepares,
    # muted sends, stutter replays) and outbound frames the seeded
    # --chaos-drop-pct link dropped. Both zero on a healthy replica — a
    # nonzero value in production is an alarm, in a chaos test it is the
    # proof the injection ran.
    "pbft_faults_injected_total": ("counter", {"server.py", "net.cc"}),
    "pbft_chaos_dropped_total": ("counter", {"server.py", "net.cc"}),
    # Persistent verify-service surface: windows (launches) the
    # coalescing dispatcher actually shipped, items per launch window,
    # and how many client connections each merged window carried. The
    # warm/cold compile gauges record the once-per-deploy startup cost
    # (cold = traced+compiled shapes, warm = serialized-executable or
    # cache reloads) so the bench can report it OUTSIDE the timed
    # region. Registered in core/metrics.cc too (eager registration:
    # every runtime exposes the same series set, zero-valued where the
    # lifecycle can't happen).
    "pbft_verify_service_launches_total": (
        "counter",
        {"service.py", "net.cc"},
    ),
    "pbft_verify_service_window_size": (
        "histogram",
        {"service.py", "net.cc"},
    ),
    "pbft_verify_service_coalesced_clients": (
        "histogram",
        {"service.py", "net.cc"},
    ),
    "pbft_verify_service_cold_compile_seconds": (
        "gauge",
        {"verify_service.py", "net.cc"},
    ),
    "pbft_verify_service_warm_compile_seconds": (
        "gauge",
        {"verify_service.py", "net.cc"},
    ),
    # Scale-out surface. Replica side: live sockets, event-loop
    # readiness wakeups (epoll_wait/poll returns in C++; stream read
    # completions in asyncio), bounded-outbound drops + partial-write
    # backpressure episodes, and client requests received over gateway
    # links. Gateway side (net/gateway.py): downstream client
    # connections open and requests forwarded upstream — the tier's
    # multiplexing ratio is gateway_clients_open vs the replicas'
    # connections_open.
    "pbft_connections_open": ("gauge", {"server.py", "net.cc"}),
    "pbft_epoll_wakeups_total": ("counter", {"server.py", "net.cc"}),
    "pbft_write_backpressure_events_total": (
        "counter",
        {"server.py", "net.cc", "gateway.py"},
    ),
    "pbft_gateway_clients_open": ("gauge", {"gateway.py"}),
    "pbft_gateway_forwarded_total": (
        "counter",
        {"gateway.py", "server.py", "net.cc"},
    ),
    # Perf-under-faults surface. Backoff level: the view
    # timer's current exponential multiplier (1 = fresh, doubles per
    # consecutive no-progress expiry, §4.5.2) — a sustained high level is
    # a cluster failing to converge. Overload rejections: client requests
    # answered with an explicit {"type":"overloaded"} instead of being
    # queued into the tail (admission control: per-client in-flight caps
    # + the global backlog watermark; gateway and both replica runtimes).
    # Gateway failovers: a gateway-fabric link had to be replaced — a
    # client failing over to another gateway (GatewayClient), a gateway
    # re-dialing a dead replica link (ClientGateway), or a replica losing
    # a live gateway link (both runtimes).
    "pbft_view_timer_backoff_level": ("gauge", {"server.py", "net.cc"}),
    # Multi-core surface. Loop threads: event-loop shards the
    # replica runs (pbftd net_threads; always 1 on the single-loop
    # asyncio runtime). Offload depth: aggregate occupancy of the
    # per-shard crypto-pipeline queues (AEAD seal/open + codec work held
    # off the loop threads). Cross-thread wakes: eventfd/pipe wakes
    # crossing the loop-shard / crypto-pipeline / consensus boundaries —
    # the handoff cost the sharding pays for its parallelism. The asyncio
    # runtime emits the latter two as zeros for series-set parity.
    "pbft_net_loop_threads": ("gauge", {"server.py", "net.cc"}),
    "pbft_crypto_offload_queue_depth": ("gauge", {"server.py", "net.cc"}),
    "pbft_cross_thread_wakes_total": ("counter", {"server.py", "net.cc"}),
    "pbft_overload_rejections_total": (
        "counter",
        {"gateway.py", "server.py", "net.cc"},
    ),
    "pbft_gateway_failovers_total": (
        "counter",
        {"gateway.py", "server.py", "net.cc"},
    ),
    # Fast-path surface (protocol 1.3.0). MAC frames: outbound
    # normal-case frames authenticated by a per-link session-MAC vector
    # instead of hot-path signature verification (zero in signature mode
    # and against pre-1.3.0 peers). Tentative executions: sequences
    # executed at PREPARED (one commit round-trip early); rollbacks:
    # tentative sequences undone by a view change / certified-checkpoint
    # catch-up — nonzero rollbacks with zero client-visible divergence is
    # exactly the §5.3 story the chaos matrix checks.
    "pbft_mac_frames_total": ("counter", {"server.py", "net.cc"}),
    "pbft_tentative_executions_total": ("counter", {"server.py", "net.cc"}),
    "pbft_tentative_rollbacks_total": ("counter", {"server.py", "net.cc"}),
    # Durable-recovery surface. WAL appends: records written
    # to the write-ahead log (votes, view transitions, stable
    # checkpoints); fsyncs: group-commit fsync syscalls (one per emit
    # boundary with pending records — NOT one per message; zero with
    # wal_fsync off); bytes: file bytes written (appends + compactions).
    # Recovery seconds: wall time of the last WAL replay + state
    # reinstall (gauge; 0 = this life started fresh).
    "pbft_wal_appends_total": ("counter", {"server.py", "net.cc"}),
    "pbft_wal_fsyncs_total": ("counter", {"server.py", "net.cc"}),
    "pbft_wal_bytes_total": ("counter", {"server.py", "net.cc"}),
    "pbft_recovery_seconds": ("gauge", {"server.py", "net.cc"}),
    # Health-introspection surface. Resource gauges a soak can
    # gate flat: resident set (/proc/self/statm x page size), open file
    # descriptors (/proc/self/fd entries), and the WAL file's on-disk
    # byte size (0 with WAL off). Progress gauges a stall detector can
    # watch: seconds since executed_upto last advanced (as observed at
    # scrape/refresh time) and the verify-inbox depth. All five refresh
    # lazily when the status/metrics surface is rendered — a dead-idle
    # replica pays nothing for them.
    "pbft_process_rss_bytes": ("gauge", {"server.py", "net.cc"}),
    "pbft_open_fds": ("gauge", {"server.py", "net.cc"}),
    "pbft_wal_disk_bytes": ("gauge", {"server.py", "net.cc"}),
    "pbft_last_progress_seconds": ("gauge", {"server.py", "net.cc"}),
    "pbft_inbox_depth": ("gauge", {"server.py", "net.cc"}),
    "pbft_batch_size": ("histogram", {"server.py", "net.cc"}),
    "pbft_verify_batch_size": ("histogram", {"server.py", "service.py", "net.cc"}),
    "pbft_verify_seconds": ("histogram", {"server.py", "service.py", "net.cc"}),
    "pbft_phase_pre_prepare_seconds": ("histogram", {"server.py", "net.cc"}),
    "pbft_phase_prepare_seconds": ("histogram", {"server.py", "net.cc"}),
    "pbft_phase_commit_seconds": ("histogram", {"server.py", "net.cc"}),
    "pbft_phase_reply_seconds": ("histogram", {"server.py", "net.cc"}),
    "pbft_request_reply_seconds": ("histogram", {"server.py", "net.cc"}),
}

# Fixed histogram bucket upper edges (le semantics: v <= edge). Shared by
# both runtimes — core/metrics.cc mirrors these values; the lint compares.
LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# The consensus phases in protocol order. "request" exists only on the
# primary (it assigns the sequence number); every replica sees the rest.
PHASES = ("request", "pre_prepare", "prepared", "committed", "executed")

# -- black-box flight recorder -------------------------------------
#
# Both runtimes keep a fixed-size ring of compact binary records
# (core/flight.{h,cc} lock-free atomics; utils/flight.py a
# bounded deque) dumped to a file on SIGTERM/fatal/invariant-failure and
# decoded by scripts/flight_dump.py. The on-disk format is shared:
#
#   header  FLIGHT_MAGIC (8B) + u32le version + u32le record count
#   record  u64le t_ns, u16le event id, i16le peer, i32le view, i32le seq
#
# Event ids are the cross-runtime contract below; core/flight.h mirrors
# them (enum FlightEvent). The "request" consensus phase records as
# batch_sealed (the primary's sequence assignment IS the seal).
FLIGHT_MAGIC = b"PBFTBBX1"
FLIGHT_VERSION = 1
FLIGHT_RECORD_SIZE = 20
FLIGHT_EVENTS = {
    1: "request_rx",
    2: "batch_sealed",
    3: "pre_prepare",
    4: "prepared",
    5: "committed",
    6: "executed",
    7: "reply_tx",
    8: "view_timer_fired",
    9: "view_change_sent",
    10: "new_view_installed",
    11: "verify_batch",
    # Perf-under-faults coverage: the view timer's backoff
    # level changed (seq = new level), a client request was answered with
    # an explicit overload rejection (seq = request timestamp), and a
    # gateway-fabric link was replaced (peer = replica id / gateway index
    # where meaningful).
    12: "backoff_level",
    13: "overload_rejected",
    14: "gateway_failover",
    # Fast-path coverage: a reply left at PREPARED (seq = the
    # request timestamp), and a tentative-suffix rollback on view change
    # / certified-checkpoint catch-up (seq = sequences rolled back).
    15: "tentative_reply",
    16: "tentative_rollback",
    # Durable recovery: WAL replay began (view = persisted
    # view, seq = the stable-checkpoint floor) and recovery finished
    # (seq = the recovered executed_upto). core/flight.h mirrors the ids.
    17: "recovery_started",
    18: "recovery_complete",
}
FLIGHT_EVENT_IDS = {name: i for i, name in FLIGHT_EVENTS.items()}

# -- health document ----------------------------------------------
#
# Both runtimes extend their metrics_json/metrics() status surface into a
# versioned health document: resource readings (rss_bytes, open_fds,
# wal_disk_bytes), progress watermarks (inbox_depth, sealed_unexecuted,
# waiting_requests, last_progress_seconds, uptime_seconds) and identity
# digests (chain_digest, state_digest) alongside the existing counters.
# health_version stamps the document shape so pbft_top and the detector
# library (the JAX package's analysis/health.py) can refuse snapshots from a
# runtime speaking a different schema. core/net.h mirrors the value
# (kHealthDocVersion — constants lint pair "health document version").
HEALTH_DOC_VERSION = 1

# phase-transition -> the latency histogram it feeds (observed at
# "executed" time from the span's stamps).
PHASE_HISTOGRAMS = {
    ("request", "pre_prepare"): "pbft_phase_pre_prepare_seconds",
    ("pre_prepare", "prepared"): "pbft_phase_prepare_seconds",
    ("prepared", "committed"): "pbft_phase_commit_seconds",
    ("committed", "executed"): "pbft_phase_reply_seconds",
}


def histogram_buckets(name: str):
    """The fixed bucket edges for a manifest histogram."""
    if METRIC_SCHEMAS[name][0] != "histogram":
        raise ValueError(f"{name} is not a histogram")
    if name in (
        "pbft_verify_batch_size",
        "pbft_verify_pool_window_size",
        "pbft_batch_size",
        "pbft_verify_service_window_size",
        "pbft_verify_service_coalesced_clients",
    ):
        return BATCH_SIZE_BUCKETS
    return LATENCY_BUCKETS_S
