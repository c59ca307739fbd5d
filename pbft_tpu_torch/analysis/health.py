"""Cluster-health detectors over timestamped snapshot sequences: the
port's copy of ``pbft_tpu/analysis/health.py`` (the same detectors,
thresholds and verdict shape).

Pure functions — no sockets, no clocks. The input is a *history*: a list
of snapshots, each ``{"t": <seconds, monotonic-ish float>, "replicas":
{<rid>: <health document>}}`` where the health document is the dict both
runtimes serve on ``/status`` (core/net.cc ``metrics_json`` /
pbft_tpu_torch/net/server.py ``_refresh_health``; shape stamped by
``health_version``). Collectors — ``pbft_tpu_torch.scripts.pbft_top``,
``pbft_tpu_torch.scripts.endurance_soak``, ``chaos_bench --health-gate`` —
build histories however they like (live HTTP polls, simulator state,
parsed logs) and hand them here, so every gate in the repo trips on the
same definitions.

Each detector returns a list of *verdicts* (empty = healthy):

    {"detector": <name>, "replica": <rid or None>,
     "reason": <one sentence>, "evidence": {<window facts>}}

The detectors (thresholds are parameters; the shared defaults are the
constants-lint-paired values mirrored by core/net.h):

silent-stall        pending work (verify inbox + sealed-but-unexecuted +
                    forwarded-but-unreplied requests) while executed_upto
                    stays flat for >= stall_seconds. This is the liveness
                    failure completion-pct can't see mid-run (Castro &
                    Liskov §4.5: a correct cluster must keep executing
                    while work pends).
resource-leak       robust positive slope (Theil-Sen median of pairwise
                    slopes) on rss_bytes / open_fds / wal_disk_bytes
                    after a warmup prefix, AND projected growth over the
                    window above an absolute floor — slope alone would
                    trip on allocator noise, floors alone on one big
                    transient.
divergence          two replicas report the same committed_upto with
                    different chain digests. The committed chain is
                    deterministic per sequence, so ANY mismatch at an
                    equal floor is a safety violation, not a lag.
stuck-view-change   in_view_change held across >= stall_seconds while the
                    view number never advances — the cluster is burning
                    timeouts without converging on a new primary.
queue-saturation    verify-inbox depth at or above a watermark for the
                    whole sustain window — upstream of a stall: work is
                    arriving faster than it can ever drain.

A resource reading of 0 means "no data" (/proc absent), never a
baseline; such points are skipped.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# Shared thresholds/defaults (constants lint pairs with core/net.h:
# kHealthStallSeconds, kHealthSnapshotIntervalS). The stall threshold is
# deliberately whole seconds: last-progress clocks on both runtimes are
# quantized to the observation cadence.
HEALTH_STALL_SECONDS = 5
HEALTH_SNAPSHOT_INTERVAL_S = 2

# Leak floors: the projected growth over the post-warmup window that
# turns a positive slope into a verdict. RSS breathes with allocator
# arenas and fds with transient dials; the WAL compacts at stable
# checkpoints so its steady-state file size is bounded, but one
# checkpoint interval of appends can sit on disk between compactions.
LEAK_RSS_FLOOR_BYTES = 48 << 20
LEAK_FDS_FLOOR = 16
LEAK_WAL_FLOOR_BYTES = 8 << 20

QUEUE_SATURATION_DEPTH = 512


def _verdict(detector: str, replica, reason: str, evidence: dict) -> dict:
    return {
        "detector": detector,
        "replica": replica,
        "reason": reason,
        "evidence": evidence,
    }


def _series(history: List[dict], rid, key) -> List[tuple]:
    """[(t, value)] for one replica's field across the history (snapshots
    where the replica or the field is missing are skipped — a dead or
    pre-v16 replica contributes no points, it does not zero-fill)."""
    out = []
    for snap in history:
        doc = snap.get("replicas", {}).get(rid)
        if doc is None or key not in doc:
            continue
        out.append((snap["t"], doc[key]))
    return out


def _rids(history: List[dict]) -> list:
    seen = {}
    for snap in history:
        for rid in snap.get("replicas", {}):
            seen[rid] = True
    return list(seen)


def theil_sen_slope(points: List[tuple]) -> Optional[float]:
    """Median of all pairwise slopes — one wild reading cannot fake (or
    hide) a trend, unlike least squares. None with < 2 usable points."""
    slopes = []
    for i in range(len(points)):
        t0, v0 = points[i]
        for t1, v1 in points[i + 1:]:
            if t1 == t0:
                continue
            slopes.append((v1 - v0) / (t1 - t0))
    if not slopes:
        return None
    slopes.sort()
    mid = len(slopes) // 2
    if len(slopes) % 2:
        return slopes[mid]
    return (slopes[mid - 1] + slopes[mid]) / 2.0


def _pending_work(doc: dict) -> int:
    """The replica-local evidence that SOMETHING should be executing.
    waiting_requests matters: with a muted primary, a backup's inbox
    drains (it verified and forwarded) while the request sits unreplied
    in its progress-timer map — that is exactly the silent stall."""
    return (
        int(doc.get("inbox_depth", 0))
        + int(doc.get("sealed_unexecuted", 0))
        + int(doc.get("waiting_requests", 0))
    )


def detect_silent_stall(
    history: List[dict], stall_seconds: float = HEALTH_STALL_SECONDS
) -> List[dict]:
    out = []
    for rid in _rids(history):
        exec_series = _series(history, rid, "executed_upto")
        if len(exec_series) < 2:
            continue
        # Scan for the longest suffix window with flat executed_upto and
        # pending work at every point in it (a momentarily-empty queue
        # resets the clock: the replica may simply be idle).
        window: List[tuple] = []  # (t, executed, pending)
        for snap in history:
            doc = snap.get("replicas", {}).get(rid)
            if doc is None or "executed_upto" not in doc:
                continue
            executed = doc["executed_upto"]
            pending = _pending_work(doc)
            if window and (executed != window[-1][1] or pending == 0):
                window = []
            window.append((snap["t"], executed, pending))
            if (
                len(window) >= 2
                and window[0][2] > 0
                and window[-1][0] - window[0][0] >= stall_seconds
            ):
                out.append(_verdict(
                    "silent-stall", rid,
                    "pending work with executed_upto flat for "
                    f"{window[-1][0] - window[0][0]:.1f}s",
                    {
                        "executed_upto": executed,
                        "pending": pending,
                        "flat_seconds": round(window[-1][0] - window[0][0], 3),
                        "window_start_t": window[0][0],
                        "window_end_t": window[-1][0],
                    },
                ))
                break  # one verdict per replica
    return out


def detect_resource_leak(
    history: List[dict],
    warmup_frac: float = 0.25,
    min_points: int = 6,
    floors: Optional[Dict[str, float]] = None,
) -> List[dict]:
    if floors is None:
        floors = {
            "rss_bytes": LEAK_RSS_FLOOR_BYTES,
            "open_fds": LEAK_FDS_FLOOR,
            "wal_disk_bytes": LEAK_WAL_FLOOR_BYTES,
        }
    out = []
    for rid in _rids(history):
        for key, floor in floors.items():
            pts = [(t, v) for t, v in _series(history, rid, key) if v > 0]
            if len(pts) < min_points:
                continue
            pts = pts[int(len(pts) * warmup_frac):]  # drop warmup prefix
            if len(pts) < 2:
                continue
            span = pts[-1][0] - pts[0][0]
            if span <= 0:
                continue
            slope = theil_sen_slope(pts)
            if slope is None or slope <= 0:
                continue
            projected = slope * span
            if projected < floor:
                continue
            out.append(_verdict(
                "resource-leak", rid,
                f"{key} climbing ~{slope:.1f}/s over {span:.0f}s "
                f"(projected +{projected:.0f} > floor {floor:.0f})",
                {
                    "metric": key,
                    "slope_per_s": slope,
                    "window_seconds": round(span, 3),
                    "projected_growth": round(projected, 1),
                    "floor": floor,
                    "first": pts[0][1],
                    "last": pts[-1][1],
                },
            ))
    return out


def detect_divergence(history: List[dict]) -> List[dict]:
    out = []
    reported = set()  # (rid_a, rid_b, seq) pairs already verdicted
    for snap in history:
        docs = snap.get("replicas", {})
        by_floor: Dict[int, list] = {}
        for rid, doc in docs.items():
            if "chain_digest" not in doc:
                continue
            floor = doc.get("committed_upto", 0)
            if floor > 0:
                by_floor.setdefault(floor, []).append((rid, doc["chain_digest"]))
        for floor, entries in by_floor.items():
            digests = {}
            for rid, digest in entries:
                digests.setdefault(digest, []).append(rid)
            if len(digests) <= 1:
                continue
            groups = sorted(digests.items(), key=lambda kv: -len(kv[1]))
            key = (floor, tuple(sorted(r for _, rids in groups for r in rids)))
            if key in reported:
                continue
            reported.add(key)
            out.append(_verdict(
                "divergence", None,
                f"chain digests disagree at committed_upto={floor}",
                {
                    "committed_upto": floor,
                    "t": snap["t"],
                    "groups": [
                        {"chain_digest": d, "replicas": sorted(map(str, rs))}
                        for d, rs in groups
                    ],
                },
            ))
    return out


def detect_stuck_view_change(
    history: List[dict], stall_seconds: float = HEALTH_STALL_SECONDS
) -> List[dict]:
    out = []
    for rid in _rids(history):
        window: List[tuple] = []  # (t, view)
        for snap in history:
            doc = snap.get("replicas", {}).get(rid)
            if doc is None or "in_view_change" not in doc:
                continue
            if not doc["in_view_change"]:
                window = []
                continue
            view = doc.get("view", 0)
            if window and view != window[-1][1]:
                window = []  # the view DID move: progress, restart clock
            window.append((snap["t"], view))
            if (
                len(window) >= 2
                and window[-1][0] - window[0][0] >= stall_seconds
            ):
                out.append(_verdict(
                    "stuck-view-change", rid,
                    "in view change without installing for "
                    f"{window[-1][0] - window[0][0]:.1f}s",
                    {
                        "view": view,
                        "stuck_seconds": round(window[-1][0] - window[0][0], 3),
                        "window_start_t": window[0][0],
                    },
                ))
                break
    return out


def detect_queue_saturation(
    history: List[dict],
    depth: int = QUEUE_SATURATION_DEPTH,
    sustain_seconds: float = HEALTH_STALL_SECONDS,
) -> List[dict]:
    out = []
    for rid in _rids(history):
        window: List[tuple] = []  # (t, depth)
        for snap in history:
            doc = snap.get("replicas", {}).get(rid)
            if doc is None or "inbox_depth" not in doc:
                continue
            if doc["inbox_depth"] < depth:
                window = []
                continue
            window.append((snap["t"], doc["inbox_depth"]))
            if (
                len(window) >= 2
                and window[-1][0] - window[0][0] >= sustain_seconds
            ):
                out.append(_verdict(
                    "queue-saturation", rid,
                    f"verify inbox >= {depth} for "
                    f"{window[-1][0] - window[0][0]:.1f}s",
                    {
                        "depth": window[-1][1],
                        "watermark": depth,
                        "sustained_seconds": round(
                            window[-1][0] - window[0][0], 3
                        ),
                    },
                ))
                break
    return out


ALL_DETECTORS = (
    detect_silent_stall,
    detect_resource_leak,
    detect_divergence,
    detect_stuck_view_change,
    detect_queue_saturation,
)


def run_detectors(
    history: List[dict],
    stall_seconds: float = HEALTH_STALL_SECONDS,
    leak_floors: Optional[Dict[str, float]] = None,
    saturation_depth: int = QUEUE_SATURATION_DEPTH,
) -> List[dict]:
    """All detectors over one history; the concatenated verdicts (empty =
    healthy). The shared thresholds fan out to each detector's knob."""
    verdicts: List[dict] = []
    verdicts += detect_silent_stall(history, stall_seconds=stall_seconds)
    verdicts += detect_resource_leak(history, floors=leak_floors)
    verdicts += detect_divergence(history)
    verdicts += detect_stuck_view_change(history, stall_seconds=stall_seconds)
    verdicts += detect_queue_saturation(
        history, depth=saturation_depth, sustain_seconds=stall_seconds
    )
    return verdicts
