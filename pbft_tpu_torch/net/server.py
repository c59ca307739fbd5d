"""The asyncio replica runtime with an in-process verifier on the card (the
port's copy of ``pbft_tpu/net/server.py``).

Two deployment shapes ship with this framework (SURVEY.md §5):

1. ``pbftd`` (C++, core/net.cc) — the native daemon; its remote verifier
   ships batches over a socket to the colocated verify service
   (``net/verify_service.py``).
2. This module — the replica IS the card's process, so signature batches
   never cross a process boundary: the event loop drains every socket, then
   runs ONE batched verify over everything that arrived (one window on the
   card: a replayed CUDA graph of ``crypto.batch.verify_many``), then emits
   the resulting protocol messages.

``verifier`` says where a batch is verified:

- ``"cuda"`` (the default): the card, in this process
  (``net.service.cuda_backend``, sharded over the local cards when there
  are several). The device is resolved when the server is built, before
  it binds its port: without CUDA it raises and never listens, and it
  never carries on on the host. torch is imported on this path only.
- ``"cpu"``: the host (``native.host_batch_verify``: the C++ core's verify
  pool, the oracle while the core is still being built).
- ``"host:port"`` or a unix path: a verify service (``ServiceVerifier``:
  short connect deadline, readiness handshake, the host's verifier as the
  fallback while the service warms or after its link dies).
- a callable: used as given (items -> verdicts).

Wire-compatible with pbftd: framed canonical JSON between replicas, raw
JSON with dial-back replies for clients (the reference's client contract,
reference src/client_handler.rs:75-84). A pbftd cluster and an
AsyncReplicaServer cluster interoperate — the encodings are byte-identical
(tests/test_native_messages.py).

Run one replica:  python -m pbft_tpu_torch.net.server --config network.json \
                      --id 0 --seed <64-hex> [--verifier cuda|cpu|HOST:PORT]
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import random
import time
from typing import Callable, Dict, List, Optional, Tuple

import hmac

from .. import native
from ..consensus.config import ClusterConfig
from ..consensus.messages import (
    ClientReply,
    ClientRequest,
    Message,
    PrePrepare,
    batch_digest,
    decode_payload,
    from_wire,
    mac_frame_lane,
    payload_is_mac_frame,
    signable_from_payload,
    to_binary,
    to_binary_mac,
    with_sig,
)
from ..consensus.replica import (
    Broadcast,
    Replica,
    Reply,
    Send,
    _host_sign,
)
from ..utils import (
    ConsensusSpans,
    MetricsRegistry,
    count_open_fds,
    file_size_bytes,
    get_tracer,
    read_rss_bytes,
    start_metrics_server,
)
from ..utils.trace_schema import HEALTH_DOC_VERSION
from . import secure
from .gateway import GATEWAY_CLIENT_PREFIX


def _frame_bytes(payload: bytes) -> bytes:
    return len(payload).to_bytes(4, "big") + payload


class _PeerLink:
    """One dialed peer link: the stream writer, the secure channel (None
    on plaintext links), and the negotiated payload codec. ``binary``
    flips when the peer's hello (plaintext hello-ack or secure hello_r)
    offers the binary-v2 codec; frames sent before that go as JSON —
    receivers detect the codec per frame. ``mac``: both sides
    offered the authenticator mode on this link, so hot messages go out
    as MAC-vector frames (the link's send lane key lives in the server's
    _mac_send_keys table, feeding the shared per-broadcast vector)."""

    __slots__ = ("writer", "chan", "binary", "mac")

    def __init__(self, writer, chan=None, binary=False, mac=False):
        self.writer = writer
        self.chan = chan
        self.binary = binary
        self.mac = mac


class _EncodedOut:
    """A message mid-fan-out: canonical JSON and binary-v2 encodings are
    computed lazily, AT MOST ONCE each, however many peers the message
    goes to (the serialize-once invariant). Encoding is synchronous, so
    concurrent _send_to tasks sharing one instance cannot race. When the
    owning server is set, each actual encode bumps its
    ``broadcast_encodes`` counter — the invariant test compares that
    against the broadcast count (encodes == broadcasts, never
    broadcasts x peers)."""

    __slots__ = (
        "msg", "_json", "_binary", "_binary_tried", "_mac", "_mac_tried",
        "_server",
    )

    def __init__(self, msg: Message, server=None):
        self.msg = msg
        self._json: Optional[bytes] = None
        self._binary: Optional[bytes] = None
        self._binary_tried = False
        self._mac: Optional[bytes] = None
        self._mac_tried = False
        self._server = server

    def _count(self) -> None:
        if self._server is not None:
            self._server.broadcast_encodes += 1
            if self._server.metrics_registry.enabled:
                self._server.metrics_registry.counter(
                    "pbft_broadcast_encodes_total"
                ).inc()

    def json_payload(self) -> bytes:
        if self._json is None:
            self._json = self.msg.canonical()
            self._count()
        return self._json

    def binary_payload(self) -> Optional[bytes]:
        if not self._binary_tried:
            self._binary_tried = True
            self._binary = to_binary(self.msg)
            if self._binary is not None:
                self._count()
        return self._binary

    def mac_payload(self, keys: Dict[int, bytes]) -> Optional[bytes]:
        """The MAC-vector frame, computed AT MOST ONCE per
        broadcast: one lane per peer in ``keys`` (the sender-side session
        keys of every mac-negotiated link), all over the message's
        signable digest — the serialize-once invariant extended to the
        authenticator mode. A peer whose link joins mid-fan-out misses
        its lane and falls back to signature verification (the sig rides
        in the frame), so staleness costs a signature check, never a
        drop. None when the type has no MAC form (or no mac links yet)."""
        if not self._mac_tried:
            self._mac_tried = True
            if keys:
                digest = self.msg.signable()
                self._mac = to_binary_mac(
                    self.msg,
                    [
                        (rid, secure.mac_tag(key, digest))
                        for rid, key in sorted(keys.items())
                    ],
                )
                if self._mac is not None:
                    self._count()
        return self._mac


def _frame_obj(obj: dict) -> bytes:
    return _frame_bytes(json.dumps(obj, separators=(",", ":")).encode())


# Replica-level Byzantine behavior modes (--fault). Same names as
# core/pbftd.cc --fault and the simulation's FAULT_MODES, so one chaos
# scenario scripts identically against either daemon. "" = honest.
FAULT_MODES = ("sig-corrupt", "mute", "stutter", "equivocate")

# Deterministic equivocation transform (matches core/net.cc and
# consensus/simulation.py): variant B mutates every operation with this
# suffix, recomputes the batch digest, and RE-SIGNS — both variants carry
# valid signatures, which is what makes equivocation a real attack.
EQUIV_SUFFIX = "#equiv"

# Bounded per-connection outbound (mirrors core/net.cc
# kMaxConnOutbound; constants lint): a frame that would grow a slow
# reader's write buffer past this is dropped and counted — PBFT
# retransmission absorbs the loss like any link drop.
MAX_CONN_OUTBOUND = 8 << 20
# Gateway route-cache bound (mirrors kMaxGatewayRoutes): on overflow the
# cache clears and un-routed "gw/" replies fan out over all gateway links.
MAX_GATEWAY_ROUTES = 1 << 17


class ViewTimerBackoff:
    """Pure §4.5.2 view-timer policy, shared semantics with
    core/net.cc check_progress_timer and unit-tested in
    tests/test_view_change.py. The runtime polls it with the current
    clock and a progress count (``AsyncReplicaServer._timer_progress``,
    which, unlike core/net.cc, also credits sequences committed above a
    gap in the replica's execution); the policy answers what to do:

      "armed"      a fresh deadline was set (timeout_s x level)
      "idle"       deadline not reached yet
      "progress"   work advanced since arming — level resets to 1
      "retransmit" deadline expired mid-view-change, first expiry at this
                   level: re-broadcast the pending VIEW-CHANGE verbatim
                   (lost-frame recovery converges in the SAME view)
      "escalate"   deadline expired with no progress (again): start the
                   next view change; the level doubles (T, 2T, 4T, ...,
                   capped) so cascading view changes decelerate instead
                   of storming.
    """

    MAX_LEVEL = 64  # cap: 64 x T between escalations at the extreme

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self.level = 1
        self.deadline: Optional[float] = None
        self._snapshot = (0, 0)  # (executed_upto, view) at arm time
        self._retransmitted = False

    def clear(self) -> None:
        """No pending work: disarm and reset the backoff."""
        self.deadline = None
        self.level = 1
        self._retransmitted = False

    def poll(
        self, now: float, executed: int, view: int, in_view_change: bool
    ) -> str:
        if self.deadline is None:
            self._snapshot = (executed, view)
            self.deadline = now + self.timeout_s * self.level
            return "armed"
        if now < self.deadline:
            return "idle"
        self.deadline = None  # rearmed by the next poll while work pends
        exec_snap, view_snap = self._snapshot
        if executed > exec_snap or view > view_snap:
            self.level = 1
            self._retransmitted = False
            return "progress"
        if in_view_change and not self._retransmitted:
            self._retransmitted = True
            return "retransmit"
        self.level = min(self.level * 2, self.MAX_LEVEL)
        self._retransmitted = False
        return "escalate"


async def _read_frame(reader, timeout: float = 10.0) -> bytes:
    hdr = await asyncio.wait_for(reader.readexactly(4), timeout)
    n = int.from_bytes(hdr, "big")
    if n > (1 << 24):
        raise ConnectionError("oversized frame")
    return await asyncio.wait_for(reader.readexactly(n), timeout)


class AsyncReplicaServer:
    def __init__(
        self,
        config: ClusterConfig,
        replica_id: int,
        seed: bytes,
        verifier: Callable | str = "cuda",
        vc_timeout: float = 0.0,
        discovery: str = "",
        byzantine: bool = False,
        fault: str = "",
        chaos_drop_pct: float = 0.0,
        chaos_delay_ms: int = 0,
        chaos_seed: Optional[int] = None,
        metrics_port: Optional[int] = None,
        flight=None,
        wal=None,
    ):
        self.config = config
        self.id = replica_id
        self.replica = Replica(config, replica_id, seed)
        # Durable recovery (consensus/wal.py): attach the
        # write-ahead log (opened/replayed by main() BEFORE the event
        # loop — file I/O stays off the loop) and reinstall any
        # persisted pre-crash state. The recovery span is stamped into
        # the flight ring + the pbft_recovery_seconds gauge once the
        # metrics registry exists (below).
        self.wal = wal
        self.recovered_from_wal = False
        self._recovery_seconds = 0.0
        self._seen_wal = (0, 0, 0)  # (appends, fsyncs, bytes) snapshots
        if wal is not None:
            self.replica.wal = wal
            if not wal.recovered.empty():
                if flight is not None:
                    rec = wal.recovered
                    flight.record(
                        "recovery_started",
                        view=rec.view,
                        seq=rec.checkpoint[0] if rec.checkpoint else 0,
                    )
                t0 = time.monotonic()
                self.replica.restore_from_wal(wal.recovered)
                self._recovery_seconds = time.monotonic() - t0
                self.recovered_from_wal = True
                if flight is not None:
                    flight.record(
                        "recovery_complete",
                        view=self.replica.view,
                        seq=self.replica.executed_upto,
                    )
        # Metrics + consensus-phase spans (utils/metrics.py; names are the
        # cross-runtime contract in utils/trace_schema.py). The registry is
        # live whenever a scrape surface was asked for; spans additionally
        # feed consensus_span trace events when tracing is on. With neither,
        # phase_hook stays None — zero per-transition cost.
        self.metrics_registry = MetricsRegistry(
            labels={"replica": str(replica_id)}, enabled=metrics_port is not None
        )
        if self.metrics_registry.enabled:
            self.metrics_registry.preregister()  # full replica series set
        self.metrics_port = metrics_port
        self._metrics_server = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None  # set by start()
        self.metrics_listen_port = 0
        # Black-box flight recorder (utils/flight.py): the last N
        # protocol events in a bounded ring, dumped on SIGTERM/fatal (the
        # runner installs the handler — see main()). None = one attribute
        # check per event site, like the tracer.
        self.flight = flight
        if self.metrics_registry.enabled or get_tracer().enabled:
            self.spans = ConsensusSpans(
                self.metrics_registry, tracer=get_tracer(), replica=replica_id
            )
            if flight is not None:
                _spans_hook = self.spans.on_phase
                _flight_hook = flight.record_phase

                def _phase(phase, view, seq):
                    _flight_hook(phase, view, seq)
                    _spans_hook(phase, view, seq)

                self.replica.phase_hook = _phase
            else:
                self.replica.phase_hook = self.spans.on_phase
        else:
            self.spans = None
            if flight is not None:
                self.replica.phase_hook = flight.record_phase
        # View-change spans: view_change_sent /
        # new_view_installed are rare reconfiguration events — the hook is
        # always wired; the tracer/flight checks inside gate the cost.
        self.replica.view_hook = self._on_view_event
        # When the primary's open batch first became non-empty (monotonic)
        # — the "batch wait" waterfall segment measured at seal time.
        self._batch_open_since: Optional[float] = None
        if self.metrics_registry.enabled:
            # Batch occupancy at every pre-prepare accept.
            _batch_hist = self.metrics_registry.histogram("pbft_batch_size")
            self.replica.batch_hook = _batch_hist.observe
        # Last-seen replica execution counters, for the
        # pbft_requests_executed_total / pbft_consensus_rounds_total deltas.
        self._seen_executed = 0
        self._seen_rounds = 0
        self.service_verifier = None
        if callable(verifier):
            self.verify = verifier
        elif verifier == "cuda":
            # The card, in this process: resolved here, before start()
            # binds the port, so a machine without CUDA raises instead of
            # listening and failing at its first batch (or verifying on
            # the host). The backend shards over the local cards when
            # there are several and is one card's window otherwise.
            from ..device import resolve_device
            from .service import cuda_backend

            resolve_device("cuda")
            self.verify = cuda_backend
        elif ":" in verifier or verifier.startswith("/"):
            # A "host:port" / unix-path spec dials the colocated verify
            # service (mirror of pbftd's RemoteVerifier): short connect
            # deadline, readiness handshake, and the host's verify pool as
            # the per-batch fallback whenever the service is warming,
            # unreachable, or dies mid-stream — consensus never blocks
            # on a cold card.
            from .verify_service import ServiceVerifier

            self.service_verifier = ServiceVerifier(verifier)
            self.verify = self.service_verifier.verify_batch
        elif verifier in ("", "cpu"):
            # The host: the native C++ verify pool once the core is built
            # and loaded, the pure-Python oracle until then. Identical
            # accept sets on honest traffic, so the choice cannot diverge
            # replicas.
            self.verify = native.host_batch_verify
        else:
            raise ValueError(
                f"unknown verifier {verifier!r}: cuda, cpu, host:port, a "
                "unix path or a callable"
            )
        self.vc_timeout = vc_timeout
        self.secure = config.secure
        self._seed = seed
        # Fast-path modes: whether this node OFFERS the MAC
        # authenticator mode in its hellos (config.fastpath == "mac",
        # unless an env lever capped the advertised protocol), the
        # per-dest sender-side lane keys of every mac-negotiated link
        # (feeding the shared per-broadcast MAC vector), and the frame
        # tallies. Tentative execution is config-driven inside Replica;
        # the runtime only stamps its flight/metrics surface.
        self.fastpath_mac = secure.wire_offer_mac(config.fastpath == "mac")
        self._mac_send_keys: Dict[int, bytes] = {}
        self.mac_frames = 0
        self.mac_rejected = 0
        self._seen_tentative = 0
        self._seen_rollbacks = 0
        self.discovery_target = discovery
        self._discovery = None
        self._warned_no_discovery = False
        # Fault injection (parity with pbftd --fault): one of
        # FAULT_MODES, or "" for honest. ``byzantine`` is the legacy
        # spelling of sig-corrupt. Self-delivery stays honest in every
        # mode (a Byzantine replica trusts its own messages).
        if fault and fault not in FAULT_MODES:
            raise ValueError(f"unknown fault mode {fault!r}")
        self.fault = fault or ("sig-corrupt" if byzantine else "")
        # Seeded link-level chaos (--chaos-drop-pct / --chaos-delay-ms):
        # outbound peer frames drop with probability drop_pct; delay
        # holds each send for a uniform 0..delay_ms. Per-destination
        # ordering is preserved (the per-dest link lock serializes the
        # seal+write), so secure-channel AEAD nonces stay in sequence.
        self.chaos_drop_pct = chaos_drop_pct
        self.chaos_delay_ms = chaos_delay_ms
        self._chaos_rng = random.Random(
            chaos_seed if chaos_seed is not None else replica_id
        )
        self.faults_injected = 0
        self.chaos_dropped = 0
        # Recently broadcast messages, for the stutter mode's replays.
        self._stutter_history: List[Message] = []
        self._server: Optional[asyncio.Server] = None
        # Gateway tier: inbound links whose hello carried
        # role=gateway. Framed client requests arrive on them; replies for
        # the clients they forwarded fan BACK over the same link instead
        # of per-reply dial-backs. link id -> writer, plus the bounded
        # client-token route cache (on overflow it clears and un-routed
        # "gw/" replies fan out over every gateway link).
        self._gateway_links: Dict[int, asyncio.StreamWriter] = {}
        self._gateway_routes: Dict[str, int] = {}
        self._gateway_link_seq = 0
        self.gateway_forwarded = 0
        # Event-loop + backpressure accounting: stream-read
        # completions (the asyncio analogue of poller wakeups), and
        # bounded-outbound drops against slow readers.
        self.event_wakeups = 0
        self.backpressure_events = 0
        self._conns_open = 0
        # dest -> _PeerLink; guarded by a per-dest lock so one handshake
        # runs per destination and sealed-frame counters never interleave.
        self._peer_links: Dict[int, _PeerLink] = {}
        self._peer_locks: Dict[int, asyncio.Lock] = {}
        self._batch_wakeup = asyncio.Event()
        # Pending seal of the primary's partial request batch:
        # armed when the open batch first becomes non-empty, fires after
        # config.batch_flush_us (0 = the next loop turn, which still
        # coalesces everything already queued on the event loop).
        self._batch_flush_handle: Optional[asyncio.TimerHandle] = None
        self._stopping = False
        self.listen_port = 0
        self.batches_run = 0
        self.frames_in = 0
        # Serialize-once accounting (metrics() + the counter-based
        # invariant test): encodes track broadcasts, never
        # broadcasts x peers. Frame counters split by negotiated codec.
        self.broadcasts = 0
        self.broadcast_encodes = 0
        self.codec_binary_frames = 0
        self.codec_json_frames = 0
        # Reply-dial pacing (mirrors core/net.cc start_reply_dial): the
        # reply address is UNTRUSTED client input, so dials are
        # deadline-bounded, capped in flight, and serialized per address
        # (an asyncio.Lock wakes waiters FIFO, so replies to one client
        # go out in order with zero polling) — a burst of black-holed
        # addresses must not accumulate tasks/FDs for the OS connect
        # timeout. A dropped reply is re-fetched from the reply cache on
        # client retransmission (PBFT §4.1).
        self._reply_dial_sem = asyncio.Semaphore(32)
        self._reply_addr_locks: Dict[str, asyncio.Lock] = {}
        self._reply_addr_refs: Dict[str, int] = {}
        # Progress timer state (mirrors core/net.cc check_progress_timer):
        # the ViewTimerBackoff policy decides retransmit-vs-escalate and
        # the exponential level (§4.5.2).
        self._waiting_requests: Dict[Tuple[str, int], float] = {}
        self._state_retry_deadline: Optional[float] = None
        self._vc_policy = ViewTimerBackoff(vc_timeout)
        # The view timer's progress count (_timer_progress): bumped when
        # execution advances or a gap's committed suffix grows.
        self._progress_ticks = 0
        self._progress_seen = (0, 0)
        self._gauged_backoff = 1  # last backoff level pushed to the gauge
        # Admission control: explicit overload rejections
        # instead of silent queueing — config.admission_inflight caps a
        # client's estimated in-flight requests (timestamp distance past
        # its last executed one), config.admission_backlog watermarks the
        # replica's own backlog (verify inbox + sealed-but-unexecuted
        # sequences). 0 disables either check.
        self.overload_rejections = 0
        # Gateway-fabric accounting: live gateway links that
        # died (clients behind them must fail over to another gateway).
        self.gateway_failovers = 0
        # Health-document progress tracker (mirrors
        # core/net.cc refresh_health): the executed_upto we last saw
        # move and when we saw it — last_progress_seconds is quantized
        # to the refresh cadence (every metrics()/status render).
        self._start_time = time.monotonic()
        self._progress_seen_executed = -1
        self._progress_seen_at = time.monotonic()

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "AsyncReplicaServer":
        ident = self.config.identity(self.id)
        self._server = await asyncio.start_server(
            self._on_connection, host="0.0.0.0", port=ident.port
        )
        self.listen_port = self._server.sockets[0].getsockname()[1]
        self._loop = asyncio.get_running_loop()
        # Multi-core key: pbftd shards its event loop across
        # net_threads; this runtime is one asyncio loop by design — accept
        # the network.json key, say so, and expose the gauge as 1 so a
        # mixed-runtime scrape attributes per-replica loop counts
        # honestly. The offload-depth gauge and cross-thread-wake counter
        # exist for series-set parity (no crypto pipelines here: both
        # stay 0).
        if self.config.net_threads > 1:
            print(
                f"async replica {self.id}: net_threads="
                f"{self.config.net_threads} requested; asyncio runtime is "
                "single-loop (key accepted, sharding is pbftd-only)",
                flush=True,
            )
        if self.metrics_registry.enabled:
            self.metrics_registry.gauge("pbft_net_loop_threads").set(1)
            self.metrics_registry.gauge(
                "pbft_crypto_offload_queue_depth"
            ).set(0)
            self.metrics_registry.counter(
                "pbft_cross_thread_wakes_total"
            ).inc(0)
            # Durable-recovery surface: how long the WAL
            # replay + reinstall took (0 = this life started fresh).
            self.metrics_registry.gauge("pbft_recovery_seconds").set(
                round(self._recovery_seconds, 6)
            )
        if self.discovery_target:
            from .discovery import Discovery

            self._discovery = await Discovery(
                self.discovery_target, self.id, self.listen_port, self.config.n
            ).start()
        if self.metrics_port is not None:
            # /status serves the health document, built on this loop by
            # status() (the scrape thread waits for it): a document read
            # from the scrape thread could pair one committed_upto with
            # the chain digest of a later execution, which the divergence
            # detector reads as a fork.
            self._metrics_server = start_metrics_server(
                self.metrics_registry, self.metrics_port,
                status_fn=self.status,
            )
            self.metrics_listen_port = self._metrics_server.server_address[1]
        asyncio.get_running_loop().create_task(self._batch_pump())
        if self.vc_timeout > 0:
            asyncio.get_running_loop().create_task(self._timer_loop())
        return self

    async def stop(self) -> None:
        self._stopping = True
        if self._batch_flush_handle is not None:
            self._batch_flush_handle.cancel()
            self._batch_flush_handle = None
        self._batch_wakeup.set()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()
        if self._discovery:
            self._discovery.stop()
        # The dialed links first: peers stopping at the same time then see
        # their inbound links close, and none waits on another's below.
        for link in self._peer_links.values():
            link.writer.close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    # -- inbound ------------------------------------------------------------

    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._conn_delta(+1)
        try:
            first = await reader.read(1)
            if not first:
                return
            if first == b"{":
                await self._client_connection(first, reader)
            else:
                await self._peer_connection(first, reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError):
            pass
        finally:
            self._conn_delta(-1)
            writer.close()

    # -- scale-out accounting -------------------------------------

    def _conn_delta(self, d: int) -> None:
        """Track open sockets (accepted + dialed peer links) and refresh
        the pbft_connections_open gauge — parity with core/net.cc's
        end-of-iteration sweep."""
        self._conns_open += d
        if self.metrics_registry.enabled:
            self.metrics_registry.gauge("pbft_connections_open").set(
                max(0, self._conns_open) + len(self._peer_links)
            )

    def _count_wakeup(self) -> None:
        """One event-loop readiness wakeup serviced (a stream read
        completed) — the asyncio analogue of a poller wait() return."""
        self.event_wakeups += 1
        if self.metrics_registry.enabled:
            self.metrics_registry.counter("pbft_epoll_wakeups_total").inc()

    def _count_backpressure(self) -> None:
        self.backpressure_events += 1
        if self.metrics_registry.enabled:
            self.metrics_registry.counter(
                "pbft_write_backpressure_events_total"
            ).inc()

    def _writer_has_room(self, writer: asyncio.StreamWriter) -> bool:
        """Bounded-outbound admission (mirrors
        core/net.cc): a frame that would grow a slow reader's transport
        buffer past MAX_CONN_OUTBOUND is dropped and counted instead of
        buffering without limit — retransmission absorbs the loss."""
        try:
            size = writer.transport.get_write_buffer_size()
        except (AttributeError, RuntimeError):
            return True
        if size > MAX_CONN_OUTBOUND:
            self._count_backpressure()
            return False
        return True

    # A raw-JSON client line may not exceed this; longer input is a
    # protocol violation (or an attack) and drops the connection instead
    # of buffering without bound.
    MAX_CLIENT_LINE = 1 << 20

    def _ingest_client_line(self, line: bytes) -> None:
        line = line.strip()
        if not line:
            return
        try:
            msg = from_wire(line)
        except (ValueError, KeyError, json.JSONDecodeError):
            return
        self._ingest(msg)

    async def _client_connection(self, first: bytes, reader) -> None:
        # Raw JSON, one message per line (telnet-able, like the reference's
        # gateway). Proper line buffering: requests larger than one read()
        # are reassembled, and a line above MAX_CLIENT_LINE drops the
        # connection (bounded buffering on an unauthenticated socket).
        buf = first
        while True:
            nl = buf.find(b"\n")
            if nl >= 0:
                line, buf = buf[:nl], buf[nl + 1 :]
                self._ingest_client_line(line)
                continue
            if len(buf) > self.MAX_CLIENT_LINE:
                return  # oversized line: drop the connection
            chunk = await reader.read(65536)
            if not chunk:
                break
            self._count_wakeup()
            buf += chunk
        self._ingest_client_line(buf)  # trailing JSON without newline

    def _pubkey_of(self, node: int) -> Optional[bytes]:
        if 0 <= node < self.config.n:
            return self.config.identity(node).pubkey_bytes()
        return None

    async def _peer_connection(self, first: bytes, reader, writer) -> None:
        """Framed replica link. The first frame must be a ``hello`` carrying
        the protocol version (rejected cleanly on mismatch); in secure
        clusters the responder side of the handshake runs here and every
        subsequent frame is AEAD-opened before parsing."""
        buf = first
        chan: Optional[secure.SecureChannel] = None
        hello_seen = False
        # Gateway link state: set when the hello carried
        # role=gateway; cleaned up on disconnect so replies stop fanning
        # to a dead link (stale routes fall back to the all-links fan-out,
        # which skips the removed id).
        gw_link_id: Optional[int] = None
        try:
            while True:
                while len(buf) < 4:
                    chunk = await reader.read(65536)
                    if not chunk:
                        return
                    self._count_wakeup()
                    buf += chunk
                n = int.from_bytes(buf[:4], "big")
                if n > (1 << 24):
                    return  # corrupt frame
                while len(buf) < 4 + n:
                    chunk = await reader.read(65536)
                    if not chunk:
                        return
                    self._count_wakeup()
                    buf += chunk
                payload, buf = buf[4 : 4 + n], buf[4 + n :]
                if not hello_seen or (
                    chan is not None and not chan.established
                ):
                    try:
                        obj = json.loads(payload)
                    except (ValueError, UnicodeDecodeError):
                        obj = None
                    try:
                        if not hello_seen:
                            if (
                                not isinstance(obj, dict)
                                or obj.get("type") != "hello"
                            ):
                                if self.secure:
                                    raise secure.HandshakeError(
                                        "plaintext peer rejected: first "
                                        "frame must be an encrypted-link "
                                        "hello"
                                    )
                                # Plaintext cluster: tolerate a missing
                                # hello (raw protocol frame) for tooling
                                # compat.
                                hello_seen = True
                            else:
                                secure.SecureChannel.check_version(obj)
                                hello_seen = True
                                peer_mac = (
                                    self.fastpath_mac
                                    and secure.hello_offers_mac(obj)
                                )
                                if obj.get("role") == "gateway":
                                    # Gateway trust (parity with
                                    # core/net.cc): framed client requests
                                    # arrive on this link; replies for the
                                    # clients it forwarded fan BACK over
                                    # it. A gateway has no replica
                                    # identity, so the signed-DH handshake
                                    # cannot admit one: plaintext only.
                                    if self.secure:
                                        raise secure.HandshakeError(
                                            "gateway links require a "
                                            "plaintext cluster (a gateway "
                                            "has no replica identity to "
                                            "authenticate)"
                                        )
                                    self._gateway_link_seq += 1
                                    gw_link_id = self._gateway_link_seq
                                    self._gateway_links[gw_link_id] = writer
                                if self.secure:
                                    chan = secure.SecureChannel(
                                        self.id,
                                        self._seed,
                                        self._pubkey_of,
                                        initiator=False,
                                        offer_mac=self.fastpath_mac,
                                    )
                                    reply = chan.on_hello(obj)
                                    writer.write(_frame_obj(reply))
                                    await writer.drain()
                                elif peer_mac and isinstance(
                                    obj.get("eph"), str
                                ):
                                    # Authenticator mode on a plaintext
                                    # cluster: run the SAME
                                    # signed station-to-station handshake
                                    # purely for lane-key agreement +
                                    # peer identity — frames after it
                                    # stay plaintext (auth-only channel,
                                    # never sealed/opened).
                                    chan = secure.SecureChannel(
                                        self.id,
                                        self._seed,
                                        self._pubkey_of,
                                        initiator=False,
                                        offer_mac=self.fastpath_mac,
                                        auth_only=True,
                                    )
                                    reply = chan.on_hello(obj)
                                    writer.write(_frame_obj(reply))
                                    await writer.drain()
                                else:
                                    # Plaintext hello-ack: advertise this
                                    # node's version + codec offer so the
                                    # dialing peer can negotiate binary-v2
                                    # (a 1.0.0 initiator parses and
                                    # ignores any non-reject frame).
                                    writer.write(
                                        _frame_obj(
                                            secure.plain_hello(
                                                self.id,
                                                offer_mac=self.fastpath_mac,
                                            )
                                        )
                                    )
                                    await writer.drain()
                                continue
                        elif chan is not None:
                            if (
                                not isinstance(obj, dict)
                                or obj.get("type") != "auth"
                            ):
                                raise secure.HandshakeError(
                                    "expected auth frame"
                                )
                            chan.on_auth(obj)
                            continue
                    except secure.HandshakeError as e:
                        try:
                            writer.write(
                                _frame_obj(secure.reject_payload(str(e)))
                            )
                            await writer.drain()
                        except (ConnectionError, OSError):
                            pass
                        return
                if chan is not None and not chan.auth_only:
                    try:
                        payload = chan.open_frame(payload)
                    except secure.HandshakeError:
                        return  # tampered/desynced stream: drop the conn
                try:
                    msg = decode_payload(payload)
                except (ValueError, KeyError, json.JSONDecodeError):
                    continue
                if gw_link_id is not None and isinstance(msg, ClientRequest):
                    # Remember the forwarding link so this client's reply
                    # fans back over it (exact route; the "gw/" fan-out
                    # fallback covers replicas that only saw the request
                    # via pre-prepare).
                    self._note_gateway_route(msg.client, gw_link_id)
                    self.gateway_forwarded += 1
                    if self.metrics_registry.enabled:
                        self.metrics_registry.counter(
                            "pbft_gateway_forwarded_total"
                        ).inc()
                if (
                    chan is not None
                    and chan.established
                    and chan.mac_negotiated
                    and payload_is_mac_frame(payload)
                ):
                    self._ingest_mac(msg, payload, chan)
                else:
                    self._ingest(msg, payload)
        finally:
            if gw_link_id is not None:
                self._gateway_links.pop(gw_link_id, None)
                if not self._stopping:
                    # A live gateway link died: clients behind
                    # it must fail over to another gateway — count it so
                    # the chaos bench can attribute the blip.
                    self.gateway_failovers += 1
                    if self.metrics_registry.enabled:
                        self.metrics_registry.counter(
                            "pbft_gateway_failovers_total"
                        ).inc()
                    if self.flight is not None:
                        self.flight.record(
                            "gateway_failover",
                            view=self.replica.view,
                            peer=gw_link_id & 0x7FFF,
                        )

    def _note_gateway_route(self, client: str, link_id: int) -> None:
        """Bounded route cache (mirrors core/net.cc note_gateway_route):
        on overflow it CLEARS — un-routed replies degrade to the all-links
        fan-out, extra frames but never lost quorums."""
        if len(self._gateway_routes) >= MAX_GATEWAY_ROUTES:
            self._gateway_routes.clear()
        self._gateway_routes[client] = link_id

    def _on_view_event(self, ev: str, v: int) -> None:
        """Replica.view_hook target: stamp view-change span events."""
        if self.flight is not None:
            self.flight.record(ev, view=v)
        tracer = get_tracer()
        if not tracer.enabled:
            return
        if ev == "view_change_sent":
            tracer.event("view_change_sent", replica=self.id, pending_view=v)
        else:
            tracer.event("new_view_installed", replica=self.id, view=v)

    def _admission_reject(self, req: ClientRequest) -> bool:
        """Admission control at request ingest: a FRESH request
        past the per-client in-flight cap or the global backlog watermark
        is answered with an explicit {"type": "overloaded"} line (over the
        gateway link or the dial-back channel) and dropped — the client
        backs off with jitter instead of silently queueing into the p99.
        Retransmissions (timestamp at or below the client's last executed
        one) always pass: the reply cache answers them, and liveness must
        never be admission-gated. Mirrors core/net.cc."""
        cfg = self.config
        if cfg.admission_inflight <= 0 and cfg.admission_backlog <= 0:
            return False
        last = self.replica.last_timestamp.get(req.client, 0)
        if req.timestamp <= last:
            return False
        reject = (
            cfg.admission_inflight > 0
            and req.timestamp - last > cfg.admission_inflight
        )
        if not reject and cfg.admission_backlog > 0:
            backlog = self.replica.pending_count() + max(
                0, self.replica.seq_counter - self.replica.executed_upto
            )
            reject = backlog > cfg.admission_backlog
        if not reject:
            return False
        self.overload_rejections += 1
        if self.metrics_registry.enabled:
            self.metrics_registry.counter(
                "pbft_overload_rejections_total"
            ).inc()
        if self.flight is not None:
            self.flight.record(
                "overload_rejected",
                view=self.replica.view,
                seq=req.timestamp,
            )
        payload = json.dumps(
            {
                "type": "overloaded",
                "client": req.client,
                "timestamp": req.timestamp,
                "replica": self.id,
            },
            separators=(",", ":"),
        ).encode()
        if req.client.startswith(GATEWAY_CLIENT_PREFIX):
            self._gateway_line(req.client, payload)
        else:
            asyncio.get_running_loop().create_task(
                self._dial_line(req.client, payload + b"\n")
            )
        return True

    def _ingest_mac(self, msg: Message, payload: bytes, chan) -> None:
        """One MAC-vector frame off an authenticator-mode link: verify
        this replica's lane against the link's session key and the
        message's claimed sender against the link's authenticated peer,
        then dispatch WITHOUT the verify queue (the whole point — zero
        hot-path signature verification). A frame with no lane for us
        (link joined mid-fan-out) falls back to the signature path the
        embedded sig still serves; a lane MISMATCH is dropped and
        counted (a tampered or replayed-across-links frame)."""
        lane = mac_frame_lane(payload, self.id)
        if lane is None:
            self._ingest(msg, payload)
            return
        expected = secure.mac_tag(
            chan.auth_recv_key, signable_from_payload(payload, msg)
        )
        if not hmac.compare_digest(lane, expected) or (
            getattr(msg, "replica", None) != chan.peer_id
        ):
            self.mac_rejected += 1
            return
        self.frames_in += 1
        if self.metrics_registry.enabled:
            self.metrics_registry.counter("pbft_frames_in_total").inc()
        actions = self.replica.receive_authenticated(msg)
        if actions:
            self._emit(actions)
        self._batch_wakeup.set()

    def _ingest(self, msg: Message, payload: Optional[bytes] = None) -> None:
        self.frames_in += 1
        if self.metrics_registry.enabled:
            self.metrics_registry.counter("pbft_frames_in_total").inc()
        if isinstance(msg, ClientRequest):
            if self._admission_reject(msg):
                return
            # Request-level waterfall anchor: when this replica
            # first saw the request — on the primary, the start of the
            # client-queue -> batch-wait handoff.
            if self.flight is not None:
                self.flight.record(
                    "request_rx", view=self.replica.view, seq=msg.timestamp
                )
            tracer = get_tracer()
            if tracer.enabled:
                tracer.event(
                    "request_rx",
                    replica=self.id,
                    client=msg.client,
                    req_ts=msg.timestamp,
                )
        if payload is not None and not isinstance(msg, ClientRequest):
            # Receive-side canonical reuse: derive the signable digest
            # from the framed bytes (sig-splice for JSON; the binary path
            # falls through to the fixed signable template) so the verify
            # queue never re-serializes. The raw client gateway passes no
            # payload — its input is not guaranteed canonical.
            actions = self.replica.receive(
                msg, signable_from_payload(payload, msg)
            )
        else:
            actions = self.replica.receive(msg)
        if actions:
            self._emit(actions)
        if self.replica.open_batch_size() > 0:
            if self._batch_open_since is None:
                self._batch_open_since = time.monotonic()
            if self._batch_flush_handle is None:
                self._batch_flush_handle = (
                    asyncio.get_running_loop().call_later(
                        self.config.batch_flush_us / 1e6,
                        self._flush_open_batch,
                    )
                )
        self._batch_wakeup.set()

    def _flush_open_batch(self) -> None:
        """batch_flush_us expired: seal the partial batch. A seal refused
        by a closed watermark window keeps the batch open — re-arm so the
        next tick retries instead of dropping the requests."""
        self._batch_flush_handle = None
        self._emit(self.replica.flush_open_batch())
        if self.replica.open_batch_size() > 0 and not self._stopping:
            self._batch_flush_handle = asyncio.get_running_loop().call_later(
                max(self.config.batch_flush_us / 1e6, 0.001),
                self._flush_open_batch,
            )
        self._batch_wakeup.set()

    # -- the batching window -------------------------------------------------

    async def _batch_pump(self) -> None:
        """Drain -> one batched verify (one window) -> emit, forever."""
        loop = asyncio.get_running_loop()
        flush_s = self.config.verify_flush_us / 1e6
        flush_target = self.config.verify_flush_items or self.config.batch_pad
        while not self._stopping:
            await self._batch_wakeup.wait()
            self._batch_wakeup.clear()
            if flush_s > 0 and self.replica.pending_count():
                # Bounded accumulation (config.verify_flush_us/_items):
                # hold the queue until the item target or the deadline so
                # one launch carries a whole window, not one wakeup's
                # trickle. Socket readers keep appending meanwhile.
                deadline = loop.time() + flush_s
                while (
                    not self._stopping
                    and self.replica.pending_count() < flush_target
                ):
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        break
                    await asyncio.sleep(min(remaining, flush_s / 8))
            items = self.replica.pending_items()
            if not items:
                continue
            self.batches_run += 1
            if self.metrics_registry.enabled:  # batch boundaries only, like tracing
                self.metrics_registry.gauge("pbft_verify_queue_depth").set(len(items))
            # The verify call blocks (a window on the card, the host's
            # pool, or a service round trip); run it off the event loop so
            # sockets keep draining into the next batch meanwhile.
            t0 = time.monotonic()
            verdicts = await loop.run_in_executor(None, self.verify, items)
            secs = time.monotonic() - t0
            if self.metrics_registry.enabled:
                self.metrics_registry.counter("pbft_verify_batches_total").inc()
                self.metrics_registry.counter("pbft_verify_items_total").inc(len(items))
                self.metrics_registry.counter("pbft_verify_rejected_total").inc(
                    verdicts.count(False)
                )
                self.metrics_registry.histogram("pbft_verify_batch_size").observe(len(items))
                self.metrics_registry.histogram("pbft_verify_seconds").observe(secs)
                # In-process verifier: the "inflight age" IS the last
                # launch's round trip (mirrors the C++ async gauge).
                self.metrics_registry.gauge("pbft_verify_inflight_age_seconds").set(
                    round(secs, 6)
                )
            if self.flight is not None:
                self.flight.record(
                    "verify_batch",
                    view=self.replica.view,
                    seq=len(items),
                    peer=verdicts.count(False),
                )
            tracer = get_tracer()
            if tracer.enabled:  # batch boundaries only — never per message
                tracer.event(
                    "verify_batch",
                    replica=self.id,
                    size=len(items),
                    rejected=verdicts.count(False),
                    secs=round(secs, 6),
                    view=self.replica.view,
                    executed=self.replica.executed_upto,
                )
            self._emit(self.replica.deliver_verdicts(verdicts))

    # -- outbound ------------------------------------------------------------

    def _count_fault(self) -> None:
        self.faults_injected += 1
        if self.metrics_registry.enabled:
            self.metrics_registry.counter("pbft_faults_injected_total").inc()

    def _equivocate_variant(self, pp: PrePrepare) -> Message:
        """Variant B of this primary's own pre-prepare: operations
        mutated, digest recomputed, re-signed (mirrors core/net.cc)."""
        reqs_b = tuple(
            dataclasses.replace(r, operation=r.operation + EQUIV_SUFFIX)
            for r in pp.requests
        )
        variant = dataclasses.replace(
            pp, requests=reqs_b, digest=batch_digest(reqs_b), sig=""
        )
        return with_sig(
            variant, _host_sign(self._seed, variant.signable()).hex()
        )

    def _broadcast(self, loop, msg: Message) -> None:
        """One serialize-once fan-out of ``msg`` to every peer."""
        self.broadcasts += 1
        enc = _EncodedOut(self._corrupt_sig(msg), server=self)
        for dest in range(self.config.n):
            if dest != self.id:
                loop.create_task(self._send_to(dest, enc))

    def _trace_batch_sealed(self, pp: PrePrepare) -> None:
        """The primary sealed a batch (its own pre-prepare broadcast):
        emit the waterfall join record — (view, seq) plus the ordered
        [client, req_ts] keys and how long the batch waited open."""
        wait = 0.0
        if self._batch_open_since is not None:
            wait = max(0.0, time.monotonic() - self._batch_open_since)
            self._batch_open_since = None
        tracer = get_tracer()
        if tracer.enabled:
            tracer.event(
                "batch_sealed",
                replica=self.id,
                view=pp.view,
                seq=pp.seq,
                batch=len(pp.requests),
                wait_s=round(wait, 6),
                reqs=[[r.client, r.timestamp] for r in pp.requests],
            )

    def _flush_wal(self) -> None:
        """Group commit: one write + one fsync for every WAL
        record noted since the last emit boundary — durability BEFORE
        visibility, off the per-message path. Sync on purpose: the send
        tasks _emit creates only run after this method returns, so no
        vote can reach a socket before it is durable."""
        wal = self.wal
        if wal is None or not wal.pending():
            return
        wal.flush()
        if self.metrics_registry.enabled:
            a0, f0, b0 = self._seen_wal
            reg = self.metrics_registry
            reg.counter("pbft_wal_appends_total").inc(wal.appends - a0)
            reg.counter("pbft_wal_fsyncs_total").inc(wal.fsyncs - f0)
            reg.counter("pbft_wal_bytes_total").inc(wal.bytes_written - b0)
        self._seen_wal = (wal.appends, wal.fsyncs, wal.bytes_written)

    def _emit(self, actions: List) -> None:
        if self.wal is not None:
            self._flush_wal()
        loop = asyncio.get_running_loop()
        mute = self.fault == "mute"
        for act in actions:
            if isinstance(act, Broadcast):
                if (
                    isinstance(act.msg, PrePrepare)
                    and act.msg.replica == self.id
                ):
                    # Seal observed BEFORE the fault modes: even a muted
                    # or equivocating primary sealed locally. (The flight
                    # record comes from the "request" phase transition.)
                    self._trace_batch_sealed(act.msg)
                if mute:  # receives but never sends (--fault mute)
                    self._count_fault()
                    continue
                if (
                    self.fault == "equivocate"
                    and isinstance(act.msg, PrePrepare)
                    and act.msg.replica == self.id
                    and act.msg.requests
                ):
                    # The equivocating primary forks its own pre-prepare:
                    # even peers get the genuine batch, odd peers a
                    # conflicting validly-signed one — same (view, seq),
                    # different digest. At <= f faulty neither side can
                    # reach a commit quorum; the honest replicas' timers
                    # must vote this primary out.
                    self._count_fault()
                    self.broadcasts += 1
                    enc_a = _EncodedOut(act.msg, server=self)
                    enc_b = _EncodedOut(
                        self._equivocate_variant(act.msg), server=self
                    )
                    for dest in range(self.config.n):
                        if dest != self.id:
                            loop.create_task(
                                self._send_to(
                                    dest, enc_a if dest % 2 == 0 else enc_b
                                )
                            )
                    continue
                # Serialize-once fan-out: ONE canonical encode (and at
                # most one binary-v2 encode, when any link negotiated it)
                # per broadcast, shared by every destination task. The
                # Byzantine corruption is applied once too.
                self._broadcast(loop, act.msg)
                if self.fault == "stutter":
                    # Seeded stale replays alongside the fresh broadcast:
                    # honest replicas must treat the replay as the
                    # duplicate it is.
                    if self._stutter_history and self._chaos_rng.random() < 0.3:
                        self._count_fault()
                        self._broadcast(
                            loop, self._chaos_rng.choice(self._stutter_history)
                        )
                    self._stutter_history.append(act.msg)
                    del self._stutter_history[:-32]
            elif isinstance(act, Send):
                if isinstance(act.msg, ClientRequest) and self.vc_timeout > 0:
                    self._waiting_requests[
                        (act.msg.client, act.msg.timestamp)
                    ] = time.monotonic() + self.vc_timeout
                if act.dest == self.id:
                    self._ingest(act.msg)
                elif mute:
                    self._count_fault()
                else:
                    loop.create_task(
                        self._send_to(
                            act.dest, _EncodedOut(self._corrupt_sig(act.msg))
                        )
                    )
            elif isinstance(act, Reply):
                self._waiting_requests.pop(
                    (act.msg.client, act.msg.timestamp), None
                )
                if mute:  # a mute replica never dials the client back
                    self._count_fault()
                    continue
                if self.flight is not None:
                    self.flight.record(
                        "reply_tx", view=act.msg.view, seq=act.msg.timestamp
                    )
                    if act.msg.tentative:
                        # Fast-path coverage: the reply left
                        # at PREPARED, one commit round-trip early.
                        self.flight.record(
                            "tentative_reply",
                            view=act.msg.view,
                            seq=act.msg.timestamp,
                        )
                tracer = get_tracer()
                if tracer.enabled:
                    tracer.event(
                        "reply_tx",
                        replica=self.id,
                        client=act.msg.client,
                        req_ts=act.msg.timestamp,
                        view=act.msg.view,
                    )
                if act.client.startswith(GATEWAY_CLIENT_PREFIX):
                    # Gateway-routed client: the "address" is a
                    # routing token, never dialable — one framed write on
                    # the persistent gateway link instead of a dial-back.
                    self._gateway_reply(act.client, act.msg)
                else:
                    loop.create_task(self._dial_reply(act.client, act.msg))
        # Tentative-execution surface: counter deltas + the
        # rollback flight record (a rollback is a rare, load-bearing
        # event — exactly what the black box exists to capture).
        t_roll = self.replica.counters["tentative_rollbacks"]
        if t_roll > self._seen_rollbacks:
            if self.flight is not None:
                self.flight.record(
                    "tentative_rollback",
                    view=self.replica.view,
                    seq=t_roll - self._seen_rollbacks,
                )
            if self.metrics_registry.enabled:
                self.metrics_registry.counter(
                    "pbft_tentative_rollbacks_total"
                ).inc(t_roll - self._seen_rollbacks)
            self._seen_rollbacks = t_roll
        if self.metrics_registry.enabled:
            t_exec = self.replica.counters["tentative_executions"]
            if t_exec > self._seen_tentative:
                self.metrics_registry.counter(
                    "pbft_tentative_executions_total"
                ).inc(t_exec - self._seen_tentative)
                self._seen_tentative = t_exec
            # Deltas of the replica's own counters: "executed" counts per
            # REQUEST, "rounds_executed" per sequence number — together
            # the batch amplification (requests per three-phase instance).
            executed = self.replica.counters["executed"]
            rounds = self.replica.counters["rounds_executed"]
            if executed > self._seen_executed:
                self.metrics_registry.counter(
                    "pbft_requests_executed_total"
                ).inc(executed - self._seen_executed)
                self._seen_executed = executed
            if rounds > self._seen_rounds:
                self.metrics_registry.counter(
                    "pbft_consensus_rounds_total"
                ).inc(rounds - self._seen_rounds)
                self._seen_rounds = rounds

    async def _open_peer_link(self, dest: int) -> Optional[_PeerLink]:
        """Dial a peer and run the link prologue: always a hello first
        frame (protocol version); in secure clusters the full initiator
        handshake (hello -> hello_r -> auth) before any protocol frame."""
        ident = self.config.identity(dest)
        host, port = ident.host, ident.port
        if port == 0:  # discovery-addressed peer (the mDNS equivalent)
            if self._discovery is None:
                if not self._warned_no_discovery:
                    self._warned_no_discovery = True
                    print(
                        f"replica {self.id}: config lists port-0 peers but "
                        "discovery is disabled (--discovery); those peers "
                        "are unreachable",
                        flush=True,
                    )
                return None
            addr = self._discovery.peers.get(dest)
            if addr is None:
                return None  # no beacon yet: retransmission covers the loss
            host, _, p = addr.rpartition(":")
            port = int(p)
        try:
            reader, writer = await asyncio.open_connection(host, port)
        except OSError:
            return None  # peer down: PBFT tolerates f of these
        if not self.secure and not self.fastpath_mac:
            writer.write(_frame_obj(secure.plain_hello(self.id)))
            # A version-mismatched responder answers with a reject frame,
            # and a 1.1.0 responder answers with its own hello (the codec
            # offer); watch for both so rejects are loud and the link
            # upgrades to binary-v2 the moment the offer arrives.
            link = _PeerLink(writer)
            asyncio.get_running_loop().create_task(
                self._watch_link(dest, reader, link)
            )
            return link
        # Secure link handshake — or, in authenticator mode on a
        # plaintext cluster, the SAME signed handshake run auth-only
        # (lane-key agreement + peer identity; frames stay plaintext).
        chan = secure.SecureChannel(
            self.id,
            self._seed,
            self._pubkey_of,
            initiator=True,
            expected_peer=dest,
            offer_mac=self.fastpath_mac,
            auth_only=not self.secure,
        )
        try:
            writer.write(_frame_obj(chan.initiator_hello()))
            await writer.drain()
            reply = json.loads(await _read_frame(reader))
            if not self.secure and not (
                isinstance(reply, dict) and isinstance(reply.get("eph"), str)
            ):
                # A plaintext responder that answered the mac-offering
                # hello with a classic hello-ack (pre-1.3.0, or
                # signature-mode config): downgrade this link to the
                # plain flavor — its ack still carried the codec offer.
                if (
                    isinstance(reply, dict)
                    and reply.get("type") == "reject"
                ):
                    raise secure.HandshakeError(
                        f"peer rejected handshake: {reply.get('reason')}"
                    )
                link = _PeerLink(
                    writer, binary=secure.hello_offers_binary(reply)
                )
                asyncio.get_running_loop().create_task(
                    self._watch_link(dest, reader, link)
                )
                return link
            auth = chan.on_hello_reply(reply)
            writer.write(_frame_obj(auth))
            await writer.drain()
        except (
            secure.HandshakeError,
            ConnectionError,
            OSError,
            asyncio.TimeoutError,
            asyncio.IncompleteReadError,
            ValueError,
        ) as e:
            print(
                f"replica {self.id}: handshake with {dest} failed: {e}",
                flush=True,
            )
            writer.close()
            return None
        # Secure links need the watcher too: a responder-side reject or
        # close after the handshake must drop the cached link immediately,
        # not linger until the next write fails (silently losing one send).
        # hello_r carried the responder's codec offer: binary-v2 from here
        # on when both sides speak it — and the mac offer: a
        # mutually-offered link registers its sender-side lane key so
        # broadcasts grow a lane for this peer.
        mac = chan.mac_negotiated
        if mac:
            self._mac_send_keys[dest] = chan.auth_send_key
        else:
            self._mac_send_keys.pop(dest, None)
        link = _PeerLink(
            writer,
            chan if self.secure else None,
            binary=secure.hello_offers_binary(reply),
            mac=mac,
        )
        asyncio.get_running_loop().create_task(
            self._watch_link(dest, reader, link)
        )
        return link

    async def _watch_link(self, dest: int, reader, link: _PeerLink) -> None:
        """Watch a dialed link (plain or secure) for reject frames, the
        plaintext hello-ack (the responder's codec offer), and EOF.
        Dropping the cached link the moment the responder closes or
        rejects means the next _send_to re-dials instead of writing into
        a dead socket's kernel buffer (which would silently lose the
        first post-failure send)."""
        writer = link.writer
        try:
            while True:
                raw = await _read_frame(reader, timeout=3600.0)
                try:
                    obj = json.loads(raw)
                except ValueError:
                    continue  # sealed frame on a secure link — not a reject
                if isinstance(obj, dict) and obj.get("type") == "reject":
                    print(
                        f"replica {self.id}: peer {dest} rejected link: "
                        f"{obj.get('reason')}",
                        flush=True,
                    )
                    break
                if isinstance(obj, dict) and obj.get("type") == "hello":
                    link.binary = secure.hello_offers_binary(obj)
        except (
            ConnectionError,
            OSError,
            asyncio.TimeoutError,
            asyncio.IncompleteReadError,
            ValueError,
        ):
            pass  # EOF / dead or hour-idle link: drop and re-dial on demand
        writer.close()
        if (cached := self._peer_links.get(dest)) and cached.writer is writer:
            self._peer_links.pop(dest, None)

    def _corrupt_sig(self, msg: Message) -> Message:
        """The Byzantine signer's outgoing message: same content, garbage
        signature (mirrors core/net.cc corrupt_sig — 'f' * len)."""
        if self.fault != "sig-corrupt":
            return msg
        sig = getattr(msg, "sig", "")
        if not sig:
            return msg
        self._count_fault()
        return with_sig(msg, "f" * len(sig))

    async def _send_to(self, dest: int, enc: _EncodedOut) -> None:
        if self.chaos_drop_pct > 0 and (
            self._chaos_rng.random() < self.chaos_drop_pct
        ):
            # Seeded link loss (--chaos-drop-pct): the frame never leaves
            # this replica — PBFT's retransmission paths must absorb it.
            self.chaos_dropped += 1
            if self.metrics_registry.enabled:
                self.metrics_registry.counter("pbft_chaos_dropped_total").inc()
            return
        if self.chaos_delay_ms > 0:
            # Held BEFORE the per-dest link lock: concurrent sends wake in
            # jittered order, so frames reorder across broadcasts, while
            # the lock still serializes the seal+write per link (secure
            # channels keep their AEAD nonce sequence).
            await asyncio.sleep(
                self._chaos_rng.random() * self.chaos_delay_ms / 1000.0
            )
        lock = self._peer_locks.setdefault(dest, asyncio.Lock())
        async with lock:
            link = self._peer_links.get(dest)
            if link is None or link.writer.is_closing():
                link = await self._open_peer_link(dest)
                if link is None:
                    return
                self._peer_links[dest] = link
            payload = None
            mac_frame = False
            if link.mac:
                # Authenticator mode: the shared MAC-vector frame — one
                # encode + one lane set per broadcast, every mac link
                # ships the same bytes (its receiver verifies its lane
                # instead of the hot-path signature).
                payload = enc.mac_payload(self._mac_send_keys)
                mac_frame = payload is not None
            if payload is None and link.binary:
                payload = enc.binary_payload()
            if payload is not None:
                self.codec_binary_frames += 1
                if self.metrics_registry.enabled:
                    self.metrics_registry.counter(
                        "pbft_codec_binary_frames_total"
                    ).inc()
                if mac_frame:
                    self.mac_frames += 1
                    if self.metrics_registry.enabled:
                        self.metrics_registry.counter(
                            "pbft_mac_frames_total"
                        ).inc()
            else:
                payload = enc.json_payload()
                self.codec_json_frames += 1
                if self.metrics_registry.enabled:
                    self.metrics_registry.counter(
                        "pbft_codec_json_frames_total"
                    ).inc()
            # Bounded-outbound admission BEFORE the seal: a
            # black-holed peer whose drain() never completes must not
            # grow the transport buffer (or the task queue behind the
            # link lock) without limit — and on secure links the drop
            # must happen before the AEAD nonce is consumed.
            if not self._writer_has_room(link.writer):
                return  # drop-and-count: retransmission absorbs the loss
            if link.chan is not None:
                # Per-peer sealing over the SHARED plaintext: the AEAD
                # counter is per-link state, so only the seal (not the
                # encode) runs per peer.
                payload = link.chan.seal_frame(payload)
            try:
                link.writer.write(_frame_bytes(payload))
                await link.writer.drain()
            except (ConnectionError, OSError):
                self._peer_links.pop(dest, None)

    def _gateway_reply(self, client: str, reply: ClientReply) -> None:
        self._gateway_line(client, reply.canonical())

    def _gateway_line(self, client: str, line: bytes) -> None:
        """Fan a raw-JSON line (reply or overloaded notice) back over the
        gateway link that forwarded for ``client`` (exact route), or over
        EVERY live gateway link when the route is unknown/stale —
        gateways drop tokens they don't own, so degradation is extra
        frames, never a lost reply quorum. Writes are admission-checked
        (bounded outbound) and never awaited: a slow gateway costs
        dropped replies, not a stalled replica."""
        payload = _frame_bytes(line)
        wid = self._gateway_routes.get(client)
        if wid is not None and wid in self._gateway_links:
            writers = [self._gateway_links[wid]]
        else:
            if wid is not None:
                self._gateway_routes.pop(client, None)  # stale route
            writers = list(self._gateway_links.values())
        for w in writers:
            if w.is_closing() or not self._writer_has_room(w):
                continue
            try:
                w.write(payload)
            except (ConnectionError, OSError, RuntimeError):
                pass

    async def _dial_reply(self, client_addr: str, reply: ClientReply) -> None:
        reply = self._corrupt_sig(reply)
        await self._dial_line(client_addr, reply.canonical() + b"\n")

    async def _dial_line(self, client_addr: str, line: bytes) -> None:
        # One dial per address at a time — a LATER reply to the same
        # address is a distinct message (the client may already be on its
        # next request), so queue on the address lock (FIFO) rather than
        # drop, bounded by the same ~6 s TTL the C++ reply backlog uses
        # (core/net.cc). Lock entries are refcounted away when idle.
        deadline = time.monotonic() + 6.0
        lock = self._reply_addr_locks.setdefault(client_addr, asyncio.Lock())
        self._reply_addr_refs[client_addr] = (
            self._reply_addr_refs.get(client_addr, 0) + 1
        )
        try:
            async with lock:
                if time.monotonic() >= deadline:
                    return  # expired in the queue: retransmission (§4.1)
                async with self._reply_dial_sem:
                    if time.monotonic() >= deadline:
                        # Expired waiting for a dial slot (e.g. behind a
                        # burst of black-holed addresses): a reply this
                        # stale is the retransmission path's job now.
                        return
                    host, _, port = client_addr.rpartition(":")
                    try:
                        _, writer = await asyncio.wait_for(
                            asyncio.open_connection(host, int(port)),
                            timeout=3.0,
                        )
                        writer.write(line)
                        await asyncio.wait_for(writer.drain(), timeout=3.0)
                        writer.close()
                    except (OSError, ValueError, asyncio.TimeoutError):
                        pass  # client gone / black-holed address
        finally:
            refs = self._reply_addr_refs[client_addr] - 1
            if refs:
                self._reply_addr_refs[client_addr] = refs
            else:
                del self._reply_addr_refs[client_addr]
                self._reply_addr_locks.pop(client_addr, None)

    # -- request/progress timer (PBFT §4.4 liveness) -------------------------

    async def _timer_loop(self) -> None:
        while not self._stopping:
            await asyncio.sleep(self.vc_timeout / 4)
            now = time.monotonic()
            for key in [
                k
                for k, t in self._waiting_requests.items()
                if now - t > 10 * self.vc_timeout
            ]:
                del self._waiting_requests[key]
            # Forwarded requests that this replica's state has executed
            # wait for nothing: a state transfer installs executions that
            # emit no reply here, and they must not hold the timer.
            done = self.replica.last_timestamp
            for key in [k for k in self._waiting_requests if k[1] <= done.get(k[0], 0)]:
                del self._waiting_requests[key]
            if self.replica.awaiting_state is not None:
                # A lagging replica waiting on state transfer retries the
                # fetch once per vc_timeout (mirrors core/net.cc) — a view
                # change would not help it catch up.
                self._timer_deadline = None
                if self._state_retry_deadline is None:
                    self._state_retry_deadline = now + self.vc_timeout
                elif now >= self._state_retry_deadline:
                    self._emit(self.replica.retry_state_transfer())
                    self._state_retry_deadline = None
                continue
            self._state_retry_deadline = None
            pending = bool(self._waiting_requests) or self.replica.has_unexecuted()
            if not pending:
                self._vc_policy.clear()
                self._observe_backoff_level()
                continue
            state = self._vc_policy.poll(
                now,
                self._timer_progress(),
                self.replica.view,
                self.replica.in_view_change,
            )
            if state == "retransmit":
                # First no-progress expiry while a view change pends:
                # re-broadcast the pending VIEW-CHANGE verbatim instead
                # of escalating — a lost VIEW-CHANGE/NEW-VIEW recovers in
                # the SAME view. The primary-elect answers a
                # retransmitted VIEW-CHANGE with its cached NEW-VIEW.
                if self.flight is not None:
                    self.flight.record(
                        "view_timer_fired",
                        view=self.replica.view,
                        seq=self._vc_policy.level,
                    )
                get_tracer().event(
                    "view_timer_fired",
                    replica=self.id,
                    view=self.replica.view,
                    backoff=self._vc_policy.level,
                )
                self._emit(self.replica.retransmit_view_change())
            elif state == "escalate":
                if self.metrics_registry.enabled:
                    self.metrics_registry.counter("pbft_view_changes_total").inc()
                # The view-change span opens here:
                # timer fired -> view_change_sent -> new_view_installed.
                if self.flight is not None:
                    self.flight.record(
                        "view_timer_fired",
                        view=self.replica.view,
                        seq=self._vc_policy.level,
                    )
                get_tracer().event(
                    "view_timer_fired",
                    replica=self.id,
                    view=self.replica.view,
                    backoff=self._vc_policy.level,
                )
                get_tracer().event(
                    "view_change_start",
                    replica=self.id,
                    pending_view=self.replica.view + 1,
                    backoff=self._vc_policy.level,
                )
                self._emit(self.replica.start_view_change())
            self._observe_backoff_level()

    def _gap_commits(self) -> int:
        """The highest sequence committed in this view above a gap in this
        replica's execution, capped at the checkpoint that must close the
        gap; 0 without a gap. A replica that missed sequences (revived
        with fresh state, or cut off) holds later ones committed by 2f+1
        replicas but cannot execute them until that checkpoint's state
        transfer: commits that keep arriving show the primary ordering,
        and the replica waits for the checkpoint rather than start a view
        change that no peer joins. Past the checkpoint the credit stops,
        so a primary that skips a sequence delays the view change by at
        most one checkpoint interval of its own ordering. Signature mode
        only (tentative mode counts committed sequences already)."""
        r = self.replica
        if r.config.tentative or r.in_view_change or not r.pending_execution:
            return 0
        top = max(r.pending_execution)
        missing = [s for s in range(r.executed_upto + 1, top) if s not in r.pending_execution]
        if not missing:
            return 0
        interval = r.config.checkpoint_interval
        return min(top, -(-missing[-1] // interval) * interval)

    def _timer_progress(self) -> int:
        """What the view timer counts as progress: a count bumped when the
        replica's progress marker advances (COMMITTED sequences in
        tentative mode: tentative executions roll back, so they must not
        placate the timer while commits starve; executed ones otherwise),
        or when ``_gap_commits`` grows."""
        seen = (self.replica.progress_marker(), self._gap_commits())
        if seen[0] > self._progress_seen[0] or seen[1] > self._progress_seen[1]:
            self._progress_ticks += 1
        self._progress_seen = seen
        return self._progress_ticks

    def _observe_backoff_level(self) -> None:
        """Push the view-timer backoff level to the gauge + flight
        recorder when it changed: a sustained high level IS
        the storm signal the chaos bench reads."""
        level = self._vc_policy.level
        if level == self._gauged_backoff:
            return
        self._gauged_backoff = level
        if self.metrics_registry.enabled:
            self.metrics_registry.gauge("pbft_view_timer_backoff_level").set(
                level
            )
        if self.flight is not None:
            self.flight.record(
                "backoff_level", view=self.replica.view, seq=level
            )

    def _refresh_health(self) -> dict:
        """Advance the last-progress tracker and push the health gauges
        (mirrors core/net.cc refresh_health). Returns the
        health-document fields metrics() folds into the status dict.
        Lazy: runs only when the status surface renders, so an
        unscraped replica pays nothing."""
        now = time.monotonic()
        executed = self.replica.executed_upto
        if executed != self._progress_seen_executed:
            self._progress_seen_executed = executed
            self._progress_seen_at = now
        rss = read_rss_bytes()
        fds = count_open_fds()
        wal_bytes = file_size_bytes(self.wal.path if self.wal else None)
        inbox = self.replica.pending_count()
        since = round(now - self._progress_seen_at, 6)
        if self.metrics_registry.enabled:
            reg = self.metrics_registry
            reg.gauge("pbft_process_rss_bytes").set(rss)
            reg.gauge("pbft_open_fds").set(fds)
            reg.gauge("pbft_wal_disk_bytes").set(wal_bytes)
            reg.gauge("pbft_last_progress_seconds").set(since)
            reg.gauge("pbft_inbox_depth").set(inbox)
        return {
            "health_version": HEALTH_DOC_VERSION,
            "uptime_seconds": round(now - self._start_time, 6),
            "rss_bytes": rss,
            "open_fds": fds,
            "wal_disk_bytes": wal_bytes,
            "inbox_depth": inbox,
            "sealed_unexecuted": max(
                0, self.replica.seq_counter - self.replica.executed_upto
            ),
            "waiting_requests": len(self._waiting_requests),
            "last_progress_seconds": since,
            "chain_digest": self.replica.committed_chain.hex(),
            "state_digest": self.replica.state_digest.hex(),
        }

    def status(self, timeout: float = 5.0) -> dict:
        """``metrics()`` for a caller on another thread (the /status scrape
        thread, a ThreadReplica's caller): built on the replica's event
        loop, so that the document is one moment of the replica. Read
        directly on the loop's own thread or when the loop does not run."""
        loop = self._loop
        if loop is None or not loop.is_running() or loop is _running_loop():
            return self.metrics()
        return asyncio.run_coroutine_threadsafe(self._metrics_on_loop(), loop).result(timeout)

    async def _metrics_on_loop(self) -> dict:
        return self.metrics()

    def metrics(self) -> dict:
        return {
            "replica": self.id,
            "port": self.listen_port,
            "frames_in": self.frames_in,
            "verify_batches": self.batches_run,
            # Remote-verifier health (service spec only): batches the
            # local native pool absorbed because the service was warming,
            # unreachable, or died mid-stream.
            "verify_service_fallbacks": (
                self.service_verifier.used_fallback
                if self.service_verifier is not None
                else 0
            ),
            "broadcasts": self.broadcasts,
            "broadcast_encodes": self.broadcast_encodes,
            "codec_binary_frames": self.codec_binary_frames,
            "codec_json_frames": self.codec_json_frames,
            # Scale-out surface (parity with core/net.cc
            # metrics_json). net_threads reports 1: the asyncio runtime
            # is single-loop whatever the config asked for.
            "net_backend": "asyncio",
            "net_threads": 1,
            "cross_thread_wakes": 0,
            "crypto_offload_queue_depth": 0,
            "connections_open": max(0, self._conns_open)
            + len(self._peer_links),
            "event_wakeups": self.event_wakeups,
            "backpressure_events": self.backpressure_events,
            "gateway_links": len(self._gateway_links),
            "gateway_forwarded": self.gateway_forwarded,
            # Perf-under-faults surface.
            "overload_rejections": self.overload_rejections,
            "gateway_failovers": self.gateway_failovers,
            "view_timer_backoff": self._vc_policy.level,
            "faults_injected": self.faults_injected,
            "chaos_dropped": self.chaos_dropped,
            # Fast-path surface: the negotiated-offer mode,
            # tentative execution, MAC frame tallies, committed floor.
            "mode": "mac" if self.fastpath_mac else "sig",
            "tentative": self.config.tentative,
            "mac_frames": self.mac_frames,
            "mac_rejected": self.mac_rejected,
            # Durable-recovery surface.
            "wal_enabled": self.wal is not None,
            "recovered_from_wal": self.recovered_from_wal,
            "wal_appends": self.wal.appends if self.wal else 0,
            "wal_fsyncs": self.wal.fsyncs if self.wal else 0,
            "wal_bytes": self.wal.bytes_written if self.wal else 0,
            "committed_upto": self.replica.committed_upto,
            "executed_upto": self.replica.executed_upto,
            "low_mark": self.replica.low_mark,
            "view": self.replica.view,
            "in_view_change": self.replica.in_view_change,
            # Health document (shape contracted with
            # core/net.cc metrics_json by HEALTH_DOC_VERSION).
            **self._refresh_health(),
            **self.replica.counters,
        }


def _running_loop() -> Optional[asyncio.AbstractEventLoop]:
    try:
        return asyncio.get_running_loop()
    except RuntimeError:
        return None


async def _amain(args, config_text: str, flight=None, wal=None) -> None:
    # config_text is read by main() BEFORE the event loop starts: file
    # I/O inside a coroutine is a blocking call on the loop (flagged by
    # the JAX package's analysis/async_blocking.py lint). The
    # WAL is opened/replayed there too for the same reason.
    config = ClusterConfig.from_json(config_text)
    # --batch-* override network.json, mirroring pbftd.
    import dataclasses as _dc

    if args.batch_max_items is not None and args.batch_max_items >= 1:
        config = _dc.replace(config, batch_max_items=args.batch_max_items)
    if args.batch_flush_us is not None and args.batch_flush_us >= 0:
        config = _dc.replace(config, batch_flush_us=args.batch_flush_us)
    # Fast-path overrides, mirroring pbftd --fastpath /
    # --tentative: network.json stays the default source of truth.
    if args.fastpath:
        config = _dc.replace(config, fastpath=args.fastpath)
    if args.tentative:
        config = _dc.replace(config, tentative=True)
    server = AsyncReplicaServer(
        config,
        args.id,
        bytes.fromhex(args.seed),
        verifier=args.verifier,
        vc_timeout=args.vc_timeout_ms / 1000.0,
        discovery=args.discovery,
        byzantine=args.byzantine,
        fault=args.fault,
        chaos_drop_pct=args.chaos_drop_pct,
        chaos_delay_ms=args.chaos_delay_ms,
        chaos_seed=args.chaos_seed,
        metrics_port=args.metrics_port,
        flight=flight,
        wal=wal,
    )
    await server.start()
    print(
        f"async replica {args.id} listening on {server.listen_port} "
        f"(verifier={args.verifier})",
        flush=True,
    )
    while True:
        await asyncio.sleep(args.metrics_every or 3600)
        if args.metrics_every:
            print(json.dumps(server.metrics()), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--id", type=int, required=True)
    parser.add_argument("--seed", required=True, help="64-hex Ed25519 seed")
    parser.add_argument(
        "--verifier",
        default="cuda",
        help="cuda = batches verified on the card in this process (raises "
        "before listening without CUDA); cpu = the host's verify pool; "
        "HOST:PORT or a unix path = a verify service",
    )
    parser.add_argument("--vc-timeout-ms", type=int, default=0)
    parser.add_argument("--metrics-every", type=int, default=0)
    parser.add_argument(
        "--batch-max-items",
        type=int,
        default=None,
        help="requests the primary folds into ONE three-phase instance "
        "(overrides network.json batch_max_items; 1 = pre-batching "
        "one-instance-per-request)",
    )
    parser.add_argument(
        "--batch-flush-us",
        type=int,
        default=None,
        help="how long a partial batch may wait for more requests before "
        "the runtime seals it (overrides network.json batch_flush_us)",
    )
    parser.add_argument(
        "--fastpath",
        default="",
        choices=("", "sig", "mac"),
        help="fast-path authenticator mode: 'mac' offers "
        "per-link session-MAC authentication of normal-case frames in "
        "this node's hellos (overrides network.json fastpath); links "
        "whose peer did not offer it fall back to signature mode",
    )
    parser.add_argument(
        "--tentative",
        action="store_true",
        help="execute + reply at PREPARED (tentative) with "
        "rollback on view change; clients need 2f+1 matching tentative "
        "votes (overrides network.json tentative=false)",
    )
    parser.add_argument(
        "--wal-dir",
        default="",
        help="durable recovery: keep a write-ahead log at "
        "{dir}/replica-{id}.wal (view, sent votes, stable checkpoint) "
        "with group-commit fsync, and on restart replay it so this "
        "replica re-joins the SAME view without contradicting a "
        "persisted vote (overrides network.json wal_dir)",
    )
    parser.add_argument(
        "--wal-fsync",
        type=int,
        default=-1,
        choices=(-1, 0, 1),
        help="1/0 overrides network.json wal_fsync: 0 keeps the WAL "
        "writes but skips fsync (kill -9 of the process stays safe via "
        "the page cache; only host power loss can drop the tail)",
    )
    parser.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        help="serve Prometheus text format on this port (0 = ephemeral); "
        "metric names match pbftd --metrics-port so a mixed-runtime "
        "cluster scrapes uniformly",
    )
    parser.add_argument(
        "--discovery",
        default="",
        help="multicast group:port for peer discovery (mDNS equivalent)",
    )
    parser.add_argument(
        "--byzantine",
        action="store_true",
        help="fault injection: corrupt every outgoing signature "
        "(legacy spelling of --fault sig-corrupt)",
    )
    parser.add_argument(
        "--fault",
        default="",
        choices=("",) + FAULT_MODES,
        help="Byzantine behavior mode (parity with pbftd --fault): "
        "sig-corrupt | mute | stutter | equivocate",
    )
    parser.add_argument(
        "--chaos-drop-pct",
        type=float,
        default=0.0,
        help="seeded link chaos: drop this fraction of outbound peer "
        "frames (0..1)",
    )
    parser.add_argument(
        "--chaos-delay-ms",
        type=int,
        default=0,
        help="seeded link chaos: hold each outbound peer frame for a "
        "uniform 0..N ms",
    )
    parser.add_argument(
        "--chaos-seed",
        type=int,
        default=None,
        help="chaos RNG seed (default: the replica id) — same seed, same "
        "drop/delay pattern",
    )
    parser.add_argument("--trace", default=None, help="JSONL trace file")
    parser.add_argument(
        "--flight-file",
        default=None,
        help="black-box flight recorder dump target: the last N protocol "
        "events, written on SIGTERM/SIGINT/fatal (decode with "
        "scripts/flight_dump.py); mirrors pbftd --flight-file",
    )
    args = parser.parse_args()
    if args.trace:
        from ..utils import set_trace_file

        set_trace_file(args.trace)
    flight = None
    if args.flight_file:
        from ..utils.flight import FlightRecorder, install_signal_dump

        flight = FlightRecorder(capacity=8192)
        install_signal_dump(flight, args.flight_file)
    with open(args.config) as fh:
        config_text = fh.read()
    # Durable recovery: open + replay the WAL here, before
    # the event loop exists — replay is file I/O, and the no-blocking-
    # calls-on-the-loop lint applies to it like any other read.
    wal = None
    cfg_for_wal = ClusterConfig.from_json(config_text)
    wal_dir = args.wal_dir or cfg_for_wal.wal_dir
    if wal_dir:
        import os as _os

        from ..consensus.wal import WriteAheadLog

        _os.makedirs(wal_dir, exist_ok=True)
        do_fsync = (
            cfg_for_wal.wal_fsync if args.wal_fsync < 0 else bool(args.wal_fsync)
        )
        wal = WriteAheadLog(
            _os.path.join(wal_dir, f"replica-{args.id}.wal"), fsync=do_fsync
        )
    try:
        asyncio.run(_amain(args, config_text, flight=flight, wal=wal))
    except BaseException:
        # Fatal path (unhandled exception, loop torn down): the black box
        # must still ship — same contract as pbftd's on_fatal handler.
        if flight is not None:
            flight.dump(args.flight_file)
        raise


if __name__ == "__main__":
    main()
