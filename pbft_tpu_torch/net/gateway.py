"""Client-gateway tier: multiplex thousands of client connections onto a
few persistent replica links (the port's copy of
``pbft_tpu/net/gateway.py``).

The reference's client contract (raw JSON request in, reply *dialed back*
to the client's advertised host:port) costs the cluster ~n sockets per
concurrent client — at a "millions of users" scale that is FD
exhaustion long before it is a throughput problem. The gateway keeps the
telnet-able downstream contract (raw JSON lines in, raw JSON reply lines
out, all on ONE connection) and swaps the upstream shape: one framed,
persistent link per replica, announced by a ``role=gateway`` hello, over
which client requests flow up and replies fan BACK (both runtimes trust
the link instead of dialing the client; core/net.cc + net/server.py).
10k concurrent clients then cost the cluster ~n·gateways sockets.

Identity: a gateway-routed client addresses itself with a ROUTING TOKEN,
never a dialable address — the ``gw/``-prefixed ``client`` field
(GATEWAY_CLIENT_PREFIX, mirrored by core/net.h kGatewayClientPrefix;
constants lint). Tokens are client-chosen and stable across reconnects,
so per-(client, ts) exactly-once and the cached-reply retransmission path
(PBFT §4.1) survive a gateway restart exactly as they survive a client
redial. The gateway forwards request bytes UNCHANGED (canonicality is
end-to-end); replies are routed downstream by the token each reply
carries, and every replica's copy is forwarded — the f+1 reply-quorum
count stays where the paper puts it, in the client.

Forwarding policy: a fresh (token, ts) goes to the current primary
(tracked from the view field of routed replies); a retransmission (ts
not above the token's high-water mark) broadcasts to ALL replicas —
the paper's client liveness rule, which forces forwarding and
eventually a view change on a faulty primary.

Run one gateway:  python -m pbft_tpu_torch.net.gateway --config network.json \
                      [--port P] [--metrics-port M]
Secure clusters are refused upstream: a gateway holds no replica
identity, so the signed-DH handshake cannot admit it.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import socket
import threading
import time
from typing import Dict, List, Optional

from ..consensus.config import ClusterConfig
from ..consensus.messages import ClientRequest
from ..utils import (
    MetricsRegistry,
    count_open_fds,
    read_rss_bytes,
    start_metrics_server,
)
from ..utils.trace_schema import HEALTH_DOC_VERSION
from . import secure
from .client import PbftClient

# Gateway-routed client identities carry this prefix (mirrored by
# core/net.h kGatewayClientPrefix; constants lint): such a "client
# address" is a routing token, never a dialable host:port.
GATEWAY_CLIENT_PREFIX = "gw/"

# Bounded outbound per downstream/upstream connection (mirrors
# server.py MAX_CONN_OUTBOUND / core/net.cc kMaxConnOutbound).
_MAX_WRITE_BUFFER = 8 << 20
# Token bookkeeping bound: on overflow the maps clear — a cleared route
# re-registers on the client's next request, a cleared high-water mark
# turns one fresh request into a broadcast (extra frames, never loss).
_MAX_TOKENS = 1 << 17

# A raw-JSON client line may not exceed this (same bound as the replica
# gateways): longer input is a protocol violation on an unauthenticated
# socket and drops the connection instead of buffering without bound.
MAX_CLIENT_LINE = 1 << 20


def _frame_bytes(payload: bytes) -> bytes:
    return len(payload).to_bytes(4, "big") + payload


def gateway_hello() -> dict:
    """The version-carrying hello that opens every upstream link. The
    ``role`` field is the trust switch: both runtimes mark the link as a
    gateway link (requests arrive on it, replies fan back over it)."""
    return {
        "type": "hello",
        "ver": secure.wire_hello_version(),
        "node": -1,
        "role": "gateway",
    }


class _UpstreamLink:
    """One persistent framed link to a replica."""

    __slots__ = ("writer", "task")

    def __init__(self, writer: asyncio.StreamWriter, task: asyncio.Task):
        self.writer = writer
        self.task = task


class ClientGateway:
    """One gateway process: a raw-JSON line server for clients in front
    of n persistent framed replica links."""

    def __init__(
        self,
        config: ClusterConfig,
        host: str = "0.0.0.0",
        port: int = 0,
        metrics_port: Optional[int] = None,
        max_inflight: int = 0,
        max_queue_depth: int = 0,
        flight=None,
    ):
        if config.secure:
            raise ValueError(
                "gateway tier requires a plaintext cluster: a gateway has "
                "no replica identity for the signed-DH handshake"
            )
        self.config = config
        self.host = host
        self.port = port
        self.listen_port = 0
        self.metrics_registry = MetricsRegistry(
            labels={"gateway": "0"}, enabled=metrics_port is not None
        )
        if self.metrics_registry.enabled:
            self.metrics_registry.preregister(emitter="gateway.py")
        self.metrics_port = metrics_port
        self._metrics_server = None
        self.metrics_listen_port = 0
        self._server: Optional[asyncio.Server] = None
        # token -> downstream writer (the reply route), and the per-token
        # forwarded-timestamp high-water mark (retransmission detection).
        self._routes: Dict[str, asyncio.StreamWriter] = {}
        self._last_ts: Dict[str, int] = {}
        # rid -> _UpstreamLink, each guarded by a per-rid lock so one
        # dial+hello runs per replica.
        self._links: Dict[int, _UpstreamLink] = {}
        self._link_locks: Dict[int, asyncio.Lock] = {}
        # Current view, tracked from routed replies: fresh requests go to
        # view % n, so a view change re-aims the firehose without any
        # client knowing.
        self._view = 0
        self._stopping = False
        self._keeper_task: Optional[asyncio.Task] = None
        self.clients_open = 0
        self.forwarded = 0
        self.replies_routed = 0
        self.backpressure_events = 0
        # Admission control: per-token in-flight cap +
        # a global queue-depth watermark. A FRESH request past either
        # bound is answered with an explicit {"type": "overloaded"} line
        # downstream and NOT forwarded; retransmissions of an already
        # in-flight (token, ts) always pass — liveness is never
        # admission-gated. In-flight entries prune when a reply routes
        # (per-client execution is timestamp-ordered, so a reply for ts
        # retires every entry at or below it). 0 disables either bound.
        self.max_inflight = max_inflight
        self.max_queue_depth = max_queue_depth
        self._inflight: Dict[str, set] = {}
        self._inflight_total = 0
        self.overload_rejections = 0
        # Gateway-fabric failovers: upstream replica links this
        # gateway had to re-dial after they died mid-run.
        self.upstream_failovers = 0
        # Black-box flight recorder (utils/flight.py, --flight-file):
        # failover/overload events ship with the chaos bench's black
        # boxes the same way replica recorders do. None = one attribute
        # check per event site.
        self.flight = flight
        # Health-document uptime anchor.
        self._start_time = time.monotonic()

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "ClientGateway":
        self._server = await asyncio.start_server(
            self._on_client, host=self.host, port=self.port
        )
        self.listen_port = self._server.sockets[0].getsockname()[1]
        if self.metrics_port is not None:
            # /status serves the gateway's health document so
            # pbft_top can watch the tier alongside the replicas.
            self._metrics_server = start_metrics_server(
                self.metrics_registry, self.metrics_port,
                status_fn=self.metrics,
            )
            self.metrics_listen_port = self._metrics_server.server_address[1]
        # EVERY replica needs a live gateway link, not just the ones
        # requests flow to: a backup only ever SENDS on its link (the
        # reply fan-back for requests it saw via pre-prepare), so lazy
        # dial-on-send would leave backup replies with nowhere to go and
        # the client short of its f+1 quorum.
        self._keeper_task = asyncio.get_running_loop().create_task(
            self._link_keeper()
        )
        return self

    async def _link_keeper(self) -> None:
        while not self._stopping:
            for rid in range(self.config.n):
                try:
                    await self._ensure_link(rid)
                except OSError:
                    pass  # replica down: PBFT tolerates f of these
            await asyncio.sleep(1.0)

    async def stop(self) -> None:
        self._stopping = True
        if self._keeper_task is not None:
            self._keeper_task.cancel()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for link in self._links.values():
            link.writer.close()
            link.task.cancel()
        self._links.clear()

    def metrics(self) -> dict:
        return {
            # Health document: the gateway is a replica-less
            # process, so its document is the resource subset — no
            # progress watermarks or chain digests to report.
            "health_version": HEALTH_DOC_VERSION,
            "uptime_seconds": round(time.monotonic() - self._start_time, 6),
            "rss_bytes": read_rss_bytes(),
            "open_fds": count_open_fds(),
            "gateway_clients_open": self.clients_open,
            "gateway_forwarded": self.forwarded,
            "replies_routed": self.replies_routed,
            "backpressure_events": self.backpressure_events,
            "upstream_links": len(self._links),
            "overload_rejections": self.overload_rejections,
            "gateway_failovers": self.upstream_failovers,
            "inflight": self._inflight_total,
            "view": self._view,
        }

    # -- downstream (clients) ------------------------------------------------

    def _set_clients_gauge(self) -> None:
        if self.metrics_registry.enabled:
            self.metrics_registry.gauge("pbft_gateway_clients_open").set(
                self.clients_open
            )

    def _writer_has_room(self, writer: asyncio.StreamWriter) -> bool:
        """Bounded outbound against a slow reader (drop-and-count): the
        dropped reply is re-fetched from the replicas' reply caches on
        retransmission, a dropped request is retransmission-covered."""
        try:
            size = writer.transport.get_write_buffer_size()
        except (AttributeError, RuntimeError):
            return True
        if size > _MAX_WRITE_BUFFER:
            self.backpressure_events += 1
            if self.metrics_registry.enabled:
                self.metrics_registry.counter(
                    "pbft_write_backpressure_events_total"
                ).inc()
            return False
        return True

    async def _on_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self.clients_open += 1
        self._set_clients_gauge()
        owned_tokens: List[str] = []
        try:
            buf = b""
            while True:
                nl = buf.find(b"\n")
                if nl >= 0:
                    line, buf = buf[:nl], buf[nl + 1 :]
                    await self._handle_line(line.strip(), writer, owned_tokens)
                    continue
                if len(buf) > MAX_CLIENT_LINE:
                    return  # oversized line: drop the connection
                chunk = await reader.read(65536)
                if not chunk:
                    return
                buf += chunk
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            pass
        finally:
            self.clients_open -= 1
            self._set_clients_gauge()
            for token in owned_tokens:
                if self._routes.get(token) is writer:
                    self._routes.pop(token, None)
            writer.close()

    async def _handle_line(
        self, line: bytes, writer: asyncio.StreamWriter, owned_tokens: List[str]
    ) -> None:
        if not line:
            return
        try:
            obj = json.loads(line)
        except (ValueError, UnicodeDecodeError):
            return
        if not isinstance(obj, dict):
            return
        token = obj.get("client")
        if not isinstance(token, str) or not token.startswith(
            GATEWAY_CLIENT_PREFIX
        ):
            # A dialable address through the gateway would re-open the
            # per-client-socket cost the tier exists to remove — and an
            # unauthenticated redirect channel. Drop it.
            return
        if token not in self._routes:
            owned_tokens.append(token)
        if len(self._routes) >= _MAX_TOKENS:
            self._routes.clear()
        self._routes[token] = writer
        ts = obj.get("timestamp")
        retransmission = (
            isinstance(ts, int) and self._last_ts.get(token, -1) >= ts
        )
        if not retransmission and isinstance(ts, int):
            # Admission control: a fresh request past the
            # per-token in-flight cap or the global watermark is rejected
            # with an explicit overloaded line instead of queueing into
            # the cluster's tail. Retransmissions always pass.
            pend = self._inflight.setdefault(token, set())
            if ts not in pend and (
                (self.max_inflight > 0 and len(pend) >= self.max_inflight)
                or (
                    self.max_queue_depth > 0
                    and self._inflight_total >= self.max_queue_depth
                )
            ):
                self._reject_overloaded(token, ts, writer)
                return
            if ts not in pend:
                pend.add(ts)
                self._inflight_total += 1
        framed = _frame_bytes(bytes(line))
        self.forwarded += 1
        if self.metrics_registry.enabled:
            self.metrics_registry.counter("pbft_gateway_forwarded_total").inc()
        if isinstance(ts, int) and not retransmission:
            if len(self._last_ts) >= _MAX_TOKENS:
                self._last_ts.clear()
            self._last_ts[token] = ts
        if retransmission:
            # The paper's client liveness rule by proxy: a retransmitted
            # request broadcasts to every replica, forcing forwards and
            # eventually a view change on a faulty primary.
            for rid in range(self.config.n):
                await self._send_upstream(rid, framed)
        else:
            await self._send_upstream(self._view % self.config.n, framed)

    def _reject_overloaded(self, token: str, ts: int, writer) -> None:
        """Answer a rejected request with an explicit overloaded line —
        the client backs off with jitter (request_with_retry) instead of
        interpreting silence as a faulty primary."""
        self.overload_rejections += 1
        if self.metrics_registry.enabled:
            self.metrics_registry.counter(
                "pbft_overload_rejections_total"
            ).inc()
        if self.flight is not None:
            self.flight.record("overload_rejected", view=self._view, seq=ts)
        if writer.is_closing() or not self._writer_has_room(writer):
            return
        try:
            writer.write(
                json.dumps(
                    {
                        "type": "overloaded",
                        "client": token,
                        "timestamp": ts,
                        "replica": -1,
                    },
                    separators=(",", ":"),
                ).encode()
                + b"\n"
            )
        except (ConnectionError, OSError, RuntimeError):
            pass

    def _retire_inflight(self, token: str, ts: int) -> None:
        """A reply for (token, ts) routed downstream: per-client execution
        is timestamp-ordered, so every in-flight entry at or below ts is
        complete (or superseded) — prune them all."""
        pend = self._inflight.get(token)
        if not pend:
            return
        done = {t for t in pend if t <= ts}
        if done:
            pend.difference_update(done)
            self._inflight_total -= len(done)
        if not pend:
            del self._inflight[token]

    # -- upstream (replicas) -------------------------------------------------

    async def _send_upstream(self, rid: int, framed: bytes) -> None:
        link = await self._ensure_link(rid)
        if link is None:
            return  # replica down: PBFT tolerates f of these
        if link.writer.is_closing() or not self._writer_has_room(link.writer):
            return  # drop-and-count: retransmission absorbs the loss
        try:
            link.writer.write(framed)
        except (ConnectionError, OSError, RuntimeError):
            self._drop_link(rid, link)

    async def _ensure_link(self, rid: int) -> Optional[_UpstreamLink]:
        link = self._links.get(rid)
        if link is not None and not link.writer.is_closing():
            return link
        lock = self._link_locks.setdefault(rid, asyncio.Lock())
        async with lock:
            link = self._links.get(rid)
            if link is not None and not link.writer.is_closing():
                return link
            ident = self.config.identity(rid)
            try:
                reader, writer = await asyncio.open_connection(
                    ident.host, ident.port
                )
            except OSError:
                return None
            writer.write(
                _frame_bytes(
                    json.dumps(
                        gateway_hello(), separators=(",", ":")
                    ).encode()
                )
            )
            task = asyncio.get_running_loop().create_task(
                self._link_reader(rid, reader)
            )
            link = _UpstreamLink(writer, task)
            self._links[rid] = link
            return link

    def _drop_link(self, rid: int, link: _UpstreamLink) -> None:
        if self._links.get(rid) is link:
            self._links.pop(rid, None)
        link.writer.close()

    async def _link_reader(self, rid: int, reader: asyncio.StreamReader) -> None:
        """Drain one upstream link: hello-acks are consumed, rejects are
        loud, and every reply frame routes downstream by its token."""
        buf = b""
        try:
            while True:
                while len(buf) < 4:
                    chunk = await reader.read(65536)
                    if not chunk:
                        return
                    buf += chunk
                n = int.from_bytes(buf[:4], "big")
                if n > (1 << 24):
                    return  # corrupt frame: drop the link
                while len(buf) < 4 + n:
                    chunk = await reader.read(65536)
                    if not chunk:
                        return
                    buf += chunk
                payload, buf = buf[4 : 4 + n], buf[4 + n :]
                try:
                    obj = json.loads(payload)
                except (ValueError, UnicodeDecodeError):
                    continue
                if not isinstance(obj, dict):
                    continue
                kind = obj.get("type")
                if kind == "hello":
                    continue  # the responder's version/codec ack
                if kind == "reject":
                    print(
                        f"gateway: replica {rid} rejected link: "
                        f"{obj.get('reason')}",
                        flush=True,
                    )
                    return
                self._route_reply(obj, payload)
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            pass
        finally:
            link = self._links.get(rid)
            if link is not None and link.task is asyncio.current_task():
                self._links.pop(rid, None)
            if not self._stopping:
                # Upstream replica link died mid-run: the
                # keeper re-dials within a second — count the failover so
                # a chaos arm can attribute the blip.
                self.upstream_failovers += 1
                if self.metrics_registry.enabled:
                    self.metrics_registry.counter(
                        "pbft_gateway_failovers_total"
                    ).inc()
                if self.flight is not None:
                    self.flight.record(
                        "gateway_failover", view=self._view, peer=rid
                    )

    def _route_reply(self, obj: dict, payload: bytes) -> None:
        token = obj.get("client")
        if not isinstance(token, str):
            return
        view = obj.get("view")
        if isinstance(view, int) and view > self._view:
            self._view = view  # a view change re-aims fresh requests
        ts = obj.get("timestamp")
        if isinstance(ts, int):
            # Completion retires admission bookkeeping whether or not the
            # downstream client is still connected to hear about it.
            self._retire_inflight(token, ts)
        w = self._routes.get(token)
        if w is None or w.is_closing():
            return  # token not ours (fan-out copy) or client gone
        if not self._writer_has_room(w):
            return  # slow client: drop; retransmission re-fetches
        try:
            w.write(payload + b"\n")
            self.replies_routed += 1
        except (ConnectionError, OSError, RuntimeError):
            pass


# -- the client side of the tier ---------------------------------------------

_token_seq_lock = threading.Lock()
_token_seq = 0


def next_token(prefix: str = "c") -> str:
    """A process-unique gateway routing token. Stable identity is the
    CALLER's job across reconnects (pass the same token back in); this
    only guarantees two clients in one process never collide."""
    global _token_seq
    with _token_seq_lock:
        _token_seq += 1
        return (
            f"{GATEWAY_CLIENT_PREFIX}{prefix}-"
            f"{threading.get_native_id():x}-{_token_seq:x}"
        )


class GatewayClient(PbftClient):
    """PbftClient surface over a gateway connection: same f+1
    signature-verified reply quorum (wait_result is inherited), but no
    dial-back listener — requests and replies share ONE socket, and the
    identity is a routing token instead of host:port.

    HA: pass SEVERAL gateway addresses and the client fails
    over on a dead socket — reconnect to the next gateway, same stable
    ``gw/`` token, and replay of the in-flight request lines. Because the
    token and timestamps are unchanged, the replicas' per-(client, ts)
    exactly-once guard + reply caches make the replay safe: a request the
    dead gateway already forwarded executes once and the replay is
    answered from the cache, one it never forwarded gets ordered now —
    completion stays 100% through a gateway death mid-request."""

    def __init__(
        self,
        config: ClusterConfig,
        gateway_addr,
        token: Optional[str] = None,
    ):
        # Deliberately no super().__init__: the base class would start a
        # dial-back listener, which is exactly what the gateway removes.
        self.config = config
        self.replies = []
        self._lock = threading.Lock()
        self._new_reply = threading.Condition(self._lock)
        self._send_lock = threading.Lock()
        self._timestamp = 0
        self.latency_log = {}
        self.address = token or next_token()
        self._addrs: List[str] = (
            [gateway_addr]
            if isinstance(gateway_addr, str)
            else list(gateway_addr)
        )
        self._addr_idx = 0
        # ts -> raw request line, for the failover replay. Entries retire
        # on the first reply seen for their timestamp (a partially-voted
        # request is re-covered by the normal retransmission path).
        self._inflight_lines: Dict[int, bytes] = {}
        self.failovers = 0
        self._closed = False
        self.sock = self._dial_gateway(first=True)
        self._rx_thread = threading.Thread(
            target=self._read_loop, args=(self.sock,), daemon=True
        )
        self._rx_thread.start()

    def _dial_gateway(self, first: bool = False) -> socket.socket:
        """Dial gateways round-robin starting at the current index;
        raises the last OSError when none answers."""
        last_err: Optional[OSError] = None
        for i in range(len(self._addrs)):
            idx = (self._addr_idx + (0 if first else 1) + i) % len(
                self._addrs
            )
            host, _, port = self._addrs[idx].rpartition(":")
            try:
                s = socket.create_connection((host, int(port)), timeout=10)
            except OSError as e:
                last_err = e
                continue
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._addr_idx = idx
            return s
        raise last_err or OSError("no gateway reachable")

    def _failover_locked(self, dead: socket.socket) -> None:
        """Replace a dead gateway socket (caller holds _send_lock): dial
        the next gateway, replay every in-flight request line under the
        SAME token, restart the reader. Raises OSError when no gateway
        answers (callers surface it or retry on their own timer)."""
        if self._closed or self.sock is not dead:
            return  # another thread already failed over
        try:
            dead.close()
        except OSError:
            pass
        s = self._dial_gateway()
        self.sock = s
        self.failovers += 1
        for ts in sorted(self._inflight_lines):
            try:
                s.sendall(self._inflight_lines[ts])
            except OSError:
                break  # the next _send_line attempt fails over again
        self._rx_thread = threading.Thread(
            target=self._read_loop, args=(s,), daemon=True
        )
        self._rx_thread.start()

    def _read_loop(self, sock: socket.socket) -> None:
        try:
            fh = sock.makefile("rb")
            for line in fh:
                rx = time.monotonic()
                line = line.strip()
                if not line:
                    continue
                try:
                    reply = json.loads(line)
                except (ValueError, UnicodeDecodeError):
                    continue
                if isinstance(reply, dict):
                    reply["_rx"] = rx
                    # Checked once, on arrival, as PbftClient's listener does.
                    reply["_valid"] = self._reply_signature_valid(reply)
                    ts = reply.get("timestamp")
                    if (
                        isinstance(ts, int)
                        and reply.get("type") != "overloaded"
                    ):
                        self._inflight_lines.pop(ts, None)
                    with self._new_reply:
                        self.replies.append(reply)
                        self._new_reply.notify_all()
        except (OSError, ValueError):
            pass  # socket closed
        # EOF/error on the CURRENT socket = the gateway died under us:
        # fail over proactively so queued replies keep flowing even
        # before the next send notices.
        if not self._closed:
            with self._send_lock:
                try:
                    self._failover_locked(sock)
                except OSError:
                    pass  # no gateway up right now; sends will retry

    def close(self) -> None:
        self._closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()

    def _send_line(self, payload: bytes) -> None:
        with self._send_lock:  # not _lock: sendall must never block the
            for _ in range(1 + len(self._addrs)):  # reply reader's notify
                sock = self.sock
                try:
                    sock.sendall(payload)
                    return
                except OSError:
                    self._failover_locked(sock)  # raises when none answer

    def request(self, operation, to_replica=0, timestamp=None):
        """One raw-JSON request through the gateway (the gateway picks
        the replica; ``to_replica`` is accepted for drop-in compat and
        ignored)."""
        del to_replica
        if timestamp is None:
            self._timestamp += 1
            timestamp = self._timestamp
        req = ClientRequest(
            operation=operation, timestamp=timestamp, client=self.address
        )
        self._stamp_send(timestamp)
        line = req.canonical() + b"\n"
        self._inflight_lines[timestamp] = line
        self._send_line(line)
        return req

    def request_many(self, operations, to_replica=0, window=32, timeout=30.0):
        """Pipelined submission over the single gateway connection —
        mirrors PbftClient.request_many, with retransmission resending
        the SAME line (the gateway broadcasts a retransmitted (token, ts)
        to all replicas, the paper's liveness rule by proxy)."""
        del to_replica
        results: Dict[int, str] = {}
        timestamps: List[int] = []
        inflight: List[tuple] = []  # (timestamp, operation)
        next_op = 0
        while len(results) < len(operations):
            while next_op < len(operations) and len(inflight) < window:
                self._timestamp += 1
                ts = self._timestamp
                req = ClientRequest(
                    operation=operations[next_op],
                    timestamp=ts,
                    client=self.address,
                )
                self._stamp_send(ts)
                line = req.canonical() + b"\n"
                self._inflight_lines[ts] = line
                self._send_line(line)
                timestamps.append(ts)
                inflight.append((ts, operations[next_op]))
                next_op += 1
            ts, op = inflight.pop(0)
            try:
                results[ts] = self.wait_result(ts, timeout=timeout)
                self._drop_replies_upto(ts)
            except TimeoutError:
                retry = ClientRequest(
                    operation=op, timestamp=ts, client=self.address
                )
                line = retry.canonical() + b"\n"
                self._inflight_lines[ts] = line
                self._send_line(line)
                results[ts] = self.wait_result(ts, timeout=timeout)
                self._drop_replies_upto(ts)
            self._inflight_lines.pop(ts, None)
        return [results[ts] for ts in timestamps]


# -- daemon entry -------------------------------------------------------------


async def _amain(args, config_text: str, flight=None) -> None:
    config = ClusterConfig.from_json(config_text)
    gw = ClientGateway(
        config,
        host=args.host,
        port=args.port,
        metrics_port=args.metrics_port,
        max_inflight=args.max_inflight,
        max_queue_depth=args.max_queue_depth,
        flight=flight,
    )
    await gw.start()
    print(f"gateway listening on {gw.listen_port}", flush=True)
    if gw.metrics_listen_port:
        # pbft_top / endurance_soak parse this to find /status.
        print(f"gateway metrics on {gw.metrics_listen_port}", flush=True)
    while True:
        await asyncio.sleep(args.metrics_every or 3600)
        if args.metrics_every:
            print(json.dumps(gw.metrics()), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--metrics-every", type=int, default=0)
    parser.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        help="serve Prometheus text format on this port (0 = ephemeral)",
    )
    parser.add_argument(
        "--max-inflight",
        type=int,
        default=0,
        help="admission control: per-client-token in-flight "
        "request cap — a fresh request past it is answered with an "
        "explicit overloaded line instead of forwarded (0 = off)",
    )
    parser.add_argument(
        "--max-queue-depth",
        type=int,
        default=0,
        help="admission control: global in-flight watermark across every "
        "token this gateway forwards for (0 = off)",
    )
    parser.add_argument(
        "--flight-file",
        default=None,
        help="black-box flight recorder dump target (failover/overload "
        "events), written on SIGTERM/SIGINT — decode with "
        "scripts/flight_dump.py",
    )
    args = parser.parse_args()
    flight = None
    if args.flight_file:
        from ..utils.flight import FlightRecorder, install_signal_dump

        flight = FlightRecorder(capacity=8192)
        install_signal_dump(flight, args.flight_file)
    with open(args.config) as fh:
        config_text = fh.read()
    try:
        asyncio.run(_amain(args, config_text, flight=flight))
    except BaseException:
        if flight is not None:
            flight.dump(args.flight_file)
        raise


if __name__ == "__main__":
    main()
