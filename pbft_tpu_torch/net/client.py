"""The PBFT client (the port's copy of ``pbft_tpu/net/client.py``).

A client sends a raw-JSON ``ClientRequest`` line over TCP to a replica and
runs a listener on its advertised dial-back address; it accepts a result
once f + 1 replicas sent matching committed replies, or 2f + 1 matching
replies in one view when some are tentative. A reply votes only when its
Ed25519 signature is valid for the replica it names, checked once, when it
arrives, with ``native.host_batch_verify`` (the C++ core's verify pool; the
oracle only while the core is still being built).

An explicit ``{"type": "overloaded"}`` line (a replica's or a gateway's
admission control) never votes: ``request_with_retry`` counts it in
``overload_rejections`` and backs off in place instead of rotating and
broadcasting.
"""

from __future__ import annotations

import json
import random
import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import native
from ..consensus.config import ClusterConfig
from ..consensus.messages import ClientReply, ClientRequest


def _dial(host: str, port: int, timeout: float = 5.0) -> socket.socket:
    """Every client dial: TCP_NODELAY, as a request is one small write."""
    s = socket.create_connection((host, port), timeout=timeout)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


class PbftClient:
    def __init__(self, config: ClusterConfig, host: str = "127.0.0.1", port: int = 0):
        self.config = config
        self.replies: List[dict] = []
        self._lock = threading.Lock()
        self._new_reply = threading.Condition(self._lock)
        client = self

        class Handler(socketserver.StreamRequestHandler):
            disable_nagle_algorithm = True

            def handle(self):
                data = self.rfile.read()
                rx = time.monotonic()  # arrival stamp for first-reply latency
                for line in data.splitlines():
                    try:
                        reply = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if not isinstance(reply, dict):
                        continue
                    reply["_rx"] = rx
                    reply["_valid"] = client._reply_signature_valid(reply)
                    with client._new_reply:
                        client.replies.append(reply)
                        client._new_reply.notify_all()

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True
            # Every replica dials back once per reply: a pipelined burst is
            # n x window connects at once.
            request_queue_size = 128

        self.server = Server((host, port), Handler)
        self.address = "%s:%d" % self.server.server_address
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()
        self._timestamp = 0
        # timestamp -> {send, first_reply, quorum} monotonic stamps, for the
        # latency percentiles and the waterfall join with replica traces.
        self.latency_log: Dict[int, dict] = {}

    def _stamp_send(self, timestamp: int) -> None:
        # First send only: a retransmission must not erase the wait.
        self.latency_log.setdefault(timestamp, {}).setdefault("send", time.monotonic())

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    def _broadcast(self, payload: bytes, replicas) -> None:
        for rid in replicas:
            ident = self.config.identity(rid)
            try:
                with _dial(ident.host, ident.port, timeout=2) as s:
                    s.sendall(payload)
            except OSError:
                pass  # a dead replica: the others carry the request

    # -- request path -------------------------------------------------------

    def request(self, operation: str, to_replica: int = 0, timestamp: Optional[int] = None) -> ClientRequest:
        """Send one raw-JSON request to a replica (the primary by default)."""
        if timestamp is None:
            self._timestamp += 1
            timestamp = self._timestamp
        req = ClientRequest(operation=operation, timestamp=timestamp, client=self.address)
        ident = self.config.identity(to_replica)
        self._stamp_send(timestamp)
        with _dial(ident.host, ident.port) as s:
            s.sendall(req.canonical() + b"\n")
        return req

    def request_many(
        self,
        operations: List[str],
        to_replica: int = 0,
        window: int = 32,
        timeout: float = 30.0,
    ) -> List[str]:
        """Pipelined submission over one connection, up to ``window``
        requests in flight, each completed in submission order. Timestamps
        are consecutive and TCP keeps their order, so the primary sees them
        in order. A request that misses its quorum is retransmitted to every
        replica and waited for once more; the results come back in
        operation order, or TimeoutError."""
        results: Dict[int, str] = {}
        timestamps: List[int] = []
        inflight: List[Tuple[int, str]] = []
        ident = self.config.identity(to_replica)
        with _dial(ident.host, ident.port) as sock:
            next_op = 0
            while len(results) < len(operations):
                while next_op < len(operations) and len(inflight) < window:
                    self._timestamp += 1
                    ts = self._timestamp
                    req = ClientRequest(operation=operations[next_op], timestamp=ts, client=self.address)
                    self._stamp_send(ts)
                    sock.sendall(req.canonical() + b"\n")
                    timestamps.append(ts)
                    inflight.append((ts, operations[next_op]))
                    next_op += 1
                ts, op = inflight.pop(0)
                try:
                    results[ts] = self.wait_result(ts, timeout=timeout)
                except TimeoutError:
                    retry = ClientRequest(operation=op, timestamp=ts, client=self.address)
                    self._broadcast(retry.canonical() + b"\n", range(self.config.n))
                    results[ts] = self.wait_result(ts, timeout=timeout)
                self._drop_replies_upto(ts)
        return [results[ts] for ts in timestamps]

    def _drop_replies_upto(self, timestamp: int) -> None:
        """Prune consumed replies (requests complete in timestamp order), so
        that a long run's quorum scans stay short."""
        with self._lock:
            self.replies = [r for r in self.replies if r.get("timestamp", 0) > timestamp]

    # Overload rejections absorbed across every request_with_retry call:
    # explicit {"type": "overloaded"} replies, not timeouts.
    overload_rejections = 0

    def _consume_overloaded(self, timestamp: int) -> int:
        """Remove and count the explicit overload rejections for
        ``timestamp`` from the reply stream (they carry no signature, so
        the quorum count never sees them)."""
        with self._lock:
            kept = [r for r in self.replies if not (r.get("type") == "overloaded" and r.get("timestamp") == timestamp)]
            hits = len(self.replies) - len(kept)
            if hits:
                self.replies = kept
        return hits

    def request_with_retry(self, operation: str, timeout: float = 20.0, retry_every: float = 2.0) -> str:
        """Send to the primary; at each retransmission timer expiry rotate
        the direct target and broadcast to every replica, with jittered
        exponential backoff between retries, until ``timeout``.

        An overload rejection is not a timeout: the cluster is alive and
        asked for less, so the client backs off (with jitter) and resends
        to the same target only, without rotating or broadcasting, which
        would multiply the load n-fold. Rejections add to
        ``overload_rejections`` and to the request's latency record."""
        self._timestamp += 1
        ts = self._timestamp
        payload = ClientRequest(operation=operation, timestamp=ts, client=self.address).canonical() + b"\n"
        self._stamp_send(ts)
        self._broadcast(payload, [0])
        deadline = time.monotonic() + timeout
        attempt = 0
        target = 0
        rng = random.Random()
        while True:
            wait = min(retry_every * (1.5**attempt), 4 * retry_every) * (0.5 + rng.random())
            wait = min(wait, max(0.1, deadline - time.monotonic()))
            try:
                return self.wait_result(ts, timeout=wait)
            except TimeoutError:
                rejected = self._consume_overloaded(ts)
                if time.monotonic() >= deadline:
                    raise
                attempt += 1
                if rejected:
                    self.overload_rejections += rejected
                    rec = self.latency_log.get(ts)
                    if rec is not None:
                        rec["overloaded"] = rec.get("overloaded", 0) + rejected
                    self._broadcast(payload, [target])
                    continue
                target = attempt % self.config.n
                self._broadcast(payload, [target, *range(self.config.n)])

    # -- latency export -----------------------------------------------------

    def latency_records(self) -> List[dict]:
        """{client, req_ts, send[, first_reply, quorum, overloaded]} per
        request, in send order."""
        out = []
        for ts in sorted(self.latency_log):
            rec = self.latency_log[ts]
            if "send" not in rec:
                continue
            row = {"client": self.address, "req_ts": ts, "send": rec["send"]}
            row.update({k: rec[k] for k in ("first_reply", "quorum", "overloaded") if k in rec})
            out.append(row)
        return out

    def write_trace(self, path: str) -> int:
        """Append one ``client_request`` JSONL event per stamp record, for
        the waterfall join with replica traces. Returns the event count."""
        from ..utils.trace import Tracer

        n = 0
        with open(path, "a") as fh:
            tracer = Tracer(fh)
            for row in self.latency_records():
                extra = {k: round(row[k], 6) for k in ("first_reply", "quorum") if k in row}
                if "overloaded" in row:  # a count of rejections, not a stamp
                    extra["overloaded"] = int(row["overloaded"])
                tracer.event("client_request", client=row["client"], req_ts=row["req_ts"],
                             send=round(row["send"], 6), **extra)
                n += 1
        return n

    def _reply_signature_valid(self, r: dict) -> bool:
        """Whether the reply carries a valid signature of the replica it
        claims to come from, over its signed content (``tentative``
        included)."""
        try:
            rid = r["replica"]
            if not isinstance(rid, int) or not 0 <= rid < self.config.n:
                return False
            reply = ClientReply(
                view=int(r["view"]),
                timestamp=int(r["timestamp"]),
                client=str(r["client"]),
                replica=rid,
                result=str(r["result"]),
                sig=str(r["sig"]),
                tentative=int(r.get("tentative", 0)),
            )
            sig = bytes.fromhex(reply.sig)
            pub = self.config.identity(rid).pubkey_bytes()
            if len(sig) != 64 or len(pub) != 32:
                return False
            return native.host_batch_verify([(pub, reply.signable(), sig)])[0]
        except (KeyError, TypeError, ValueError):
            return False

    def wait_result(self, timestamp: int, f: Optional[int] = None, timeout: float = 10.0) -> str:
        """Block until a reply quorum for ``timestamp``: f + 1 matching
        committed replies from distinct replicas, or 2f + 1 matching
        replies in one view when some are tentative."""
        f = self.config.f if f is None else f
        deadline = time.monotonic() + timeout
        with self._new_reply:
            while True:
                # One vote per replica id: duplicates must not make a quorum.
                votes: Dict[int, Tuple[str, int, int]] = {}
                for r in self.replies:
                    if r.get("timestamp") == timestamp and r["_valid"]:
                        votes[r["replica"]] = (r.get("result"), r.get("view"), 1 if r.get("tentative") else 0)
                by_result: Dict[Tuple[str, int], int] = {}
                committed_by_result: Dict[str, int] = {}
                for result, view, tentative in votes.values():
                    by_result[(result, view)] = by_result.get((result, view), 0) + 1
                    if not tentative:
                        committed_by_result[result] = committed_by_result.get(result, 0) + 1
                for (result, _view), count in by_result.items():
                    if count >= 2 * f + 1 or committed_by_result.get(result, 0) >= f + 1:
                        rec = self.latency_log.get(timestamp)
                        if rec is not None and "quorum" not in rec:
                            rec["quorum"] = time.monotonic()
                            rxs = [r["_rx"] for r in self.replies if r.get("timestamp") == timestamp]
                            if rxs:
                                rec["first_reply"] = min(rxs)
                        return result
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"no reply quorum for t={timestamp}; got {by_result}")
                self._new_reply.wait(remaining)
