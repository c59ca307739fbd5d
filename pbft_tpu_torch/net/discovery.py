"""UDP-multicast peer discovery for the asyncio runtime (the port's copy
of ``pbft_tpu/net/discovery.py``).

Protocol mirror of core/discovery.cc (one beacon format, two runtimes, so
a mixed pbftd/asyncio cluster discovers itself): replicas beacon
``{"id": N, "port": P}`` to a multicast group ~1/s and learn each other's
addresses from received beacons, letting network.json list identities
(pubkeys) without pinning ports (``"port": 0``). The reference applies
mDNS to every node (reference src/main.rs:46,
src/network_behaviour_composer.rs:24-42).

Like mDNS, discovery is unauthenticated *addressing* only: consensus
safety rests on the Ed25519 signatures checked at the protocol layer (and
on the secure-link handshake when enabled), so a spoofed beacon can at
worst misroute traffic that then fails verification.
"""

from __future__ import annotations

import asyncio
import json
import socket
import struct
import time
from typing import Dict, Optional

DEFAULT_PORT = 17700


class Discovery(asyncio.DatagramProtocol):
    """Join ``target`` ("group:port", e.g. "239.255.77.77:17700"), beacon
    this replica's TCP port, and collect peer addresses into ``peers``.

    ``cluster_n`` bounds accepted beacon ids to [0, cluster_n) — the
    channel is unauthenticated, so out-of-cluster ids must not grow the
    map. ``expiry_s`` ages out peers whose beacons stop (the reference's
    mDNS-expiry TODO, reference src/network_behaviour_composer.rs:34-40).
    """

    def __init__(
        self,
        target: str,
        replica_id: int,
        tcp_port: int,
        cluster_n: int = 0,
        expiry_s: float = 10.0,
    ):
        group, _, port = target.rpartition(":")
        if not group:
            group, port = target, str(DEFAULT_PORT)
        self.group = group
        self.port = int(port)
        self.id = replica_id
        self.tcp_port = tcp_port
        self.cluster_n = cluster_n
        self.expiry_s = expiry_s
        self.peers: Dict[int, str] = {}  # id -> "host:port"
        self._last_seen: Dict[int, float] = {}
        self._transport: Optional[asyncio.DatagramTransport] = None
        self._send_sock: Optional[socket.socket] = None
        self._beacon_task: Optional[asyncio.Task] = None
        self._stopping = False

    async def start(self) -> "Discovery":
        loop = asyncio.get_running_loop()
        recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        recv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            recv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        recv.bind(("", self.port))
        group = socket.inet_aton(self.group)
        on_loopback = True
        try:  # loopback interface first (the dev/test topology) ...
            mreq = group + socket.inet_aton("127.0.0.1")
            recv.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        except OSError:  # ... else the default interface (multi-host LAN)
            mreq = group + struct.pack("!I", socket.INADDR_ANY)
            recv.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
            on_loopback = False
        recv.setblocking(False)
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: self, sock=recv
        )
        send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if on_loopback:
            # Pin the send interface to match the joined one; when the
            # join fell back to the default interface, leave the kernel's
            # default route so beacons actually leave the host.
            send.setsockopt(
                socket.IPPROTO_IP,
                socket.IP_MULTICAST_IF,
                socket.inet_aton("127.0.0.1"),
            )
        send.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        self._send_sock = send
        self._beacon_task = loop.create_task(self._beacon_loop())
        return self

    def stop(self) -> None:
        self._stopping = True
        if self._beacon_task:
            self._beacon_task.cancel()
        if self._transport:
            self._transport.close()
        if self._send_sock:
            self._send_sock.close()

    def announce(self) -> None:
        if self._send_sock is None:
            return
        beacon = json.dumps({"id": self.id, "port": self.tcp_port}).encode()
        try:
            self._send_sock.sendto(beacon, (self.group, self.port))
        except OSError:
            pass

    async def _beacon_loop(self) -> None:
        while not self._stopping:
            self.announce()
            self._expire()
            await asyncio.sleep(1.0)

    def _expire(self) -> None:
        now = time.monotonic()
        for rid in [
            r for r, t in self._last_seen.items() if now - t > self.expiry_s
        ]:
            del self._last_seen[rid]
            self.peers.pop(rid, None)

    # -- DatagramProtocol ----------------------------------------------------

    def datagram_received(self, data: bytes, addr) -> None:
        try:
            obj = json.loads(data)
        except (ValueError, UnicodeDecodeError):
            return
        if not isinstance(obj, dict):
            return
        rid, port = obj.get("id"), obj.get("port")
        # The channel is unauthenticated: strict field validation so a
        # spoofed beacon can at worst misroute traffic, never poison the
        # peer map with unusable addresses (bool is an int subclass and
        # must not pass; ports must be dialable).
        if isinstance(rid, bool) or not isinstance(rid, int):
            return
        if isinstance(port, bool) or not isinstance(port, int):
            return
        if not 0 < port <= 65535:
            return
        if rid == self.id:
            return
        if rid < 0 or (self.cluster_n > 0 and rid >= self.cluster_n):
            return
        self.peers[rid] = f"{addr[0]}:{port}"
        self._last_seen[rid] = time.monotonic()
