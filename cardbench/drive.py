"""Closed-loop load: client processes, each holding some of the cell's
``PbftClient`` identities.

Each identity keeps ``outstanding`` requests in flight over one connection
to the primary (so that the primary reads its timestamps in order) and sends
the next request as soon as the oldest one's f + 1 reply quorum arrives
(``PbftClient.wait_result``, which stamps it). It starts sending at
``start_at``, sends nothing from ``stop_at`` on, and waits for what is
outstanding until ``drain_until``; a request with no quorum by then has
failed. A request that waits ``RETRY_S`` is sent again to every replica,
as ``PbftClient.request_many`` does. The drive loop is
``bench/harness.py``'s, bounded by time instead of a request count.

The operations are null operations: fixed-width strings from the seed, the
identity and a counter, the same length for every seed.
"""

from __future__ import annotations

import collections
import multiprocessing
import threading
import time
import traceback
from typing import List

RETRY_S = 20.0


def op_string(tag: int, client: int, k: int) -> str:
    return f"{tag:016x}-{client:04d}-{k:08d}"


def _identity_loop(client, index: int, outstanding: int, tag: int, sample_ks: frozenset,
                   start_at: float, stop_at: float, drain_until: float, out: dict) -> None:
    from pbft_tpu_torch.consensus.messages import ClientRequest
    from pbft_tpu_torch.net.client import _dial

    records, samples = [], []
    inflight = collections.deque()
    retried = set()
    primary = client.config.identity(0)
    time.sleep(max(0.0, start_at - time.monotonic()))
    with _dial(primary.host, primary.port) as sock:
        k = 0
        while True:
            now = time.monotonic()
            while now < stop_at and len(inflight) < outstanding:
                client._timestamp += 1
                ts = client._timestamp
                op = op_string(tag, index, k)
                client._stamp_send(ts)
                sock.sendall(ClientRequest(operation=op, timestamp=ts, client=client.address).canonical() + b"\n")
                inflight.append((ts, op, k))
                k += 1
                now = time.monotonic()
            if not inflight:
                break
            ts, op, seq = inflight[0]
            remaining = drain_until - now
            if remaining <= 0:
                break
            try:
                result = client.wait_result(ts, timeout=min(remaining, RETRY_S))
            except TimeoutError:
                if ts not in retried and time.monotonic() < drain_until:
                    retried.add(ts)
                    retry = ClientRequest(operation=op, timestamp=ts, client=client.address)
                    client._broadcast(retry.canonical() + b"\n", range(client.config.n))
                continue
            if seq in sample_ks:
                with client._lock:
                    replies = [{k2: v for k2, v in r.items() if not k2.startswith("_")}
                               for r in client.replies if r.get("timestamp") == ts]
                samples.append({"client": client.address, "timestamp": ts, "result": result, "replies": replies})
            inflight.popleft()
            client._drop_replies_upto(ts)
    for ts, rec in sorted(client.latency_log.items()):
        records.append({"client": index, "timestamp": ts, "send": rec["send"], "quorum": rec.get("quorum")})
    out["records"] = records
    out["samples"] = samples
    out["retried"] = len(retried)


def worker_main(conn, config_json: str, indices: List[int], outstanding: int, tag: int, sample_ks: dict) -> None:
    """One client process: builds its identities, reports their addresses,
    waits for the schedule ``(start_at, stop_at, drain_until)``, drives,
    and sends back every request's stamps and the sampled replies."""
    clients = []
    try:
        from pbft_tpu_torch import native
        from pbft_tpu_torch.consensus.config import ClusterConfig
        from pbft_tpu_torch.net.client import PbftClient

        native.lib()  # the clients' reply verifier, loaded before the load starts
        config = ClusterConfig.from_json(config_json)
        clients = [PbftClient(config) for _ in indices]
        conn.send(("ready", [c.address for c in clients]))
        start_at, stop_at, drain_until = conn.recv()
        outs = [dict() for _ in clients]
        threads = [
            threading.Thread(
                target=_identity_loop,
                args=(c, i, outstanding, tag, frozenset(sample_ks.get(i, ())), start_at, stop_at, drain_until, o),
                daemon=True,
            )
            for c, i, o in zip(clients, indices, outs)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(1.0, drain_until - time.monotonic() + 30))
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client thread did not end by the drain's end")
        missing = [i for i, o in zip(indices, outs) if "records" not in o]
        if missing:
            raise RuntimeError(f"client identities {missing} ended without records")
        conn.send(("done", outs))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the run
        conn.send(("error", traceback.format_exc()))
    finally:
        for c in clients:
            c.close()
        conn.close()


class ClientFleet:
    """The client processes of one run (spawned: the parent holds threads
    and a CUDA context)."""

    def __init__(self, config_json: str, clients: int, outstanding: int, processes: int, tag: int,
                 sample_ks: dict):
        ctx = multiprocessing.get_context("spawn")
        self.procs, self.conns = [], []
        groups = [list(range(clients))[p::processes] for p in range(processes)]
        for group in groups:
            if not group:
                continue
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=worker_main, args=(child, config_json, group, outstanding, tag, sample_ks),
                               daemon=True)
            proc.start()
            child.close()
            self.procs.append(proc)
            self.conns.append(parent)

    def _recv(self, conn, timeout: float):
        if not conn.poll(timeout):
            raise TimeoutError("a client process did not answer")
        kind, payload = conn.recv()
        if kind == "error":
            raise RuntimeError(f"a client process failed:\n{payload}")
        return payload

    def wait_ready(self, timeout: float = 120.0) -> List[str]:
        addresses = []
        for conn in self.conns:
            addresses += self._recv(conn, timeout)
        return addresses

    def go(self, start_at: float, stop_at: float, drain_until: float) -> None:
        for conn in self.conns:
            conn.send((start_at, stop_at, drain_until))

    def results(self, timeout: float) -> List[dict]:
        outs = []
        deadline = time.monotonic() + timeout
        for conn in self.conns:
            outs += self._recv(conn, max(1.0, deadline - time.monotonic()))
        return outs

    def stop(self) -> None:
        for proc in self.procs:
            proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join(10)
        for conn in self.conns:
            conn.close()
