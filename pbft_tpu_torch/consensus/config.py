"""Cluster configuration: the rebuild makes network.json real.

The reference shipped a network.json (4 nodes, ports 8000-8003, primary 8000)
that no code ever read (SURVEY.md §2 "Static topology config"); here it is the
actual source of truth for replica identities, keys, f, the batching window,
and the verifier backend selection.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

from ..crypto import ref as crypto_ref
from .messages import blake2b_256


@dataclasses.dataclass(frozen=True)
class ReplicaIdentity:
    replica_id: int
    host: str
    port: int
    pubkey: str  # hex

    def pubkey_bytes(self) -> bytes:
        return bytes.fromhex(self.pubkey)


@dataclasses.dataclass
class ClusterConfig:
    replicas: List[ReplicaIdentity]
    watermark_window: int = 256
    checkpoint_interval: int = 16
    batch_pad: int = 64  # padded batch size fed to the card's verifier
    # Bounded verify accumulation: when verify_flush_us > 0 a replica
    # holds its verify queue until verify_flush_items are pending
    # (0 = batch_pad) or the oldest item has waited verify_flush_us —
    # trading that much latency for a fatter batching window (more items
    # per verifier launch). 0 = flush every event-loop pass.
    verify_flush_us: int = 0
    verify_flush_items: int = 0
    # Request batching: the primary accumulates client requests
    # into an ordered batch and runs ONE three-phase instance per batch.
    # batch_max_items caps the batch (1 = the pre-batching one-instance-
    # per-request protocol, wire-compatible with 1.1.0 peers);
    # batch_flush_us bounds how long a partial batch may wait for more
    # requests before the runtime seals it (0 = seal on the next
    # event-loop pass). Backups ignore both: batch composition is the
    # primary's choice, acceptance is size-agnostic.
    batch_max_items: int = 1
    batch_flush_us: int = 0
    # Admission control: explicit overload replies instead of
    # silent queueing into the tail. admission_inflight caps ONE client's
    # estimated in-flight requests (its request timestamp's distance past
    # the last executed one — client timestamps are consecutive, so the
    # distance IS the pipeline depth); admission_backlog watermarks the
    # replica's own backlog (verify inbox + sealed-but-unexecuted
    # sequences). A fresh request past either bound is answered with
    # {"type": "overloaded"} and dropped — clients back off with jitter
    # (net/client.py request_with_retry). Retransmissions always pass
    # (liveness must never be admission-gated). 0 disables either check.
    admission_inflight: int = 0
    admission_backlog: int = 0
    # Multi-core replica core: event-loop shard threads (each
    # with a companion crypto pipeline thread) the NATIVE runtime runs;
    # 1 = the classic single-threaded loop. The asyncio runtime accepts
    # the key and stays single-loop (it logs as much at startup) — its
    # parallelism lives in the verifier's mesh, not the socket layer. The
    # default is constants-linted against core/replica.h.
    net_threads: int = 1
    # Fast-path modes (protocol 1.3.0; defaults constants-linted
    # against core/replica.h). fastpath = "mac" makes this node OFFER the
    # per-link MAC-vector authenticator mode in its hellos — normal-case
    # frames on links where BOTH sides offered it are authenticated by
    # link MACs instead of hot-path signature verification (signatures
    # are still minted: they are the evidence view changes re-verify).
    # tentative = True makes replicas execute and reply once PREPARED
    # (before commit; Castro–Liskov §5.3) with rollback on view change —
    # clients then accept a 2f+1 matching tentative-reply quorum.
    fastpath: str = "sig"
    tentative: bool = False
    # Durable replica recovery: when wal_dir is non-empty each
    # replica keeps a write-ahead log at {wal_dir}/replica-{id}.wal —
    # current view, sent votes (digest only), latest stable checkpoint
    # certificate + snapshot — flushed with group-commit fsync batching
    # at the runtime's emit boundary, and replayed on restart so a
    # kill -9'd replica re-joins the SAME view without ever contradicting
    # a persisted vote. wal_fsync=False keeps the writes but skips the
    # fsync (kill -9 of the process stays safe via the page cache; only
    # host power loss can drop the tail) — the A/B lever that makes the
    # durability cost visible in the bench. Defaults constants-linted
    # against core/replica.h.
    wal_dir: str = ""
    wal_fsync: bool = True
    verifier: str = "cpu"  # "cpu", or a verify service's "host:port" or unix path
    # Encrypted replica-replica links (signed-ephemeral DH + AEAD framing,
    # net/secure.py) — the reference's development_transport
    # bundles Noise encryption on every link (reference src/main.rs:42).
    secure: bool = False

    @property
    def n(self) -> int:
        return len(self.replicas)

    @property
    def f(self) -> int:
        return (self.n - 1) // 3

    def primary_of(self, view: int) -> int:
        return view % self.n

    def identity(self, replica_id: int) -> ReplicaIdentity:
        return self.replicas[replica_id]

    def to_json(self) -> str:
        return json.dumps(
            {
                "watermark_window": self.watermark_window,
                "checkpoint_interval": self.checkpoint_interval,
                "batch_pad": self.batch_pad,
                "verify_flush_us": self.verify_flush_us,
                "verify_flush_items": self.verify_flush_items,
                "batch_max_items": self.batch_max_items,
                "batch_flush_us": self.batch_flush_us,
                "admission_inflight": self.admission_inflight,
                "admission_backlog": self.admission_backlog,
                "net_threads": self.net_threads,
                "fastpath": self.fastpath,
                "tentative": self.tentative,
                "wal_dir": self.wal_dir,
                "wal_fsync": self.wal_fsync,
                "verifier": self.verifier,
                "secure": self.secure,
                "replicas": [dataclasses.asdict(r) for r in self.replicas],
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "ClusterConfig":
        d = json.loads(text)
        return cls(
            replicas=[ReplicaIdentity(**r) for r in d["replicas"]],
            watermark_window=d.get("watermark_window", 256),
            checkpoint_interval=d.get("checkpoint_interval", 16),
            batch_pad=d.get("batch_pad", 64),
            verify_flush_us=d.get("verify_flush_us", 0),
            verify_flush_items=d.get("verify_flush_items", 0),
            batch_max_items=d.get("batch_max_items", 1),
            batch_flush_us=d.get("batch_flush_us", 0),
            admission_inflight=d.get("admission_inflight", 0),
            admission_backlog=d.get("admission_backlog", 0),
            net_threads=d.get("net_threads", 1),
            fastpath=d.get("fastpath", "sig"),
            tentative=bool(d.get("tentative", False)),
            wal_dir=d.get("wal_dir", ""),
            wal_fsync=bool(d.get("wal_fsync", True)),
            verifier=d.get("verifier", "cpu"),
            secure=bool(d.get("secure", False)),
        )


def make_local_cluster(
    n: int, base_port: int = 8000, seed_prefix: bytes = b"pbft-tpu-replica-"
):
    """Deterministic localhost cluster for tests/simulation.

    Returns (config, seeds): seeds[i] is replica i's Ed25519 seed. The
    primary listens for clients on base_port, mirroring the reference's
    fixed client port 8000 (reference src/client_handler.rs:22-28).
    """
    seeds = []
    identities = []
    for i in range(n):
        seed = blake2b_256(seed_prefix + str(i).encode())
        pub = crypto_ref.public_key(seed)
        seeds.append(seed)
        identities.append(
            ReplicaIdentity(
                replica_id=i, host="127.0.0.1", port=base_port + i, pubkey=pub.hex()
            )
        )
    return ClusterConfig(replicas=identities), seeds
