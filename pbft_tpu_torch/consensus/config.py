"""The cluster's configuration, ``network.json``: the port's copy of
``pbft_tpu/consensus/config.py``, cut to what a ``pbftd`` cluster on the
verify service needs.

``pbftd`` reads replica identities and keys, the watermark and checkpoint
intervals, the verify flush window, the request batch knobs, the verifier
and ``secure`` from it. The JAX package's admission, multi-loop, fast-path
and write-ahead-log keys are written at their defaults (``_FIXED``) and are
not settable here, so ``to_json`` emits the JAX package's bytes for every
configuration this copy can hold (``tests/test_torch_harness.py``), and
``from_json`` refuses a file that sets any of them otherwise.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List

from ..crypto import ref as crypto_ref
from .messages import blake2b_256

# Keys of the JAX package's network.json that this copy keeps at their
# defaults, in its order (between batch_flush_us and verifier).
_FIXED = {
    "admission_inflight": 0,
    "admission_backlog": 0,
    "net_threads": 1,
    "fastpath": "sig",
    "tentative": False,
    "wal_dir": "",
    "wal_fsync": True,
}


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
    batch_pad: int = 64  # a replica's verify batch target
    # Bounded verify accumulation: with verify_flush_us > 0 a replica holds
    # its verify queue until verify_flush_items are pending (0 = batch_pad)
    # or the oldest item has waited verify_flush_us.
    verify_flush_us: int = 0
    verify_flush_items: int = 0
    # Request batching: the primary runs one three-phase instance per batch
    # of up to batch_max_items requests, sealing a partial batch after
    # batch_flush_us (0 = on the next event-loop pass).
    batch_max_items: int = 1
    batch_flush_us: int = 0
    verifier: str = "cpu"  # "cpu", or a verify service's "host:port" or unix path
    # Encrypted replica-to-replica links (signed ephemeral DH + AEAD).
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
                **_FIXED,
                "verifier": self.verifier,
                "secure": self.secure,
                "replicas": [dataclasses.asdict(r) for r in self.replicas],
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "ClusterConfig":
        d = json.loads(text)
        unsupported = {k: d[k] for k, v in _FIXED.items() if k in d and d[k] != v}
        if unsupported:
            raise ValueError(f"settings this configuration cannot hold: {unsupported}")
        return cls(
            replicas=[ReplicaIdentity(**r) for r in d["replicas"]],
            watermark_window=d.get("watermark_window", 256),
            checkpoint_interval=d.get("checkpoint_interval", 16),
            batch_pad=d.get("batch_pad", 64),
            verify_flush_us=d.get("verify_flush_us", 0),
            verify_flush_items=d.get("verify_flush_items", 0),
            batch_max_items=d.get("batch_max_items", 1),
            batch_flush_us=d.get("batch_flush_us", 0),
            verifier=d.get("verifier", "cpu"),
            secure=bool(d.get("secure", False)),
        )


def make_local_cluster(n: int, base_port: int = 8000, seed_prefix: bytes = b"pbft-tpu-replica-"):
    """A deterministic localhost cluster: (config, seeds), where seeds[i]
    is replica i's Ed25519 seed (the JAX package's derivation, so both
    packages make the same keys) and replica i listens on base_port + i."""
    seeds = []
    identities = []
    for i in range(n):
        seed = blake2b_256(seed_prefix + str(i).encode())
        seeds.append(seed)
        identities.append(
            ReplicaIdentity(replica_id=i, host="127.0.0.1", port=base_port + i, pubkey=crypto_ref.public_key(seed).hex())
        )
    return ClusterConfig(replicas=identities), seeds
