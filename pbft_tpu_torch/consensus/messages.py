"""Client request and reply: the port's copy of the client's part of
``pbft_tpu/consensus/messages.py``.

Canonical bytes are JSON with sorted keys and fixed separators; a message's
digest is Blake2b-256 of them. Replicas sign the 32-byte Blake2b digest of a
message's content without its ``sig`` field (its signable bytes). A wire
frame is a 4-byte big-endian length and the canonical JSON. ``pbftd``
(``core/messages.cc``) and the JAX package produce the same bytes;
``tests/test_torch_harness.py`` pins them equal. The replica-to-replica
types and the binary and MAC codecs are left out: the client sends none.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, ClassVar, Dict, Type


def blake2b_256(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def _canonical_json(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


class Message:
    """Base: canonical bytes, signable digest, wire (de)serialization."""

    TYPE: ClassVar[str] = ""
    _REGISTRY: ClassVar[Dict[str, Type["Message"]]] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.TYPE:
            Message._REGISTRY[cls.TYPE] = cls

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["type"] = self.TYPE
        return d

    def canonical(self) -> bytes:
        return _canonical_json(self.to_dict())

    def signable(self) -> bytes:
        """32-byte digest of the content excluding the signature field."""
        d = self.to_dict()
        d.pop("sig", None)
        return blake2b_256(_canonical_json(d))

    @classmethod
    def from_dict(cls, d: dict) -> "Message":
        d = dict(d)
        return Message._REGISTRY[d.pop("type")](**d)


def to_wire(msg: Message) -> bytes:
    payload = msg.canonical()
    return len(payload).to_bytes(4, "big") + payload


_INT64_MIN, _INT64_MAX = -(2**63), 2**63 - 1


def _check_int64(obj) -> None:
    """Reject integers outside int64: ``pbftd`` parses int64 and drops
    out-of-range messages, so the client rejects the same set."""
    if isinstance(obj, bool):
        return
    if isinstance(obj, int):
        if not (_INT64_MIN <= obj <= _INT64_MAX):
            raise ValueError(f"integer out of int64 range: {obj}")
    elif isinstance(obj, dict):
        for v in obj.values():
            _check_int64(v)
    elif isinstance(obj, list):
        for v in obj:
            _check_int64(v)


def from_wire(frame: bytes) -> Message:
    d = json.loads(frame.decode())
    _check_int64(d)
    return Message.from_dict(d)


@dataclasses.dataclass(frozen=True)
class ClientRequest(Message):
    """o = operation, t = timestamp, c = the client's dial-back address
    "host:port"."""

    TYPE: ClassVar[str] = "client-request"
    operation: str
    timestamp: int
    client: str


# The tentative-reply flag's JSON member name (core/messages.h
# kTentativeField). Omitted when zero, so committed replies keep the bytes
# they had before tentative execution existed.
TENTATIVE_FIELD = "tentative"


@dataclasses.dataclass(frozen=True)
class ClientReply(Message):
    """A reply dialed back to the client, signed by the replying replica:
    the client's f + 1 reply quorum counts only replies whose signature
    proves which replica cast them. ``tentative`` is 1 when the replica
    executed the request once prepared, before commit (the client then
    needs 2f + 1 matching votes); it is signed content."""

    TYPE: ClassVar[str] = "client-reply"
    view: int
    timestamp: int
    client: str
    replica: int
    result: str
    sig: str = ""
    tentative: int = 0

    def to_dict(self) -> dict:
        d = super().to_dict()
        if not d.get(TENTATIVE_FIELD):
            d.pop(TENTATIVE_FIELD, None)
        return d
