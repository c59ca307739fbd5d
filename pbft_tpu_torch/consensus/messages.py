"""PBFT message types, canonical encoding, digests, and signatures.

Capability parity with the reference's message layer (reference
src/message.rs): ClientRequest / PrePrepare / Prepare / Commit / ClientReply
with a content digest over the client request — plus what the reference left
as TODOs: real signatures on every replica-to-replica message (reference
src/behavior.rs:127,:185) and a Checkpoint message for watermark advancement
(reference src/behavior.rs:154,:192).

Encoding decisions:
- Canonical bytes = JSON with sorted keys and fixed separators; the digest is
  Blake2b-256 of those bytes (the reference also used Blake2b,
  src/message.rs:3,:209-212).
- Replicas sign the 32-byte Blake2b digest of a message's signable content.
  Fixing the signed payload at 32 bytes makes the Ed25519 challenge hash
  SHA-512(R||A||M) exactly one block — every shape in the batch verifier
  is static (see ``crypto/sha512.py``).
- Wire frame = 4-byte big-endian length + JSON (the reference used
  varint-framed JSON, src/protocol_config.rs:51,:82; a fixed-width prefix is
  friendlier to the C++ runtime and to batch scanning).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, ClassVar, Dict, Optional, Type


def blake2b_256(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def _canonical_json(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


class Message:
    """Base: canonical bytes, digest, signable digest, wire (de)serialization."""

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
        """32-byte digest of the content excluding the signature field.

        Hot message types render through a fixed template (byte-identical
        to the generic sorted-keys dump; tests/test_wire_codec.py pins the
        parity) — the generic path pays dataclasses.asdict per call."""
        fast = _signable_bytes_fast(self)
        if fast is not None:
            return blake2b_256(fast)
        d = self.to_dict()
        d.pop("sig", None)
        return blake2b_256(_canonical_json(d))

    @classmethod
    def from_dict(cls, d: dict) -> "Message":
        d = dict(d)
        typ = d.pop("type")
        target = Message._REGISTRY[typ]

        def _req(rd) -> "ClientRequest":
            rd = dict(rd)
            rd.pop("type", None)
            return ClientRequest(**rd)

        if target is PrePrepare:
            # Legacy singular `request` (batch of one) and the batched
            # `requests` list both decode to the requests tuple. A
            # one-element `requests` list is REJECTED, exactly like the
            # C++ parser: each batch has one canonical encoding, and
            # admitting the other form here while the native runtime
            # drops it would be a cross-runtime consensus divergence.
            if "request" in d and isinstance(d["request"], dict):
                d["requests"] = (_req(d.pop("request")),)
            elif isinstance(d.get("requests"), (list, tuple)):
                if len(d["requests"]) == 1:
                    raise ValueError(
                        "one-element `requests` must encode as `request`"
                    )
                d["requests"] = tuple(
                    _req(r) if isinstance(r, dict) else r
                    for r in d["requests"]
                )
        elif "request" in d and isinstance(d["request"], dict):
            d["request"] = _req(d["request"])
        return target(**d)


def to_wire(msg: Message) -> bytes:
    payload = msg.canonical()
    return len(payload).to_bytes(4, "big") + payload


_INT64_MIN, _INT64_MAX = -(2**63), 2**63 - 1


def _check_int64(obj) -> None:
    """Reject integers outside int64: the C++ runtime parses int64 and
    *drops* out-of-range messages, so Python must reject the same set or
    the two implementations would digest different canonical bytes for
    the same wire message (a consensus divergence)."""
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
    """o=operation, t=timestamp, c=client dial-back address "host:port"
    (reference src/message.rs:34-38)."""

    TYPE: ClassVar[str] = "client-request"
    operation: str
    timestamp: int
    client: str

    def digest(self) -> str:
        return blake2b_256(self.canonical()).hex()


# The tentative-reply flag's JSON member name (mirrors
# core/messages.h kTentativeField, constants lint). Omitted when zero so
# committed replies stay byte-identical to pre-1.3.0 peers.
TENTATIVE_FIELD = "tentative"


@dataclasses.dataclass(frozen=True)
class ClientReply(Message):
    """Reply dialed back to the client (reference src/message.rs:55-72),
    signed by the replying replica: PBFT §4.1's f+1 reply quorum only
    means something if a vote proves which replica cast it — unsigned
    replies let one faulty party mint arbitrary votes on the dial-back
    channel.

    ``tentative``: 1 when the replica executed the request at
    *prepared* (before commit, Castro–Liskov §5.3 tentative execution) —
    the client needs 2f+1 matching tentative votes instead of f+1
    committed ones. Part of the SIGNED content (a forgeable flag would
    let a man-in-the-middle upgrade tentative votes to committed ones);
    omitted from the canonical encoding when 0, so committed replies are
    byte-identical to pre-1.3.0 replies."""

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


def batch_digest(requests) -> str:
    """The pre-prepare content digest over an ordered request batch.

    A batch of exactly one request keeps the legacy definition — the
    digest of that request's canonical bytes — so batch=1 pre-prepares
    are byte-identical (wire AND signable) to pre-batching peers. Any
    other size (including the empty batch, the new-view gap filler)
    digests the CONCATENATED per-request digests with Blake2b-256:
    order-sensitive, and collision-free down to the per-request digests."""
    if len(requests) == 1:
        return requests[0].digest()
    return blake2b_256(
        b"".join(bytes.fromhex(r.digest()) for r in requests)
    ).hex()


@dataclasses.dataclass(frozen=True)
class PrePrepare(Message):
    """<<PRE-PREPARE, v, n, d>, M> signed by the primary
    (reference src/message.rs:106-137), where M is an ordered request
    BATCH agreed under one sequence number (Castro & Liskov's batching
    amplifier). ``digest`` is batch_digest(requests). A batch of one
    encodes with the legacy singular ``request`` member (canonical JSON
    and binary alike) for wire compatibility with pre-batching peers;
    any other size uses the ``requests`` list / the 0x06 binary layout."""

    TYPE: ClassVar[str] = "pre-prepare"
    view: int
    seq: int
    digest: str
    requests: tuple  # tuple[ClientRequest, ...]
    replica: int
    sig: str = ""

    def __post_init__(self):
        object.__setattr__(self, "requests", tuple(self.requests))

    def to_dict(self) -> dict:
        d = {
            "view": self.view,
            "seq": self.seq,
            "digest": self.digest,
            "replica": self.replica,
            "sig": self.sig,
            "type": self.TYPE,
        }
        reqs = [dataclasses.asdict(r) for r in self.requests]
        if len(reqs) == 1:
            d["request"] = reqs[0]
        else:
            d["requests"] = reqs
        return d

    def batch_digest(self) -> str:
        return batch_digest(self.requests)


@dataclasses.dataclass(frozen=True)
class Prepare(Message):
    """<PREPARE, v, n, d, i> (reference src/message.rs:175-188)."""

    TYPE: ClassVar[str] = "prepare"
    view: int
    seq: int
    digest: str
    replica: int
    sig: str = ""


@dataclasses.dataclass(frozen=True)
class Commit(Message):
    """<COMMIT, v, n, d, i> (reference src/message.rs:214-239; the rebuild
    keys its log by (v, n), fixing the reference's view-only CommitKey,
    src/state.rs:23)."""

    TYPE: ClassVar[str] = "commit"
    view: int
    seq: int
    digest: str
    replica: int
    sig: str = ""


@dataclasses.dataclass(frozen=True)
class ViewChange(Message):
    """<VIEW-CHANGE, v+1, n, C, P, i> (PBFT §4.4 — absent from the
    reference, whose View was a constant with no mutation API, reference
    src/view.rs:1-13).

    - ``last_stable_seq``/``checkpoint_proof``: n and C — 2f+1 checkpoint
      message dicts proving the replica's last stable checkpoint.
    - ``prepared_proofs``: P — one entry per sequence prepared above n:
      {"pre_prepare": <dict>, "prepares": [<dict>, ...]} with 2f matching
      backup prepares each. Stored as raw dicts: they are *evidence*
      (re-validated structurally + cryptographically by the receiver),
      not live protocol messages."""

    TYPE: ClassVar[str] = "view-change"
    new_view: int
    last_stable_seq: int
    checkpoint_proof: tuple
    prepared_proofs: tuple
    replica: int
    sig: str = ""

    def __post_init__(self):
        # JSON round-trips tuples as lists; normalize for equality.
        object.__setattr__(self, "checkpoint_proof", tuple(self.checkpoint_proof))
        object.__setattr__(self, "prepared_proofs", tuple(self.prepared_proofs))

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["checkpoint_proof"] = list(self.checkpoint_proof)
        d["prepared_proofs"] = list(self.prepared_proofs)
        return d


@dataclasses.dataclass(frozen=True)
class NewView(Message):
    """<NEW-VIEW, v+1, V, O> (PBFT §4.4): V = 2f+1 view-change message
    dicts, O = the new primary's re-issued pre-prepare dicts for every
    in-flight sequence (null requests fill gaps)."""

    TYPE: ClassVar[str] = "new-view"
    new_view: int
    view_changes: tuple
    pre_prepares: tuple
    replica: int
    sig: str = ""

    def __post_init__(self):
        object.__setattr__(self, "view_changes", tuple(self.view_changes))
        object.__setattr__(self, "pre_prepares", tuple(self.pre_prepares))

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["view_changes"] = list(self.view_changes)
        d["pre_prepares"] = list(self.pre_prepares)
        return d


NULL_CLIENT = "<null>"


def null_request() -> "ClientRequest":
    """Filler for sequence gaps in a new view (PBFT §4.4: 'a special null
    request which goes through the protocol like other requests but whose
    execution is a no-op')."""
    return ClientRequest(operation="<null>", timestamp=0, client=NULL_CLIENT)


@dataclasses.dataclass(frozen=True)
class Checkpoint(Message):
    """<CHECKPOINT, n, d, i>: state digest at sequence n; 2f+1 matching
    checkpoints advance the low watermark (PBFT §4.3; a reference TODO,
    src/behavior.rs:154)."""

    TYPE: ClassVar[str] = "checkpoint"
    seq: int
    digest: str
    replica: int
    sig: str = ""


@dataclasses.dataclass(frozen=True)
class StateRequest(Message):
    """<STATE-REQUEST, n, i>: a replica whose watermark jumped past its
    execution asks peers for the checkpoint payload at stable sequence n
    (PBFT §5.3 state-transfer analogue; the reference TODO'd even the
    watermark checks, src/behavior.rs:154,:192)."""

    TYPE: ClassVar[str] = "state-request"
    seq: int
    replica: int
    sig: str = ""


@dataclasses.dataclass(frozen=True)
class StateResponse(Message):
    """<STATE-RESPONSE, n, payload, i>: the canonical checkpoint payload at
    sequence n (app snapshot + chain digest + per-client reply caches,
    see Replica._checkpoint_payload). The receiver trusts it only if its
    Blake2b-256 digest equals the 2f+1-certified stable checkpoint digest —
    the sender's signature gates transport, the digest gates content."""

    TYPE: ClassVar[str] = "state-response"
    seq: int
    snapshot: str
    replica: int
    sig: str = ""


def with_sig(msg: Message, sig_hex: str) -> Message:
    return dataclasses.replace(msg, sig=sig_hex)


# -- fast signable templates -------------------------------------------------
#
# The generic signable path costs a recursive dataclasses.asdict plus a
# sorted-keys dumps per message; the hot types have a fixed key order, so
# their canonical signable bytes render directly. Strings go through
# json.dumps for the exact escaping; int fields are guarded with
# `type(x) is int` because a stray bool would render "True" where the
# generic path emits "true" — mismatched types fall back to the generic
# derivation instead of diverging.

_dumps = json.dumps


def _signable_bytes_fast(msg: "Message") -> Optional[bytes]:
    t = msg.__class__
    if t is Prepare or t is Commit:
        v, s, d, r = msg.view, msg.seq, msg.digest, msg.replica
        if (
            type(v) is int and type(s) is int and type(r) is int
            and type(d) is str
        ):
            return (
                f'{{"digest":{_dumps(d)},"replica":{r},"seq":{s},'
                f'"type":"{t.TYPE}","view":{v}}}'
            ).encode()
        return None
    if t is Checkpoint:
        s, d, r = msg.seq, msg.digest, msg.replica
        if type(s) is int and type(r) is int and type(d) is str:
            return (
                f'{{"digest":{_dumps(d)},"replica":{r},"seq":{s},'
                f'"type":"checkpoint"}}'
            ).encode()
        return None
    if t is PrePrepare:
        reqs = msg.requests
        if not (
            type(msg.view) is int and type(msg.seq) is int
            and type(msg.replica) is int and type(msg.digest) is str
            and type(reqs) is tuple
            and all(
                type(r) is ClientRequest and type(r.timestamp) is int
                and type(r.operation) is str and type(r.client) is str
                for r in reqs
            )
        ):
            return None
        def _req_body(r):
            return (
                f'{{"client":{_dumps(r.client)},'
                f'"operation":{_dumps(r.operation)},'
                f'"timestamp":{r.timestamp}}}'
            )
        if len(reqs) == 1:
            member = f'"request":{_req_body(reqs[0])}'
        else:
            member = '"requests":[' + ",".join(_req_body(r) for r in reqs) + "]"
        return (
            f'{{"digest":{_dumps(msg.digest)},"replica":{msg.replica},'
            f'{member},"seq":{msg.seq},'
            f'"type":"pre-prepare","view":{msg.view}}}'
        ).encode()
    if t is ClientRequest:
        if (
            type(msg.timestamp) is int and type(msg.operation) is str
            and type(msg.client) is str
        ):
            return (
                f'{{"client":{_dumps(msg.client)},'
                f'"operation":{_dumps(msg.operation)},'
                f'"timestamp":{msg.timestamp},"type":"client-request"}}'
            ).encode()
        return None
    return None


# -- receive-side canonical reuse --------------------------------------------

# Types whose "sig" member is uniquely top-level in the canonical JSON —
# view-change/new-view evidence nests signed dicts, so those always take
# the generic derivation (they are rare by construction).
_SPLICE_TYPES = None  # filled below, after the dataclasses exist


def signable_from_payload(payload: bytes, msg: Message) -> bytes:
    """Signable digest straight from a received framed payload.

    For canonical JSON payloads of the hot types, splice out the
    top-level ``"sig"`` member and hash the remaining bytes instead of
    re-serializing the parsed message. Quotes inside JSON string values
    are always escaped, so the first raw ``,"sig":"`` is the real key;
    any ambiguity (duplicate keys, non-canonical input) yields a digest
    matching no honest signable — the signature check fails closed.
    Everything else (binary payloads, nested-sig types) falls back to
    ``msg.signable()``. tests/test_wire_codec.py pins that the two
    derivations agree for every message type."""
    if payload[:1] == b"{" and type(msg) in _SPLICE_TYPES:
        i = payload.find(b',"sig":"')
        if i >= 0:
            j = payload.find(b'"', i + 8)
            if j >= 0:
                return blake2b_256(payload[:i] + payload[j + 1 :])
    return msg.signable()


# -- binary hot-message codec v2 ---------------------------------------------
#
# Negotiated per link via the version-carrying hello (net/secure.py);
# byte-identical to core/messages.cc message_to_binary/from_binary
# (pinned by the cross-runtime fuzz in tests/test_wire_codec.py).
#
#   payload := 0xB2 | type:u8 | fields
#   i64    -> 8 bytes big-endian (two's complement)
#   str    -> u32 big-endian length + UTF-8 bytes
#   digest -> 32 raw bytes (64 hex chars in the JSON codec)
#   sig    -> 64 raw bytes (128 hex chars in the JSON codec)
#
# Signatures still cover the canonical-JSON signable digest, so a signed
# message re-encodes for mixed-codec fan-out without re-signing.

WIRE_BINARY_MAGIC = 0xB2
CODEC_BINARY2 = "bin2"

_BIN_CLIENT_REQUEST = 0x01
_BIN_PRE_PREPARE = 0x02
_BIN_PREPARE = 0x03
_BIN_COMMIT = 0x04
_BIN_CHECKPOINT = 0x05
# Batched pre-prepare: same header as 0x02 but the request
# payload is a u32 count followed by that many {operation, timestamp,
# client} groups. Batches of exactly one keep emitting 0x02, so a
# batch=1 cluster's frames are byte-identical to pre-batching peers.
_BIN_PRE_PREPARE_BATCH = 0x06
_BIN_MAX_BATCH = 1 << 16

# MAC-vector authenticated frame variants (protocol 1.3.0;
# byte-identical to core/messages.cc — constants lint pins the codes):
#
#   0xB2 | mac_code | <base fields, sig included> |
#       count x (rid:u8 | tag:16B) | count:u8
#
# The base fields are EXACTLY the signature variant's (the Ed25519
# signature rides along — it is the evidence view changes re-verify
# inline; what MAC mode removes is every hot-path signature
# VERIFICATION). The lane vector holds one 16-byte keyed-BLAKE2b tag per
# intended receiver, each under that (sender, receiver) link's key,
# so ONE encoded payload fans out to every peer (serialize-once)
# and each receiver checks only its own lane. The count byte sits LAST
# so a receiver finds its lane in O(count) from the frame tail without
# re-parsing the variable-length field region.
_BIN_PRE_PREPARE_MAC = 0x12
_BIN_PREPARE_MAC = 0x13
_BIN_COMMIT_MAC = 0x14
_BIN_CHECKPOINT_MAC = 0x15
_BIN_PRE_PREPARE_BATCH_MAC = 0x16
_MAC_VECTOR_MAX = 64

# mac code <-> the base (signature-variant) code it wraps.
_MAC_TO_BASE = {
    _BIN_PRE_PREPARE_MAC: _BIN_PRE_PREPARE,
    _BIN_PREPARE_MAC: _BIN_PREPARE,
    _BIN_COMMIT_MAC: _BIN_COMMIT,
    _BIN_CHECKPOINT_MAC: _BIN_CHECKPOINT,
    _BIN_PRE_PREPARE_BATCH_MAC: _BIN_PRE_PREPARE_BATCH,
}
_BASE_TO_MAC = {base: mac for mac, base in _MAC_TO_BASE.items()}


def _i64(v: int) -> bytes:
    return v.to_bytes(8, "big", signed=True)


def _b_str(s: str) -> bytes:
    b = s.encode()
    return len(b).to_bytes(4, "big") + b


def _b_hex(h: str, n: int) -> Optional[bytes]:
    if type(h) is not str or len(h) != 2 * n:
        return None
    try:
        return bytes.fromhex(h)
    except ValueError:
        return None


def to_binary(msg: Message) -> Optional[bytes]:
    """Binary-v2 encoding of the hot normal-case types; None for any
    other type or a digest/sig field that is not fixed-width hex — the
    caller falls back to the JSON codec."""
    t = msg.__class__
    try:
        if t is ClientRequest:
            return (
                bytes((WIRE_BINARY_MAGIC, _BIN_CLIENT_REQUEST))
                + _b_str(msg.operation) + _i64(msg.timestamp)
                + _b_str(msg.client)
            )
        if t is PrePrepare:
            digest = _b_hex(msg.digest, 32)
            sig = _b_hex(msg.sig, 64)
            if digest is None or sig is None:
                return None
            head = (
                _i64(msg.view) + _i64(msg.seq) + digest
                + _i64(msg.replica) + sig
            )
            if len(msg.requests) == 1:
                req = msg.requests[0]
                return (
                    bytes((WIRE_BINARY_MAGIC, _BIN_PRE_PREPARE)) + head
                    + _b_str(req.operation) + _i64(req.timestamp)
                    + _b_str(req.client)
                )
            if len(msg.requests) > _BIN_MAX_BATCH:
                return None
            body = len(msg.requests).to_bytes(4, "big") + b"".join(
                _b_str(r.operation) + _i64(r.timestamp) + _b_str(r.client)
                for r in msg.requests
            )
            return (
                bytes((WIRE_BINARY_MAGIC, _BIN_PRE_PREPARE_BATCH))
                + head + body
            )
        if t is Prepare or t is Commit:
            digest = _b_hex(msg.digest, 32)
            sig = _b_hex(msg.sig, 64)
            if digest is None or sig is None:
                return None
            code = _BIN_PREPARE if t is Prepare else _BIN_COMMIT
            return (
                bytes((WIRE_BINARY_MAGIC, code))
                + _i64(msg.view) + _i64(msg.seq) + digest
                + _i64(msg.replica) + sig
            )
        if t is Checkpoint:
            digest = _b_hex(msg.digest, 32)
            sig = _b_hex(msg.sig, 64)
            if digest is None or sig is None:
                return None
            return (
                bytes((WIRE_BINARY_MAGIC, _BIN_CHECKPOINT))
                + _i64(msg.seq) + digest + _i64(msg.replica) + sig
            )
    except (OverflowError, AttributeError, UnicodeEncodeError):
        return None
    return None


def to_binary_mac(msg: Message, lanes) -> Optional[bytes]:
    """MAC-vector frame for a hot message: the signature-variant fields
    plus one (receiver id, 16-byte tag) lane per entry in ``lanes``
    (an iterable of ``(rid, tag16)``; the caller computes each tag as a
    keyed BLAKE2b of the message's signable digest under its link's key,
    as ``pbft_tpu/net/secure.py`` ``mac_tag`` does). None when
    the message has no binary form, lanes are empty/over the bound, or
    a lane is malformed — the caller falls back to the signature frame."""
    base = to_binary(msg)
    if base is None:
        return None
    mac_code = _BASE_TO_MAC.get(base[1])
    if mac_code is None:
        return None
    entries = list(lanes)
    if not entries or len(entries) > _MAC_VECTOR_MAX:
        return None
    vec = bytearray()
    for rid, tag in entries:
        if not (isinstance(rid, int) and 0 <= rid <= 0xFF):
            return None
        if not isinstance(tag, (bytes, bytearray)) or len(tag) != 16:
            return None
        vec.append(rid)
        vec += tag
    return (
        bytes((WIRE_BINARY_MAGIC, mac_code))
        + base[2:]
        + bytes(vec)
        + len(entries).to_bytes(1, "big")
    )


def payload_is_mac_frame(payload: bytes) -> bool:
    return (
        len(payload) >= 2
        and payload[0] == WIRE_BINARY_MAGIC
        and payload[1] in _MAC_TO_BASE
    )


def mac_frame_lane(payload: bytes, rid: int) -> Optional[bytes]:
    """This receiver's 16-byte authenticator tag from a MAC frame's lane
    vector, or None (not a MAC frame, malformed vector, or no lane for
    ``rid`` — e.g. a link that joined mid-fan-out; the caller then falls
    back to the signature path, which the embedded sig still serves)."""
    if not payload_is_mac_frame(payload):
        return None
    count = payload[-1]
    if not (1 <= count <= _MAC_VECTOR_MAX):
        return None
    start = len(payload) - 1 - 17 * count
    if start < 2:
        return None
    for k in range(count):
        off = start + 17 * k
        if payload[off] == rid:
            return payload[off + 1 : off + 17]
    return None


class _BinReader:
    __slots__ = ("b", "off")

    def __init__(self, b: bytes, off: int):
        self.b = b
        self.off = off

    def _take(self, n: int) -> bytes:
        end = self.off + n
        if end > len(self.b):
            raise ValueError("truncated binary frame")
        out = self.b[self.off : end]
        self.off = end
        return out

    def i64(self) -> int:
        return int.from_bytes(self._take(8), "big", signed=True)

    def str_(self) -> str:
        n = int.from_bytes(self._take(4), "big")
        if n > (1 << 24):
            raise ValueError("oversized string in binary frame")
        return self._take(n).decode()

    def hex_(self, n: int) -> str:
        return self._take(n).hex()


def from_binary(payload: bytes) -> Message:
    """Decode a binary-v2 payload; raises ValueError on any malformation
    (short reads, trailing bytes, unknown type, invalid UTF-8). MAC
    frame variants decode to the same Message as their signature twins —
    the lane vector is validated structurally here and verified
    cryptographically by the net layer (which holds the link keys)."""
    if len(payload) < 2 or payload[0] != WIRE_BINARY_MAGIC:
        raise ValueError("not a binary-v2 payload")
    code = payload[1]
    if code in _MAC_TO_BASE:
        count = payload[-1]
        if not (1 <= count <= _MAC_VECTOR_MAX):
            raise ValueError("bad MAC-vector count")
        end = len(payload) - 1 - 17 * count
        if end < 2:
            raise ValueError("truncated MAC-vector frame")
        payload = bytes((WIRE_BINARY_MAGIC, _MAC_TO_BASE[code])) + payload[2:end]
        code = payload[1]
    r = _BinReader(payload, 2)
    if code == _BIN_CLIENT_REQUEST:
        msg: Message = ClientRequest(
            operation=r.str_(), timestamp=r.i64(), client=r.str_()
        )
    elif code in (_BIN_PRE_PREPARE, _BIN_PRE_PREPARE_BATCH):
        view, seq = r.i64(), r.i64()
        digest = r.hex_(32)
        replica = r.i64()
        sig = r.hex_(64)
        if code == _BIN_PRE_PREPARE:
            reqs = (
                ClientRequest(
                    operation=r.str_(), timestamp=r.i64(), client=r.str_()
                ),
            )
        else:
            count = int.from_bytes(r._take(4), "big")
            if count > _BIN_MAX_BATCH or count == 1:
                # count==1 must encode as 0x02 (one canonical form per
                # message, or signable digests would fork).
                raise ValueError("invalid batched pre-prepare count")
            reqs = tuple(
                ClientRequest(
                    operation=r.str_(), timestamp=r.i64(), client=r.str_()
                )
                for _ in range(count)
            )
        msg = PrePrepare(
            view=view, seq=seq, digest=digest, requests=reqs,
            replica=replica, sig=sig,
        )
    elif code in (_BIN_PREPARE, _BIN_COMMIT):
        cls = Prepare if code == _BIN_PREPARE else Commit
        msg = cls(
            view=r.i64(), seq=r.i64(), digest=r.hex_(32),
            replica=r.i64(), sig=r.hex_(64),
        )
    elif code == _BIN_CHECKPOINT:
        msg = Checkpoint(
            seq=r.i64(), digest=r.hex_(32), replica=r.i64(), sig=r.hex_(64)
        )
    else:
        raise ValueError(f"unknown binary message type {code:#x}")
    if r.off != len(payload):
        raise ValueError("trailing bytes in binary frame")
    return msg


def decode_payload(payload: bytes) -> Message:
    """Decode a framed payload of either codec (binary-v2 when it opens
    with the magic byte, canonical JSON otherwise)."""
    if payload[:1] == bytes((WIRE_BINARY_MAGIC,)):
        return from_binary(payload)
    return from_wire(payload)


_SPLICE_TYPES = (
    PrePrepare, Prepare, Commit, Checkpoint, StateRequest, StateResponse
)
