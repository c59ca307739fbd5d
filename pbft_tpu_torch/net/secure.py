"""Authenticated, encrypted replica-replica links (the port's copy of
``pbft_tpu/net/secure.py``: the same handshake, keys and frames, so a port
replica and a JAX or ``pbftd`` replica share one link).

The reference secures every libp2p link with ``development_transport``
(Noise encryption + yamux muxing, reference src/main.rs:42) and names its
protocol ``/ackintosh/pbft/1.0.0`` (reference src/protocol_config.rs:24).
This module is the rebuild's equivalent, designed around the primitives
both runtimes already ship (Ed25519 point arithmetic + BLAKE2b) instead
of pulling in a Noise stack:

- **Handshake**: signed ephemeral Diffie-Hellman on edwards25519 (the
  station-to-station pattern). Each side sends a fresh ephemeral public
  key; both sign the transcript hash with their *identity* key (the one
  registered in network.json), giving mutual authentication + forward
  secrecy. ECDH reuses the existing curve code — clamped scalars clear
  the cofactor exactly as in X25519.
- **Versioning**: the first frame on every peer connection is a plaintext
  ``hello`` carrying ``ver``; a mismatch is answered with a ``reject``
  frame naming both versions, then the connection closes — a mixed-version
  cluster fails loudly instead of with undiagnosable JSON errors.
- **AEAD**: encrypt-then-MAC with keyed BLAKE2b (RFC 7693 keyed mode is a
  PRF): per-direction keys, implicit frame counters (TCP preserves
  order), 64-byte keystream blocks, 16-byte tag. hashlib.blake2b on this
  side; core/blake2b.cc's keyed mode on the C++ side — byte-identical
  (tests/test_secure.py pins interop).

Handshake frames (canonical JSON payloads inside the normal 4-byte
length framing; initiator = the dialing replica):

    hello_i: {"type":"hello","ver":V,"node":i,"eph":<64hex>}
    hello_r: {"type":"hello","ver":V,"node":r,"eph":<64hex>,"sig":<128hex>}
    auth_i:  {"type":"auth","node":i,"sig":<128hex>}
    reject:  {"type":"reject","reason":...,"ver":V}

with sig_r = Ed25519(identity_r, transcript || "|resp") and
sig_i = Ed25519(identity_i, transcript || "|init"), where
transcript = BLAKE2b-256("pbft-tpu-hs1|" + V + "|" + eph_i + "|" + eph_r).
In plaintext clusters (``secure: false``) only ``hello_i`` is sent — the
version check still runs on every link, but no keys are negotiated.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets
from typing import Optional, Tuple

from ..consensus.messages import CODEC_BINARY2
from ..crypto import ref

# 1.1.0 adds the negotiated binary-v2 payload codec
# (consensus/messages.py); 1.2.0 adds the batched pre-prepare (binary
# 0x06 / JSON `requests`) whose batch=1 frames stay
# byte-identical to 1.1.0; 1.3.0 adds the fast-path modes:
# per-link session-MAC authenticators on normal-case frames (the
# MAC-vector binary variants, consensus/messages.py 0x12-0x16) and the
# tentative client-reply flag. Older peers stay interoperable — the
# hello's ver gates what a sender may offer (a link only runs MAC mode
# when BOTH hellos offered "mac1"), the handshake transcript binds to
# the initiator's advertised version so mixed-version secure handshakes
# still agree on the signed bytes, and a batching primary simply must
# not be pointed at pre-1.2.0 peers with batch_max_items > 1.
PROTOCOL_VERSION = "pbft-tpu/1.3.0"
PROTOCOL_VERSION_BATCH = "pbft-tpu/1.2.0"
PROTOCOL_VERSION_BIN2 = "pbft-tpu/1.1.0"
PROTOCOL_VERSION_LEGACY = "pbft-tpu/1.0.0"
_COMPATIBLE_VERSIONS = (
    PROTOCOL_VERSION,
    PROTOCOL_VERSION_BATCH,
    PROTOCOL_VERSION_BIN2,
    PROTOCOL_VERSION_LEGACY,
)

# The authenticator-mode offer carried in the 1.3.0 hello's "auth" list
# (mirrors core/secure.h kAuthModeMac; constants lint): per-link session
# MACs over the signable digest, keys derived from the handshake
# transcript. MAC_TAG_LEN and MAC_CONTEXT are the tag width and the
# domain-separation label (core/secure.h kMacTagLen / kMacContext).
AUTH_MODE_MAC = "mac1"
MAC_TAG_LEN = 16
MAC_CONTEXT = "pbft-tpu-auth1|"


def _wire_json_forced() -> bool:
    return os.environ.get("PBFT_WIRE_CODEC") == "json"


def _proto_capped_12() -> bool:
    """PBFT_PROTO_CAP=1.2.0 advertises the 1.2.0 hello with no fast-path
    offer — the interop-test lever simulating a pre-1.3.0 peer (the same
    role PBFT_WIRE_CODEC=json plays for 1.0.0)."""
    return os.environ.get("PBFT_PROTO_CAP") == "1.2.0"


def wire_hello_version() -> str:
    """The version this node advertises: 1.3.0 with the codec + fast-path
    offers, 1.2.0 under PBFT_PROTO_CAP=1.2.0, or the legacy 1.0.0
    JSON-only hello when PBFT_WIRE_CODEC=json (the mixed-cluster escape
    hatches and the interop-test levers)."""
    if _wire_json_forced():
        return PROTOCOL_VERSION_LEGACY
    if _proto_capped_12():
        return PROTOCOL_VERSION_BATCH
    return PROTOCOL_VERSION


def wire_offer_binary() -> bool:
    return not _wire_json_forced()


def wire_offer_mac(fastpath_mac: bool) -> bool:
    """Whether this node's hellos offer the MAC authenticator mode: the
    cluster config asked for it (fastpath == "mac") AND nothing capped
    the advertised protocol below 1.3.0."""
    return fastpath_mac and not _wire_json_forced() and not _proto_capped_12()


def hello_offers_binary(obj: dict) -> bool:
    """True when a peer's hello offers the binary-v2 codec (and this node
    offers it too): the sender may then encode hot messages as binary."""
    if not wire_offer_binary():
        return False
    codecs = obj.get("codecs")
    return isinstance(codecs, list) and CODEC_BINARY2 in codecs


def hello_offers_mac(obj: dict) -> bool:
    """True when a peer's hello offers the MAC authenticator mode. The
    caller still ANDs this with its own offer — a link runs MAC frames
    only when both sides advertised mac1."""
    auth = obj.get("auth")
    return isinstance(auth, list) and AUTH_MODE_MAC in auth


def _attach_codecs(o: dict, offer_mac: bool = False) -> dict:
    if wire_offer_binary():
        o["codecs"] = [CODEC_BINARY2]
    if wire_offer_mac(offer_mac):
        o["auth"] = [AUTH_MODE_MAC]
    return o


def mac_tag(key: bytes, signable_digest: bytes) -> bytes:
    """One authenticator lane: keyed BLAKE2b over the domain label + the
    32-byte signable digest (the same bytes a signature would cover).
    Byte-identical to core/secure.cc mac_tag."""
    return hashlib.blake2b(
        MAC_CONTEXT.encode() + signable_digest, key=key,
        digest_size=MAC_TAG_LEN,
    ).digest()
_HS_CONTEXT = b"pbft-tpu-hs1|"
_KDF_CONTEXT = b"pbft-tpu-k1|"
TAG_LEN = 16
# Point of small order (the identity) in compressed encoding: y = 1.
_IDENTITY_ENC = (1).to_bytes(32, "little")


def _clamp(k: bytes) -> int:
    a = int.from_bytes(k, "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def dh_keypair(seed: Optional[bytes] = None) -> Tuple[bytes, bytes]:
    """Ephemeral keypair: (secret 32B, compressed public 32B)."""
    if seed is None:
        seed = secrets.token_bytes(32)
    pub = ref.point_compress(ref.scalar_mult(_clamp(seed), ref.BASE))
    return seed, pub


def dh_shared(secret: bytes, peer_pub: bytes) -> Optional[bytes]:
    """Shared secret = compress(clamp(secret) * decompress(peer_pub)).

    None on an invalid peer point or a small-order result (the clamped
    scalar is a multiple of 8, so a small-order peer point collapses to
    the identity — rejecting it prevents a key-contribution bypass).
    """
    pt = ref.point_decompress(peer_pub)
    if pt is None:
        return None
    out = ref.point_compress(ref.scalar_mult(_clamp(secret), pt))
    if out == _IDENTITY_ENC:
        return None
    return out


def transcript(ver: str, eph_i: bytes, eph_r: bytes) -> bytes:
    return hashlib.blake2b(
        _HS_CONTEXT + ver.encode() + b"|" + eph_i + b"|" + eph_r,
        digest_size=32,
    ).digest()


def derive_keys(shared: bytes, eph_i: bytes, eph_r: bytes) -> Tuple[bytes, bytes]:
    """(key_i2r, key_r2i): 64 bytes each = enc key 32 || mac key 32."""
    def kdf(label: bytes) -> bytes:
        return hashlib.blake2b(
            _KDF_CONTEXT + label + b"|" + eph_i + b"|" + eph_r,
            key=shared,
            digest_size=64,
        ).digest()

    return kdf(b"i2r"), kdf(b"r2i")


def derive_auth_keys(
    shared: bytes, eph_i: bytes, eph_r: bytes
) -> Tuple[bytes, bytes]:
    """(auth_i2r, auth_r2i): 32 bytes each — the per-direction session
    keys behind the MAC-vector authenticators. Derived from the
    SAME handshake transcript material as the AEAD keys but under
    distinct labels, so authenticator lanes and frame sealing never share
    key bytes. Byte-identical to core/secure.cc derive_key("a-i2r"...)."""
    def kdf(label: bytes) -> bytes:
        return hashlib.blake2b(
            _KDF_CONTEXT + label + b"|" + eph_i + b"|" + eph_r,
            key=shared,
            digest_size=32,
        ).digest()

    return kdf(b"a-i2r"), kdf(b"a-r2i")


def seal(key: bytes, ctr: int, plaintext: bytes) -> bytes:
    """ciphertext || 16-byte tag (encrypt-then-MAC, keyed BLAKE2b)."""
    enc, mac = key[:32], key[32:]
    nonce = ctr.to_bytes(8, "little")
    ks = b"".join(
        hashlib.blake2b(
            nonce + j.to_bytes(4, "little"), key=enc, digest_size=64
        ).digest()
        for j in range((len(plaintext) + 63) // 64)
    )
    n = len(plaintext)
    ct = (
        int.from_bytes(plaintext, "little") ^ int.from_bytes(ks[:n], "little")
    ).to_bytes(n, "little")
    tag = hashlib.blake2b(nonce + ct, key=mac, digest_size=TAG_LEN).digest()
    return ct + tag


def open_sealed(key: bytes, ctr: int, sealed: bytes) -> Optional[bytes]:
    """Inverse of seal(); None on a bad tag (constant-time compare)."""
    if len(sealed) < TAG_LEN:
        return None
    ct, tag = sealed[:-TAG_LEN], sealed[-TAG_LEN:]
    nonce = ctr.to_bytes(8, "little")
    expect = hashlib.blake2b(nonce + ct, key=key[32:], digest_size=TAG_LEN).digest()
    if not hmac.compare_digest(expect, tag):
        return None
    ks = b"".join(
        hashlib.blake2b(
            nonce + j.to_bytes(4, "little"), key=key[:32], digest_size=64
        ).digest()
        for j in range((len(ct) + 63) // 64)
    )
    n = len(ct)
    return (
        int.from_bytes(ct, "little") ^ int.from_bytes(ks[:n], "little")
    ).to_bytes(n, "little")


class HandshakeError(Exception):
    """Terminal handshake failure; the connection must close."""


def _hex_field(obj: dict, key: str, nbytes: int) -> bytes:
    """Decode a hex handshake field; malformed input is a protocol error
    (HandshakeError), never a stray ValueError escaping the handler."""
    val = obj.get(key)
    if not isinstance(val, str) or len(val) != 2 * nbytes:
        raise HandshakeError(f"handshake frame without valid {key!r} field")
    try:
        return bytes.fromhex(val)
    except ValueError:
        raise HandshakeError(f"non-hex {key!r} field in handshake frame")


class SecureChannel:
    """One connection's handshake state machine + sealed-frame codec.

    Drive with ``initiator_hello()`` / ``on_hello()`` / ``on_hello_reply()``
    / ``on_auth()`` until ``established``; then ``seal_frame()`` /
    ``open_frame()``. Byte-compatible with core/secure.cc.
    """

    def __init__(
        self,
        my_id: int,
        identity_seed: bytes,
        pubkey_of,  # Callable[[int], Optional[bytes]] — network.json table
        initiator: bool,
        expected_peer: Optional[int] = None,
        eph_secret: Optional[bytes] = None,
        offer_mac: bool = False,
        auth_only: bool = False,
    ):
        self.my_id = my_id
        self._seed = identity_seed
        self._pubkey_of = pubkey_of
        self.initiator = initiator
        self.expected_peer = expected_peer
        self.peer_id: Optional[int] = None
        self._eph_secret, self.eph_pub = dh_keypair(eph_secret)
        self._peer_eph: Optional[bytes] = None
        self._send_key: Optional[bytes] = None
        self._recv_key: Optional[bytes] = None
        self._send_ctr = 0
        self._recv_ctr = 0
        self.established = False
        # Fast-path negotiation: whether THIS node offers the
        # MAC authenticator mode, whether the peer's hello offered it,
        # and the per-direction session keys once established.
        # ``auth_only`` marks a channel that runs the SAME signed
        # handshake purely for key agreement + identity — frames on the
        # link stay plaintext (the fastpath=mac, secure=false flavor);
        # callers must not seal/open through an auth-only channel.
        self.offer_mac = offer_mac
        self.auth_only = auth_only
        self.peer_offers_mac = False
        self.auth_send_key: Optional[bytes] = None
        self.auth_recv_key: Optional[bytes] = None
        # The transcript binds to the INITIATOR's advertised version
        # (both sides know it after hello_i): initiator = the version it
        # sends; responder = set from hello_i in on_hello.
        self._hs_version = wire_hello_version()

    # -- handshake ----------------------------------------------------------

    def initiator_hello(self) -> dict:
        return _attach_codecs(
            {
                "type": "hello",
                "ver": wire_hello_version(),
                "node": self.my_id,
                "eph": self.eph_pub.hex(),
            },
            offer_mac=self.offer_mac,
        )

    @staticmethod
    def check_version(obj: dict) -> None:
        # Compatible set, not exact match: 1.1.0 only ADDS the negotiated
        # binary codec, so 1.0.0 peers interoperate (JSON frames both ways).
        ver = obj.get("ver")
        if ver not in _COMPATIBLE_VERSIONS:
            raise HandshakeError(
                f"protocol version mismatch: peer speaks {ver!r}, "
                f"this node speaks {PROTOCOL_VERSION!r}"
            )

    def _transcript(self) -> bytes:
        eph_i = self.eph_pub if self.initiator else self._peer_eph
        eph_r = self._peer_eph if self.initiator else self.eph_pub
        return transcript(self._hs_version, eph_i, eph_r)

    def _finish(self) -> None:
        shared = dh_shared(self._eph_secret, self._peer_eph)
        if shared is None:
            raise HandshakeError("invalid ephemeral key from peer")
        eph_i = self.eph_pub if self.initiator else self._peer_eph
        eph_r = self._peer_eph if self.initiator else self.eph_pub
        k_i2r, k_r2i = derive_keys(shared, eph_i, eph_r)
        self._send_key = k_i2r if self.initiator else k_r2i
        self._recv_key = k_r2i if self.initiator else k_i2r
        a_i2r, a_r2i = derive_auth_keys(shared, eph_i, eph_r)
        self.auth_send_key = a_i2r if self.initiator else a_r2i
        self.auth_recv_key = a_r2i if self.initiator else a_i2r
        self.established = True

    def _verify_peer_sig(self, obj: dict, label: bytes) -> None:
        node = obj.get("node")
        if not isinstance(node, int):
            raise HandshakeError("handshake frame without node id")
        if self.expected_peer is not None and node != self.expected_peer:
            raise HandshakeError(
                f"peer claims node {node}, expected {self.expected_peer}"
            )
        pub = self._pubkey_of(node)
        if pub is None:
            raise HandshakeError(f"unknown node id {node}")
        sig = _hex_field(obj, "sig", 64)
        if not ref.verify(pub, self._transcript() + label, sig):
            raise HandshakeError(f"bad handshake signature from node {node}")
        self.peer_id = node

    def on_hello(self, obj: dict) -> dict:
        """Responder: process hello_i, return hello_r."""
        self.check_version(obj)
        if not isinstance(obj.get("eph"), str):
            raise HandshakeError(
                "plaintext peer rejected: this cluster requires encrypted "
                "links (hello carried no ephemeral key)"
            )
        # check_version admitted the initiator's version into the
        # compatible set; the transcript binds to it.
        self._hs_version = obj["ver"]
        self.peer_offers_mac = hello_offers_mac(obj)
        self._peer_eph = _hex_field(obj, "eph", 32)
        sig = ref.sign(self._seed, self._transcript() + b"|resp")
        return _attach_codecs(
            {
                "type": "hello",
                "ver": wire_hello_version(),
                "node": self.my_id,
                "eph": self.eph_pub.hex(),
                "sig": sig.hex(),
            },
            offer_mac=self.offer_mac,
        )

    def on_hello_reply(self, obj: dict) -> dict:
        """Initiator: process hello_r, return auth_i; channel established."""
        if obj.get("type") == "reject":
            raise HandshakeError(f"peer rejected handshake: {obj.get('reason')}")
        self.check_version(obj)
        if not isinstance(obj.get("eph"), str):
            raise HandshakeError("responder hello carried no ephemeral key")
        self.peer_offers_mac = hello_offers_mac(obj)
        self._peer_eph = _hex_field(obj, "eph", 32)
        self._verify_peer_sig(obj, b"|resp")
        sig = ref.sign(self._seed, self._transcript() + b"|init")
        self._finish()
        return {"type": "auth", "node": self.my_id, "sig": sig.hex()}

    def on_auth(self, obj: dict) -> None:
        """Responder: process auth_i; channel established."""
        if self._peer_eph is None:
            raise HandshakeError("auth before hello")
        self._verify_peer_sig(obj, b"|init")
        self._finish()

    @property
    def mac_negotiated(self) -> bool:
        """Both sides offered the MAC authenticator mode on this link."""
        return wire_offer_mac(self.offer_mac) and self.peer_offers_mac

    # -- sealed frames ------------------------------------------------------

    def seal_frame(self, payload: bytes) -> bytes:
        sealed = seal(self._send_key, self._send_ctr, payload)
        self._send_ctr += 1
        return sealed

    def open_frame(self, sealed: bytes) -> bytes:
        payload = open_sealed(self._recv_key, self._recv_ctr, sealed)
        if payload is None:
            raise HandshakeError(
                f"AEAD tag mismatch on frame {self._recv_ctr} "
                f"from node {self.peer_id}"
            )
        self._recv_ctr += 1
        return payload


def reject_payload(reason: str) -> dict:
    return {"type": "reject", "reason": reason, "ver": wire_hello_version()}


def plain_hello(my_id: int, offer_mac: bool = False) -> dict:
    """The version-carrying (and codec-offering) hello sent on plaintext
    peer links — both as the dialing side's first frame and as the
    responder's hello-ack that lets the dialer negotiate binary-v2."""
    return _attach_codecs(
        {"type": "hello", "ver": wire_hello_version(), "node": my_id},
        offer_mac=offer_mac,
    )
