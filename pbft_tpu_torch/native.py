"""The native verify pool: ctypes bindings to the C++ core's batch verifier
(``core/`` -> ``build-core/libpbftcore.so``), the port's copy of the part of
``pbft_tpu/native.py`` that verification and signing need.

The pool (``core/verify_pool.cc``) splits a batch into fixed 256-item
windows and checks each by a random linear combination on its threads; its
accept set equals RFC 8032's on every signature a single signer can make
(two crafted signatures with cancelling torsion defects in one window pass
together, by design: see ``core/ed25519.cc``). It is the host's verifier:
the daemon's warm-time fallback and the replica client's safety net
(``host_batch_verify``), and the service's ``native`` backend. The core's
single-signature ``sign`` and ``verify`` are the replicas' host signer and
inline verifier (``consensus/replica.py``). The rest of the C ABI is bound
too, with the reference's signatures: the hashes (``blake2b``,
``blake2b_keyed``, ``sha512``), the secure channel's primitives
(``dh_public``, ``dh_shared``, ``aead_seal``, ``aead_open``, ``mac_tag``),
the binary wire codec (``message_to_binary``, ``message_from_binary``,
``signable_from_payload``, ``message_to_binary_mac``, ``mac_frame_lane``),
the native flight recorder (``flight_*``) and the verifier's test hooks
(``force_entropy_exhaustion``, ``pubkey_cache_*``): the surface the
cross-runtime parity tests hold the Python runtime against. Where the C
side reads a fixed-size key or secret, a buffer of another length raises
``ValueError`` (the reference passes it through); a failed open, a shared
secret of a small-order point or an undecodable frame is ``None``, as in
the reference.

There is one build of ``core/`` in a checkout, ``build-core/``, shared with
the JAX package. When its artifacts are missing this module builds them all
(the library, ``pbftd`` and ``core_test``) with ``g++`` directly, one
compiler process per source at once, under a file lock, each artifact
written under a temporary name and renamed into place, the library last.
A missing compiler is final for the process; a failed build is tried again
a minute later, and a failed load at the next call (the JAX package's
builder writes the library in place, so a load can meet a half-written
file).
"""

from __future__ import annotations

import ctypes
import fcntl
import json
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

_REPO_ROOT = Path(__file__).resolve().parent.parent
_CORE = _REPO_ROOT / "core"
_BUILD_DIR = _REPO_ROOT / "build-core"
_LIB_PATH = _BUILD_DIR / "libpbftcore.so"
_EXECUTABLES = {"pbftd": "pbftd.cc", "core_test": "core_test.cc"}

# The library's sources, in core/CMakeLists.txt order; pbftd.cc and
# core_test.cc link against the library.
_LIB_SOURCES = [
    "blake2b.cc", "sha512.cc", "ed25519.cc", "json.cc", "messages.cc",
    "metrics.cc", "flight.cc", "wal.cc", "replica.cc", "verifier.cc",
    "verify_pool.cc",
    "secure.cc", "net.cc", "net_shard.cc", "discovery.cc", "capi.cc",
]

_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[Exception] = None  # the last failed build or load
_retry_at = 0.0  # time.monotonic() before which lib() re-raises _lib_error
_BUILD_RETRY_S = 60.0
_LOAD_TRIES = 3
_lib_lock = threading.Lock()


class NoCompilerError(RuntimeError):
    """No C++ compiler: the library cannot be built in this process."""


def _run_all(cmds: List[Tuple[str, List[str]]]) -> None:
    """Run the compiler commands at once, at a low priority (a daemon's
    build runs beside its engine's warm); raise with the errors of any that
    failed."""
    nice = ["nice", "-n", "10"] if shutil.which("nice") else []
    procs = [
        (what, subprocess.Popen([*nice, *cmd], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        for what, cmd in cmds
    ]
    failed = []
    for what, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{what}:\n{err[-4000:]}")
    if failed:
        raise RuntimeError("building the native core failed:\n" + "\n".join(failed))


def _build_into(tmp: Path) -> None:
    """Compile and link every artifact into ``tmp`` with the flags of the
    CMake Release config (strict: warnings fail the build unless
    PBFT_CORE_NO_WERROR=1). Every source compiles at once, then the library
    links, then both executables."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        raise NoCompilerError("no C++ compiler found for the native core")
    common = ["-O2", "-std=c++17", "-Wall", "-Wextra", "-pthread"]
    if not os.environ.get("PBFT_CORE_NO_WERROR"):
        common.append("-Werror")

    def obj(src: str) -> str:
        return str(tmp / (src[:-3] + ".o"))

    _run_all(
        [(src, [cxx, *common, "-fPIC", "-c", str(_CORE / src), "-o", obj(src)]) for src in _LIB_SOURCES]
        + [(src, [cxx, *common, "-c", str(_CORE / src), "-o", obj(src)]) for src in _EXECUTABLES.values()]
    )
    so = str(tmp / _LIB_PATH.name)
    _run_all([(_LIB_PATH.name, [cxx, *common, "-fPIC", "-shared", "-o", so, *map(obj, _LIB_SOURCES)])])
    _run_all(
        [
            (exe, [cxx, *common, "-o", str(tmp / exe), obj(src), "-L", str(tmp), "-lpbftcore", "-Wl,-rpath,$ORIGIN"])
            for exe, src in _EXECUTABLES.items()
        ]
    )


def build() -> dict:
    """Build ``build-core/`` when any of its artifacts is missing. Safe
    against other processes building at the same time: an ``fcntl`` lock on
    ``build-core/.build.lock`` serializes concurrent builds, and a reader
    never sees a half-written file. Returns ``{"built": bool, "build_s":
    seconds}``; raises if the build fails."""
    t0 = time.perf_counter()
    _BUILD_DIR.mkdir(exist_ok=True)
    with open(_BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            artifacts = [_LIB_PATH] + [_BUILD_DIR / exe for exe in _EXECUTABLES]
            if all(p.exists() for p in artifacts):
                return {"built": False, "build_s": time.perf_counter() - t0}
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR, prefix=".build-") as tmp:
                _build_into(Path(tmp))
                # The library last: the JAX package's build() takes the
                # library's presence to mean the whole build is there.
                for exe in _EXECUTABLES:
                    os.replace(Path(tmp) / exe, _BUILD_DIR / exe)
                os.replace(Path(tmp) / _LIB_PATH.name, _LIB_PATH)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return {"built": True, "build_s": time.perf_counter() - t0}


def _bind(so: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the signatures of the functions this module calls."""
    so.pbft_ed25519_verify_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    so.pbft_ed25519_verify_batch.restype = None
    so.pbft_set_verify_threads.argtypes = [ctypes.c_int]
    so.pbft_set_verify_threads.restype = None
    so.pbft_verify_threads.argtypes = []
    so.pbft_verify_threads.restype = ctypes.c_int
    so.pbft_verify_pool_stats_json.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    so.pbft_verify_pool_stats_json.restype = ctypes.c_size_t
    so.pbft_ed25519_public_key.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    so.pbft_ed25519_public_key.restype = None
    so.pbft_ed25519_sign.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
    so.pbft_ed25519_sign.restype = None
    so.pbft_ed25519_verify.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
    so.pbft_ed25519_verify.restype = ctypes.c_int
    buf, size, i64 = ctypes.c_char_p, ctypes.c_size_t, ctypes.c_longlong
    for name, args, res in (
        ("pbft_blake2b", [buf, size, buf, size], None),
        ("pbft_blake2b_keyed", [buf, size, buf, size, buf, size], None),
        ("pbft_sha512", [buf, buf, size], None),
        ("pbft_dh_public", [buf, buf], None),
        ("pbft_dh_shared", [buf, buf, buf], ctypes.c_int),
        ("pbft_aead_seal", [buf, ctypes.c_uint64, buf, size, buf], None),
        ("pbft_aead_open", [buf, ctypes.c_uint64, buf, size, buf], ctypes.c_long),
        ("pbft_test_force_entropy_exhaustion", [ctypes.c_int], None),
        ("pbft_pubkey_cache_clear", [], None),
        ("pbft_test_pubkey_cache_disable", [ctypes.c_int], None),
        ("pbft_flight_configure", [size], None),
        ("pbft_flight_record", [ctypes.c_int, i64, i64, ctypes.c_int], None),
        ("pbft_flight_total", [], ctypes.c_ulonglong),
        ("pbft_flight_dump", [buf], ctypes.c_long),
        ("pbft_flight_reset", [], None),
        ("pbft_message_to_binary", [buf, size, buf, size], size),
        ("pbft_message_from_binary", [buf, size, buf, size, buf], size),
        ("pbft_signable_from_payload", [buf, size, buf], ctypes.c_int),
        ("pbft_message_to_binary_mac", [buf, size, buf, size, buf, size], size),
        ("pbft_mac_frame_lane", [buf, size, i64, buf], ctypes.c_int),
        ("pbft_mac_tag", [buf, buf, buf], None),
    ):
        fn = getattr(so, name)
        fn.argtypes = args
        fn.restype = res
    return so


def _load() -> ctypes.CDLL:
    """Load and bind the built library, trying again briefly while it does
    not load: a builder that writes it in place leaves it half-written for
    the length of a link."""
    for _ in range(_LOAD_TRIES - 1):
        try:
            return _bind(ctypes.CDLL(str(_LIB_PATH)))
        except OSError:
            time.sleep(0.5)
    return _bind(ctypes.CDLL(str(_LIB_PATH)))


def _get(blocking: bool) -> Optional[ctypes.CDLL]:
    """The loaded library, built first where needed. Without ``blocking``,
    None while another thread builds or loads it. Raises if it cannot be
    built or loaded, and re-raises that failure until ``_retry_at``."""
    global _lib, _lib_error, _retry_at
    if _lib is not None:
        return _lib
    if not _lib_lock.acquire(blocking=blocking):
        return None
    try:
        if _lib is None:
            if time.monotonic() < _retry_at:
                raise RuntimeError(f"the native core is unavailable: {_lib_error}") from _lib_error
            built = False
            try:
                build()
                built = True
                _lib = _load()
            except (OSError, RuntimeError, AttributeError) as e:
                _lib_error = e
                if isinstance(e, NoCompilerError):
                    _retry_at = math.inf
                elif not built:
                    _retry_at = time.monotonic() + _BUILD_RETRY_S
                raise
        return _lib
    finally:
        _lib_lock.release()


def lib() -> ctypes.CDLL:
    """The loaded library, built first where needed; raises if it cannot be
    built or loaded."""
    return _get(blocking=True)


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        lib()
        return True
    except (OSError, RuntimeError, AttributeError):
        return False


def load_in_background() -> None:
    """Build and load the library on a daemon thread, so that
    ``host_batch_verify`` finds it ready: until then it answers from the
    oracle, and no caller waits on the compiler."""
    if _lib is None:
        threading.Thread(target=available, name="native-core-load", daemon=True).start()


def host_verifier() -> str:
    """What ``host_batch_verify`` answers with now: ``"native"`` once the
    library is loaded, else ``"oracle"``."""
    return "native" if _lib is not None else "oracle"


def _verify_on(so: ctypes.CDLL, items: Sequence[Tuple[bytes, bytes, bytes]]) -> List[bool]:
    n = len(items)
    if n == 0:
        return []
    for pub, msg, sig in items:
        if len(pub) != 32 or len(msg) != 32 or len(sig) != 64:
            raise ValueError("native verify_batch takes (pub32, msg32, sig64) triples")
    pubs = b"".join(i[0] for i in items)
    msgs = b"".join(i[1] for i in items)
    sigs = b"".join(i[2] for i in items)
    out = ctypes.create_string_buffer(n)
    so.pbft_ed25519_verify_batch(pubs, msgs, sigs, out, n)
    return [b == 1 for b in out.raw]


def verify_batch(items: Sequence[Tuple[bytes, bytes, bytes]]) -> List[bool]:
    """Verify (pub32, msg32, sig64) triples on the native verify pool, one
    bool per item. Raises ValueError on a triple of other lengths, and
    whatever ``lib()`` raises when the library cannot be built or loaded."""
    return _verify_on(lib(), items) if items else []


def _check_seed(seed: bytes) -> None:
    if len(seed) != 32:
        raise ValueError(f"an Ed25519 seed is 32 bytes, not {len(seed)}")


def public_key(seed: bytes) -> bytes:
    """The 32-byte Ed25519 public key of a 32-byte seed (RFC 8032)."""
    _check_seed(seed)
    out = ctypes.create_string_buffer(32)
    lib().pbft_ed25519_public_key(out, seed)
    return out.raw


def sign(seed: bytes, msg: bytes) -> bytes:
    """The 64-byte RFC 8032 signature of ``msg`` under ``seed``: the same
    bytes as ``crypto.ref.sign`` (signatures are deterministic)."""
    _check_seed(seed)
    out = ctypes.create_string_buffer(64)
    lib().pbft_ed25519_sign(out, seed, msg, len(msg))
    return out.raw


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """One signature, checked alone (no random linear combination): the
    accept set of ``crypto.ref.verify``. False for a key or signature of
    another length."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    return bool(lib().pbft_ed25519_verify(pub, msg, len(msg), sig))


def set_verify_threads(threads: int) -> None:
    """Reconfigure the pool's width (0 = hardware concurrency). Tears down
    the existing pool; call between batches."""
    lib().pbft_set_verify_threads(threads)


def verify_threads() -> int:
    """The pool's actual width (creates the pool)."""
    return lib().pbft_verify_threads()


def verify_pool_stats() -> dict:
    """Lifetime pool counters: threads, batches, windows, items, busy and
    wall seconds, utilization, last queue depth and window items."""
    buf = ctypes.create_string_buffer(512)
    n = lib().pbft_verify_pool_stats_json(buf, len(buf))
    return json.loads(buf.raw[:n].decode())


def host_batch_verify(items: Sequence[Tuple[bytes, bytes, bytes]]) -> List[bool]:
    """The host's batch verifier: the native pool when the library is
    loaded, else the RFC 8032 oracle item by item (identical accept sets on
    honest traffic). The daemon serves warm-time traffic with it, and the
    replica client verifies a batch with it when the service is warming,
    unreachable or dies mid-stream, so a cold card never blocks consensus.
    It never waits on a build that another thread runs (the oracle answers
    meanwhile); ``host_verifier()`` says which one answers."""
    try:
        so = _get(blocking=False)
    except (OSError, RuntimeError, AttributeError):
        so = None
    if so is not None:
        return _verify_on(so, items)
    from .crypto import ref

    return [ref.verify(p, m, s) for p, m, s in items]


def _check_len(what: str, data: bytes, n: int) -> None:
    if len(data) != n:
        raise ValueError(f"{what} is {n} bytes, not {len(data)}")


def blake2b(data: bytes, digest_size: int = 32) -> bytes:
    """BLAKE2b of ``data`` (``hashlib.blake2b``'s bytes), 1-64 bytes out."""
    if not 1 <= digest_size <= 64:
        raise ValueError(f"a BLAKE2b digest is 1-64 bytes, not {digest_size}")
    out = ctypes.create_string_buffer(digest_size)
    lib().pbft_blake2b(out, digest_size, data, len(data))
    return out.raw


def blake2b_keyed(key: bytes, data: bytes, digest_size: int = 32) -> bytes:
    """Keyed BLAKE2b (a key of up to 64 bytes), as ``hashlib.blake2b(key=)``."""
    if not 1 <= digest_size <= 64 or len(key) > 64:
        raise ValueError(f"BLAKE2b takes a key of up to 64 bytes and 1-64 bytes out, not {len(key)}, {digest_size}")
    out = ctypes.create_string_buffer(digest_size)
    lib().pbft_blake2b_keyed(out, digest_size, key, len(key), data, len(data))
    return out.raw


def sha512(data: bytes) -> bytes:
    """SHA-512 of ``data`` (``hashlib.sha512``'s bytes)."""
    out = ctypes.create_string_buffer(64)
    lib().pbft_sha512(out, data, len(data))
    return out.raw


def dh_public(secret: bytes) -> bytes:
    """The secure channel's Diffie-Hellman public value (on the Ed25519
    curve) of a 32-byte secret."""
    _check_len("a DH secret", secret, 32)
    out = ctypes.create_string_buffer(32)
    lib().pbft_dh_public(out, secret)
    return out.raw


def dh_shared(secret: bytes, peer_pub: bytes) -> Optional[bytes]:
    """The shared secret with a peer's public value; None when the peer's
    value is rejected (not a point, or of small order)."""
    _check_len("a DH secret", secret, 32)
    _check_len("a DH public value", peer_pub, 32)
    out = ctypes.create_string_buffer(32)
    ok = lib().pbft_dh_shared(out, secret, peer_pub)
    return out.raw if ok else None


def aead_seal(key: bytes, ctr: int, plaintext: bytes) -> bytes:
    """The secure channel's frame seal under a 64-byte key and counter:
    the ciphertext and a 16-byte tag."""
    _check_len("an AEAD key", key, 64)
    out = ctypes.create_string_buffer(len(plaintext) + 16)
    lib().pbft_aead_seal(key, ctr, plaintext, len(plaintext), out)
    return out.raw


def aead_open(key: bytes, ctr: int, sealed: bytes) -> Optional[bytes]:
    """The plaintext of a sealed frame; None when its tag does not check."""
    _check_len("an AEAD key", key, 64)
    out = ctypes.create_string_buffer(max(len(sealed), 1))
    n = lib().pbft_aead_open(key, ctr, sealed, len(sealed), out)
    return out.raw[:n] if n >= 0 else None


def force_entropy_exhaustion(on: bool) -> None:
    """TEST hook: simulate entropy exhaustion, so that the pool's random
    linear combination is off and its windows verify item by item."""
    lib().pbft_test_force_entropy_exhaustion(1 if on else 0)


def pubkey_cache_clear() -> None:
    """Drop every entry of the core's decompressed-key cache."""
    lib().pbft_pubkey_cache_clear()


def pubkey_cache_disable(on: bool) -> None:
    """TEST hook: take the cold (uncached) key-decompression path, so that
    a test can compare warm and cold verdicts."""
    lib().pbft_test_pubkey_cache_disable(1 if on else 0)


def flight_configure(capacity: int) -> None:
    """(Re)size and enable the core's black-box flight recorder ring
    (``core/flight.cc``); capacity 0 disables it."""
    lib().pbft_flight_configure(capacity)


def flight_record(ev: int, view: int = 0, seq: int = 0, peer: int = -1) -> None:
    """Record one event (an id of ``utils.trace_schema.FLIGHT_EVENTS``) in
    the core's ring; one branch while the recorder is disabled."""
    lib().pbft_flight_record(ev, view, seq, peer)


def flight_total() -> int:
    """Records the core's ring ever accepted (not clamped to its capacity)."""
    return int(lib().pbft_flight_total())


def flight_dump(path: str) -> int:
    """Write the core's ring as a binary dump; returns the record count, or
    -1 on failure. Decode with ``utils.flight.decode_file`` or
    ``python -m pbft_tpu_torch.scripts.flight_dump``."""
    return int(lib().pbft_flight_dump(str(path).encode()))


def flight_reset() -> None:
    """Empty the core's ring."""
    lib().pbft_flight_reset()


def message_to_binary(payload: bytes) -> Optional[bytes]:
    """A JSON message payload parsed by the core and encoded with its
    binary-v2 codec; None when the type has no binary form. Byte for byte
    ``consensus.messages.to_binary`` of the same message."""
    out = ctypes.create_string_buffer(len(payload) + 256)
    n = lib().pbft_message_to_binary(payload, len(payload), out, len(out))
    if n == 0 or n > len(out):
        return None
    return out.raw[:n]


def message_from_binary(payload: bytes) -> Optional[Tuple[bytes, bytes]]:
    """A binary-v2 payload decoded by the core: (canonical JSON bytes,
    signable digest), or None when it does not decode."""
    out = ctypes.create_string_buffer(4 * len(payload) + 1024)
    digest = ctypes.create_string_buffer(32)
    n = lib().pbft_message_from_binary(payload, len(payload), out, len(out), digest)
    if n == 0 or n > len(out):
        return None
    return out.raw[:n], digest.raw


def signable_from_payload(payload: bytes) -> Optional[bytes]:
    """The core's receive-side signable digest of a framed payload (JSON
    signature splice or binary template, else the generic path); None when
    the payload does not parse."""
    digest = ctypes.create_string_buffer(32)
    if not lib().pbft_signable_from_payload(payload, len(payload), digest):
        return None
    return digest.raw


def message_to_binary_mac(payload: bytes, lanes) -> Optional[bytes]:
    """A JSON message payload as the core's MAC-vector frame; ``lanes`` is
    a sequence of (replica id, 16-byte tag). None when the type has no MAC
    form."""
    for _, tag in lanes:
        _check_len("a MAC lane's tag", bytes(tag), 16)
    blob = b"".join(rid.to_bytes(1, "big") + bytes(tag) for rid, tag in lanes)
    out = ctypes.create_string_buffer(len(payload) + len(blob) + 256)
    n = lib().pbft_message_to_binary_mac(payload, len(payload), blob, len(lanes), out, len(out))
    if n == 0 or n > len(out):
        return None
    return out.raw[:n]


def mac_frame_lane(payload: bytes, rid: int) -> Optional[bytes]:
    """Replica ``rid``'s 16-byte tag in a MAC frame, or None when absent."""
    tag = ctypes.create_string_buffer(16)
    if not lib().pbft_mac_frame_lane(payload, len(payload), rid, tag):
        return None
    return tag.raw


def mac_tag(key: bytes, signable: bytes) -> bytes:
    """The core's authenticator-lane tag of a 32-byte signable under a
    32-byte link key (``net/secure.py`` ``mac_tag``)."""
    _check_len("a MAC key", key, 32)
    _check_len("a signable digest", signable, 32)
    tag = ctypes.create_string_buffer(16)
    lib().pbft_mac_tag(key, signable, tag)
    return tag.raw
