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
inline verifier (``consensus/replica.py``).

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
