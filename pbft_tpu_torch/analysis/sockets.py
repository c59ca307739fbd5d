"""Socket-option conformance lint: the port's copy of
``pbft_tpu/analysis/sockets.py``, over ``core/`` and
``pbft_tpu_torch/net/``.

Every TCP stream socket in BOTH runtimes must be tuned at creation:
``TCP_NODELAY`` on data sockets (one Nagle stall on a 100-byte consensus
frame dwarfs a whole round) and ``SO_REUSEADDR`` on listeners (restart
races). This pass keeps a NEW dial or accept site from silently
regressing latency:

- C++ (core library sources, test programs excluded): every
  ``socket(AF_INET, SOCK_STREAM...)`` creation and every ``accept(``
  call must be followed, within a few lines, by a call to
  ``tune_stream_socket`` / ``tune_listen_socket`` (core/net.h) — the two
  canonical spellings of the options. AF_UNIX and SOCK_DGRAM sockets are
  exempt (no Nagle / not streams).
- Python (pbft_tpu_torch/net): every ``socket.create_connection(`` and every
  ``socket.socket(..., SOCK_STREAM)`` must be followed, within a few
  lines, by a ``TCP_NODELAY`` setsockopt (asyncio transports set it
  automatically since 3.6, so only raw-socket sites are scanned).
  ``socketserver`` handlers spell it ``disable_nagle_algorithm = True``
  or set the option in ``setup`` — both count, same window.

Like every pass here, reads relative to ``root`` so
tests/test_torch_lint.py can run it against a shadow tree with a deliberately untuned site.
"""

from __future__ import annotations

import pathlib
import re
from typing import List

REPO = pathlib.Path(__file__).resolve().parent.parent.parent

# Library sources only: the test programs (core_test.cc, race_stress.cc)
# open throwaway loopback sockets where a missed option costs nothing.
CXX_FILES = [
    "core/net.cc",
    "core/verifier.cc",
    "core/secure.cc",
    "core/pbftd.cc",
    "core/discovery.cc",
]
PY_GLOB = "pbft_tpu_torch/net/*.py"

# How many lines after the creation site the tuning call must appear in.
WINDOW = 8

_CXX_STREAM_SOCKET = re.compile(r"socket\s*\(\s*AF_INET\s*,\s*SOCK_STREAM")
_CXX_ACCEPT = re.compile(r"=\s*(?:::)?accept\s*\(")
_CXX_TUNE = re.compile(r"tune_(?:stream|listen)_socket\s*\(")

_PY_DIAL = re.compile(r"socket\.create_connection\s*\(")
_PY_STREAM_SOCKET = re.compile(r"socket\.socket\s*\([^)\n]*SOCK_STREAM")
_PY_TUNE = re.compile(r"TCP_NODELAY|disable_nagle_algorithm\s*=\s*True")


def _window_ok(lines: List[str], i: int, tune: re.Pattern) -> bool:
    return any(tune.search(line) for line in lines[i : i + WINDOW + 1])


def files_scanned(root: pathlib.Path = REPO) -> List[pathlib.Path]:
    out = [root / p for p in CXX_FILES]
    out += sorted(root.glob(PY_GLOB))
    return [p for p in out if p.exists()]


def check(root: pathlib.Path = REPO) -> List[str]:
    errors: List[str] = []
    for rel in CXX_FILES:
        path = root / rel
        if not path.exists():
            continue
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            site = None
            if _CXX_STREAM_SOCKET.search(line):
                site = "stream socket()"
            elif _CXX_ACCEPT.search(line) and "AF_UNIX" not in line:
                site = "accept()"
            if site and not _window_ok(lines, i, _CXX_TUNE):
                errors.append(
                    f"{rel}:{i + 1}: {site} without "
                    f"tune_stream_socket/tune_listen_socket within "
                    f"{WINDOW} lines (socket discipline)"
                )
    for path in sorted(root.glob(PY_GLOB)):
        rel = path.relative_to(root)
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            site = None
            if _PY_DIAL.search(line):
                site = "socket.create_connection"
            elif _PY_STREAM_SOCKET.search(line) and "AF_UNIX" not in line:
                site = "stream socket.socket"
            if site and not _window_ok(lines, i, _PY_TUNE):
                errors.append(
                    f"{rel}:{i + 1}: {site} without TCP_NODELAY within "
                    f"{WINDOW} lines (socket discipline)"
                )
    return errors
