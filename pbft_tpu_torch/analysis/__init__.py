"""Static-analysis passes over both runtimes: the port's copy of
``pbft_tpu/analysis/``, pointed at the port.

The C++ core (``core/``) and the port's asyncio runtime
(``pbft_tpu_torch/``) are two implementations of one protocol, held
together by hand-mirrored constants and a shared metrics/trace manifest.
The passes read the port's files where the reference reads ``pbft_tpu/``,
and ``core/`` as the reference does:

    constants       cross-runtime constant conformance (wire magic,
                    message tags, protocol versions, config defaults,
                    RLC window, pad ladder, status handshake)
    async-blocking  no blocking calls inside ``async def`` in
                    pbft_tpu_torch/net
    metrics         every metric/trace emitter matches the manifest
                    (pbft_tpu_torch/utils/trace_schema.py)
    sockets         TCP_NODELAY / SO_REUSEADDR at every stream-socket
                    creation site in core/ and pbft_tpu_torch/net

Entry point: ``python -m pbft_tpu_torch.scripts.pbft_lint`` (wired into
tier 1 by tests/test_torch_lint.py). Every pass takes a ``root`` so the
tests can run them against shadow trees with deliberate violations.
"""

from __future__ import annotations

import pathlib
from typing import Callable, Dict, List

from . import async_blocking, constants, metrics_lint, sockets

REPO = pathlib.Path(__file__).resolve().parent.parent.parent

PASSES: Dict[str, Callable[[pathlib.Path], List[str]]] = {
    "constants": constants.check,
    "async-blocking": async_blocking.check,
    "metrics": metrics_lint.check,
    "sockets": sockets.check,
}


def run_all(root: pathlib.Path = REPO, passes=None) -> Dict[str, List[str]]:
    """pass name -> error list (empty = clean). Unknown names raise."""
    selected = list(PASSES) if passes is None else list(passes)
    unknown = [p for p in selected if p not in PASSES]
    if unknown:
        raise ValueError(f"unknown passes {unknown}; have {sorted(PASSES)}")
    return {name: PASSES[name](root) for name in selected}


def scanned_files(root: pathlib.Path = REPO) -> List[pathlib.Path]:
    """Every file any pass reads, absolute, deduplicated — the set a
    shadow tree (tests/test_torch_lint.py) must copy for all passes to
    run."""
    paths = [root / rel for rel in constants.files_scanned()]
    paths += async_blocking.files_scanned(root)
    paths += metrics_lint.files_scanned(root)
    paths += sockets.files_scanned(root)
    out, seen = [], set()
    for p in paths:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


def files_per_pass(root: pathlib.Path = REPO) -> Dict[str, int]:
    """pass name -> the number of files it reads (for reports)."""
    return {
        "constants": len(constants.files_scanned()),
        "async-blocking": len(async_blocking.files_scanned(root)),
        "metrics": len(metrics_lint.files_scanned(root)),
        "sockets": len(sockets.files_scanned(root)),
    }
