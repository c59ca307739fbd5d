"""Black-box flight recorder — the Python mirror of core/flight.{h,cc}
(the port's copy of ``pbft_tpu/utils/flight.py``).

A bounded ring of the last N protocol events (request_rx, batch_sealed,
phase transitions, reply_tx, view-change spans), kept in memory for the
process's whole life and dumped to a compact binary file on
SIGTERM/fatal/invariant-failure. Unlike the JSONL tracer — which only
helps for replicas that lived long enough to flush — the black box is
what a chaos soak or sanitizer kill recovers from the dead process.

Record path discipline matches the Tracer/metrics rule: one attribute
check when disabled, no locks (deque.append is atomic under the GIL; a
concurrent dump may miss the newest record, never corrupt one).

The on-disk format (trace_schema.FLIGHT_MAGIC/FLIGHT_EVENTS) is shared
byte-for-byte with the C++ recorder and the JAX package's;
scripts/flight_dump.py decodes all three.
"""

from __future__ import annotations

import os
import signal
import struct
import time
from collections import deque
from typing import Dict, List, Optional

from . import trace_schema

_HEADER = struct.Struct("<8sII")  # magic, version, record count
_RECORD = struct.Struct("<QHhii")  # t_ns, event id, peer, view, seq
assert _RECORD.size == trace_schema.FLIGHT_RECORD_SIZE

# The consensus-phase hook's names, mapped onto flight event ids: the
# primary's "request" transition (sequence assignment) IS the batch seal.
_PHASE_EVENTS = {
    "request": "batch_sealed",
    "pre_prepare": "pre_prepare",
    "prepared": "prepared",
    "committed": "committed",
    "executed": "executed",
}


def _i32(v: int) -> int:
    v = int(v) & 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def _i16(v: int) -> int:
    v = int(v) & 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


class FlightRecorder:
    """Fixed-capacity ring of (t_ns, event, peer, view, seq) records."""

    __slots__ = ("enabled", "capacity", "_ring")

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.capacity = capacity
        self.enabled = enabled
        self._ring: deque = deque(maxlen=capacity)

    def record(
        self,
        ev,
        view: int = 0,
        seq: int = 0,
        peer: int = -1,
        t_ns: Optional[int] = None,
    ) -> None:
        if not self.enabled:
            return
        if isinstance(ev, str):
            ev = trace_schema.FLIGHT_EVENT_IDS.get(ev, 0)
        self._ring.append(
            (
                time.monotonic_ns() if t_ns is None else int(t_ns),
                int(ev) & 0xFFFF,
                _i16(peer),
                _i32(view),
                _i32(seq),
            )
        )

    def record_phase(self, phase: str, view: int, seq: int) -> None:
        """Replica.phase_hook adapter (phase, view, seq)."""
        if not self.enabled:
            return
        name = _PHASE_EVENTS.get(phase)
        if name is not None:
            self.record(name, view=view, seq=seq)

    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self) -> List[tuple]:
        return list(self._ring)

    def encode(self) -> bytes:
        recs = self.snapshot()
        out = [
            _HEADER.pack(
                trace_schema.FLIGHT_MAGIC, trace_schema.FLIGHT_VERSION, len(recs)
            )
        ]
        out.extend(_RECORD.pack(*r) for r in recs)
        return b"".join(out)

    def dump(self, path: str) -> int:
        """Write the binary dump; returns the record count."""
        data = self.encode()
        with open(path, "wb") as fh:
            fh.write(data)
        return (len(data) - _HEADER.size) // _RECORD.size


def encode_records(records) -> bytes:
    """Re-encode decoded records (t_ns, ev, peer, view, seq) — the
    byte-exact round-trip check the overhead-guard test pins."""
    out = [
        _HEADER.pack(
            trace_schema.FLIGHT_MAGIC, trace_schema.FLIGHT_VERSION, len(records)
        )
    ]
    out.extend(_RECORD.pack(*r) for r in records)
    return b"".join(out)


def decode_bytes(data: bytes) -> List[Dict]:
    """Decode a dump into [{t_ns, ev, event, peer, view, seq}, ...].
    Raises ValueError on a bad magic/version or truncated record."""
    if len(data) < _HEADER.size:
        raise ValueError("flight dump truncated before header")
    magic, version, count = _HEADER.unpack_from(data, 0)
    if magic != trace_schema.FLIGHT_MAGIC:
        raise ValueError(f"not a flight dump (magic {magic!r})")
    if version != trace_schema.FLIGHT_VERSION:
        raise ValueError(f"unknown flight dump version {version}")
    need = _HEADER.size + count * _RECORD.size
    if len(data) < need:
        raise ValueError(
            f"flight dump truncated: header claims {count} records, "
            f"{(len(data) - _HEADER.size) // _RECORD.size} present"
        )
    out = []
    off = _HEADER.size
    for _ in range(count):
        t_ns, ev, peer, view, seq = _RECORD.unpack_from(data, off)
        off += _RECORD.size
        out.append(
            {
                "t_ns": t_ns,
                "ev": ev,
                "event": trace_schema.FLIGHT_EVENTS.get(ev, f"unknown-{ev}"),
                "peer": peer,
                "view": view,
                "seq": seq,
            }
        )
    return out


def decode_file(path: str) -> List[Dict]:
    with open(path, "rb") as fh:
        return decode_bytes(fh.read())


def install_signal_dump(recorder: FlightRecorder, path: str) -> None:
    """Dump the black box when the process is terminated (SIGTERM/SIGINT)
    — the flight-data-recorder contract: a replica killed mid-soak still
    ships its last N protocol events. The handler exits with the
    conventional 128+signum status after writing the dump."""

    def _handler(signum, frame):  # noqa: ARG001 - signal contract
        try:
            recorder.dump(path)
        finally:
            os._exit(128 + signum)

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)
