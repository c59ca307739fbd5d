"""Structured JSONL tracing (the port's copy of ``pbft_tpu/utils/trace.py``,
used by the verify service's ``--trace``).

Events are single JSON lines: {"ts": <monotonic>, "ev": <name>, ...fields}.
Disabled (no-op, one attribute check) unless a sink is set — tracing must
never tax the batching hot loop the way the reference's println!-in-poll
did (reference src/handler.rs:265,:269; SURVEY.md §5).
"""

from __future__ import annotations

import json
import threading
import time
from typing import IO, Optional


class Tracer:
    def __init__(self, sink: Optional[IO[str]] = None):
        self.sink = sink
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.sink is not None

    def event(self, ev: str, **fields) -> None:
        if self.sink is None:
            return
        rec = {"ts": round(time.monotonic(), 6), "ev": ev}
        rec.update(fields)
        # default=str: a non-JSON-serializable field value (a stray bytes
        # digest, an enum, a numpy scalar) degrades to its str() form
        # instead of throwing in the batching hot loop.
        line = json.dumps(rec, separators=(",", ":"), default=str) + "\n"
        with self._lock:
            self.sink.write(line)
            self.sink.flush()


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def set_trace_file(path: Optional[str]) -> Tracer:
    """Route global tracing to a JSONL file (None disables); closes any
    previously set sink. Raises OSError if the file cannot be opened."""
    global _tracer
    old_sink = _tracer.sink
    _tracer = Tracer(open(path, "a") if path else None)
    if old_sink is not None:
        old_sink.close()
    return _tracer
