"""Per-replica write-ahead log: durable safety state for crash-restart
(PBFT §4.3's stable-storage message log, and the
restart-from-disk recovery of Castro & Liskov's TOCS 2002 paper).

Every recovery story before this assumed a crashed replica came back
with FRESH state and caught up via §5.3 state transfer — which means a
restarted replica has forgotten its PREPARE/COMMIT votes and can, in
principle, vote twice for one (view, seq): the amnesia violation the
stable-storage log exists to prevent. This module persists exactly the
state whose loss breaks safety:

- the current view (and whether a view change was pending at the crash);
- every vote this replica SENT — pre-prepare (primary seal), prepare,
  commit — as (kind, view, seq) -> digest. Digest only: the message
  bodies are recoverable from any peer; what must survive is what WE
  claimed, so the restarted replica can refuse to contradict it;
- the latest stable checkpoint: its canonical payload (which embeds the
  app snapshot AND the per-client exactly-once reply cache) plus the
  2f+1 checkpoint certificate, so recovery reinstalls a proven state
  and the next VIEW-CHANGE can still prove its watermark.

Durability rides the runtimes' existing batching seams (group commit):
``note_*`` appends records to an in-memory buffer and updates the live
mirror; the runtime calls :meth:`WriteAheadLog.flush` once per emit
boundary — BEFORE any of that pass's votes reach a socket — so one
fsync covers a whole verify batch's worth of votes instead of one per
message. ``fsync=False`` (network.json ``wal_fsync``) keeps the write
but skips the fsync: kill -9 of the process stays safe (the page cache
survives), only a whole-host power loss can lose the tail.

The on-disk format is byte-identical to core/wal.{h,cc}:

    header  WAL_MAGIC (8B) + u32le version
    record  u8 tag + u32le payload length + payload
      view        (0x01)  i64le view + u8 in_view_change + i64le pending
      vote        (0x02)  u8 kind + i64le view + i64le seq + 32B digest
      checkpoint  (0x03)  i64le seq + u32le len + payload
                          + u32le len + certificate JSON

Only the tail record can ever be torn (append-only writes): replay
stops at the first truncated record. On open — and on every stable
checkpoint — the log COMPACTS: a fresh file holding the view record,
the latest checkpoint, and the votes above its sequence is written to
``<path>.tmp``, fsynced, and renamed over the old log, so the file is
bounded by the watermark window instead of growing forever.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

WAL_MAGIC = b"PBFTWAL1"
WAL_VERSION = 1
# Record tags (cross-runtime contract with core/wal.h; constants lint).
WAL_REC_VIEW = 0x01
WAL_REC_VOTE = 0x02
WAL_REC_CHECKPOINT = 0x03
# Vote kinds inside a WAL_REC_VOTE record.
WAL_VOTE_PRE_PREPARE = 1
WAL_VOTE_PREPARE = 2
WAL_VOTE_COMMIT = 3

_HEADER = struct.Struct("<8sI")
_REC_HDR = struct.Struct("<BI")
_VIEW = struct.Struct("<qBq")
_VOTE = struct.Struct("<Bqq32s")
_CP_SEQ = struct.Struct("<q")
_U32 = struct.Struct("<I")


@dataclasses.dataclass
class WalState:
    """What a replay recovered: the state a restarted replica reinstalls."""

    view: int = 0
    in_view_change: bool = False
    pending_view: int = 0
    # (kind, view, seq) -> digest hex — the votes this replica sent.
    votes: Dict[Tuple[int, int, int], str] = dataclasses.field(
        default_factory=dict
    )
    # (seq, canonical payload, certificate JSON) of the stable checkpoint.
    checkpoint: Optional[Tuple[int, str, str]] = None

    def empty(self) -> bool:
        return (
            self.view == 0
            and not self.in_view_change
            and not self.votes
            and self.checkpoint is None
        )

    def max_pre_prepare_seq(self) -> int:
        """Highest sequence this replica (as primary) ever pre-prepared —
        a recovered primary must never re-assign one of these."""
        return max(
            (seq for (kind, _v, seq) in self.votes
             if kind == WAL_VOTE_PRE_PREPARE),
            default=0,
        )


def _encode_view(view: int, ivc: bool, pending: int) -> bytes:
    payload = _VIEW.pack(view, 1 if ivc else 0, pending)
    return _REC_HDR.pack(WAL_REC_VIEW, len(payload)) + payload


def _encode_vote(kind: int, view: int, seq: int, digest_hex: str) -> bytes:
    payload = _VOTE.pack(kind, view, seq, bytes.fromhex(digest_hex))
    return _REC_HDR.pack(WAL_REC_VOTE, len(payload)) + payload


def _encode_checkpoint(seq: int, payload: str, cert_json: str) -> bytes:
    p = payload.encode()
    c = cert_json.encode()
    body = _CP_SEQ.pack(seq) + _U32.pack(len(p)) + p + _U32.pack(len(c)) + c
    return _REC_HDR.pack(WAL_REC_CHECKPOINT, len(body)) + body


def decode_bytes(data: bytes) -> WalState:
    """Replay a log image into a WalState. Tolerates a torn tail record
    (the only kind a kill -9 mid-append can produce); raises ValueError
    on a wrong magic or version (that is corruption, not a torn tail)."""
    state = WalState()
    if len(data) < _HEADER.size:
        return state  # fresh/empty (or torn before the header completed)
    magic, version = _HEADER.unpack_from(data, 0)
    if magic != WAL_MAGIC:
        raise ValueError(f"not a pbft WAL (magic {magic!r})")
    if version != WAL_VERSION:
        raise ValueError(f"unknown WAL version {version}")
    off = _HEADER.size
    while off + _REC_HDR.size <= len(data):
        tag, n = _REC_HDR.unpack_from(data, off)
        off += _REC_HDR.size
        if off + n > len(data):
            break  # torn tail: the record never finished writing
        payload = data[off : off + n]
        off += n
        if tag == WAL_REC_VIEW and n == _VIEW.size:
            view, ivc, pending = _VIEW.unpack(payload)
            state.view = view
            state.in_view_change = bool(ivc)
            state.pending_view = pending
        elif tag == WAL_REC_VOTE and n == _VOTE.size:
            kind, view, seq, digest = _VOTE.unpack(payload)
            state.votes[(kind, view, seq)] = digest.hex()
        elif tag == WAL_REC_CHECKPOINT and n >= _CP_SEQ.size + 2 * _U32.size:
            (seq,) = _CP_SEQ.unpack_from(payload, 0)
            p = _CP_SEQ.size
            (plen,) = _U32.unpack_from(payload, p)
            p += _U32.size
            if p + plen + _U32.size > n:
                continue  # malformed: skip, keep replaying
            cp_payload = payload[p : p + plen]
            p += plen
            (clen,) = _U32.unpack_from(payload, p)
            p += _U32.size
            if p + clen > n:
                continue
            cert = payload[p : p + clen]
            state.checkpoint = (seq, cp_payload.decode(), cert.decode())
            # Votes at or below a stable checkpoint are beneath the
            # watermark: they can never be re-sent, so they no longer
            # constrain anything.
            for key in [k for k in state.votes if k[2] <= seq]:
                del state.votes[key]
        # Unknown tags / wrong-size payloads are skipped: forward compat.
    return state


def replay(path: str) -> WalState:
    """Replay the log at ``path`` (missing file == empty state)."""
    try:
        with open(path, "rb") as fh:
            return decode_bytes(fh.read())
    except FileNotFoundError:
        return WalState()


class WriteAheadLog:
    """The append-side of the log, plus the live mirror the replica's
    no-contradiction guards consult.

    ``path=None`` is the SIMULATOR mode: no file I/O at all — the object
    itself plays the disk (it survives the simulated crash while the
    Replica object is discarded), which is exactly the durability model
    the chaos soak's crash-restart schedules need.
    """

    def __init__(self, path: Optional[str] = None, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self.appends = 0  # records appended (pbft_wal_appends_total)
        self.fsyncs = 0  # fsync syscalls issued (pbft_wal_fsyncs_total)
        self.bytes_written = 0  # file bytes written (pbft_wal_bytes_total)
        self._pending: List[bytes] = []
        self._compact_due = False
        # Live mirror (the guards' source of truth) + the frozen replay
        # snapshot recovery installs.
        self.state = replay(path) if path else WalState()
        self.recovered = dataclasses.replace(
            self.state, votes=dict(self.state.votes)
        )
        if path:
            # Recovery compaction: start the new life from a bounded,
            # cleanly-terminated log (also heals any torn tail record).
            self._compact()

    # -- the replica-facing surface ------------------------------------------

    def vote_digest(self, kind: int, view: int, seq: int) -> Optional[str]:
        return self.state.votes.get((kind, view, seq))

    def note_vote(self, kind: int, view: int, seq: int, digest_hex: str) -> bool:
        """Record a vote about to be sent. Returns False — and records
        NOTHING — when a durable vote for the same (kind, view, seq)
        names a DIFFERENT digest: the caller must not send (sending
        would be the equivocation the log exists to prevent). A repeat
        of an identical vote returns True without growing the log."""
        key = (kind, view, seq)
        held = self.state.votes.get(key)
        if held is not None:
            return held == digest_hex
        self.state.votes[key] = digest_hex
        self._pending.append(_encode_vote(kind, view, seq, digest_hex))
        self.appends += 1
        return True

    def note_view(self, view: int, in_view_change: bool, pending: int) -> None:
        st = self.state
        if (st.view, st.in_view_change, st.pending_view) == (
            view, in_view_change, pending
        ):
            return
        st.view = view
        st.in_view_change = in_view_change
        st.pending_view = pending
        self._pending.append(_encode_view(view, in_view_change, pending))
        self.appends += 1

    def note_checkpoint(self, seq: int, payload: str, cert) -> None:
        """A 2f+1-certified stable checkpoint: the durable restart point.
        ``cert`` is the certificate (a list of checkpoint dicts, or its
        canonical JSON). Prunes votes at or below ``seq`` and schedules a
        compaction for the next flush."""
        cur = self.state.checkpoint
        if cur is not None and cur[0] >= seq:
            return
        cert_json = (
            cert if isinstance(cert, str)
            else json.dumps(cert, sort_keys=True, separators=(",", ":"))
        )
        self.state.checkpoint = (seq, payload, cert_json)
        for key in [k for k in self.state.votes if k[2] <= seq]:
            del self.state.votes[key]
        self._pending.append(_encode_checkpoint(seq, payload, cert_json))
        self.appends += 1
        self._compact_due = True

    def pending(self) -> int:
        return len(self._pending)

    # -- the group-commit point ----------------------------------------------

    def flush(self) -> None:
        """THE durability point (group commit): called by the runtime at
        the emit boundary, before any of this pass's votes reach a
        socket. One write + one fsync per call, however many records
        accumulated; a due compaction replaces the append entirely."""
        if not self._pending and not self._compact_due:
            return
        if self.path is None:  # simulator mode: the object IS the disk
            self._pending.clear()
            self._compact_due = False
            return
        if self._compact_due:
            self._compact()
            return
        data = b"".join(self._pending)
        self._pending.clear()
        fd = os.open(self.path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, data)
            self.bytes_written += len(data)
            if self.fsync:
                os.fsync(fd)
                self.fsyncs += 1
        finally:
            os.close(fd)

    def _compact(self) -> None:
        """Rewrite the log as header + view + checkpoint + live votes
        (tmp, fsync, rename, fsync dir) — bounded by the watermark
        window, and always cleanly terminated."""
        self._pending.clear()
        self._compact_due = False
        if self.path is None:
            return
        st = self.state
        out = [_HEADER.pack(WAL_MAGIC, WAL_VERSION)]
        out.append(_encode_view(st.view, st.in_view_change, st.pending_view))
        if st.checkpoint is not None:
            out.append(_encode_checkpoint(*st.checkpoint))
        for (kind, view, seq) in sorted(st.votes, key=lambda k: (k[1], k[2], k[0])):
            out.append(_encode_vote(kind, view, seq, st.votes[(kind, view, seq)]))
        data = b"".join(out)
        tmp = self.path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.write(fd, data)
            self.bytes_written += len(data)
            if self.fsync:
                os.fsync(fd)
                self.fsyncs += 1
        finally:
            os.close(fd)
        os.replace(tmp, self.path)
        if self.fsync:
            # The rename must be durable too, or a crash resurrects the
            # pre-compaction file without the records appended since.
            dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
                self.fsyncs += 1
            finally:
                os.close(dfd)
