"""The PBFT replica: a deterministic, I/O-free state machine.

Mirrors the capability surface of the reference's consensus behaviour
(reference src/behavior.rs) with the paper-mandated pieces the reference left
as TODOs filled in:

- real quorums: prepared = pre-prepare + 2f matching PREPAREs; committed-local
  = prepared + 2f+1 COMMITs (reference stubs at src/behavior.rs:181,:208,:222);
- signature verification on every replica message, *batched*: the replica
  never verifies inline — it exposes `pending_items()` as (pubkey, digest,
  sig) triples and resumes in `deliver_verdicts(...)`, so the transport layer
  can gate whole batches through the card's verifier in one window;
- watermarks (h, H] + checkpoint protocol for log truncation (TODOs at
  reference src/behavior.rs:154,:192);
- in-order execution with per-client exactly-once timestamps and cached
  replies (reference discards duplicates, src/behavior.rs:391-398; the paper
  resends the cached reply — we do both correctly);
- backup -> primary request forwarding (TODO at reference
  src/client_handler.rs:66-68).

The state machine never touches sockets, clocks, or threads: inputs arrive by
method call, outputs are returned as Action values (SURVEY.md §4 item 1 —
this is what made the reference untestable, its validation was welded to the
libp2p behaviour).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..crypto import ref as crypto
from .config import ClusterConfig
from .wal import (
    WAL_VOTE_COMMIT,
    WAL_VOTE_PRE_PREPARE,
    WAL_VOTE_PREPARE,
    WalState,
)
from .messages import (
    NULL_CLIENT,
    Checkpoint,
    ClientReply,
    ClientRequest,
    Commit,
    Message,
    NewView,
    Prepare,
    PrePrepare,
    StateRequest,
    StateResponse,
    ViewChange,
    _canonical_json,
    batch_digest,
    blake2b_256,
    with_sig,
)


@dataclasses.dataclass(frozen=True)
class Send:
    dest: int
    msg: Message


@dataclasses.dataclass(frozen=True)
class Broadcast:
    msg: Message


@dataclasses.dataclass(frozen=True)
class Reply:
    client: str
    msg: ClientReply


Action = object  # Send | Broadcast | Reply

# Forwarded-request retention bound (mirrors core/replica.h
# kMaxForwardedRetained; constants lint): a backup remembers the last
# request it forwarded per client so a view change can RE-AIM it at the
# new primary — without this, a request forwarded to a primary that then
# gets voted out evaporates with the old view, and the only recovery is
# the client's (slow) retransmission timer, during which the request
# timers keep escalating view changes with nothing to order. On overflow
# the map clears: retransmission covers the forgotten entries.
MAX_FORWARDED_RETAINED = 1024


_HOST_SIGNER = None


def _host_sign(seed: bytes, msg: bytes) -> bytes:
    """Host-side message signing: the native C++ signer when the core
    builds and loads (~40-55 us), else the pure-Python oracle (~4 ms). The
    two are byte-identical (RFC 8032 signatures are deterministic), so the
    choice cannot diverge replicas."""
    global _HOST_SIGNER
    if _HOST_SIGNER is None:
        from .. import native

        _HOST_SIGNER = native.sign if native.available() else crypto.sign
    return _HOST_SIGNER(seed, msg)


_HOST_VERIFIER = None


def _host_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Host-side inline verification (view-change evidence): the native
    C++ verifier when the core builds and loads, else the pure-Python
    oracle; identical accept sets, so the choice cannot diverge replicas.
    Matters under chaos: a view-change storm verifies hundreds of nested
    certificate signatures inline, and the ~4 ms Python oracle turns each
    storm into seconds. (The host's batch verifier, the safety net of a
    replica on a verify service, is ``native.host_batch_verify``.)"""
    global _HOST_VERIFIER
    if _HOST_VERIFIER is None:
        from .. import native

        _HOST_VERIFIER = native.verify if native.available() else crypto.verify
    return _HOST_VERIFIER(pub, msg, sig)


def _strip_tentative(d: dict) -> dict:
    d.pop("tentative", None)
    return d


def default_app(operation: str, seq: int) -> str:
    """The reference's execution is a no-op with a hardcoded result
    (reference src/message.rs:70); kept as the default app."""
    return "awesome!"


# Apps may optionally be *stateful*: any callable with ``snapshot() -> str``
# and ``restore(s: str) -> None`` attributes participates in state transfer
# (PBFT §5.3) — its snapshot is embedded in the checkpoint payload that the
# 2f+1-certified checkpoint digest commits to. A bare callable (like
# default_app) is treated as stateless (empty snapshot).


class Replica:
    def __init__(
        self,
        config: ClusterConfig,
        replica_id: int,
        seed: bytes,
        app: Callable[[str, int], str] = default_app,
    ):
        self.config = config
        self.id = replica_id
        self._seed = seed
        self._app = app
        self.view = 0
        self.seq_counter = 0  # primary's PrePrepareSequence (src/message.rs:154-172)
        self.low_mark = 0
        # Logs keyed by (view, seq) for *all three* phases (fixes the
        # reference's view-only commit key, src/state.rs:23).
        self.pre_prepares: Dict[Tuple[int, int], PrePrepare] = {}
        self.prepares: Dict[Tuple[int, int], Dict[int, Prepare]] = {}
        self.commits: Dict[Tuple[int, int], Dict[int, Commit]] = {}
        self.sent_commit: Set[Tuple[int, int]] = set()
        self.executed_upto = 0
        self.pending_execution: Dict[int, Tuple[int, str]] = {}
        self.last_timestamp: Dict[str, int] = {}
        self.last_reply: Dict[str, ClientReply] = {}
        self.checkpoints: Dict[int, Dict[int, Checkpoint]] = {}
        self.state_digest = blake2b_256(b"pbft-genesis")
        # Tentative execution (Castro–Liskov §5.3; active when
        # config.tentative). committed_upto <= executed_upto is the
        # highest sequence whose whole prefix is committed-local AND
        # executed — everything above it ran tentatively (at prepared)
        # and can roll back on a view change. Per executed sequence above
        # the floor, _tentative_undo holds what execution changed (prior
        # chain digest, per-request prior timestamp/reply cache entries,
        # app snapshot); _pending_checkpoints holds checkpoint payloads
        # captured at execution time whose EMISSION waits for the commit
        # point (a checkpoint may only cover state that cannot roll
        # back); committed_chain is the chain digest AT the committed
        # floor (what the invariant checker compares across replicas).
        self.committed_upto = 0
        self.committed_chain = self.state_digest
        self._tentative_undo: Dict[int, dict] = {}
        self._committed_seqs: Set[int] = set()
        self._pending_checkpoints: Dict[int, str] = {}
        self.stable_proof: List[dict] = []  # 2f+1 checkpoint dicts @ low_mark
        # Checkpoint payloads we can serve to lagging peers (seq -> canonical
        # JSON, see _checkpoint_payload), and the (seq, digest) we are
        # ourselves waiting to fetch after a watermark jump.
        self.snapshots: Dict[int, str] = {}
        self.awaiting_state: Optional[Tuple[int, str]] = None
        # View change (PBFT §4.4; the reference had no view mutation at all,
        # reference src/view.rs:1-13).
        self.in_view_change = False
        self.pending_view = 0
        self.view_changes: Dict[int, Dict[int, ViewChange]] = {}
        # NEW-VIEW messages this replica (as primary-elect) has already
        # built, keyed by view: membership suppresses redundant
        # recomputation when retransmitted VIEW-CHANGEs arrive, and the
        # cached message is RESENT point-to-point to a replica whose
        # VIEW-CHANGE shows it never received the broadcast — lost-frame
        # recovery without a second O computation or a second broadcast.
        self.new_view_sent: Dict[int, NewView] = {}
        # Our own latest VIEW-CHANGE (pending view): the runtime's
        # retransmission timer re-broadcasts it verbatim instead of
        # escalating on every expiry (§4.5 liveness under loss).
        self._my_view_change: Optional[ViewChange] = None
        # Write-ahead log (consensus/wal.py): when set by the
        # runtime, every vote this replica sends is recorded (and durable
        # before the send — the runtime flushes at its emit boundary),
        # and a vote contradicting a persisted one is REFUSED: the
        # amnesia guard that makes crash-restart safe. None = the
        # pre-durability behavior, one attribute check per vote.
        self.wal = None
        # (message, optional precomputed signable digest) — see receive().
        self._inbox: List[Tuple[Message, Optional[bytes]]] = []
        # Consensus-phase observer (utils.metrics.ConsensusSpans.on_phase):
        # called as hook(phase, view, seq) at each protocol transition. The
        # state machine itself stays clock-free and deterministic — the
        # hook only reports that a transition happened; the runtime stamps
        # it. None (the default) costs one attribute check per transition,
        # never per message (the Tracer discipline, utils/trace.py).
        self.phase_hook: Optional[Callable[[str, int, int], None]] = None
        # Batch-size observer: called with len(pp.requests) at every
        # pre-prepare accept (feeds the pbft_batch_size histogram). Same
        # one-attribute-check-when-unset discipline as phase_hook.
        self.batch_hook: Optional[Callable[[int], None]] = None
        # View-change observer: called with
        # ("view_change_sent", pending_view) when this replica broadcasts
        # VIEW-CHANGE and with ("new_view_installed", view) when it enters
        # the new view. Rare reconfiguration events; the runtime stamps
        # them into the matching trace events and the flight recorder.
        # Same unset discipline as phase_hook.
        self.view_hook: Optional[Callable[[str, int], None]] = None
        # The primary's OPEN batch: requests accumulated but not
        # yet sealed under a sequence number. _open_batch_ts tracks the
        # highest pending timestamp per client so duplicate suppression
        # also sees requests that sit in the unsealed batch.
        self._open_batch: List[ClientRequest] = []
        self._open_batch_ts: Dict[str, int] = {}
        # Last request forwarded to the primary, per client (backup role):
        # re-aimed at the new primary on view entry, retired
        # at execution. Bounded by MAX_FORWARDED_RETAINED.
        self._forwarded: Dict[str, ClientRequest] = {}
        # Highest timestamp per client this primary has SEALED under a
        # sequence number in the CURRENT view (PBFT §4.2: "the primary
        # checks its log" — without this, a client retransmission arriving
        # after the seal but before execution gets ordered AGAIN, burning
        # a whole three-phase instance on a duplicate the execution-time
        # exactly-once guard then skips). Cleared on view entry: a request
        # sealed in an ABANDONED view may need re-ordering by the new
        # primary, so the memory must not outlive the view.
        self._sealed_ts: Dict[str, int] = {}
        self.counters: Dict[str, int] = {
            "sig_verified": 0,
            "sig_rejected": 0,
            "mac_verified": 0,
            "tentative_executions": 0,
            "tentative_rollbacks": 0,
            "pre_prepares_accepted": 0,
            "prepares_accepted": 0,
            "commits_accepted": 0,
            "executed": 0,
            "rounds_executed": 0,
            "duplicate_requests": 0,
            "checkpoints_stable": 0,
            "view_changes_started": 0,
            "view_changes_completed": 0,
            "state_transfers": 0,
        }

    # -- identity helpers ---------------------------------------------------

    @property
    def is_primary(self) -> bool:
        return self.config.primary_of(self.view) == self.id

    @property
    def primary(self) -> int:
        return self.config.primary_of(self.view)

    @property
    def high_mark(self) -> int:
        return self.low_mark + self.config.watermark_window

    def has_unexecuted(self) -> bool:
        """True when accepted pre-prepares (or committed-but-unexecuted
        slots) sit above executed_upto — the runtime's request-timer
        signal (mirrors core/replica.cc). In tentative mode an executed
        but uncommitted suffix also counts: its commits are still owed,
        and starving them must keep the timer armed."""
        if self.pending_execution:
            return True
        if self.config.tentative and self.executed_upto > self.committed_upto:
            return True
        return any(seq > self.executed_upto for _, seq in self.pre_prepares)

    def progress_marker(self) -> int:
        """What the runtime's view timer treats as progress: COMMITTED
        sequences in tentative mode (tentative executions roll back, so
        they must not placate the timer while commits starve), executed
        sequences otherwise."""
        return (
            self.committed_upto if self.config.tentative else self.executed_upto
        )

    def _sign(self, msg: Message) -> Message:
        return with_sig(msg, _host_sign(self._seed, msg.signable()).hex())

    # -- client request path (reference src/behavior.rs:63-98) --------------

    def on_client_request(self, req: ClientRequest) -> List[Action]:
        # §4.1: EVERY replica re-sends its cached reply on a
        # retransmission of an executed request — backups included,
        # BEFORE the forward-to-primary (mirrors core/replica.cc). The
        # cached reply carries this replica's own signature, so f+1
        # retransmission answers form a distinct-voter quorum.
        cached = self.last_reply.get(req.client)
        if cached is not None and cached.timestamp == req.timestamp:
            self.counters["duplicate_requests"] += 1
            return [Reply(req.client, cached)]
        # A timestamp at or below the client's last EXECUTED one can
        # never execute again (per-client exactly-once) and its reply is
        # no longer cached: drop it on EVERY role. Backups
        # used to forward these forever — each forward re-armed the
        # request timer for a request with nothing left to order, and a
        # client stuck retransmitting a superseded timestamp could drive
        # perpetual view changes out of pure duplicate traffic.
        last = self.last_timestamp.get(req.client)
        if last is not None and req.timestamp <= last:
            self.counters["duplicate_requests"] += 1
            return []
        if not self.is_primary:
            # Forward to the primary (reference TODO src/client_handler.rs:66-68),
            # and REMEMBER the request: if this view dies before it
            # executes, _enter_new_view re-aims it at the new primary
            # (see MAX_FORWARDED_RETAINED).
            if len(self._forwarded) >= MAX_FORWARDED_RETAINED:
                self._forwarded.clear()
            self._forwarded[req.client] = req
            return [Send(self.primary, req)]
        # Duplicate suppression must also see the OPEN batch: a
        # retransmission arriving while its first copy waits unsealed
        # would otherwise be ordered (and executed) twice... well, once —
        # the execution-time exactly-once guard catches it — but it would
        # burn batch slots and inflate sequence traffic for nothing.
        pending = self._open_batch_ts.get(req.client)
        if pending is not None and req.timestamp <= pending:
            self.counters["duplicate_requests"] += 1
            return []
        sealed = self._sealed_ts.get(req.client)
        if sealed is not None and req.timestamp <= sealed:
            # Already ordered in this view (sealed, in flight): either it
            # commits here, or a view change clears this memory.
            self.counters["duplicate_requests"] += 1
            return []
        self._open_batch.append(req)
        self._open_batch_ts[req.client] = req.timestamp
        if len(self._open_batch) >= max(1, self.config.batch_max_items):
            return self._seal_batch()
        return []  # the runtime's batch_flush_us timer seals partials

    def open_batch_size(self) -> int:
        """Requests waiting in the unsealed batch — the runtime's flush
        timer (config.batch_flush_us) polls this."""
        return len(self._open_batch)

    def flush_open_batch(self) -> List[Action]:
        """Seal the open batch regardless of occupancy (runtime flush
        timer). No-op while empty or while the watermark window is
        closed (the batch stays open; retried on the next tick)."""
        if not self._open_batch:
            return []
        return self._seal_batch()

    def _seal_batch(self) -> List[Action]:
        if self.seq_counter + 1 > self.high_mark:
            return []  # out of window until a checkpoint advances it
        batch = tuple(self._open_batch)
        if self.wal is not None and not self.wal.note_vote(
            WAL_VOTE_PRE_PREPARE,
            self.view,
            self.seq_counter + 1,
            batch_digest(batch),
        ):
            # A durable pre-prepare for this (view, seq) names a
            # DIFFERENT batch (can only happen if recovery restored a
            # lower seq_counter than the log proves we used): sealing
            # would equivocate. Leave the batch open; the watermark /
            # view machinery resolves the slot.
            return []
        self._open_batch = []
        self._open_batch_ts = {}
        for req in batch:
            self._sealed_ts[req.client] = req.timestamp
        self.seq_counter += 1
        n = self.seq_counter
        hook = self.phase_hook
        if hook is not None:  # primary-only: request -> sequence assignment
            hook("request", self.view, n)
        pp = self._sign(
            PrePrepare(
                view=self.view,
                seq=n,
                digest=batch_digest(batch),
                requests=batch,
                replica=self.id,
            )
        )
        out: List[Action] = [Broadcast(pp)]
        out.extend(self._accept_pre_prepare(pp))
        return out

    # -- signature gating ---------------------------------------------------

    def receive(
        self, msg: Message, signable: Optional[bytes] = None
    ) -> List[Action]:
        """Queue a replica-to-replica message for batched verification.

        ClientRequests skip the queue (clients are unauthenticated, matching
        the reference's client contract). ``signable`` is the 32-byte
        signable digest the net layer derived from the received frame
        bytes (messages.signable_from_payload) — when present,
        pending_items reuses it instead of re-serializing."""
        if isinstance(msg, ClientRequest):
            return self.on_client_request(msg)
        self._inbox.append((msg, signable, False))
        return []

    def pending_count(self) -> int:
        """Queue depth without building the items — the server's bounded
        accumulation window (config.verify_flush_us) polls this."""
        return len(self._inbox)

    def _consume_inbox(self, verdicts: List[bool]):
        """Split the inbox into (entry, ok) pairs covered by ``verdicts``
        and the remainder: pre-authenticated entries pass for free (and
        are consumed greedily at the tail), verification-needing entries
        consume one verdict each, in arrival order."""
        taken: List[Tuple[Message, bool, bool]] = []
        vi = 0
        consumed = 0
        for msg, _signable, preauth in self._inbox:
            if preauth:
                taken.append((msg, True, True))
            else:
                if vi >= len(verdicts):
                    break
                taken.append((msg, verdicts[vi], False))
                vi += 1
            consumed += 1
        self._inbox = self._inbox[consumed:]
        return taken

    def pending_items(self) -> List[Tuple[bytes, bytes, bytes]]:
        """(pubkey32, digest32, sig64) per queued message NEEDING
        verification, for the batch verifier (pre-authenticated entries —
        MAC-accepted frames queued behind the signed types for ordering —
        are skipped; deliver_verdicts treats them as already valid)."""
        items = []
        for msg, signable, preauth in self._inbox:
            if preauth:
                continue
            rid = getattr(msg, "replica", None)
            pub = (
                self.config.identity(rid).pubkey_bytes()
                if rid is not None and 0 <= rid < self.config.n
                else bytes(32)
            )
            try:
                sig = bytes.fromhex(msg.sig)
            except (AttributeError, ValueError):
                sig = b""
            if len(sig) != 64:
                sig = bytes(64)  # guaranteed-invalid placeholder
            # Receive-side canonical reuse: the net layer already hashed
            # the sender's framed bytes — no re-serialization here.
            items.append((pub, signable or msg.signable(), sig))
        return items

    def receive_authenticated(self, msg: Message) -> List[Action]:
        """Dispatch a message the NET layer already authenticated via its
        per-link MAC (authenticator mode): no signature
        check — the MAC lane proved the sender, and the net layer checked
        the claimed replica id against the link's authenticated peer.

        ORDERING: when the verify inbox is non-empty the message queues
        BEHIND it (pre-verified) instead of dispatching immediately — a
        MAC frame overtaking a still-unverified NEW-VIEW from the same
        sender would be dropped as belonging to a view this replica has
        not entered yet, and the primary's per-view duplicate suppression
        then pins the request until the NEXT view change (a liveness
        wedge the chaos soak caught). The inbox only ever holds the rare
        signed types in MAC mode, so the fast path stays fast."""
        self.counters["mac_verified"] += 1
        if isinstance(msg, ClientRequest):
            return self.on_client_request(msg)
        if self._inbox:
            self._inbox.append((msg, None, True))
            return []
        return self._dispatch(msg)

    def deliver_verdicts(self, verdicts: List[bool]) -> List[Action]:
        """Resume processing for the queued messages, in arrival order."""
        out: List[Action] = []
        for msg, ok, preauth in self._consume_inbox(verdicts):
            if not ok:
                self.counters["sig_rejected"] += 1
                continue
            if not preauth:  # MAC-accepted entries counted at receive
                self.counters["sig_verified"] += 1
            out.extend(self._dispatch(msg))
        return out

    # -- protocol dispatch (reference src/behavior.rs:304-414) --------------

    def _dispatch(self, msg: Message) -> List[Action]:
        if isinstance(msg, PrePrepare):
            return self._on_pre_prepare(msg)
        if isinstance(msg, Prepare):
            return self._on_prepare(msg)
        if isinstance(msg, Commit):
            return self._on_commit(msg)
        if isinstance(msg, Checkpoint):
            return self._on_checkpoint(msg)
        if isinstance(msg, ViewChange):
            return self._on_view_change(msg)
        if isinstance(msg, NewView):
            return self._on_new_view(msg)
        if isinstance(msg, StateRequest):
            return self._on_state_request(msg)
        if isinstance(msg, StateResponse):
            return self._on_state_response(msg)
        if isinstance(msg, ClientRequest):
            return self.on_client_request(msg)
        return []

    def _on_pre_prepare(self, pp: PrePrepare) -> List[Action]:
        # validate (reference src/behavior.rs:126-157 + watermark TODO :154)
        if self.in_view_change:
            return []  # §4.4: only checkpoint/view-change/new-view accepted
        if pp.view != self.view or pp.replica != self.primary:
            return []
        if pp.batch_digest() != pp.digest:
            return []
        if not (self.low_mark < pp.seq <= self.high_mark):
            return []
        existing = self.pre_prepares.get((pp.view, pp.seq))
        if existing is not None:
            return []  # already have a pre-prepare for (v, n)
        return self._accept_pre_prepare(pp)

    def _accept_pre_prepare(self, pp: PrePrepare) -> List[Action]:
        key = (pp.view, pp.seq)
        if self.wal is not None:
            # Amnesia guard: our durable vote for this slot —
            # the pre-prepare we sealed as primary, or the prepare we
            # broadcast as backup — is the floor a restart must honor. A
            # pre-prepare naming a different digest is refused outright
            # (accepting it could grow a conflicting certificate); one
            # naming the SAME digest re-enters normally, which is how a
            # recovered replica resumes the round without re-voting
            # anything new.
            kind = (
                WAL_VOTE_PRE_PREPARE
                if self.config.primary_of(pp.view) == self.id
                else WAL_VOTE_PREPARE
            )
            if not self.wal.note_vote(kind, pp.view, pp.seq, pp.digest):
                return []
        self.pre_prepares[key] = pp
        self.counters["pre_prepares_accepted"] += 1
        hook = self.phase_hook
        if hook is not None:
            hook("pre_prepare", pp.view, pp.seq)
        bhook = self.batch_hook
        if bhook is not None:
            bhook(len(pp.requests))
        # The primary's pre-prepare stands in for its prepare (PBFT §4.2):
        # only backups multicast PREPARE, and _prepared wants 2f *backup*
        # prepares, giving 2f+1 distinct replicas per certificate.
        if self.config.primary_of(pp.view) == self.id:
            return self._maybe_commit(key)
        prep = self._sign(
            Prepare(view=pp.view, seq=pp.seq, digest=pp.digest, replica=self.id)
        )
        out: List[Action] = [Broadcast(prep)]
        out.extend(self._insert_prepare(prep))
        return out

    def _on_prepare(self, p: Prepare) -> List[Action]:
        if self.in_view_change or p.view != self.view:
            return []
        if not (self.low_mark < p.seq <= self.high_mark):
            return []
        return self._insert_prepare(p)

    def _insert_prepare(self, p: Prepare) -> List[Action]:
        key = (p.view, p.seq)
        slot = self.prepares.setdefault(key, {})
        if p.replica in slot:
            return []
        slot[p.replica] = p
        self.counters["prepares_accepted"] += 1
        return self._maybe_commit(key)

    def _prepared(self, key: Tuple[int, int]) -> bool:
        """pre-prepare + 2f matching *backup* prepares (PBFT §4.2; reference
        stub `>= 1` at src/behavior.rs:177-182). Excluding the primary keeps
        every prepared certificate at 2f+1 distinct replicas — counting a
        primary prepare would shrink it to 2f and break quorum
        intersection across views."""
        pp = self.pre_prepares.get(key)
        if pp is None:
            return False
        primary = self.config.primary_of(key[0])
        matching = sum(
            1
            for rid, p in self.prepares.get(key, {}).items()
            if rid != primary and p.digest == pp.digest
        )
        return matching >= 2 * self.config.f

    def _maybe_commit(self, key: Tuple[int, int]) -> List[Action]:
        if key in self.sent_commit or not self._prepared(key):
            return []
        if self.wal is not None and not self.wal.note_vote(
            WAL_VOTE_COMMIT, key[0], key[1], self.pre_prepares[key].digest
        ):
            return []  # contradicts a durable commit vote: never send
        self.sent_commit.add(key)
        hook = self.phase_hook
        if hook is not None:
            hook("prepared", key[0], key[1])
        pp = self.pre_prepares[key]
        cm = self._sign(
            Commit(view=key[0], seq=key[1], digest=pp.digest, replica=self.id)
        )
        out: List[Action] = [Broadcast(cm)]
        if self.config.tentative:
            # Tentative execution (§5.3): PREPARED is the execute point —
            # the reply goes out one commit round-trip early, flagged
            # tentative; the commit quorum later promotes it (and a view
            # change before that rolls it back).
            view, seq = key
            if seq > self.executed_upto and seq not in self.pending_execution:
                self.pending_execution[seq] = (view, pp.digest)
                out.extend(self._drain_executions())
        out.extend(self._insert_commit(cm))
        return out

    def _on_commit(self, c: Commit) -> List[Action]:
        if self.in_view_change or c.view != self.view:
            return []
        if not (self.low_mark < c.seq <= self.high_mark):
            return []
        return self._insert_commit(c)

    def _insert_commit(self, c: Commit) -> List[Action]:
        key = (c.view, c.seq)
        slot = self.commits.setdefault(key, {})
        if c.replica in slot:
            return []
        slot[c.replica] = c
        self.counters["commits_accepted"] += 1
        return self._maybe_execute(key)

    def _committed_local(self, key: Tuple[int, int]) -> bool:
        """prepared + 2f+1 matching commits (PBFT §4.2; reference stub at
        src/behavior.rs:214-223)."""
        if not self._prepared(key):
            return False
        pp = self.pre_prepares[key]
        matching = sum(
            1 for c in self.commits.get(key, {}).values() if c.digest == pp.digest
        )
        return matching >= 2 * self.config.f + 1

    def _maybe_execute(self, key: Tuple[int, int]) -> List[Action]:
        if not self._committed_local(key):
            return []
        view, seq = key
        if self.config.tentative and seq <= self.executed_upto:
            # Already executed (tentatively) — the commit quorum arrived
            # now: advance the committed floor. No "committed" phase
            # stamp: the span already closed at the tentative execution,
            # and a committed stamp after "executed" would violate the
            # phase-order invariant the timeline checker enforces.
            if seq <= self.committed_upto or seq in self._committed_seqs:
                return []
            return self._note_committed(seq)
        if seq <= self.executed_upto or seq in self.pending_execution:
            return []
        self.pending_execution[seq] = (view, self.pre_prepares[key].digest)
        hook = self.phase_hook
        if hook is not None:
            hook("committed", view, seq)
        return self._drain_executions()

    def _drain_executions(self) -> List[Action]:
        """Execute strictly in sequence order (the reference executed on
        arrival order, src/behavior.rs:383-410; in-order execution is what
        makes replicas' app state deterministic)."""
        out: List[Action] = []
        while self.executed_upto + 1 in self.pending_execution:
            seq = self.executed_upto + 1
            view, digest = self.pending_execution.pop(seq)
            self.executed_upto = seq
            hook = self.phase_hook
            if hook is not None:
                hook("executed", view, seq)
            pp = self.pre_prepares.get((view, seq))
            # Tentative mode: is this execution already backed by a
            # commit quorum (definitive) or only by the prepared
            # certificate (tentative — reply flagged, undo recorded)?
            tentative_mode = self.config.tentative
            committed_now = not tentative_mode or self._committed_local(
                (view, seq)
            )
            undo: Optional[dict] = None
            if tentative_mode:
                # Undo record for EVERY executed sequence above the
                # committed floor (committed-now ones included — the
                # floor may still be below them, and rollback walks the
                # whole suffix): prior chain digest, per-request prior
                # exactly-once entries, app snapshot when stateful.
                snap = getattr(self._app, "snapshot", None)
                undo = {
                    "chain": self.state_digest,
                    "items": [],
                    "app": snap() if callable(snap) else None,
                }
                self._tentative_undo[seq] = undo
            if pp is None:
                # Defensive: can only happen if the pre-prepare log lost an
                # entry for a slot that committed; the watermark-jump path
                # (the old way to get here) now goes through state transfer
                # (_on_state_response) instead of skipping executions.
                if tentative_mode and committed_now:
                    out.extend(self._note_committed(seq))
                continue
            self.counters["rounds_executed"] += 1
            if not pp.requests:
                # Empty batch (view-change gap filler, PBFT §4.4's null
                # request as a batch): a no-op execution that still
                # advances the sequence and the state digest chain — the
                # SAME chain fold a legacy single null request produced,
                # so the two gap-filler encodings cannot fork app state.
                self.state_digest = hashlib.blake2b(
                    self.state_digest + b"<null>" + seq.to_bytes(8, "big"),
                    digest_size=32,
                ).digest()
            for req in pp.requests:
                if req.client == NULL_CLIENT:
                    # Legacy null request (a 1.1.0 peer's gap filler riding
                    # a batch of one): no-op, no reply, chain advances.
                    self.state_digest = hashlib.blake2b(
                        self.state_digest + b"<null>" + seq.to_bytes(8, "big"),
                        digest_size=32,
                    ).digest()
                    continue
                last = self.last_timestamp.get(req.client)
                if last is not None and req.timestamp <= last:
                    # exactly-once (reference src/behavior.rs:391-398),
                    # enforced per batch item in batch order.
                    self.counters["duplicate_requests"] += 1
                    continue
                if undo is not None:
                    undo["items"].append(
                        (req.client, last, self.last_reply.get(req.client))
                    )
                result = self._app(req.operation, seq)
                self.counters["executed"] += 1
                self.state_digest = hashlib.blake2b(
                    self.state_digest
                    + result.encode()
                    + seq.to_bytes(8, "big"),
                    digest_size=32,
                ).digest()
                self.last_timestamp[req.client] = req.timestamp
                self._forwarded.pop(req.client, None)  # executed: retire
                reply = self._sign(
                    ClientReply(
                        view=view,
                        timestamp=req.timestamp,
                        client=req.client,
                        replica=self.id,
                        result=result,
                        tentative=0 if committed_now else 1,
                    )
                )
                self.last_reply[req.client] = reply
                out.append(Reply(req.client, reply))
            if seq % self.config.checkpoint_interval == 0:
                payload = self._checkpoint_payload(seq)
                if tentative_mode:
                    # Deferred emission: the payload is captured NOW (the
                    # state IS the state at seq) but the Checkpoint
                    # message waits for the commit point — a checkpoint
                    # may only ever cover state that cannot roll back.
                    self._pending_checkpoints[seq] = payload
                else:
                    self.snapshots[seq] = payload
                    cp = self._sign(
                        Checkpoint(
                            seq=seq,
                            digest=blake2b_256(payload.encode()).hex(),
                            replica=self.id,
                        )
                    )
                    out.append(Broadcast(cp))
                    out.extend(self._insert_checkpoint(cp))
            if tentative_mode:
                if committed_now:
                    out.extend(self._note_committed(seq))
                else:
                    self.counters["tentative_executions"] += 1
        if not self.config.tentative:
            # Signature mode: every execution is definitive — the floor
            # tracks execution so the progress/metrics surface is uniform.
            self.committed_upto = self.executed_upto
            self.committed_chain = self.state_digest
        return out

    # -- tentative promotion & rollback (§5.3) --------------------

    def _note_committed(self, seq: int) -> List[Action]:
        """Sequence ``seq`` is committed-local AND executed: advance the
        committed floor over every contiguously-committed sequence,
        retire their undo records, refresh committed_chain, and emit any
        checkpoint whose (deferred) interval boundary the floor crossed."""
        if seq <= self.committed_upto:
            return []
        self._committed_seqs.add(seq)
        out: List[Action] = []
        while (self.committed_upto + 1) in self._committed_seqs:
            self.committed_upto += 1
            s = self.committed_upto
            self._committed_seqs.discard(s)
            self._tentative_undo.pop(s, None)
            payload = self._pending_checkpoints.pop(s, None)
            if payload is not None:
                self.snapshots[s] = payload
                cp = self._sign(
                    Checkpoint(
                        seq=s,
                        digest=blake2b_256(payload.encode()).hex(),
                        replica=self.id,
                    )
                )
                out.append(Broadcast(cp))
                out.extend(self._insert_checkpoint(cp))
        nxt = self._tentative_undo.get(self.committed_upto + 1)
        self.committed_chain = (
            nxt["chain"] if nxt is not None else self.state_digest
        )
        return out

    def _rollback_tentative(self) -> None:
        """Undo every execution above the committed floor, newest first
        (view-change entry, or a certified checkpoint past the floor):
        chain digest, per-client exactly-once timestamps, cached replies,
        and app state all revert to the committed point; the re-issued
        sequences then re-prepare, re-commit, and re-execute in the new
        view. Clients that accepted a reply are safe regardless: 2f+1
        matching tentative votes imply f+1 HONEST replicas holding the
        full prepared certificate, and any new-view quorum intersects
        them — the same batch is re-issued at the same sequence."""
        if not self.config.tentative or self.executed_upto <= self.committed_upto:
            return
        rolled = 0
        for seq in range(self.executed_upto, self.committed_upto, -1):
            undo = self._tentative_undo.pop(seq, None)
            self._pending_checkpoints.pop(seq, None)
            self._committed_seqs.discard(seq)
            if undo is None:
                continue  # defensive: every executed seq records one
            self.state_digest = undo["chain"]
            for client, prev_ts, prev_reply in reversed(undo["items"]):
                if prev_ts is None:
                    self.last_timestamp.pop(client, None)
                else:
                    self.last_timestamp[client] = prev_ts
                if prev_reply is None:
                    self.last_reply.pop(client, None)
                else:
                    self.last_reply[client] = prev_reply
            if undo["app"] is not None:
                restore = getattr(self._app, "restore", None)
                if callable(restore):
                    restore(undo["app"])
            rolled += 1
        self.executed_upto = self.committed_upto
        self.committed_chain = self.state_digest
        for s in [x for x in self.pending_execution if x > self.committed_upto]:
            del self.pending_execution[s]
        if rolled:
            self.counters["tentative_rollbacks"] += rolled

    # -- checkpoints, watermarks & state transfer (PBFT §4.3, §5.3) ---------

    def _app_snapshot(self) -> str:
        snap = getattr(self._app, "snapshot", None)
        return snap() if callable(snap) else ""

    def _checkpoint_payload(self, seq: int) -> str:
        """Canonical JSON the checkpoint digest commits to: app snapshot,
        the execution chain digest, and the per-client exactly-once caches.
        Byte-identical across the Python and C++ runtimes (sorted keys,
        compact separators) — the digest gates state transfer, so both
        runtimes must serialize the same bytes for the same state."""
        obj = {
            "app": self._app_snapshot(),
            "chain": self.state_digest.hex(),
            # The reply cache is replica-local in its `replica` and `sig`
            # fields; normalize both so all correct replicas digest
            # identical payload bytes (the restorer stamps its own id back
            # in and re-signs). The tentative flag is normalized away too:
            # by the time a checkpoint at this seq is EMITTED the prefix
            # is committed, and capture-time flag skew (one replica
            # executed a seq tentatively, another already held the
            # quorum) must not fork the certified payload bytes.
            "replies": [
                [c, _strip_tentative(
                    {**self.last_reply[c].to_dict(), "replica": -1, "sig": ""}
                )]
                for c in sorted(self.last_reply)
            ],
            "seq": seq,
            "timestamps": [
                [c, self.last_timestamp[c]] for c in sorted(self.last_timestamp)
            ],
        }
        return _canonical_json(obj).decode()

    def retry_state_transfer(self) -> List[Action]:
        """Re-broadcast the pending StateRequest (runtime retry timer)."""
        if self.awaiting_state is None:
            return []
        seq, _ = self.awaiting_state
        return [Broadcast(self._sign(StateRequest(seq=seq, replica=self.id)))]

    def _on_state_request(self, sr: StateRequest) -> List[Action]:
        payload = self.snapshots.get(sr.seq)
        if payload is None or not (0 <= sr.replica < self.config.n):
            return []
        resp = self._sign(
            StateResponse(seq=sr.seq, snapshot=payload, replica=self.id)
        )
        return [Send(sr.replica, resp)]

    def _install_checkpoint_payload(self, seq: int, snapshot: str) -> bool:
        """Install a certified checkpoint payload wholesale: app state,
        chain digest, per-client exactly-once caches, committed floor.
        Shared by §5.3 state transfer and WAL crash-recovery.
        False when the payload doesn't parse (nothing was mutated)."""
        try:
            import json as _json

            obj = _json.loads(snapshot)
            replies = {}
            for c, d in obj["replies"]:
                m = Message.from_dict(dict(d))
                if not isinstance(m, ClientReply):
                    return False
                # Stamp our id back in and re-sign: a resent cached reply
                # must carry THIS replica's vote, not a blank one.
                replies[c] = self._sign(
                    dataclasses.replace(m, replica=self.id)
                )
            timestamps = {c: int(t) for c, t in obj["timestamps"]}
            chain = bytes.fromhex(obj["chain"])
        except (KeyError, TypeError, ValueError):
            return False
        restore = getattr(self._app, "restore", None)
        if callable(restore):
            restore(obj.get("app", ""))
        self.state_digest = chain
        self.last_reply = replies
        self.last_timestamp = timestamps
        self.executed_upto = seq
        # The installed state is 2f+1-certified: the committed floor
        # moves with it and any stale tentative bookkeeping dies here.
        self.committed_upto = seq
        self.committed_chain = chain
        self._tentative_undo.clear()
        self._committed_seqs.clear()
        self._pending_checkpoints.clear()
        self.snapshots[seq] = snapshot  # we can serve peers now
        return True

    def _on_state_response(self, resp: StateResponse) -> List[Action]:
        if self.awaiting_state is None:
            return []
        seq, digest = self.awaiting_state
        if resp.seq != seq:
            return []
        if blake2b_256(resp.snapshot.encode()).hex() != digest:
            return []  # content not certified by the 2f+1 checkpoint quorum
        if not self._install_checkpoint_payload(seq, resp.snapshot):
            return []
        self.awaiting_state = None
        self.counters["state_transfers"] += 1
        self._wal_checkpoint(seq)
        return self._drain_executions()

    def restore_from_wal(self, state: WalState) -> bool:
        """Crash-recovery: reinstall the durable safety state a
        previous life of this replica persisted — BEFORE the runtime
        starts networking. The replica re-joins the SAME view at its
        stable-checkpoint floor; the vote log (already loaded in
        ``self.wal``) then refuses any send contradicting a pre-crash
        vote, and the suffix past the checkpoint catches up through the
        ordinary protocol (peer checkpoints -> §5.3 state transfer).

        A crash mid-view-change re-joins at the OLD view, not the
        pending one: its VIEW-CHANGE vote (if it got out) already counts
        at the primary-elect, duplicates are ignored, and a completed
        change reaches us as a NEW-VIEW for a higher view. Returns False
        when the persisted checkpoint payload fails to parse (the
        replica then starts fresh — state transfer still covers it)."""
        ok = True
        if state.checkpoint is not None:
            seq, payload, cert_json = state.checkpoint
            if self._install_checkpoint_payload(seq, payload):
                self.low_mark = seq
                try:
                    import json as _json

                    self.stable_proof = list(_json.loads(cert_json))
                except ValueError:
                    self.stable_proof = []
                self.seq_counter = seq
            else:
                ok = False
        self.view = max(self.view, state.view)
        # Never re-assign a sequence a previous life pre-prepared: the
        # durable vote guard would refuse the seal, but starting past the
        # floor avoids even trying.
        self.seq_counter = max(self.seq_counter, state.max_pre_prepare_seq())
        return ok

    def _on_checkpoint(self, cp: Checkpoint) -> List[Action]:
        if cp.seq <= self.low_mark:
            return []
        return self._insert_checkpoint(cp)

    def _insert_checkpoint(self, cp: Checkpoint) -> List[Action]:
        # MAC mode: checkpoints were accepted by their link
        # lane, but their embedded signatures are what stable-checkpoint
        # CERTIFICATES (the C component of view changes, and the gate on
        # state transfer) are made of — admit only provable evidence, or
        # one sig-corrupting peer poisons every honest VIEW-CHANGE.
        # Checkpoints are rare (one per interval per replica), so the
        # inline verify costs nothing the fast path can feel; signature
        # mode already verified upstream (fastpath gate keeps it free).
        if self.config.fastpath == "mac" and not self._verify_inline(
            cp.replica, cp.signable(), cp.sig
        ):
            return []
        slot = self.checkpoints.setdefault(cp.seq, {})
        if cp.replica in slot:
            return []
        slot[cp.replica] = cp
        by_digest: Dict[str, int] = {}
        for c in slot.values():
            by_digest[c.digest] = by_digest.get(c.digest, 0) + 1
        out: List[Action] = []
        for digest, count in by_digest.items():
            if count >= 2 * self.config.f + 1:
                # Keep the 2f+1 matching checkpoint messages: they are the
                # C component of our next VIEW-CHANGE (PBFT §4.4).
                proof = [
                    c.to_dict() for c in slot.values() if c.digest == digest
                ]
                out.extend(self._advance_watermark(cp.seq, digest))
                self.stable_proof = proof
                self._wal_checkpoint(cp.seq)
                break
        return out

    def _wal_checkpoint(self, seq: int) -> None:
        """Persist the stable checkpoint: payload (app snapshot
        + reply cache) and the adopted 2f+1 certificate. Skipped when we
        don't HOLD the payload yet (a lagging replica mid state transfer
        records it when the StateResponse installs)."""
        if self.wal is None:
            return
        payload = self.snapshots.get(seq)
        if payload is not None:
            self.wal.note_checkpoint(seq, payload, self.stable_proof)

    # -- view change (PBFT §4.4) -------------------------------------------
    #
    # The reference has no view mutation at all (reference src/view.rs:1-13);
    # this is the paper protocol. Design note on verification: the *hot* path
    # (pre-prepare/prepare/commit) is signature-gated through the batched
    # batch verifier (pending_items/deliver_verdicts); view changes are rare
    # reconfiguration events, so the signatures nested inside their evidence
    # (checkpoint certificates, prepared certificates, the view-change
    # messages embedded in a NEW-VIEW) are verified inline on the host.

    def _verify_inline(self, replica_id: int, signable: bytes, sig_hex: str) -> bool:
        if not (0 <= replica_id < self.config.n):
            return False
        try:
            sig = bytes.fromhex(sig_hex)
        except ValueError:
            return False
        if len(sig) != 64:
            return False
        return _host_verify(
            self.config.identity(replica_id).pubkey_bytes(), signable, sig
        )

    def start_view_change(self, new_view: Optional[int] = None) -> List[Action]:
        """Move to view v+1 (or `new_view`) and broadcast VIEW-CHANGE.

        Called by the runtime when its request timer for the current
        primary expires, or by the f+1 join rule below."""
        floor = self.pending_view if self.in_view_change else self.view
        v = (floor + 1) if new_view is None else new_view
        if v <= floor:
            return []
        self.in_view_change = True
        self.pending_view = v
        if self.wal is not None:
            self.wal.note_view(self.view, True, v)
        self.counters["view_changes_started"] += 1
        vh = self.view_hook
        if vh is not None:
            vh("view_change_sent", v)
        vc = self._sign(
            ViewChange(
                new_view=v,
                last_stable_seq=self.low_mark,
                checkpoint_proof=tuple(self.stable_proof),
                prepared_proofs=tuple(self._prepared_proofs()),
                replica=self.id,
            )
        )
        self._my_view_change = vc
        out: List[Action] = [Broadcast(vc)]
        out.extend(self._on_view_change(vc))  # log our own
        return out

    def retransmit_view_change(self) -> List[Action]:
        """Re-broadcast the VIEW-CHANGE for the pending view, verbatim
        (runtime retransmission timer): under link loss the
        original may never have reached the primary-elect — resending the
        SAME signed message converges in the SAME view, where escalating
        would burn a view number per lost frame. No counters move and
        nothing is re-signed; receivers treat it as the duplicate it is
        (and a primary-elect that already sent NEW-VIEW answers it with
        the cached NEW-VIEW, see _on_view_change)."""
        if not self.in_view_change or self._my_view_change is None:
            return []
        return [Broadcast(self._my_view_change)]

    def _prepared_proofs(self) -> List[dict]:
        """P: for each sequence prepared above the low watermark, the
        pre-prepare plus its 2f matching backup prepares (highest view
        wins when a sequence prepared in several views).

        Only evidence with VALID signatures ships: in MAC
        mode the hot path accepts frames by their lane without checking
        the embedded signature, so a sig-corrupting Byzantine peer can
        place garbage-signature prepares in honest logs — shipping one
        would make validators reject this replica's whole VIEW-CHANGE
        (the liveness wedge the chaos soak caught). A slot that cannot
        assemble a fully-valid certificate is simply not claimed: the
        client's retransmission re-orders it in the new view. In
        signature mode every logged message was already verified, so the
        filter is a no-op."""
        best: Dict[int, Tuple[int, dict]] = {}
        for (view, seq), pp in self.pre_prepares.items():
            if seq <= self.low_mark or not self._prepared((view, seq)):
                continue
            primary = self.config.primary_of(view)
            if not self._verify_inline(primary, pp.signable(), pp.sig):
                continue  # sig-corrupt primary: slot unprovable
            preps = [
                p.to_dict()
                for rid, p in self.prepares[(view, seq)].items()
                if rid != primary
                and p.digest == pp.digest
                and self._verify_inline(p.replica, p.signable(), p.sig)
            ]
            if len(preps) < 2 * self.config.f:
                continue  # not enough valid-signature evidence
            entry = {"pre_prepare": pp.to_dict(), "prepares": preps}
            if seq not in best or view > best[seq][0]:
                best[seq] = (view, entry)
        return [entry for _, (_, entry) in sorted(best.items())]

    def _validate_view_change(self, vc: ViewChange) -> bool:
        # C: 2f+1 checkpoint messages proving last_stable_seq.
        if vc.last_stable_seq > 0:
            seen: Set[int] = set()
            for d in vc.checkpoint_proof:
                try:
                    cp = Message.from_dict(dict(d))
                except (KeyError, TypeError, ValueError):
                    return False
                if not isinstance(cp, Checkpoint) or cp.seq != vc.last_stable_seq:
                    return False
                if cp.replica in seen:
                    return False
                if not self._verify_inline(cp.replica, cp.signable(), cp.sig):
                    return False
                seen.add(cp.replica)
            if self._majority_digest(vc.checkpoint_proof) is None:
                return False
        # P: each prepared certificate is internally consistent + signed.
        for proof in vc.prepared_proofs:
            try:
                pp = Message.from_dict(dict(proof["pre_prepare"]))
                preps = [Message.from_dict(dict(p)) for p in proof["prepares"]]
            except (KeyError, TypeError, ValueError):
                return False
            if not isinstance(pp, PrePrepare) or pp.seq <= vc.last_stable_seq:
                return False
            primary = self.config.primary_of(pp.view)
            if pp.replica != primary or pp.batch_digest() != pp.digest:
                return False
            if not self._verify_inline(primary, pp.signable(), pp.sig):
                return False
            seen = set()
            for p in preps:
                if not isinstance(p, Prepare):
                    return False
                if (p.view, p.seq, p.digest) != (pp.view, pp.seq, pp.digest):
                    return False
                if p.replica == primary or p.replica in seen:
                    return False
                if not self._verify_inline(p.replica, p.signable(), p.sig):
                    return False
                seen.add(p.replica)
            if len(seen) < 2 * self.config.f:
                return False
        return True

    def _on_view_change(self, vc: ViewChange) -> List[Action]:
        if vc.new_view <= self.view:
            # A VIEW-CHANGE for a view we already lead means the sender
            # never received our NEW-VIEW (it was lost, or the sender is
            # retransmitting on its timer): resend the cached message
            # point-to-point — no recomputation, no re-broadcast
            # (NEW-VIEW retransmission/suppression).
            if (
                vc.new_view == self.view
                and self.config.primary_of(vc.new_view) == self.id
                and vc.new_view in self.new_view_sent
                and 0 <= vc.replica < self.config.n
                and vc.replica != self.id
            ):
                return [Send(vc.replica, self.new_view_sent[vc.new_view])]
            return []
        slot = self.view_changes.setdefault(vc.new_view, {})
        if vc.replica in slot:
            return []
        if not self._validate_view_change(vc):
            return []
        slot[vc.replica] = vc
        out: List[Action] = []
        # Join rule (§4.5.2 liveness): f+1 replicas already moved past our
        # view -> join the smallest such view, even if our timer has not
        # fired (prevents a late replica from stalling in an abandoned view).
        floor = self.pending_view if self.in_view_change else self.view
        voters: Set[int] = set()
        candidates: List[int] = []
        for v, reps in self.view_changes.items():
            if v > floor:
                voters.update(reps)
                candidates.append(v)
        if len(voters) >= self.config.f + 1:
            out.extend(self.start_view_change(min(candidates)))
        if self.config.primary_of(vc.new_view) == self.id:
            out.extend(self._maybe_new_view(vc.new_view))
        return out

    def _compute_o(
        self, vcs: List[ViewChange]
    ) -> Tuple[int, List[Tuple[int, str, List[dict]]]]:
        """(min_s, [(seq, digest, request_dicts)]) — the O computation:
        re-issue every sequence some quorum member prepared (the whole
        request BATCH rides along in the prepared proof); gaps are filled
        with EMPTY batches (the batched form of PBFT §4.4's null
        request — execution is a no-op, the sequence still advances)."""
        min_s = max(vc.last_stable_seq for vc in vcs)
        best: Dict[int, Tuple[int, str, List[dict]]] = {}
        for vc in vcs:
            for proof in vc.prepared_proofs:
                ppd = dict(proof["pre_prepare"])
                n = ppd["seq"]
                if n <= min_s:
                    continue
                if n not in best or ppd["view"] > best[n][0]:
                    # Legacy evidence carries the singular `request`;
                    # batched evidence the `requests` list.
                    if "requests" in ppd:
                        reqs = [dict(r) for r in ppd["requests"]]
                    elif ppd.get("request") is not None:
                        reqs = [dict(ppd["request"])]
                    else:
                        reqs = []
                    best[n] = (ppd["view"], ppd["digest"], reqs)
        entries: List[Tuple[int, str, List[dict]]] = []
        max_s = max(best) if best else min_s
        for n in range(min_s + 1, max_s + 1):
            if n in best:
                entries.append((n, best[n][1], best[n][2]))
            else:
                entries.append((n, batch_digest(()), []))
        return min_s, entries

    def _majority_digest(self, proof) -> Optional[str]:
        """The digest backed by >= 2f+1 *distinct replicas* in a checkpoint
        proof, or None. This is THE quorum rule for stable-checkpoint
        evidence: _validate_view_change uses it to accept a proof and
        _stable_digest_for to pick the digest adopted during the watermark
        jump — a proof may also carry correctly-signed checkpoints with a
        minority (Byzantine) digest, so neither entry order nor repeated
        entries from one replica may influence the choice."""
        seen: Set[int] = set()
        by_digest: Dict[str, int] = {}
        for d in proof:
            d = dict(d)
            rid, dig = d.get("replica"), d.get("digest")
            if rid in seen or not isinstance(dig, str):
                continue
            seen.add(rid)
            by_digest[dig] = by_digest.get(dig, 0) + 1
        for dig, count in by_digest.items():
            if count >= 2 * self.config.f + 1:
                return dig
        return None

    def _stable_cert_for(
        self, vcs: List[ViewChange], min_s: int
    ) -> Optional[Tuple[str, List[dict]]]:
        """(digest, 2f+1 matching checkpoint dicts) certifying min_s, from
        the view-change evidence. The PROOF rides along with the digest
        because a replica whose watermark advances through a NEW-VIEW's
        min_s (not its own checkpoint collection) must ADOPT the
        certificate too: its next VIEW-CHANGE claims last_stable_seq =
        min_s, and validators reject a claim whose attached proof still
        certifies the old (pre-jump) checkpoint — a stale proof wedges
        every future view change that needs this replica's vote (found by
        the chaos soak: seed 13's cluster livelocked exactly this way)."""
        for vc in vcs:
            if vc.last_stable_seq == min_s and vc.checkpoint_proof:
                dig = self._majority_digest(vc.checkpoint_proof)
                if dig is not None:
                    proof, seen = [], set()
                    for d in vc.checkpoint_proof:
                        d = dict(d)
                        rid = d.get("replica")
                        if d.get("digest") == dig and rid not in seen:
                            seen.add(rid)
                            proof.append(d)
                    return dig, proof
        return None

    def _maybe_new_view(self, v: int) -> List[Action]:
        if v in self.new_view_sent:
            return []
        slot = self.view_changes.get(v, {})
        if len(slot) < 2 * self.config.f + 1:
            return []
        # Deterministic V: the 2f+1 lowest replica ids.
        vcs = [slot[rid] for rid in sorted(slot)[: 2 * self.config.f + 1]]
        min_s, entries = self._compute_o(vcs)
        pps = [
            self._sign(
                PrePrepare(
                    view=v,
                    seq=n,
                    digest=digest,
                    requests=tuple(
                        ClientRequest(
                            **{k: val for k, val in r.items() if k != "type"}
                        )
                        for r in reqs
                    ),
                    replica=self.id,
                )
            )
            for n, digest, reqs in entries
        ]
        nv = self._sign(
            NewView(
                new_view=v,
                view_changes=tuple(vc.to_dict() for vc in vcs),
                pre_prepares=tuple(pp.to_dict() for pp in pps),
                replica=self.id,
            )
        )
        self.new_view_sent[v] = nv
        out: List[Action] = [Broadcast(nv)]
        out.extend(
            self._enter_new_view(v, min_s, self._stable_cert_for(vcs, min_s), pps)
        )
        return out

    def _on_new_view(self, nv: NewView) -> List[Action]:
        if nv.new_view < self.view or (
            nv.new_view == self.view and not self.in_view_change
        ):
            return []
        if nv.replica != self.config.primary_of(nv.new_view):
            return []
        try:
            vcs = [Message.from_dict(dict(d)) for d in nv.view_changes]
            pps = [Message.from_dict(dict(d)) for d in nv.pre_prepares]
        except (KeyError, TypeError, ValueError):
            return []
        # V: 2f+1 distinct, correctly signed, valid view-changes for this view.
        if len(vcs) < 2 * self.config.f + 1:
            return []
        seen: Set[int] = set()
        for vc in vcs:
            if not isinstance(vc, ViewChange) or vc.new_view != nv.new_view:
                return []
            if vc.replica in seen:
                return []
            if not self._verify_inline(vc.replica, vc.signable(), vc.sig):
                return []
            if not self._validate_view_change(vc):
                return []
            seen.add(vc.replica)
        # O must equal our own recomputation from V (a Byzantine new primary
        # cannot smuggle in requests nobody prepared).
        min_s, entries = self._compute_o(vcs)
        if len(pps) != len(entries):
            return []
        for pp, (n, digest, _reqs) in zip(pps, entries):
            if not isinstance(pp, PrePrepare):
                return []
            if (pp.view, pp.seq, pp.digest) != (nv.new_view, n, digest):
                return []
            if pp.replica != nv.replica or pp.batch_digest() != pp.digest:
                return []
            if not self._verify_inline(pp.replica, pp.signable(), pp.sig):
                return []
        return self._enter_new_view(
            nv.new_view, min_s, self._stable_cert_for(vcs, min_s), pps
        )

    def _enter_new_view(
        self,
        v: int,
        min_s: int,
        stable_cert: Optional[Tuple[str, List[dict]]],
        pps: List[PrePrepare],
    ) -> List[Action]:
        # Tentative executions do not survive a view change (§5.3): roll
        # the uncommitted suffix back BEFORE processing the new view's O
        # — its re-issued pre-prepares re-run the three-phase protocol
        # and re-execute whatever the quorum actually prepared.
        self._rollback_tentative()
        self.view = v
        self.in_view_change = False
        self.pending_view = 0
        if self.wal is not None:
            self.wal.note_view(v, False, 0)
        self._my_view_change = None
        # Keep only the NEW-VIEW for the view we just entered (the one a
        # laggard's retransmitted VIEW-CHANGE may still need); older
        # entries can never be asked for again.
        self.new_view_sent = {
            w: m for w, m in self.new_view_sent.items() if w >= v
        }
        self._sealed_ts = {}  # per-view primary ordering memory
        self.counters["view_changes_completed"] += 1
        vh = self.view_hook
        if vh is not None:
            vh("new_view_installed", v)
        for past in [w for w in self.view_changes if w <= v]:
            del self.view_changes[past]
        out: List[Action] = []
        if min_s > self.low_mark and stable_cert is not None:
            stable_digest, stable_proof = stable_cert
            out.extend(self._advance_watermark(min_s, stable_digest))
            # Adopt the certificate with the watermark: our next
            # VIEW-CHANGE's C component must certify THIS stable seq.
            self.stable_proof = stable_proof
            self._wal_checkpoint(min_s)
        # The new primary continues the sequence after the re-issued slots;
        # harmless for backups (their seq_counter is unused until they lead).
        # low_mark is included: when this replica's stable checkpoint is
        # ahead of min_s (its view-change wasn't among the 2f+1 lowest ids),
        # seqs <= low_mark are already executed everywhere and would never
        # reply if re-assigned.
        self.seq_counter = max(
            self.low_mark, min_s, max((pp.seq for pp in pps), default=min_s)
        )
        # Prune normal-case log entries from abandoned views above min_s that
        # the quorum did not re-issue: they can never prepare in view v, and
        # keeping them makes has_unexecuted() fire the request timer forever.
        reissued = {pp.seq for pp in pps}
        for log in (self.pre_prepares, self.prepares, self.commits):
            for key in [k for k in log if k[0] < v and k[1] not in reissued]:
                del log[key]
        for pp in pps:
            out.extend(self._on_pre_prepare(pp))
        # Re-aim forwarded-but-unexecuted client requests at the NEW
        # primary: a request forwarded to a primary that was
        # just voted out evaporated with the old view — without this the
        # only recovery is the client's retransmission timer, and until
        # it fires the request timers keep escalating further view
        # changes with nothing to order (the storm the chaos bench
        # measures). Exactly-once is untouched: duplicates die on the
        # per-client timestamp guards wherever they land.
        for client, req in list(self._forwarded.items()):
            last = self.last_timestamp.get(client)
            if last is not None and req.timestamp <= last:
                self._forwarded.pop(client, None)  # already executed
                continue
            if self.config.primary_of(v) == self.id:
                out.extend(self.on_client_request(req))
            else:
                out.append(Send(self.config.primary_of(v), req))
        return out

    def _advance_watermark(
        self, stable_seq: int, stable_digest: str
    ) -> List[Action]:
        if stable_seq <= self.low_mark:
            return []
        if self.config.tentative and stable_seq > self.committed_upto:
            # A 2f+1 quorum checkpointed past our committed floor: the
            # tentative suffix we hold may not match the certified chain
            # — revert to the committed point and catch up through the
            # certified state (the state-transfer branch below).
            self._rollback_tentative()
        self.low_mark = stable_seq
        self.counters["checkpoints_stable"] += 1
        out: List[Action] = []
        if stable_seq > self.executed_upto:
            # We missed executions that 2f+1 replicas checkpointed, and the
            # pruning below deletes the messages that would replay them:
            # fetch the certified checkpoint state from a peer (PBFT §5.3).
            # Execution stalls (executed_upto stays) until a StateResponse
            # whose payload hashes to stable_digest arrives; the runtime
            # re-broadcasts the request on its retry timer.
            self.awaiting_state = (stable_seq, stable_digest)
            out.append(
                Broadcast(
                    self._sign(StateRequest(seq=stable_seq, replica=self.id))
                )
            )
        for log in (self.pre_prepares, self.prepares, self.commits):
            for key in [k for k in log if k[1] <= stable_seq]:
                del log[key]
        self.sent_commit = {k for k in self.sent_commit if k[1] > stable_seq}
        for seq in [s for s in self.checkpoints if s <= stable_seq]:
            del self.checkpoints[seq]
        for seq in [s for s in self.pending_execution if s <= stable_seq]:
            del self.pending_execution[seq]
        for seq in [s for s in self.snapshots if s < stable_seq]:
            del self.snapshots[seq]
        return out
