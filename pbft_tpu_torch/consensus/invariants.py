"""Machine-checked PBFT safety/liveness invariants.

What "correct under faults" MEANS, as executable checks — the piece the
happy-path integration tests structurally cannot provide (Jepsen's lesson;
Twins for the BFT case). Two consumers:

- ``InvariantChecker`` runs against a live ``simulation.Cluster`` after every
  scheduler step (scripts/chaos_soak.py). Safety checks hold under ANY fault
  load as long as at most f replicas are faulty; the liveness check is only
  promised once partitions heal and the faulty set is back within budget.
- ``check_spans`` runs against real-cluster trace data: the per-(view, seq)
  phase-stamp slots that scripts/consensus_timeline.py builds from the
  ``consensus_span`` events (``--check-invariants``).

The safety invariants:

S1  chain-digest prefix agreement — no two honest replicas ever disagree on
    the execution-chain digest at the same sequence number. The chain digest
    is a fold of every executed (result, seq), so equality at seq s implies
    agreement on the entire prefix [1, s] — batch digests included.
S2  per-(client, timestamp) exactly-once — an honest replica never emits two
    different results for one client timestamp (cached-reply resends carry
    the identical result by construction).
S3  executed => committed-with-quorum — an honest replica only advances
    executed_upto through a sequence for which 2f+1 distinct replicas sent
    COMMIT for one digest (normal case) or a 2f+1 checkpoint certificate at
    or beyond it exists (state-transfer catch-up). Evidence is tallied from
    messages replicas SEND (the cluster's sent_observer feed), so link-level
    drops cannot mask a quorum that never existed.
S5  restart never double-votes — a replica restarted from its
    write-ahead log never sends a pre-prepare/prepare/commit whose digest
    contradicts a vote it had PERSISTED before the crash (same kind, view,
    seq, different digest). The pre-crash vote map is snapshotted by
    ``Cluster.restart``; every post-restart send is checked against it.
    An amnesiac (fresh-state) restart is exactly what can violate this —
    which is why the checker exists.

The liveness invariant:

L1  with partitions healed and <=f faulty, every submitted request
    eventually collects f+1 matching replies from distinct replicas.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from .messages import (
    Checkpoint,
    ClientRequest,
    Commit,
    NewView,
    Prepare,
    PrePrepare,
)
from .simulation import Cluster


class InvariantViolation(AssertionError):
    """A safety invariant failed — carries the machine-readable detail."""

    def __init__(self, name: str, detail: str):
        super().__init__(f"{name}: {detail}")
        self.name = name
        self.detail = detail


class InvariantChecker:
    """Incremental safety checker over a live simulation cluster.

    ``faulty`` names the replicas currently EXEMPT from honesty checks —
    pass a callable (e.g. ``lambda: set(cluster.faults)``) so a schedule
    that flips fault modes mid-run keeps the exemption current. A replica
    that was EVER faulty stays exempt: its state may have been poisoned
    while Byzantine, and PBFT promises nothing about its local logs."""

    def __init__(
        self,
        cluster: Cluster,
        faulty: Optional[Callable[[], Set[int]]] = None,
    ):
        self.cluster = cluster
        self._faulty_now = faulty or (lambda: set(cluster.faults))
        self.ever_faulty: Set[int] = set()
        # Tentative mode: executions above the committed
        # floor may legitimately ROLL BACK on a view change, so the
        # checker keys its honesty rules to the floor — S1 compares the
        # chain digest AT committed_upto (the tentative suffix is
        # allowed to diverge transiently), executed_upto may decrease
        # back to the floor, and S3 accepts a 2f+1 PREPARED certificate
        # (pre-prepare + prepares from distinct senders) as the quorum
        # behind a tentative execution.
        self.tentative = bool(getattr(cluster.config, "tentative", False))
        # S1 evidence: rid -> {seq: chain digest hex observed there}.
        self.digest_at: Dict[int, Dict[int, str]] = {
            r.id: {} for r in cluster.replicas
        }
        self._last_executed: Dict[int, int] = {
            r.id: r.executed_upto for r in cluster.replicas
        }
        self._last_committed: Dict[int, int] = {
            r.id: r.committed_upto for r in cluster.replicas
        }
        # S3 evidence from sent messages: (view, seq, digest) -> commit
        # senders; (seq, digest) -> checkpoint senders; (view, seq,
        # digest) -> prepared-certificate senders (prepares + the
        # pre-prepare standing in for the primary's prepare).
        self.commit_senders: Dict[Tuple[int, int, str], Set[int]] = {}
        self.checkpoint_senders: Dict[Tuple[int, str], Set[int]] = {}
        self.prepare_senders: Dict[Tuple[int, int, str], Set[int]] = {}
        # S2 evidence: (rid, client, timestamp) -> result.
        self._reply_results: Dict[Tuple[int, str, int], str] = {}
        self._replies_seen = 0
        # S5: contradictions observed on the wire are queued
        # here (observe() runs inside message delivery, where raising
        # would corrupt the transport) and raised by the next check().
        # _seen_restarts re-baselines the monotonicity tracking when a
        # replica is restarted (its executed_upto legally drops to the
        # recovered checkpoint floor).
        self._s5_pending: List[str] = []
        self._seen_restarts: Dict[int, int] = {}
        self.violations: List[InvariantViolation] = []
        _VOTE_KINDS = {PrePrepare: 1, Prepare: 2, Commit: 3}
        prev = cluster.sent_observer

        def observe(src: int, msg) -> None:
            if prev is not None:
                prev(src, msg)
            kind = _VOTE_KINDS.get(type(msg))
            if kind is not None:
                held = self.cluster.restart_votes.get(src, {}).get(
                    (kind, msg.view, msg.seq)
                ) if hasattr(self.cluster, "restart_votes") else None
                if held is not None and held != msg.digest:
                    self._s5_pending.append(
                        f"replica {src} sent {type(msg).__name__} "
                        f"(v={msg.view}, n={msg.seq}) digest "
                        f"{msg.digest[:16]}.. contradicting its persisted "
                        f"pre-crash vote {held[:16]}.."
                    )
            if isinstance(msg, Commit):
                self.commit_senders.setdefault(
                    (msg.view, msg.seq, msg.digest), set()
                ).add(src)
            elif isinstance(msg, Checkpoint):
                self.checkpoint_senders.setdefault(
                    (msg.seq, msg.digest), set()
                ).add(src)
            elif isinstance(msg, Prepare):
                self.prepare_senders.setdefault(
                    (msg.view, msg.seq, msg.digest), set()
                ).add(src)
            elif isinstance(msg, PrePrepare):
                # The primary's pre-prepare stands in for its prepare
                # (§4.2) — it completes the 2f+1 prepared certificate.
                self.prepare_senders.setdefault(
                    (msg.view, msg.seq, msg.digest), set()
                ).add(src)
            elif isinstance(msg, NewView):
                # A new primary's re-issued pre-prepares ride INSIDE the
                # NEW-VIEW broadcast (never as standalone sends): they
                # are its prepare-equivalent vote for every re-issued
                # slot — without this, every tentative execution right
                # after a view change looks one voter short.
                for ppd in msg.pre_prepares:
                    if not isinstance(ppd, dict):
                        continue
                    view = ppd.get("view")
                    seq = ppd.get("seq")
                    digest = ppd.get("digest")
                    if isinstance(view, int) and isinstance(seq, int) and (
                        isinstance(digest, str)
                    ):
                        self.prepare_senders.setdefault(
                            (view, seq, digest), set()
                        ).add(src)

        cluster.sent_observer = observe

    # -- helpers -------------------------------------------------------------

    def honest(self) -> Set[int]:
        self.ever_faulty |= self._faulty_now()
        return {
            r.id for r in self.cluster.replicas if r.id not in self.ever_faulty
        }

    def _quorum(self) -> int:
        return 2 * self.cluster.config.f + 1

    def _fail(self, name: str, detail: str) -> None:
        v = InvariantViolation(name, detail)
        self.violations.append(v)
        raise v

    # -- the per-step safety pass -------------------------------------------

    def check(self) -> None:
        """Run S1-S3 (+ S5 under crash-restart schedules) against current
        cluster state; raises InvariantViolation on the first failure."""
        honest = self.honest()
        quorum = self._quorum()
        # S5 first: a wire-observed double vote is the gravest finding.
        if self._s5_pending:
            self._fail("restart-vote-contradiction", self._s5_pending[0])
        # A restart legally drops executed_upto to the recovered
        # checkpoint floor: re-baseline the monotonicity tracking for
        # restarted replicas. Pre-crash S1 digest evidence
        # stays — those executions happened and re-execution of the same
        # sequences must reproduce the same digests.
        for rid, epoch in getattr(
            self.cluster, "restart_epochs", {}
        ).items():
            if self._seen_restarts.get(rid) != epoch:
                self._seen_restarts[rid] = epoch
                r = self.cluster.replicas[rid]
                self._last_executed[rid] = r.executed_upto
                self._last_committed[rid] = r.committed_upto
        for r in self.cluster.replicas:
            rid = r.id
            prev = self._last_executed[rid]
            cur = r.executed_upto
            if cur < prev:
                # Tentative mode: a rollback to (at or above) the
                # committed floor is the §5.3 view-change contract, not
                # a violation — the rolled-back suffix's S1 evidence
                # dies with it.
                if self.tentative and cur >= r.committed_upto:
                    self._last_executed[rid] = cur
                    da = self.digest_at[rid]
                    for seq in [s for s in da if s > cur]:
                        del da[seq]
                    continue
                if rid in honest:
                    self._fail(
                        "executed-monotonic",
                        f"replica {rid} executed_upto went {prev} -> {cur}",
                    )
                self._last_executed[rid] = cur
                continue
            if cur == prev:
                self._observe_committed(r)
                continue
            self._last_executed[rid] = cur
            # S1 evidence: the chain digest observed at executed_upto=cur.
            # In tentative mode the executed suffix may roll back, so the
            # cross-replica comparison keys on the COMMITTED chain
            # instead (see _observe_committed); the executed-point digest
            # is still recorded for the committed-catches-up case below.
            if not self.tentative:
                self.digest_at[rid][cur] = r.state_digest.hex()
            self._observe_committed(r)
            if rid not in honest:
                continue
            # S3: each newly executed sequence must be quorum-justified.
            for seq in range(prev + 1, cur + 1):
                if self._committed_with_quorum(r, seq, quorum):
                    continue
                if self.tentative and self._prepared_with_quorum(seq, quorum):
                    continue  # tentative execution: prepared certificate
                self._fail(
                    "executed-without-quorum",
                    f"replica {rid} executed seq {seq} with no 2f+1 commit"
                    f"/checkpoint{'/prepared' if self.tentative else ''} "
                    f"evidence",
                )
        # S1: prefix agreement across every honest pair with a common seq.
        self._check_agreement(honest)
        # S2: exactly-once on the reply stream (incremental scan).
        self._check_replies(honest)

    def _observe_committed(self, r) -> None:
        """Tentative mode's S1 feed: record the chain digest AT the
        committed floor whenever it advances — the part of the chain
        that can never roll back is what honest replicas must agree on."""
        if not self.tentative:
            return
        cur = r.committed_upto
        if cur > self._last_committed[r.id] and cur > 0:
            self._last_committed[r.id] = cur
            self.digest_at[r.id][cur] = r.committed_chain.hex()

    def _committed_with_quorum(self, replica, seq: int, quorum: int) -> bool:
        # Normal case: 2f+1 distinct commit senders on one digest at seq.
        for (view, s, digest), senders in self.commit_senders.items():
            if s == seq and len(senders) >= quorum:
                return True
        # State-transfer case: a certified checkpoint at or beyond seq.
        for (s, digest), senders in self.checkpoint_senders.items():
            if s >= seq and len(senders) >= quorum:
                return True
        return False

    def _prepared_with_quorum(self, seq: int, quorum: int) -> bool:
        """Tentative-execution justification: 2f+1 distinct senders of a
        prepared certificate (prepares + the primary's pre-prepare) on
        one digest at seq."""
        for (view, s, digest), senders in self.prepare_senders.items():
            if s == seq and len(senders) >= quorum:
                return True
        return False

    def _check_agreement(self, honest: Set[int]) -> None:
        ids = sorted(honest)
        for i, a in enumerate(ids):
            for b in ids[i + 1 :]:
                da, db = self.digest_at[a], self.digest_at[b]
                for seq in da.keys() & db.keys():
                    if da[seq] != db[seq]:
                        self._fail(
                            "chain-digest-divergence",
                            f"replicas {a} and {b} disagree at seq {seq}: "
                            f"{da[seq][:16]}.. != {db[seq][:16]}..",
                        )

    def _check_replies(self, honest: Set[int]) -> None:
        replies = self.cluster.client_replies
        for rep in replies[self._replies_seen :]:
            if self.tentative and getattr(rep, "tentative", 0):
                # A tentative reply may be superseded by a different
                # result after a rollback (the client's 2f+1 rule is
                # what makes ACCEPTED results durable) — exactly-once is
                # enforced on the committed reply stream.
                continue
            key = (rep.replica, rep.client, rep.timestamp)
            prev = self._reply_results.get(key)
            if prev is None:
                self._reply_results[key] = rep.result
            elif prev != rep.result and rep.replica in honest:
                self._fail(
                    "exactly-once",
                    f"replica {rep.replica} replied both {prev!r} and "
                    f"{rep.result!r} for ({rep.client}, t={rep.timestamp})",
                )
        self._replies_seen = len(replies)

    # -- liveness ------------------------------------------------------------

    def unreplied(
        self, submitted: Iterable[ClientRequest], f: Optional[int] = None
    ) -> List[ClientRequest]:
        """L1 probe: the submitted requests still lacking their reply
        quorum from distinct replicas — f+1 matching COMMITTED replies,
        or (tentative mode) 2f+1 matching replies overall.
        Empty list == liveness satisfied."""
        f = self.cluster.config.f if f is None else f
        votes: Dict[Tuple[str, int], Dict[str, Set[int]]] = {}
        committed_votes: Dict[Tuple[str, int], Dict[str, Set[int]]] = {}
        for rep in self.cluster.client_replies:
            votes.setdefault((rep.client, rep.timestamp), {}).setdefault(
                rep.result, set()
            ).add(rep.replica)
            if not getattr(rep, "tentative", 0):
                committed_votes.setdefault(
                    (rep.client, rep.timestamp), {}
                ).setdefault(rep.result, set()).add(rep.replica)
        missing = []
        for req in submitted:
            key = (req.client, req.timestamp)
            done = any(
                len(s) >= f + 1
                for s in committed_votes.get(key, {}).values()
            ) or any(
                len(s) >= 2 * f + 1 for s in votes.get(key, {}).values()
            )
            if not done:
                missing.append(req)
        return missing


# -- trace-data invariants (real clusters, span events) -----------------------

_PHASE_ORDER = ("request", "pre_prepare", "prepared", "committed", "executed")


def check_spans(slots: Dict) -> List[str]:
    """Invariant scan over consensus_span timeline slots
    ({(view, seq) -> {rid -> {phase -> ts}}}, the structure
    scripts/consensus_timeline.py builds). Trace data carries no digests,
    so this checks the observable protocol-order invariants:

    - phase monotonicity: within one (view, seq, replica), stamps respect
      request <= pre_prepare <= prepared <= committed <= executed;
    - executed-order: a replica's executed stamps are non-decreasing in
      sequence (in-order execution — PBFT's determinism requirement);
    - single-execution: no replica executes one sequence in two views.

    Returns a list of human-readable problem strings (empty = clean)."""
    problems: List[str] = []
    by_replica: Dict[int, List[Tuple[int, int, float]]] = {}
    seq_views: Dict[Tuple[int, int], Set[int]] = {}
    for (view, seq), per in slots.items():
        for rid, stamps in per.items():
            chain = [(p, stamps[p]) for p in _PHASE_ORDER if p in stamps]
            for (pa, ta), (pb, tb) in zip(chain, chain[1:]):
                if tb < ta:
                    problems.append(
                        f"replica {rid} (v={view}, n={seq}): {pb} stamp "
                        f"precedes {pa} ({tb:.6f} < {ta:.6f})"
                    )
            if "executed" in stamps and not stamps.get("estimated"):
                by_replica.setdefault(rid, []).append(
                    (seq, view, stamps["executed"])
                )
                seq_views.setdefault((rid, seq), set()).add(view)
    for (rid, seq), views in seq_views.items():
        if len(views) > 1:
            problems.append(
                f"replica {rid} executed seq {seq} in multiple views "
                f"{sorted(views)}"
            )
    for rid, rows in by_replica.items():
        rows.sort()
        for (s0, v0, t0), (s1, v1, t1) in zip(rows, rows[1:]):
            if t1 < t0:
                problems.append(
                    f"replica {rid}: seq {s1} executed at {t1:.6f}, before "
                    f"seq {s0} at {t0:.6f} (out-of-order execution)"
                )
    return problems


def check_view_events(events) -> List[str]:
    """Protocol-order invariants over the view-change span events
    (view_timer_fired / view_change_sent / new_view_installed —
    the per-replica ordering consensus_timeline.py --check-invariants
    enforces on real-cluster traces):

    - a replica's first view_timer_fired precedes its first
      new_view_installed (the span cannot close before it opened);
    - view_change_sent toward view v precedes new_view_installed of v on
      the same replica (sending is part of joining, when both exist —
      a pure follower may install without ever sending);
    - a replica's view_change_sent pending_view values are non-decreasing
      over time (the floor rule: a replica never campaigns backwards).

    ``events`` are trace-event dicts; returns problem strings (empty =
    clean)."""
    problems: List[str] = []
    per: Dict[int, Dict[str, list]] = {}
    for e in events:
        ev = e.get("ev")
        rid = e.get("replica")
        ts = e.get("ts")
        if not isinstance(rid, int) or not isinstance(ts, (int, float)):
            continue
        if ev == "view_timer_fired":
            per.setdefault(rid, {}).setdefault("fired", []).append(ts)
        elif ev == "view_change_sent":
            per.setdefault(rid, {}).setdefault("sent", []).append(
                (ts, e.get("pending_view"))
            )
        elif ev == "new_view_installed":
            per.setdefault(rid, {}).setdefault("installed", []).append(
                (ts, e.get("view"))
            )
    for rid, evs in per.items():
        fired = sorted(evs.get("fired", []))
        sent = sorted(evs.get("sent", []))
        installed = sorted(evs.get("installed", []))
        if fired and installed and installed[0][0] < fired[0]:
            problems.append(
                f"replica {rid}: new_view_installed at {installed[0][0]:.6f} "
                f"precedes the first view_timer_fired at {fired[0]:.6f}"
            )
        first_sent: Dict[int, float] = {}
        for ts, v in sent:
            if isinstance(v, int) and v not in first_sent:
                first_sent[v] = ts
        for ts, v in installed:
            if isinstance(v, int) and v in first_sent and ts < first_sent[v]:
                problems.append(
                    f"replica {rid}: installed view {v} at {ts:.6f} before "
                    f"sending its view-change at {first_sent[v]:.6f}"
                )
        views = [v for _, v in sent if isinstance(v, int)]
        for a, b in zip(views, views[1:]):
            if b < a:
                problems.append(
                    f"replica {rid}: view_change_sent pending_view went "
                    f"backwards ({a} -> {b})"
                )
    return problems
