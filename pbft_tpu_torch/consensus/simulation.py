"""In-process cluster simulation: N replica cores over an in-memory transport.

SURVEY.md §4 item 2 — the analogue of the reference's libp2p swarm for
testing: byte-faithful message passing (frames go through to_wire/from_wire so
encoding bugs can't hide), per-replica inboxes, pluggable signature-verifier
backend (the host oracle or the batched verifier on the card), and a seeded
chaos transport: per-link delay distributions, probabilistic drop/duplication,
reordering, asymmetric partitions, crash realism, and replica-level Byzantine
behavior modes (sig-corrupt / mute / stutter / equivocate). Everything the
chaos layer does is driven by one ``random.Random`` stream derived from the
cluster seed, so a failing schedule replays deterministically
(scripts/chaos_soak.py --replay SEED).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Tuple

from ..crypto import ref as crypto
from .config import ClusterConfig, make_local_cluster
from .messages import (
    Checkpoint,
    ClientReply,
    ClientRequest,
    Commit,
    Message,
    Prepare,
    PrePrepare,
    batch_digest,
    from_wire,
    to_wire,
    with_sig,
)
from .replica import Broadcast, Replica, Reply, Send, _host_sign
from .wal import WriteAheadLog

# Replica-level Byzantine behavior modes (the sim arm of the cross-runtime
# --fault flag; core/pbftd.cc and net/server.py accept the same names).
FAULT_MODES = ("sig-corrupt", "mute", "stutter", "equivocate")

# Deterministic equivocation transform: variant B of a batch mutates every
# operation with this suffix (recomputed digest, re-signed). Shared with the
# real daemons so cross-runtime tests recognize equivocated executions.
EQUIV_SUFFIX = "#equiv"


def cpu_verifier(items: List[Tuple[bytes, bytes, bytes]]) -> List[bool]:
    """Per-message host verification — the control arm (BASELINE.md config 1)."""
    return [crypto.verify(pub, msg, sig) for pub, msg, sig in items]


def cuda_verifier(items: List[Tuple[bytes, bytes, bytes]]) -> List[bool]:
    """The batched verifier on the card (imported at the first call, so a
    simulation on the ``cpu`` arm never loads the port's device code);
    sharded over the local cards like the serving paths. Raises without
    CUDA: there is no fallback to the host."""
    from ..parallel import verify_many_auto

    return verify_many_auto(items)


VERIFIERS = {"cpu": cpu_verifier, "cuda": cuda_verifier}


@dataclasses.dataclass(frozen=True)
class LinkChaos:
    """Per-link fault distribution, sampled from the cluster's seeded RNG.

    delay_min/delay_max are in *steps* (the sim's time unit): each delivery
    waits a uniform number of extra scheduler rounds, which — combined with
    per-step inbox shuffling — yields reordering. drop_pct / dup_pct are
    per-delivery probabilities in [0, 1]."""

    drop_pct: float = 0.0
    dup_pct: float = 0.0
    delay_min: int = 0
    delay_max: int = 0

    def is_instant(self) -> bool:
        return self.delay_max <= 0 and self.drop_pct <= 0 and self.dup_pct <= 0


class Cluster:
    def __init__(
        self,
        n: int = 4,
        verifier: str | Callable = "cpu",
        seed: int = 0,
        shuffle: bool = False,
        config: Optional[ClusterConfig] = None,
        seeds: Optional[List[bytes]] = None,
        app=None,
        app_factory: Optional[Callable[[], Callable]] = None,
        mode: str = "sig",
        wal: bool = False,
    ):
        if config is None:
            config, seeds = make_local_cluster(n)
        self.config = config
        self.seeds = seeds
        self._app = app
        self._app_factory = app_factory
        # Fast-path authenticator mode: "mac" models the real
        # runtimes' per-link MACs — the transport KNOWS each
        # message's true sender, so a hot-type message whose claimed
        # replica matches the sending link dispatches pre-authenticated
        # (receive_authenticated, no signature verification), an
        # impersonating claim is dropped at the link (exactly what a
        # lane-key mismatch does on the wire), and everything else
        # (view-change/new-view/state evidence) still signature-verifies.
        if mode not in ("sig", "mac"):
            raise ValueError(f"unknown fast-path mode {mode!r}")
        self.mode = mode

        def _app_kw():
            # app_factory gives each replica its OWN app instance — required
            # for stateful apps (state transfer tests); a bare `app` is
            # shared, fine for stateless callables.
            if app_factory is not None:
                return {"app": app_factory()}
            return {"app": app} if app else {}

        self.replicas = [
            Replica(config, i, seeds[i], **_app_kw()) for i in range(config.n)
        ]
        # Durable-recovery model: with wal=True each replica
        # gets an in-memory WriteAheadLog — the OBJECT plays the disk
        # (it survives a simulated crash while the Replica object is
        # discarded by restart()). restart_votes snapshots each
        # restarted replica's pre-crash persisted votes for the S5
        # checker; restart_epochs lets the checker re-baseline its
        # executed/committed monotonicity tracking across a restart.
        self.wals: Dict[int, WriteAheadLog] = {}
        self.restart_votes: Dict[int, Dict] = {}
        self.restart_epochs: Dict[int, int] = {}
        if wal:
            for r in self.replicas:
                self.wals[r.id] = WriteAheadLog()
                r.wal = self.wals[r.id]
        # Inbox entries carry the TRUE link-level sender (src, message):
        # the mac mode's authenticity model needs it, and the byte-
        # faithful round trip still runs in _route.
        self.inboxes: Dict[int, List[Tuple[int, Message]]] = {
            i: [] for i in range(config.n)
        }
        self.client_replies: List[ClientReply] = []
        self.rng = random.Random(seed)
        # The chaos layer draws from its OWN stream so enabling/disabling it
        # never perturbs the legacy shuffle stream (seeded reproducibility
        # of pre-chaos tests), while both derive from the one cluster seed.
        self.chaos_rng = random.Random((seed << 1) ^ 0xC4A05)
        self.shuffle = shuffle
        self.dropped_links: set[Tuple[int, int]] = set()  # (src, dst)
        # outbound_mutator(src, msg) -> Message | None; ad-hoc Byzantine
        # injection (the original hook; fault modes below are the
        # declarative layer on top of the same interception point).
        self.outbound_mutator: Optional[Callable] = None
        # sent_observer(src, msg): every concrete protocol message a
        # replica puts on the wire, AFTER fault-mode mutation (what was
        # actually sent, per destination) but before link drops — the
        # invariant checker's quorum-evidence feed. A Byzantine replica
        # that equivocates is observed voting both ways, which is exactly
        # the evidence model the safety checker needs.
        self.sent_observer: Optional[Callable[[int, Message], None]] = None
        self.sig_verifications = 0
        if callable(verifier):
            self.verify = verifier
        else:
            if verifier not in VERIFIERS:
                raise ValueError(f"unknown verifier {verifier!r}: one of {tuple(VERIFIERS)} or a callable")
            self.verify = VERIFIERS[verifier]
        self._timestamp = 0
        # -- chaos state ----------------------------------------------------
        self.step_count = 0
        self.crashed: set[int] = set()
        self.faults: Dict[int, str] = {}  # replica -> FAULT_MODES entry
        self.partitions: List[set] = []  # symmetric components; [] = whole
        self.default_chaos: Optional[LinkChaos] = None
        self.link_chaos: Dict[Tuple[int, int], LinkChaos] = {}
        # Delayed deliveries: (deliver_at_step, tie_break, src, dst, Message).
        self._in_flight: List[Tuple[int, int, int, int, Message]] = []
        self._flight_seq = 0
        # Per-replica history of sent messages, for the stutter mode.
        self._sent_history: Dict[int, List[Message]] = {}
        # Equivocation engine: (view, seq) -> (digest_a, digest_b,
        # variant-b requests). Shared across colluding equivocators so a
        # faulty backup's prepares/commits track the same two-face split.
        self._equiv: Dict[Tuple[int, int], Tuple[str, str, tuple]] = {}
        self.faults_injected = 0
        self.chaos_dropped = 0

    # -- client side --------------------------------------------------------

    def submit(
        self,
        operation: str,
        client: str = "127.0.0.1:9000",
        timestamp: Optional[int] = None,
        to_replica: Optional[int] = None,
    ) -> ClientRequest:
        if timestamp is None:
            self._timestamp += 1
            timestamp = self._timestamp
        req = ClientRequest(operation=operation, timestamp=timestamp, client=client)
        dest = to_replica if to_replica is not None else self.primary_id
        if dest in self.crashed:
            return req  # a crashed replica accepts no connections
        self._route(dest, dest, req)  # client link: no mutation, no drop
        return req

    @property
    def primary_id(self) -> int:
        view = max(r.view for r in self.replicas)
        return self.config.primary_of(view)

    # -- fault schedule surface ---------------------------------------------

    def set_fault(self, replica_id: int, mode: Optional[str]) -> None:
        """Install (or with ``None`` clear) a Byzantine behavior mode."""
        if mode is None:
            self.faults.pop(replica_id, None)
            return
        if mode not in FAULT_MODES:
            raise ValueError(f"unknown fault mode {mode!r}")
        self.faults[replica_id] = mode

    def clear_fault(self, replica_id: int) -> None:
        self.set_fault(replica_id, None)

    def set_chaos(
        self,
        chaos: Optional[LinkChaos],
        src: Optional[int] = None,
        dst: Optional[int] = None,
    ) -> None:
        """Attach a LinkChaos distribution: cluster-wide by default, or to
        the one directed (src, dst) link when both are given."""
        if src is None and dst is None:
            self.default_chaos = chaos
        elif src is not None and dst is not None:
            if chaos is None:
                self.link_chaos.pop((src, dst), None)
            else:
                self.link_chaos[(src, dst)] = chaos
        else:
            raise ValueError("give both src and dst, or neither")

    def partition(self, groups) -> None:
        """Split the cluster into components: links between groups are
        severed in BOTH directions (use ``dropped_links`` directly for
        asymmetric, single-direction cuts). Replicas named in no group
        form one implicit remainder component together."""
        groups = [set(g) for g in groups]
        named = set().union(*groups) if groups else set()
        rest = set(range(self.config.n)) - named
        if rest:
            groups.append(rest)
        self.partitions = groups

    def heal(self) -> None:
        """Remove every partition (symmetric cuts only — asymmetric
        ``dropped_links`` entries are the caller's to clear)."""
        self.partitions = []

    def _partitioned(self, src: int, dst: int) -> bool:
        for g in self.partitions:
            if src in g:
                return dst not in g
        return False

    # -- transport ----------------------------------------------------------

    def _route(self, src: int, dst: int, msg: Message) -> None:
        frame = to_wire(msg)  # byte-faithful round trip on every hop
        self.inboxes[dst].append((src, from_wire(frame[4:])))

    def _emit(self, src: int, actions) -> None:
        muted = self.faults.get(src) == "mute"
        for act in actions:
            if isinstance(act, Broadcast):
                for dst in range(self.config.n):
                    if dst != src:
                        self._deliver(src, dst, act.msg)
            elif isinstance(act, Send):
                if act.dest == src:
                    self._route(src, src, act.msg)  # self-delivery: no faults
                else:
                    self._deliver(src, act.dest, act.msg)
            elif isinstance(act, Reply):
                if muted:
                    self.faults_injected += 1
                    continue  # a mute replica never dials the client back
                self.client_replies.append(act.msg)

    def _deliver(self, src: int, dst: int, msg: Message) -> None:
        if (src, dst) in self.dropped_links:
            return
        if self.outbound_mutator is not None:
            msg = self.outbound_mutator(src, msg)
            if msg is None:
                return
        for out in self._apply_fault(src, dst, msg):
            if self.sent_observer is not None:
                self.sent_observer(src, out)
            self._enqueue(src, dst, out)

    # -- Byzantine behavior modes -------------------------------------------

    def _resign(self, src: int, msg: Message) -> Message:
        return with_sig(msg, _host_sign(self.seeds[src], msg.signable()).hex())

    def _equiv_variant(self, src: int, pp: PrePrepare):
        """Variant B of a pre-prepare: every operation mutated, digest
        recomputed, re-signed with the sender's own key — both variants
        carry VALID signatures, which is what makes equivocation a real
        attack rather than a corrupt-signature reject."""
        key = (pp.view, pp.seq)
        if key not in self._equiv:
            if not pp.requests:
                return None  # empty (gap-filler) batch: nothing to fork
            reqs_b = tuple(
                dataclasses.replace(r, operation=r.operation + EQUIV_SUFFIX)
                for r in pp.requests
            )
            self._equiv[key] = (pp.digest, batch_digest(reqs_b), reqs_b)
        return self._equiv[key]

    def _apply_fault(self, src: int, dst: int, msg: Message) -> List[Message]:
        """The sender-side fault engine: 0..n concrete messages out."""
        mode = self.faults.get(src)
        if mode is None:
            return [msg]
        if mode == "mute":
            self.faults_injected += 1
            return []
        if mode == "sig-corrupt":
            sig = getattr(msg, "sig", "")
            if sig:
                self.faults_injected += 1
                return [with_sig(msg, "f" * len(sig))]
            return [msg]
        if mode == "stutter":
            history = self._sent_history.setdefault(src, [])
            out = [msg]
            if history and self.chaos_rng.random() < 0.3:
                self.faults_injected += 1
                out.append(self.chaos_rng.choice(history))
            history.append(msg)
            del history[:-32]
            return out
        # equivocate: two-face delivery. The primary's pre-prepare forks
        # into (A, B); a colluding equivocator's prepares/commits for a
        # forked slot track the variant their destination saw. Group split
        # is by destination parity — deterministic, so several equivocating
        # replicas (an over-budget f+1 run) automatically collude, which is
        # exactly the scenario the safety checker must catch.
        if isinstance(msg, PrePrepare) and msg.replica == src:
            var = self._equiv_variant(src, msg)
            if var is None:
                return [msg]
            self.faults_injected += 1
            if dst % 2 == 0:
                return [msg]
            _, digest_b, reqs_b = var
            return [
                self._resign(
                    src,
                    dataclasses.replace(
                        msg, digest=digest_b, requests=reqs_b, sig=""
                    ),
                )
            ]
        if isinstance(msg, (Prepare, Commit)):
            var = self._equiv.get((msg.view, msg.seq))
            if var is not None and msg.digest in var[:2]:
                self.faults_injected += 1
                digest = var[0] if dst % 2 == 0 else var[1]
                if digest == msg.digest:
                    return [msg]
                return [
                    self._resign(
                        src, dataclasses.replace(msg, digest=digest, sig="")
                    )
                ]
        return [msg]

    # -- the chaos link ------------------------------------------------------

    def _enqueue(self, src: int, dst: int, msg: Message) -> None:
        if self._partitioned(src, dst):
            self.chaos_dropped += 1
            return
        chaos = self.link_chaos.get((src, dst), self.default_chaos)
        copies = 1
        delay = 0
        if chaos is not None and not chaos.is_instant():
            if chaos.drop_pct > 0 and self.chaos_rng.random() < chaos.drop_pct:
                self.chaos_dropped += 1
                return
            if chaos.dup_pct > 0 and self.chaos_rng.random() < chaos.dup_pct:
                copies = 2
            if chaos.delay_max > 0:
                delay = self.chaos_rng.randint(
                    min(chaos.delay_min, chaos.delay_max), chaos.delay_max
                )
        for _ in range(copies):
            if delay <= 0:
                if dst not in self.crashed:
                    self._route(src, dst, msg)
            else:
                self._flight_seq += 1
                self._in_flight.append(
                    (self.step_count + delay, self._flight_seq, src, dst, msg)
                )

    def _inject_due(self) -> None:
        if not self._in_flight:
            return
        still, due = [], []
        for entry in self._in_flight:
            (due if entry[0] <= self.step_count else still).append(entry)
        self._in_flight = still
        for _, _, src, dst, msg in sorted(due):
            if dst in self.crashed:
                self.chaos_dropped += 1  # arrived at a dead replica
                continue
            self._route(src, dst, msg)  # already fault/link-processed

    # -- scheduler ----------------------------------------------------------

    def step(self) -> bool:
        """One round: due in-flight messages land, then every live replica
        ingests its inbox, verifies the batch, processes. Returns True if
        any message moved or is still in flight."""
        self.step_count += 1
        self._inject_due()
        moved = False
        for rid, replica in enumerate(self.replicas):
            if rid in self.crashed:
                continue  # a crashed replica does no work at all
            queue, self.inboxes[rid] = self.inboxes[rid], []
            if not queue:
                continue
            moved = True
            if self.shuffle:
                self.rng.shuffle(queue)
            actions = []
            for src, msg in queue:
                if self.mode == "mac" and isinstance(
                    msg, (PrePrepare, Prepare, Commit, Checkpoint)
                ):
                    # Authenticator mode: the link proves the sender. A
                    # claim matching the sending link dispatches
                    # pre-authenticated; an impersonating claim dies at
                    # the link (the wire's lane-key mismatch). src == rid
                    # is self/client delivery — always trusted.
                    if src == rid or msg.replica == src:
                        actions.extend(replica.receive_authenticated(msg))
                    else:
                        continue
                else:
                    actions.extend(replica.receive(msg))
            items = replica.pending_items()
            if items:
                verdicts = self.verify(items)
                self.sig_verifications += len(items)
                actions.extend(replica.deliver_verdicts(verdicts))
            self._emit(rid, actions)
        return moved or bool(self._in_flight)

    def run(self, max_steps: int = 200) -> int:
        steps = 0
        while steps < max_steps and self.step():
            steps += 1
        return steps

    # -- fault / timer injection --------------------------------------------

    def crash(self, replica_id: int) -> None:
        """Crash-stop: the replica stops processing entirely — its inbox is
        discarded (no drain, no signature verification), deliveries to it
        are dropped, and ``submit(to_replica=...)`` can no longer reach it."""
        self.crashed.add(replica_id)
        self.inboxes[replica_id] = []
        self.replicas[replica_id]._inbox = []

    def uncrash(self, replica_id: int) -> None:
        """Recover a crashed replica (state intact, inbox empty — it must
        catch up via checkpoints/state transfer like a real restart)."""
        self.crashed.discard(replica_id)

    def restart(self, replica_id: int, from_disk: bool = True) -> None:
        """Crash-restart realism: unlike ``uncrash`` (which
        models a paused process resuming with its memory intact), this
        discards the Replica OBJECT — the process died — and constructs
        a fresh one: ``from_disk=True`` replays its write-ahead log
        (requires wal=True at construction), re-joining the SAME view at
        its stable-checkpoint floor with the no-contradiction guards
        armed; ``from_disk=False`` is the amnesiac restart (fresh state
        AND a blank wal) every recovery story before the WAL assumed.
        Either way the pre-crash persisted votes are snapshotted into
        ``restart_votes`` so the S5 checker can prove (or catch) the
        no-double-vote property on everything sent afterwards."""
        old = self.replicas[replica_id]
        wal = self.wals.get(replica_id)
        if wal is not None:
            self.restart_votes.setdefault(replica_id, {}).update(
                wal.state.votes
            )
        if self._app_factory is not None:
            app_kw = {"app": self._app_factory()}
        elif self._app is not None:
            app_kw = {"app": self._app}
        else:
            app_kw = {}
        fresh = Replica(
            self.config, replica_id, self.seeds[replica_id], **app_kw
        )
        # The observability hooks belong to the "host", not the process:
        # they survive the restart (chaos_soak's flight recorders).
        fresh.phase_hook = old.phase_hook
        fresh.view_hook = old.view_hook
        fresh.batch_hook = old.batch_hook
        if wal is not None:
            if from_disk:
                fresh.wal = wal
                fresh.restore_from_wal(wal.state)
            else:
                self.wals[replica_id] = WriteAheadLog()  # blank disk
                fresh.wal = self.wals[replica_id]
        self.replicas[replica_id] = fresh
        self.inboxes[replica_id] = []
        self.restart_epochs[replica_id] = (
            self.restart_epochs.get(replica_id, 0) + 1
        )
        self.crashed.discard(replica_id)

    def trigger_view_change(self, replica_ids=None, new_view=None) -> None:
        """Fire the (runtime-owned) request timers: each listed replica
        broadcasts VIEW-CHANGE (PBFT §4.4). In a real deployment the net
        layer calls Replica.start_view_change when a forwarded request
        isn't executed before its timeout."""
        if replica_ids is None:
            replica_ids = [r.id for r in self.replicas if r.id not in self.crashed]
        for rid in replica_ids:
            if rid in self.crashed:
                continue
            self._emit(rid, self.replicas[rid].start_view_change(new_view))

    # -- assertions helpers -------------------------------------------------

    def replies_for(self, timestamp: int) -> List[ClientReply]:
        return [r for r in self.client_replies if r.timestamp == timestamp]

    def committed_result(self, timestamp: int, f: Optional[int] = None) -> str:
        """The client's acceptance rule: f+1 matching replies (PBFT §4.1)."""
        f = self.config.f if f is None else f
        by_result: Dict[str, int] = {}
        seen: set[Tuple[int, str]] = set()
        for r in self.replies_for(timestamp):
            if (r.replica, r.result) in seen:
                continue  # one vote per (replica, result): dups don't count
            seen.add((r.replica, r.result))
            by_result[r.result] = by_result.get(r.result, 0) + 1
        for result, count in by_result.items():
            if count >= f + 1:
                return result
        raise AssertionError(
            f"no f+1 quorum of matching replies for t={timestamp}: {by_result}"
        )
