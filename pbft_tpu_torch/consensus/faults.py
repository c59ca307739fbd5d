"""Declarative fault schedules for the chaos simulation.

A ``FaultSchedule`` is an ordered list of (step, action, args) events applied
to a ``simulation.Cluster`` as its scheduler reaches each step — the sim
analogue of a Jepsen nemesis timeline. Schedules serialize to/from JSON so a
failing chaos-soak seed prints a schedule a human can read and
``chaos_soak.py --replay SEED`` can regenerate bit-identically.

``random_schedule`` draws a schedule from one seed while tracking the live
fault budget: at most ``max_faulty`` replicas simultaneously crashed or
Byzantine (the PBFT f bound — the safety invariants only hold under it; the
checker-validity arm of chaos_soak deliberately exceeds it), and every
partition/crash/fault is cleared by ``steps`` so the liveness check has a
healed cluster to converge on.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import List, Optional, Tuple

from .simulation import FAULT_MODES, Cluster, LinkChaos

# action -> how chaos_soak narrates it on replay.
ACTIONS = (
    "partition",  # args: [[rid, ...], ...]
    "heal",  # args: []
    "crash",  # args: [rid]
    "revive",  # args: [rid]
    "restart",  # args: [rid, from_disk] — process restart
    "set_fault",  # args: [rid, mode]
    "clear_fault",  # args: [rid]
    "chaos",  # args: [drop_pct, dup_pct, delay_min, delay_max]
)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    step: int
    action: str
    args: Tuple = ()

    def to_list(self) -> list:
        return [self.step, self.action, list(self.args)]


class FaultSchedule:
    """Ordered fault events; ``apply_due`` fires everything scheduled at or
    before the cluster's current step exactly once."""

    def __init__(self, events: List[FaultEvent]):
        self.events = sorted(events, key=lambda e: e.step)
        self._next = 0

    def __len__(self) -> int:
        return len(self.events)

    def reset(self) -> None:
        self._next = 0

    def max_step(self) -> int:
        return self.events[-1].step if self.events else 0

    def apply_due(self, cluster: Cluster, step: int) -> List[FaultEvent]:
        """Apply every event with event.step <= step; returns them."""
        fired = []
        while self._next < len(self.events) and self.events[self._next].step <= step:
            ev = self.events[self._next]
            self._next += 1
            self.apply(cluster, ev)
            fired.append(ev)
        return fired

    @staticmethod
    def apply(cluster: Cluster, ev: FaultEvent) -> None:
        a = ev.args
        if ev.action == "partition":
            cluster.partition([set(g) for g in a[0]])
        elif ev.action == "heal":
            cluster.heal()
        elif ev.action == "crash":
            cluster.crash(a[0])
        elif ev.action == "revive":
            cluster.uncrash(a[0])
        elif ev.action == "restart":
            # Process restart: the Replica object dies; the
            # replacement replays its write-ahead log (from_disk) or
            # comes back amnesiac — the S5 checker watches either way.
            cluster.restart(a[0], bool(a[1]))
        elif ev.action == "set_fault":
            cluster.set_fault(a[0], a[1])
        elif ev.action == "clear_fault":
            cluster.clear_fault(a[0])
        elif ev.action == "chaos":
            drop, dup, dmin, dmax = a
            chaos = LinkChaos(
                drop_pct=drop, dup_pct=dup, delay_min=int(dmin), delay_max=int(dmax)
            )
            cluster.set_chaos(None if chaos.is_instant() else chaos)
        else:
            raise ValueError(f"unknown fault action {ev.action!r}")

    def to_json(self) -> str:
        return json.dumps([e.to_list() for e in self.events])

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        return cls(
            [FaultEvent(int(s), str(a), tuple(args)) for s, a, args in json.loads(text)]
        )

    def describe(self) -> str:
        return "\n".join(
            f"  step {e.step:>4}: {e.action} {list(e.args)}" for e in self.events
        )


def random_schedule(
    seed: int,
    n: int,
    steps: int,
    max_faulty: Optional[int] = None,
    events_every: int = 20,
    modes: Tuple[str, ...] = FAULT_MODES,
    restart_from_disk: bool = False,
) -> FaultSchedule:
    """A seeded nemesis timeline over ``steps`` scheduler rounds.

    Invariants of the generated schedule (not of the run — that is the
    checker's job): crashed+Byzantine replicas never exceed ``max_faulty``
    (default f = (n-1)//3), and a trailing cleanup block heals partitions,
    revives crashes, clears faults, and turns link chaos off so the
    recovery phase starts from a connected, fault-free cluster.

    ``restart_from_disk``: every recovery from a crash becomes
    a PROCESS RESTART from the write-ahead log ("restart" events,
    from_disk=True) instead of a memory-intact resume — the seeded
    crash-restart fault mode the chaos soak's S5 matrix drives (requires
    a Cluster built with wal=True)."""
    rng = random.Random(seed)
    f = (n - 1) // 3
    budget = f if max_faulty is None else max_faulty
    crashed: set = set()
    faulty: set = set()
    partitioned = False
    events: List[FaultEvent] = []

    def spend() -> int:
        return len(crashed | faulty)

    step = 0
    while True:
        step += rng.randint(max(2, events_every // 2), events_every + events_every // 2)
        if step >= steps:
            break
        roll = rng.random()
        if roll < 0.18 and not partitioned and n >= 4:
            members = list(range(n))
            rng.shuffle(members)
            cut = rng.randint(1, n - 1)
            groups = [sorted(members[:cut]), sorted(members[cut:])]
            events.append(FaultEvent(step, "partition", (groups,)))
            partitioned = True
        elif roll < 0.30 and partitioned:
            events.append(FaultEvent(step, "heal", ()))
            partitioned = False
        elif roll < 0.45 and spend() < budget:
            victim = rng.choice([r for r in range(n) if r not in crashed | faulty])
            crashed.add(victim)
            events.append(FaultEvent(step, "crash", (victim,)))
        elif roll < 0.58 and crashed:
            victim = rng.choice(sorted(crashed))
            crashed.discard(victim)
            if restart_from_disk:
                events.append(FaultEvent(step, "restart", (victim, True)))
            else:
                events.append(FaultEvent(step, "revive", (victim,)))
        elif roll < 0.75 and spend() < budget:
            victim = rng.choice([r for r in range(n) if r not in crashed | faulty])
            mode = rng.choice(list(modes))
            faulty.add(victim)
            events.append(FaultEvent(step, "set_fault", (victim, mode)))
        elif roll < 0.85 and faulty:
            victim = rng.choice(sorted(faulty))
            faulty.discard(victim)
            events.append(FaultEvent(step, "clear_fault", (victim,)))
        else:
            events.append(
                FaultEvent(
                    step,
                    "chaos",
                    (
                        round(rng.uniform(0.0, 0.15), 3),
                        round(rng.uniform(0.0, 0.10), 3),
                        0,
                        rng.randint(1, 4),
                    ),
                )
            )
    # Trailing cleanup: the liveness invariant is only promised once the
    # network heals and the faulty set is within budget (here: empty).
    cleanup = steps
    if partitioned:
        events.append(FaultEvent(cleanup, "heal", ()))
    for rid in sorted(crashed):
        if restart_from_disk:
            events.append(FaultEvent(cleanup, "restart", (rid, True)))
        else:
            events.append(FaultEvent(cleanup, "revive", (rid,)))
    for rid in sorted(faulty):
        events.append(FaultEvent(cleanup, "clear_fault", (rid,)))
    events.append(FaultEvent(cleanup, "chaos", (0.0, 0.0, 0, 0)))
    return FaultSchedule(events)


# The chaos soak's liveness actors: the replicas' view-change timers fire
# after this many steps without progress, and clients retransmit on their
# own, shorter cadence (retransmitting in the step a view change starts
# would feed every retransmission into a round the new view kills).
STALL_WINDOW = 24
RETRANSMIT_EVERY = 8


def run_schedule(
    cluster,
    checker,
    schedule: FaultSchedule,
    steps: int,
    submit_every: int = 3,
    recovery_steps: int = 600,
    clients: int = 3,
    view_change_at: Optional[int] = None,
) -> dict:
    """Drive ``cluster`` through ``schedule`` with the liveness rules of
    the chaos soak (``scripts/chaos_soak.py``, ``run_one``). It is not a
    copy of ``run_one`` (the JAX package's ``faults.py`` has no driver) and
    differs from it in: the caller builds the cluster, its verifier, mode
    and WAL and the checker; ``submit_every`` defaults to 3 (``run_one``:
    6), ``recovery_steps`` to 600 (400), and the number of clients is a
    parameter (3 there); the mid-run view change comes at ``view_change_at``
    (``run_one``: at max(2, steps // 3) in mode "mac"); no health gate (the
    soak's ``stall_ticks`` detectors), flight dumps or printing; a violation
    raises instead of returning ``ok: False``; and the result is the
    replicas' end states, to compare two runs, not the soak's summary.

    Each of ``clients`` clients keeps one request in flight (PBFT §4.1); a
    new one is submitted every ``submit_every`` steps while ``steps`` last,
    to the primary or, if it is crashed, the first live replica. Every
    ``RETRANSMIT_EVERY`` steps the clients resend their outstanding requests
    to every live replica; after ``STALL_WINDOW`` steps without progress the
    live replicas' view-change timers fire toward one common view (one past
    the highest any of them holds). ``view_change_at`` fires them once at
    that step as well (the mac mode's mid-tentative view change).
    ``checker.check()`` runs after every step and raises on a violation.
    After ``steps`` the run goes on until every request has its reply
    quorum, at most ``recovery_steps`` more.

    Uses only the cluster's and checker's public surface, so the JAX
    package's objects drive the same way. Returns the outcome: whether
    every request was answered, the requests and steps, and per replica
    (view, executed_upto, committed_upto, state digest)."""
    n = cluster.config.n
    names = [f"10.0.0.{k}:9000" for k in range(1, clients + 1)]
    pending = {c: None for c in names}
    submitted = []
    progress = (0, 0)  # (step, most executed by a live honest replica)

    def live_view_target() -> int:
        return 1 + max(
            (r.pending_view if r.in_view_change else r.view) for r in cluster.replicas if r.id not in cluster.crashed
        )

    def submit_next() -> None:
        for c in names:
            if pending[c] is None:
                dest = cluster.primary_id
                if dest in cluster.crashed:
                    dest = next((r for r in range(n) if r not in cluster.crashed), dest)
                pending[c] = cluster.submit(f"op-{len(submitted) + 1}", client=c, to_replica=dest)
                submitted.append(pending[c])
                return

    schedule.reset()
    t = 0
    for t in range(1, steps + recovery_steps + 1):
        if t > steps and not checker.unreplied(submitted):
            break
        schedule.apply_due(cluster, t)
        if t <= steps and t % submit_every == 0:
            submit_next()
        if t == view_change_at:
            cluster.trigger_view_change(new_view=live_view_target())
        cluster.step()
        checker.check()
        for c, req in pending.items():
            if req is not None and not checker.unreplied([req]):
                pending[c] = None
        if t % RETRANSMIT_EVERY == 5:
            for req in filter(None, pending.values()):
                for rid in range(n):
                    if rid not in cluster.crashed:
                        cluster.submit(req.operation, client=req.client, timestamp=req.timestamp, to_replica=rid)
        executed = max(
            (r.executed_upto for r in cluster.replicas if r.id in checker.honest() and r.id not in cluster.crashed),
            default=0,
        )
        if executed > progress[1]:
            progress = (t, executed)
        elif t - progress[0] >= STALL_WINDOW:
            progress = (t, executed)
            cluster.trigger_view_change(new_view=live_view_target())
    return {
        "answered": not checker.unreplied(submitted),
        "requests": len(submitted),
        "steps": t,
        "replicas": [[r.view, r.executed_upto, r.committed_upto, r.state_digest.hex()] for r in cluster.replicas],
    }
