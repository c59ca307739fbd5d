"""Chaos soak: seeded randomized fault schedules through the PBFT simulator,
with the safety/liveness invariants machine-checked at EVERY scheduler
step. The port's copy of the reference's ``scripts/chaos_soak.py``, on the
port's ``consensus`` (``faults.random_schedule``, ``invariants``,
``simulation.Cluster``), ``analysis.health`` and ``utils.flight``.

Per seed, per cluster size: build a Cluster, draw a ``random_schedule``
(partitions, crash/heal cycles, Byzantine modes including equivocation, link
chaos), drip client requests in while it runs, check S1-S3 after every step,
then heal everything and require L1 — every submitted request collects its
f+1 matching reply quorum. Any violation prints the seed + the schedule and
a one-command deterministic replay:

    python -m pbft_tpu_torch.scripts.chaos_soak --replay SEED [--n 4]

Determinism: one seed drives the schedule generator, the sim's chaos RNG,
and the inbox shuffle — same seed => same schedule => same verdict, in
this package and in the reference (``run_one`` is the reference's drive
loop, not ``consensus.faults.run_schedule``, whose docstring lists how it
differs).

Checker validity (a checker that can't fail is not a checker): --validate
runs an f+1-equivocator collusion (over the fault budget) and REQUIRES the
safety checker to trip.

Where the signatures are verified (``--verifier``): ``cuda`` (the default)
sends each replica's items of a step to the card in one window
(``simulation.cuda_verifier``) and raises without CUDA; ``native`` is the
C++ verify pool, ``cpu`` the RFC 8032 oracle (the CPU arms tests use).
Every result counts the verifier's calls (``windows``) and items.

Usage:
    python -m pbft_tpu_torch.scripts.chaos_soak --seeds 25 --steps 400
    python -m pbft_tpu_torch.scripts.chaos_soak --seeds 2 --steps 120 \
        --n 4 --mode sig --json                   # a smoke on the card
    python -m pbft_tpu_torch.scripts.chaos_soak --verifier native \
        --seeds 5 --steps 120 --n 4               # on the CPU
    python -m pbft_tpu_torch.scripts.chaos_soak --replay 7 --n 7
    python -m pbft_tpu_torch.scripts.chaos_soak --validate

Differences from the reference: ``--verifier`` (the reference took the
native pool when built, else the oracle; ``cuda`` is the default here);
``--json``; ``--flight-dir`` is empty by default (the reference wrote to
``chaos-blackbox``), so a run writes a file only where it is told to.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from ..analysis import health
from ..consensus import simulation
from ..consensus.faults import FaultSchedule, random_schedule
from ..consensus.invariants import (
    InvariantChecker,
    InvariantViolation,
)
from ..consensus.simulation import Cluster
from ..utils.flight import FlightRecorder

# Scheduler rounds of zero progress before the soak fires the replicas'
# view-change timers (the sim has no wall clock; this is its vc_timeout).
STALL_WINDOW = 24
# Client retransmission cadence (PBFT §4.1), deliberately DECOUPLED from
# the view-change timer: retransmitting in the same tick a view change
# starts would feed every retransmission into a round the new view kills.
RETRANSMIT_EVERY = 8


def _echo_app(operation: str, seq: int) -> str:
    """Echo app: the result IS the operation, so the execution-chain digest
    commits to the agreed request content — an equivocated batch that
    sneaks into execution diverges the chain, which is what the S1 checker
    must be able to see (the default constant-result app would mask it)."""
    return operation


VERIFIERS = ("cuda", "native", "cpu")


class CountingVerifier:
    """A simulation verifier that counts its calls and items. The cluster
    calls it once per replica per step with that replica's items (never
    with none), so on ``cuda`` each call is one window on the card."""

    def __init__(self, name: str, fn):
        self.name = name
        self._fn = fn
        self.windows = 0
        self.items = 0

    def __call__(self, items):
        self.windows += 1
        self.items += len(items)
        return self._fn(items)


def _pick_verifier(name: str = "cuda") -> CountingVerifier:
    """``cuda``: the batched verifier on the card, one window per call
    (``simulation.cuda_verifier``; raises here without CUDA, and nothing
    falls back to the host); ``native``: the C++ verify pool (raises when
    the core cannot be built); ``cpu``: the RFC 8032 oracle, item by
    item."""
    if name == "cuda":
        from ..device import resolve_device

        resolve_device()  # no card: raise before the first step
        return CountingVerifier(name, simulation.cuda_verifier)
    if name == "native":
        from .. import native

        native.lib()
        return CountingVerifier(name, native.verify_batch)
    if name == "cpu":
        return CountingVerifier(name, simulation.cpu_verifier)
    raise ValueError(f"unknown verifier {name!r}: one of {VERIFIERS}")


def _wire_flight(cluster: Cluster) -> Dict[int, FlightRecorder]:
    """One black-box flight recorder per sim replica: the phase/view
    hooks feed it the same protocol events the real daemons record
    (utils/flight.py), so a failing seed ships every replica's last
    moments — crashed replicas included, their rings are frozen in
    memory exactly where the crash left them."""
    recorders: Dict[int, FlightRecorder] = {}
    for r in cluster.replicas:
        rec = FlightRecorder(capacity=2048)
        recorders[r.id] = rec
        r.phase_hook = rec.record_phase
        r.view_hook = (
            lambda ev, v, _rec=rec: _rec.record(ev, view=v)
        )
    return recorders


def _dump_flight(
    recorders: Dict[int, FlightRecorder], flight_dir: str, seed: int, n: int
) -> List[str]:
    os.makedirs(flight_dir, exist_ok=True)
    paths = []
    for rid in sorted(recorders):
        path = os.path.join(
            flight_dir, f"seed{seed}-n{n}-replica-{rid}.flight"
        )
        recorders[rid].dump(path)
        paths.append(path)
    return paths


def run_one(
    seed: int,
    n: int,
    steps: int,
    schedule: Optional[FaultSchedule] = None,
    submit_every: int = 6,
    recovery_steps: int = 400,
    verbose: bool = False,
    flight_dir: Optional[str] = None,
    mode: str = "sig",
    crash_restart: bool = False,
    health_gate: bool = False,
    verifier: str = "cuda",
) -> dict:
    """One soak run. Returns {ok, seed, n, violation?, schedule, ...} and
    the verifier's name, calls (``windows``: one window each on
    ``cuda``) and items.

    ``mode``: "mac" soaks the fast path — per-link
    authenticator acceptance (receive_authenticated, the simulator's
    model of the MAC lanes) PLUS tentative execution with rollback, so
    the S1-S3/L1 matrix covers the authenticator+tentative protocol. A
    deterministic mid-run view change (below) guarantees every seed
    exercises a view change while tentative executions are in flight —
    the rollback path is load-bearing, not incidental.

    ``crash_restart``: every replica gets a write-ahead log
    and every crash recovery becomes a PROCESS RESTART that replays it —
    the S5 invariant (a restarted replica's post-recovery sends never
    contradict its persisted pre-crash votes) is then live alongside
    S1-S3/L1."""
    import dataclasses as _dc

    from ..consensus.config import make_local_cluster

    config, seeds = make_local_cluster(n)
    if mode == "mac":
        config = _dc.replace(config, fastpath="mac", tentative=True)
    verify = _pick_verifier(verifier)
    cluster = Cluster(config=config, seeds=seeds, seed=seed, shuffle=True,
                      verifier=verify, app=_echo_app, mode=mode,
                      wal=crash_restart)
    recorders = _wire_flight(cluster) if flight_dir else {}
    checker = InvariantChecker(cluster)
    if schedule is None:
        schedule = random_schedule(seed, n, steps,
                                   restart_from_disk=crash_restart)
    schedule.reset()
    clients = [f"10.0.0.{k}:9000" for k in range(1, 4)]
    submitted = []
    # The PBFT client contract: ONE outstanding request per client
    # (PBFT §4.1). Issuing a higher timestamp while an earlier one is
    # unreplied would let per-client exactly-once orphan the earlier
    # request forever — a client bug, not a protocol liveness failure.
    pending: dict = {c: None for c in clients}
    last_progress = (0, 0)  # (step, max honest executed)

    # --health-gate: synthetic health documents from the sim
    # replicas each tick, judged by the SAME detector library the live
    # gates use (pbft_tpu_torch/analysis/health.py). The time axis is the tick
    # index (the sim has no wall clock), so thresholds are in ticks:
    # stall = three failed rescue windows — a replica that outlives three
    # view-change rescues with pending work and flat executed_upto is
    # wedged, not slow. Stall/stuck-view verdicts only consider
    # RECOVERY-phase ticks (the schedule phase stalls legitimately under
    # partitions and crashes); divergence is unconditional safety and
    # watches every tick.
    health_history: List[dict] = []

    def health_snapshot(t: int) -> None:
        honest = checker.honest()
        outstanding = sum(1 for req in pending.values() if req is not None)
        snap: dict = {"t": float(t), "replicas": {}}
        for r in cluster.replicas:
            if r.id not in honest or r.id in cluster.crashed:
                continue
            snap["replicas"][r.id] = {
                "executed_upto": r.executed_upto,
                "committed_upto": r.committed_upto,
                "view": r.view,
                "in_view_change": r.in_view_change,
                "inbox_depth": r.pending_count(),
                "sealed_unexecuted": max(0, r.seq_counter - r.executed_upto),
                "waiting_requests": outstanding,
                "chain_digest": r.committed_chain.hex(),
            }
        health_history.append(snap)

    def health_verdicts() -> List[dict]:
        if not health_gate:
            return []
        stall_ticks = 3 * STALL_WINDOW
        recovery = [s for s in health_history if s["t"] > steps]
        return (
            health.detect_divergence(health_history)
            + health.detect_silent_stall(recovery, stall_seconds=stall_ticks)
            + health.detect_stuck_view_change(
                recovery, stall_seconds=stall_ticks
            )
        )

    def live_target() -> int:
        primary = cluster.primary_id
        if primary not in cluster.crashed:
            return primary
        for rid in range(n):
            if rid not in cluster.crashed:
                return rid
        return primary

    def refresh_pending() -> None:
        live = [req for req in pending.values() if req is not None]
        done = {
            (r.client, r.timestamp)
            for r in live
            if not checker.unreplied([r])
        }
        for c, req in list(pending.items()):
            if req is not None and (req.client, req.timestamp) in done:
                pending[c] = None

    def retransmit() -> None:
        # The client liveness rule (PBFT §4.1): rebroadcast every
        # outstanding request to every live replica — forces forwarding
        # and, with the timer trigger below, a view change on a faulty
        # primary.
        for req in pending.values():
            if req is None:
                continue
            for rid in range(n):
                if rid not in cluster.crashed:
                    cluster.submit(
                        req.operation,
                        client=req.client,
                        timestamp=req.timestamp,
                        to_replica=rid,
                    )

    def tick(t: int, in_recovery: bool) -> Optional[dict]:
        nonlocal last_progress
        cluster.step()
        try:
            checker.check()
        except InvariantViolation as v:
            return {
                "ok": False,
                "seed": seed,
                "n": n,
                "step": t,
                "violation": str(v),
                "schedule": schedule,
            }
        if health_gate:
            health_snapshot(t)
        if t % RETRANSMIT_EVERY == 5:
            retransmit()
        executed = max(
            (r.executed_upto for r in cluster.replicas
             if r.id in checker.honest() and r.id not in cluster.crashed),
            default=0,
        )
        if executed > last_progress[1]:
            last_progress = (t, executed)
        elif t - last_progress[0] >= STALL_WINDOW:
            # No progress for a whole window: the runtime-owned request
            # timers would have fired by now — suspect the primary. Fire
            # toward a COMMON target view (1 past the highest floor any
            # live replica holds): replicas bumping +1 from their own
            # skewed floors can chase each other forever without 2f+1
            # VIEW-CHANGEs ever naming one view, and the f+1 join rule
            # converges too slowly against a fixed-cadence trigger storm.
            last_progress = (t, executed)
            target = 1 + max(
                (r.pending_view if r.in_view_change else r.view)
                for r in cluster.replicas
                if r.id not in cluster.crashed
            )
            if verbose:
                print(f"    step {t}: stalled at executed={executed}; "
                      f"firing view-change timers toward view {target}")
            cluster.trigger_view_change(new_view=target)
        return None

    def with_black_box(res: dict) -> dict:
        # A failing seed ships its black boxes: one flight dump per
        # replica (decode: python -m pbft_tpu_torch.scripts.flight_dump
        # <file>).
        if recorders:
            res["flight_dumps"] = _dump_flight(recorders, flight_dir, seed, n)
        return counted(res)

    def counted(res: dict) -> dict:
        res.update(verifier=verify.name, windows=verify.windows,
                   verified_items=verify.items)
        return res

    op_counter = 0

    def submit_next() -> None:
        # Round-robin over clients, skipping any with a request still in
        # flight (one outstanding request per client, PBFT §4.1).
        nonlocal op_counter
        for c in clients:
            if pending[c] is None:
                op_counter += 1
                req = cluster.submit(f"op-{op_counter}", client=c,
                                     to_replica=live_target())
                pending[c] = req
                submitted.append(req)
                return

    for t in range(1, steps + 1):
        for ev in schedule.apply_due(cluster, t):
            if verbose:
                print(f"    step {t}: {ev.action} {list(ev.args)}")
        if t % submit_every == 0:
            submit_next()
        if mode == "mac" and t == max(2, steps // 3):
            # Mid-tentative view change: fire the timers while
            # requests are in flight so every seed exercises the §5.3
            # rollback (executions above the committed floor must revert
            # and re-run under the new view's O).
            target = 1 + max(
                (r.pending_view if r.in_view_change else r.view)
                for r in cluster.replicas
                if r.id not in cluster.crashed
            )
            if verbose:
                print(f"    step {t}: mid-tentative view change toward "
                      f"view {target}")
            cluster.trigger_view_change(new_view=target)
        fail = tick(t, in_recovery=False)
        if fail is not None:
            return with_black_box(fail)
        refresh_pending()
    # Recovery phase: the schedule's trailing cleanup healed partitions,
    # revived crashes, and cleared faults — L1 must now converge.
    for t in range(steps + 1, steps + 1 + recovery_steps):
        fail = tick(t, in_recovery=True)
        if fail is not None:
            return with_black_box(fail)
        refresh_pending()
        if not checker.unreplied(submitted):
            break
    missing = checker.unreplied(submitted)
    if missing:
        return with_black_box({
            "ok": False,
            "seed": seed,
            "n": n,
            "step": steps + recovery_steps,
            "violation": "liveness: %d of %d requests never reached their "
            "f+1 reply quorum (timestamps %s)"
            % (len(missing), len(submitted),
               [r.timestamp for r in missing[:8]]),
            "health_verdicts": health_verdicts(),
            "schedule": schedule,
        })
    verdicts = health_verdicts()
    if verdicts:
        # Completion-pct was green but a detector saw a silent stall /
        # divergence window: the failure class the health gate adds.
        return with_black_box({
            "ok": False,
            "seed": seed,
            "n": n,
            "step": steps + recovery_steps,
            "violation": "health: " + "; ".join(
                "[%s] replica=%s %s"
                % (v["detector"], v["replica"], v["reason"])
                for v in verdicts
            ),
            "health_verdicts": verdicts,
            "schedule": schedule,
        })
    return counted({
        "ok": True,
        "seed": seed,
        "n": n,
        "submitted": len(submitted),
        "executed": max(r.executed_upto for r in cluster.replicas),
        "faults_injected": cluster.faults_injected,
        "chaos_dropped": cluster.chaos_dropped,
        "health_verdicts": [],
        "schedule": schedule,
    })


def validate_checker(steps: int = 240, verbose: bool = False,
                     verifier: str = "cuda") -> dict:
    """Checker validity: f+1 colluding equivocators (n=4, f=1, TWO faulty)
    must produce a run the safety checker REJECTS. If this comes back
    clean, the checker is vacuous and every green soak is meaningless.
    The result carries the verifier's calls (``windows``) and items."""
    verify = _pick_verifier(verifier)
    cluster = Cluster(n=4, seed=1, shuffle=True, verifier=verify,
                      app=_echo_app)
    # The colluders are exempt from honesty checks — the violation must be
    # HONEST replicas 2 and 3 executing different batches at one sequence,
    # the real safety break f+1 Byzantine replicas can force.
    checker = InvariantChecker(cluster, faulty=lambda: {0, 1})
    cluster.set_fault(0, "equivocate")  # the two-face primary...
    cluster.set_fault(1, "equivocate")  # ...and its colluding backup
    for t in range(1, steps + 1):
        if t % 4 == 1:
            cluster.submit(f"op-{t}", to_replica=0)
        cluster.step()
        try:
            checker.check()
        except InvariantViolation as v:
            if verbose:
                print(f"    step {t}: checker tripped: {v}")
            return {"tripped": True, "step": t, "violation": str(v),
                    "windows": verify.windows, "verified_items": verify.items}
        if t % 40 == 0:
            cluster.trigger_view_change([2, 3])
    return {"tripped": False, "windows": verify.windows,
            "verified_items": verify.items}


def _print_failure(res: dict) -> None:
    print(f"\nFAIL seed={res['seed']} n={res['n']} at step {res['step']}:")
    print(f"  {res['violation']}")
    print("  schedule:")
    print(res["schedule"].describe())
    print(
        "  replay: python -m pbft_tpu_torch.scripts.chaos_soak --replay %d "
        "--n %d --steps %d" % (res["seed"], res["n"], res.get("steps", 0) or 0)
    )
    if res.get("flight_dumps"):
        print("  black boxes (decode: python -m "
              "pbft_tpu_torch.scripts.flight_dump FILE):")
        for p in res["flight_dumps"]:
            print(f"    {p}")


def _summary(res: dict, mode: str, steps: int) -> dict:
    """A run's result as one JSON-able line (the schedule described)."""
    out = {k: v for k, v in res.items() if k != "schedule"}
    out.update(mode=mode, steps=steps, schedule=res["schedule"].describe())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--seeds", type=int, default=25,
                        help="number of seeds to soak (0..N-1 + --seed-base)")
    parser.add_argument("--seed-base", type=int, default=0)
    parser.add_argument("--steps", type=int, default=400,
                        help="scheduler rounds under the fault schedule")
    parser.add_argument("--n", type=str, default="4,7",
                        help="comma-separated cluster sizes (default 4,7)")
    parser.add_argument("--mode", type=str, default="sig,mac",
                        help="comma-separated fast-path modes: "
                        "sig = signature-verified hot path, mac = "
                        "authenticator acceptance + tentative execution "
                        "with a forced mid-run view change (default both)")
    parser.add_argument(
        "--crash-restart", action="store_true",
        help="durable-recovery matrix: give every replica a write-ahead "
        "log and turn every crash recovery into a process RESTART that "
        "replays it; the S5 no-double-vote invariant runs alongside "
        "S1-S3/L1")
    parser.add_argument(
        "--health-gate", action="store_true",
        help="snapshot every honest live replica's health document each "
        "tick and fail the seed if the detector library finds a silent "
        "stall, divergence, or stuck view change the invariant checker "
        "missed")
    parser.add_argument("--replay", type=int, default=None,
                        help="re-run ONE seed verbosely (deterministic)")
    parser.add_argument("--validate", action="store_true",
                        help="checker validity: f+1 faulty must trip safety")
    parser.add_argument("--submit-every", type=int, default=6)
    parser.add_argument(
        "--verifier", default="cuda", choices=VERIFIERS,
        help="cuda (default: every replica's items in one window on the "
        "card per step; raises without CUDA), native (the C++ verify "
        "pool) or cpu (the RFC 8032 oracle)")
    parser.add_argument(
        "--flight-dir", default="",
        help="directory for per-replica flight-recorder dumps on failure "
        "(the black box; decode with pbft_tpu_torch.scripts.flight_dump). "
        "Empty (the default) writes none.")
    parser.add_argument("--json", action="store_true",
                        help="one JSON line per run (and per --validate)")
    args = parser.parse_args(argv)
    sizes = [int(s) for s in args.n.split(",") if s]
    modes = [m.strip() for m in args.mode.split(",") if m.strip()]

    if args.validate:
        res = validate_checker(verbose=not args.json, verifier=args.verifier)
        if args.json:
            print(json.dumps(dict(res, verifier=args.verifier)), flush=True)
        elif res["tripped"]:
            print(f"checker validity OK: f+1 equivocators tripped safety at "
                  f"step {res['step']}: {res['violation']}")
        else:
            print("checker validity FAILED: f+1 equivocators ran clean — the "
                  "safety checker is vacuous")
        return 0 if res["tripped"] else 1

    if args.replay is not None:
        rc = 0
        for mode in modes:
            for n in sizes:
                if not args.json:
                    print(f"replaying seed {args.replay} n={n} mode={mode} "
                          f"steps={args.steps}:")
                res = run_one(args.replay, n, args.steps,
                              submit_every=args.submit_every,
                              verbose=not args.json,
                              flight_dir=args.flight_dir or None, mode=mode,
                              crash_restart=args.crash_restart,
                              health_gate=args.health_gate,
                              verifier=args.verifier)
                if args.json:
                    print(json.dumps(_summary(res, mode, args.steps)), flush=True)
                elif res["ok"]:
                    print(f"  OK: {res['submitted']} requests, "
                          f"executed up to {res['executed']}, "
                          f"{res['faults_injected']} faults injected, "
                          f"{res['chaos_dropped']} chaos drops")
                else:
                    res["steps"] = args.steps
                    _print_failure(res)
                rc = rc if res["ok"] else 1
        return rc

    failures: List[dict] = []
    for i in range(args.seeds):
        seed = args.seed_base + i
        for mode in modes:
            for n in sizes:
                res = run_one(seed, n, args.steps,
                              submit_every=args.submit_every,
                              flight_dir=args.flight_dir or None, mode=mode,
                              crash_restart=args.crash_restart,
                              health_gate=args.health_gate,
                              verifier=args.verifier)
                if args.json:
                    print(json.dumps(_summary(res, mode, args.steps)), flush=True)
                elif res["ok"]:
                    print(f"seed {seed:>3} n={n} mode={mode}: OK  "
                          f"({res['submitted']} reqs, "
                          f"exec<={res['executed']}, "
                          f"{res['faults_injected']} faults, "
                          f"{res['chaos_dropped']} drops)")
                else:
                    res["steps"] = args.steps
                    res["mode"] = mode
                    _print_failure(res)
                if not res["ok"]:
                    failures.append(res)
    if args.json:
        return 1 if failures else 0
    if failures:
        print(f"\n{len(failures)} failing runs; replay any with "
              "--replay SEED --n N --steps STEPS --mode MODE")
        return 1
    print(f"\nall {args.seeds} seeds x sizes {sizes} x modes {modes} passed "
          "every safety/liveness invariant")
    return 0


if __name__ == "__main__":
    sys.exit(main())
