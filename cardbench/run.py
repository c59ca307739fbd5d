"""One run of one cell: ``python -m cardbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>``, from the root of a checkout.

Set-up (``setup_s``, from process start to the first timed request): the
config's verify service warmed on the card in this process (the kernels'
build or load, every pad shape's graphs), its ``pbftd`` replicas on
loopback with keys from the seed, the client processes, one warm-up
request through the whole path, and the traffic's ramp of closed-loop load.
Then the window of ``--seconds``; then the clients stop sending and wait
for what is outstanding, the cluster settles, and the check runs against
the plain reference once the cluster is stopped.

With ``--trace 0`` every CUDA graph replay is timed on the card's clock
(``deploy.CardClock``) for standard error's ``card clock`` line. With ``--trace 1`` the
daemon writes its per-window trace, and the load
goes on past the window for a profiled stretch (``profile.py``); the line
carries the per-layer metrics, the device's busy and window seconds and the
``breakdown``. With ``--trace 0`` it carries the end-to-end metrics.

Standard output's last line is the result; standard error's last lines are
each check's number and limit. No card (or fewer than the cell asks for), a
daemon that does not come up ready, or a JAX module loaded in this process
ends the run with a nonzero exit and no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from . import manifest

# Build and kernel caches of the program and of PyTorch, inside the checkout
# at fixed paths, so that only a checkout's first run builds.
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": "build/cardbench/torch_extensions",
    "TRITON_CACHE_DIR": "build/cardbench/triton",
    "CUDA_CACHE_PATH": "build/cardbench/cuda_cache",
}
FORBIDDEN = ("jax", "jaxlib", "flax", "pbft_tpu")
DEADLINE_S = 330  # a run must end within 360 s
REPLY_SAMPLES_PER_CLIENT = 2
REPLY_SAMPLE_RANGE = 64


def forbidden_modules(names) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's (``pbft_tpu_torch`` is not ``pbft_tpu``)."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def _nvidia_smi() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    name, limit, sm, sm_max = [x.strip() for x in out.split(",")]
    return {"name": name, "power_limit": limit, "sm_clock": sm, "sm_clock_max": sm_max}


def _cpu_s(pids) -> float:
    """User and system CPU seconds of the processes ``pids`` so far."""
    tick = os.sysconf("SC_CLK_TCK")
    total = 0
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
            total += int(fields[11]) + int(fields[12])
        except (OSError, IndexError, ValueError):
            continue
    return total / tick


def _host_load(cluster, fleet) -> dict:
    import resource

    own = resource.getrusage(resource.RUSAGE_SELF)
    return {"replicas": _cpu_s(p.pid for p in cluster.procs if p is not None),
            "clients": _cpu_s(p.pid for p in fleet.procs), "this": own.ru_utime + own.ru_stime}


def _settled(cluster, daemon, deploy, limit_s: float = 20.0) -> dict:
    """Snapshots until two in a row agree on every replica's executed
    sequence and counters and on the service's items."""
    def key(s):
        return ([(r.get("executed_upto"), r.get("executed"), r.get("sig_verified"), r.get("sig_rejected"))
                 for r in s["replicas"]], s["service"]["items"])

    prev = deploy.snapshot(cluster, daemon)
    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline:
        time.sleep(0.5)
        cur = deploy.snapshot(cluster, daemon)
        if key(cur) == key(prev):
            return cur
        prev = cur
    return prev


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float, backend: str = "cuda",
        fault: Optional[str] = None, manifest_data: Optional[dict] = None, traffic_override: Optional[dict] = None,
        engine=None) -> dict:
    """One run; returns the result (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``checks``, and with ``trace`` ``breakdown``)
    and the lines that explain it (``info``). ``backend`` ``native`` and
    ``fault`` serve the CPU tests and the control (``deploy.FAULTS``), and
    ``engine`` (a warm ``CudaVerifyEngine``) the control's runs in one
    process."""
    from . import check, deploy, drive
    from .profile import START_S, STRETCH_MAX_S, Stretch

    cell = manifest.cell(workload, manifest_data)
    config, traffic = cell["config"], dict(cell["traffic"])
    traffic.update(traffic_override or {})
    rng = random.Random(seed)
    tag = int.from_bytes(hashlib.blake2b(str(seed).encode(), digest_size=8).digest(), "big")
    scratch = tempfile.mkdtemp(prefix="cardbench-")
    daemon = cluster = fleet = None
    clock = deploy.CardClock() if backend == "cuda" and not trace else None
    try:
        service_trace = os.path.join(scratch, "service.jsonl") if trace else None
        daemon, recorder = deploy.start_daemon(config, backend, service_trace, fault, engine)
        if daemon.status_json()["state"] != ("ready" if backend == "cuda" else "cpu-only"):
            raise RuntimeError(f"the verify service is not ready: {daemon.status_json()['state']}")
        start = {"service": daemon.status_json()}
        cluster = deploy.start_cluster(config, seed, daemon.address)
        secrets = list(cluster.seeds)
        clients, per_client = traffic["clients"], traffic["outstanding_per_client"]
        sample_ks = {i: sorted(rng.sample(range(REPLY_SAMPLE_RANGE), REPLY_SAMPLES_PER_CLIENT)) for i in range(clients)}
        fleet = drive.ClientFleet(cluster.config.to_json(), clients, per_client, traffic["client_processes"], tag,
                                  sample_ks)
        fleet.wait_ready()
        from pbft_tpu_torch.net.client import PbftClient

        warm = PbftClient(cluster.config)
        try:
            warm.request_with_retry(drive.op_string(tag, 9999, 0), timeout=120, retry_every=5)
        finally:
            warm.close()
        stretch = Stretch(os.path.join(scratch, "profile.json")) if trace else None
        start_at = time.monotonic() + 0.2
        t0 = start_at + traffic["ramp_s"]
        t1 = t0 + seconds
        stop_at = t1 + (START_S + STRETCH_MAX_S if stretch is not None else 0.0)
        drain_until = stop_at + traffic["drain_s"]
        if clock is not None:
            clock.start()
        fleet.go(start_at, stop_at, drain_until)
        recorder.fault_on = True
        setup_s = t0 - t_start
        time.sleep(max(0.0, t0 - time.monotonic()))
        before = deploy.snapshot(cluster, daemon)
        load0 = _host_load(cluster, fleet)
        time.sleep(max(0.0, t1 - time.monotonic()))
        after = deploy.snapshot(cluster, daemon)
        load1 = _host_load(cluster, fleet)
        busy = {k: round((load1[k] - load0[k]) / (after["t"] - before["t"]), 3) for k in load0}
        if stretch is not None:
            _profile(stretch, recorder, stop_at)
        outs = fleet.results(max(0.0, drain_until - time.monotonic()) + 60)
        final = _settled(cluster, daemon, deploy)
        card_ms, card_replays = clock.card_ms(t0, t1) if clock is not None else (None, 0)
        device = {"platform": "gpu" if backend == "cuda" else "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
        if backend == "cuda":
            import torch

            device["kind"] = torch.cuda.get_device_name(0)
            device["memory_peak_bytes"] = int(torch.cuda.max_memory_reserved(0))
        requests = [r for o in outs for r in o["records"]]
        samples = [s for o in outs for s in o["samples"]]
        windows = list(recorder.windows)
    finally:
        if clock is not None:
            clock.stop()
        if fleet is not None:
            fleet.stop()
        if cluster is not None:
            cluster.__exit__(None, None, None)
        if daemon is not None:
            daemon.stop()
    try:
        record = {
            "t0": t0, "t1": t1, "seconds": t1 - t0, "setup_s": setup_s, "requests": requests,
            "card_ms": card_ms, "card_replays": card_replays,
            "before": before, "after": after, "windows": windows, "service_trace": _load_trace(service_trace) if trace else [],
            "profile": stretch.reduce() if stretch is not None else None,
        }
        checks, counts = check.run_checks(
            seed=seed, config=config, secrets=secrets, windows=windows, t0=t0, t1=t1, requests=requests,
            samples=samples, final=final, start=start, sent=len(requests) + 1,
        )
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = manifest.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(requests),
        "failed": sum(1 for r in requests if r["quorum"] is None),
        "metrics": metrics,
        "device": device,
    }
    if trace:
        prof = record["profile"]
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks

    result["info"] = _explain(backend, device, busy, daemon, windows, record, stretch, requests, counts, outs)
    return result


def _profile(stretch, recorder, load_until: float) -> None:
    """Profiles ``STRETCH_WINDOWS`` whole windows, or those that end within
    ``STRETCH_MAX_S`` and while the load lasts; launches are held back while
    the profiler starts and stops."""
    from .profile import STRETCH_MAX_S, STRETCH_WINDOWS

    with recorder.quiet():
        stretch.start()
        n0 = len(recorder.windows)
    until = min(time.monotonic() + STRETCH_MAX_S, load_until)
    while time.monotonic() < until and len(recorder.windows) - n0 < STRETCH_WINDOWS:
        time.sleep(0.02)
    with recorder.quiet():
        stretch.stop()


def _explain(backend, device, busy, daemon, windows, record, stretch, requests, counts, outs) -> List[str]:
    """The lines that explain a run's spread: the card and its host, the
    replay mode by padded shape, the traced stretch, the load over time."""
    from . import stats

    t0, t1 = record["t0"], record["t1"]
    info: List[str] = []
    smi = _nvidia_smi() if backend == "cuda" else {}
    info.append(f"card {device['kind']!r}; nvidia-smi {smi}; host cores {os.cpu_count()}; CPU cores busy over "
                f"the window: {busy} (replicas, client processes, this process)")
    shapes = sorted(daemon.engine.warmed_sizes) if backend == "cuda" else [16, 64, 256, 1024, 4096]
    timed = [w for w in windows if t0 <= w.start < t1]
    by_shape: dict = {}
    for w in timed:
        pad = min((s for s in shapes if s >= len(w.items)), default=len(w.items))
        by_shape.setdefault(pad, []).append((w.end - w.start) * 1e3)
    info.append("windows in the window by padded shape: " + ", ".join(
        f"{s}: {len(v)} windows, {sum(v) / len(v):.3f} wall ms each" for s, v in sorted(by_shape.items())))
    if stretch is not None:
        from . import roofline

        prof = record["profile"]
        inside = [w for w in windows if stretch.mono0 <= w.start and w.end <= stretch.mono1]
        busy_ms = prof["busy_s"] * 1e3 / max(1, len(prof["ladder"]))
        info.append(f"profiler costs {prof['costs']}")
        info.append(f"profiled stretch: {prof['window_s']:.4f} s, device busy {prof['busy_s'] * 1e3:.3f} ms, "
                    f"{prof['activities']} device activities, {len(prof['ladder'])} ladder launches, "
                    f"{len(inside)} whole windows in it; wall ms a window there "
                    f"{sum(w.end - w.start for w in inside) * 1e3 / max(1, len(inside)):.3f} against busy ms a "
                    f"launch {busy_ms:.3f}")
        by_rows: dict = {}
        for x in prof["ladder"]:
            if x["grid"] and x["s"] > 0:
                by_rows.setdefault(x["grid"][0] * roofline.LADDER_ROWS_PER_BLOCK, []).append(x["s"])
        info.append("ladder by padded rows in the stretch: " + ", ".join(
            f"{rows}: {len(v)} launches, {sum(v) / len(v) * 1e3:.4f} device ms each, roofline "
            f"{100 * roofline.bound_s('ladder', rows) * len(v) / sum(v):.3f}%" for rows, v in sorted(by_rows.items())))
        if timed and prof["ladder"]:
            info.append(f"untraced: {len(timed)} windows in the {t1 - t0:.3f} s window; at the stretch's busy ms a "
                        f"window the card would idle {100 * (1 - len(timed) * busy_ms / 1e3 / (t1 - t0)):.3f}% there")
    done = stats.completed_in(requests, t0, t1)
    if record["card_ms"] is not None:
        items = sum(len(w.items) for w in timed)
        info.append(f"card clock: {record['card_replays']} replays launched in the window, "
                    f"{record['card_ms']:.3f} device ms ({100 * record['card_ms'] / 1e3 / (t1 - t0):.3f}% of it), "
                    f"{record['card_ms'] / max(1, record['card_replays']):.4f} ms a replay; per completed request "
                    f"{record['card_ms'] / max(1, len(done)):.4f} ms and {len(timed) / max(1, len(done)):.4f} "
                    f"windows; per triple {1e3 * record['card_ms'] / max(1, items):.4f} us")
    buckets = [0] * max(1, int(round((t1 - t0) / 2)))
    for r in done:
        buckets[min(len(buckets) - 1, int((r["quorum"] - t0) / 2))] += 1
    info.append(f"completions every 2 s of the window: {buckets}")
    if done:
        lat = stats.latencies_ms(done)
        info.append("reply ms over the window's completions: " + ", ".join(
            f"p{round(q * 100)} {stats.percentile(lat, q):.3f}" for q in (0.5, 0.95, 0.99)))
    info.append(f"requests: {len(requests)} sent, {len(done)} completed in the "
                f"window; reply samples {counts['replies_sampled']}; triples in the window "
                f"{counts['items_in_window']}, {counts['items_sampled']} checked by the reference; "
                f"retransmitted {sum(o['retried'] for o in outs)}")
    return info


def _load_trace(path: str) -> List[dict]:
    out = []
    with open(path) as fh:
        for line in fh:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.monotonic() if t_start is None else t_start
    parser = argparse.ArgumentParser(prog="python -m cardbench", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(manifest.ROOT / rel)
    data = manifest.load()
    chips = manifest.cell(args.workload, data)["workload"]["chips"]
    # A run ended by a signal or its own deadline still stops every process
    # it started (the ``finally`` blocks of ``run``).
    def _end(signum, frame):
        raise SystemExit(f"cardbench: ended by signal {signum}")

    signal.signal(signal.SIGTERM, _end)
    signal.signal(signal.SIGALRM, _end)
    signal.alarm(DEADLINE_S)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start, manifest_data=data)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"cardbench: JAX modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for line in result.pop("info"):
        print(f"cardbench: {line}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
