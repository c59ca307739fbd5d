"""gpu_evidence — one-command evidence capture on the card: the port's
counterpart of the reference's ``scripts/tpu_evidence.py``, renamed because
nothing in it runs on a TPU.

Each step runs in a killable subprocess with its own timeout (a step that
hangs is cut and the next one runs); a result that is empty or holds an
error is rejected, and a rejected step makes the exit code 1. Every step's
JSON line is printed and written to ``--out-dir`` (default ``evidence/`` at
the repository's root, which git ignores):

  kernel    verify_many at B = 4,096 (a replayed CUDA graph): verifies/s   -> kernel.json
            (``value``) on a pool with one invalid item at B // 2, every
            verdict held against the RFC 8032 oracle; the host time of one
            ``cudaGraphLaunch`` of the bare window (``graph_launch_us``)
            and the window's ms. ``launch_cost_model --kernel`` and
            ``window_sweep --kernel`` read this line.
  decomp    (a) the reference's component rates, each by data-dependent    -> decomp.json
            chaining (64 applications, 16 for SHA-512) captured in one CUDA
            graph and timed by CUDA events: field_mul_per_sec,
            carry_per_sec (the 4 carry passes of a multiply alone),
            carry_share_of_mul, sha512_32B_per_sec; (b) the device ms of
            each stage of one replayed 4,096 window, as
            ``crypto/ed25519.py`` ``verify_kernel`` runs them: SHA-512 of
            R || A || M, mod L (with the S parse and range check),
            decompress (``pow_p58`` inside), the ladder, compress (``inv``
            inside) and the final compare, each captured as its own graph
            on the previous stage's outputs, beside the whole window:
            CUDA-event ms, the profiler's device busy ms and device
            activities (kernels and copies) per replay, each stage's
            outputs against the eager path's, and the stages' busy ms over
            the whole window's busy ms (``stages_over_window``; the
            replayed ms of stages and window, which also hold the idle
            gaps between a graph's kernels, are in ``stages_ms`` and
            ``window.ms``).
  profile   a torch.profiler trace of two replays of the 4,096 window      -> profile/ (chrome trace), profile.json
            (device busy ms and kernels per window)
  protocol  bench.harness --arm native-cuda (4 pbftd -> the port's         -> protocol.jsonl, protocol.json
            daemon on the card), configs 0-1, config 1 also with two
            launches in flight

    python -m pbft_tpu_torch.scripts.gpu_evidence                 # every step
    python -m pbft_tpu_torch.scripts.gpu_evidence --steps kernel,decomp \\
        --out-dir /tmp/ev

Every line names the card (``device``) and its power limit. There is no
fallback: a step raises without CUDA, and the capture fails.

Differences from the reference: no ``pallas`` step (the port's kernels are
always on: there is no switch to compare); no ``--skip-probe`` or
``--tag`` (no tunnel to wait out; the card is probed by each step); the
``kernel`` step times the port's verify_many directly rather than through
``bench.py``; ``decomp`` adds the per-stage split; the outputs go to
``--out-dir``, never to ``benchmarks/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..crypto import batch as B
from ..crypto import ed25519 as E
from ..crypto import field as F
from ..crypto import kernels, ref
from ..crypto.sha512 import sha512
from ..device import resolve_device

REPO = Path(__file__).resolve().parents[2]
STEPS = ("kernel", "decomp", "profile", "protocol")
BATCH = 4096
CHAIN = 64  # chained applications per rate (16 for SHA-512)
SHA_CHAIN = 16
MIN_TIMED_S = 1.0  # each rate is timed over at least this long
T0 = time.monotonic()


def log(msg: str) -> None:
    print(f"[gpu_evidence +{time.monotonic() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def parse_result(stdout: str) -> Optional[dict]:
    """The last ``{...}`` line of a step's output, or None."""
    for line in reversed((stdout or "").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                return None
    return None


def run_step(name: str, cmd, timeout: float, out_dir: Optional[Path] = None,
             out_json: Optional[str] = None) -> Optional[dict]:
    """Run one step in a killable subprocess; its result is the last JSON
    line of its stdout. A step that printed its result and then hung in
    teardown still counts. An empty result, or one with an ``error`` or a
    zero ``value``, is rejected (None)."""
    log(f"step {name}: {' '.join(map(str, cmd))}")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    try:
        proc = subprocess.run(list(map(str, cmd)), env=env, cwd=REPO, capture_output=True, text=True,
                              timeout=timeout)
        stdout, stderr, rc = proc.stdout, proc.stderr, proc.returncode
    except subprocess.TimeoutExpired as e:
        log(f"step {name}: TIMEOUT after {timeout} s")
        stdout = e.stdout if isinstance(e.stdout, str) else (e.stdout or b"").decode(errors="replace")
        stderr = e.stderr if isinstance(e.stderr, str) else (e.stderr or b"").decode(errors="replace")
        rc = -1
    sys.stderr.write((stderr or "")[-4000:])
    result = parse_result(stdout)
    if rc != 0:
        log(f"step {name}: rc={rc}")
    if result is not None and (result.get("error") or ("value" in result and not result.get("value"))):
        log(f"step {name}: rejected error result: {result}")
        result = None
    if out_json and result is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / out_json
        path.write_text(json.dumps(result) + "\n")
        log(f"step {name}: wrote {path}")
    return result


# ---------------------------------------------------------------------------
# The steps (each runs in its own process: ``--worker STEP``).
# ---------------------------------------------------------------------------


def card_info() -> dict:
    """The card's name and power limit, as nvidia-smi gives them, and the
    torch and CUDA versions."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in smi.split(",", 1))
    except (OSError, IndexError, ValueError, subprocess.TimeoutExpired):
        name, limit = torch.cuda.get_device_name(0), None
    return {"device": name, "power_limit": limit, "torch": torch.__version__, "cuda": torch.version.cuda}


def signed_pool(batch: int, signers: int = 16):
    """(items, want): ``batch`` rows cycling over ``signers`` signed
    (key, message) pairs, the row at ``batch // 2`` with a corrupted
    signature; ``want`` is the RFC 8032 oracle's verdict per row (checked
    once per distinct item)."""
    distinct = []
    for i in range(signers):
        seed = bytes([i + 1]) * 32
        msg = bytes([0x5A ^ i]) * 32
        distinct.append((ref.public_key(seed), msg, ref.sign(seed, msg)))
    pub, msg, sig = distinct[(batch // 2) % signers]
    bad = (pub, msg, bytes([sig[0] ^ 0x01]) + sig[1:])
    verdict = [ref.verify(*it) for it in distinct]
    items = [distinct[i % signers] for i in range(batch)]
    want = [verdict[i % signers] for i in range(batch)]
    items[batch // 2] = bad
    want[batch // 2] = ref.verify(*bad)
    return items, want


def _tuple(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


# The stages of one window, as ed25519.verify_kernel runs them: (name, the
# stage's function, the names of its inputs, the names of its outputs).
# A window starts from pub, msg and sig; ``valid`` is its verdict.


def _stage_sha512(pub, msg, sig):
    return sha512(torch.cat([sig[..., :32], pub, msg], dim=-1))


def _stage_mod_l(h_raw, sig):
    s = F.bytes_to_limbs(sig[..., 32:])
    return F.reduce512_mod_l(F.bytes_to_limbs(h_raw)), s, F.scalar_lt_l(s)


def _stage_decompress(pub):
    ok, point = E.decompress(pub)
    return (ok, *point)


def _stage_ladder(s, h, ax, ay, az, at):
    return kernels.ladder(F.scalar_bits(s), F.scalar_bits(h), E.point_neg((ax, ay, az, at)))


def _stage_compress(px, py, pz, pt):
    return E.compress((px, py, pz, pt))


def _stage_compare(enc, sig, ok_a, s_ok):
    return ok_a & s_ok & torch.all(enc == sig[..., :32], dim=-1)


STAGES = (
    ("sha512", _stage_sha512, ("pub", "msg", "sig"), ("h_raw",)),
    ("mod_l", _stage_mod_l, ("h_raw", "sig"), ("h", "s", "s_ok")),
    ("decompress", _stage_decompress, ("pub",), ("ok_a", "ax", "ay", "az", "at")),
    ("ladder", _stage_ladder, ("s", "h", "ax", "ay", "az", "at"), ("px", "py", "pz", "pt")),
    ("compress", _stage_compress, ("px", "py", "pz", "pt"), ("enc",)),
    ("compare", _stage_compare, ("enc", "sig", "ok_a", "s_ok"), ("valid",)),
)
# The CUDA kernel each stage launches (kernels.KERNELS names).
STAGE_KERNELS = {"sha512": "sha512", "decompress": "p58", "ladder": "ladder", "compress": "inv"}


def run_stages(pub, msg, sig) -> dict:
    """Every stage eagerly, in order: the window's values by name, from
    ``pub``, ``msg`` and ``sig`` (uint8 tensors) to ``valid``."""
    env = {"pub": pub.to(torch.uint8), "msg": msg.to(torch.uint8), "sig": sig.to(torch.uint8)}
    for _, fn, ins, outs in STAGES:
        env.update(zip(outs, _tuple(fn(*(env[k] for k in ins)))))
    return env


def _device_tensors(items, dev):
    pubs, msgs, sigs, _ = B.pad_batch(items, len(items))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pubs, msgs, sigs))


def _graph(fn, inputs, prime: bool = True):
    """``fn(*inputs)`` captured once as a CUDA graph over the static device
    tensors ``inputs``, after one eager run on a side stream (constants and
    the kernel libraries are loaded there, outside the capture; without
    ``prime``, an earlier eager run of the same ops has loaded them).
    Returns the graph and its static outputs."""
    if prime:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*inputs)
        torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with kernels.recording(), torch.cuda.graph(graph):
        outs = _tuple(fn(*inputs))
    torch.cuda.synchronize()
    return graph, outs


def _replay_ms(graph, reps: int) -> float:
    """Mean ms per replay over ``reps`` back-to-back replays (CUDA events),
    after one untimed replay."""
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _launch_us(graph, reps: int = 10) -> float:
    """Median host µs of one ``cudaGraphLaunch`` (``replay()`` returning),
    each on an idle card."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


def _profiled(fn) -> dict:
    """One call of ``fn`` under torch.profiler: the device's busy ms and
    its activities (kernels, copies, sets), summed over the call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"busy_ms": sum(e.device_time_total for e in dev) / 1e3, "activities": len(dev)}


def _timed_rate(fn, per_call: int) -> float:
    """Items per second of ``fn`` over at least ``MIN_TIMED_S`` (each call
    ends in a synchronize)."""
    reps, t0 = 0, time.perf_counter()
    while reps == 0 or time.perf_counter() - t0 < MIN_TIMED_S:
        fn()
        torch.cuda.synchronize()
        reps += 1
    return reps * per_call / (time.perf_counter() - t0)


def step_kernel(batch: int, out_dir: Path) -> dict:
    dev = resolve_device()
    items, want = signed_pool(batch)
    t0 = time.perf_counter()
    got = B.verify_many(items, device=dev)  # captures the window
    capture_s = time.perf_counter() - t0
    if got != want:
        raise RuntimeError(f"verify_many disagrees with the oracle on rows "
                           f"{[i for i, (a, b) in enumerate(zip(got, want)) if a != b][:8]}")
    rate = _timed_rate(lambda: B.verify_many(items, device=dev), batch)
    log("kernel: verify_many timed")
    inputs = _device_tensors(items, dev)
    graph, (valid,) = _graph(E.verify_kernel, inputs)
    graph.replay()
    if valid.cpu().tolist() != want:
        raise RuntimeError("the bare window's verdicts disagree with the oracle")
    return {
        "step": "kernel", "batch": batch, "value": rate, "verifies_per_sec": rate,
        "backend": "cuda", "verdicts_equal_oracle": True, "invalid_rows": want.count(False),
        "capture_s": capture_s, "graph_launch_us": _launch_us(graph),
        "window_ms": _replay_ms(graph, 10), **card_info(),
    }


def step_decomp(batch: int, out_dir: Path) -> dict:
    dev = resolve_device()
    rng = np.random.default_rng(0)
    out: dict = {"step": "decomp", "batch": batch}

    def chained_rate(fn, x, iters: int) -> tuple:
        def chain(v):
            for _ in range(iters):
                v = fn(v)
            return v

        t0 = time.perf_counter()
        graph, _ = _graph(chain, (x,))
        capture_s = time.perf_counter() - t0
        reps = max(1, int(MIN_TIMED_S * 1e3 / max(_replay_ms(graph, 1), 1e-3)))
        return iters * batch / (_replay_ms(graph, reps) / 1e3), capture_s

    x = torch.from_numpy(rng.integers(0, 200, (batch, F.NLIMBS), dtype=np.int32)).to(dev)
    rate, capture_s = chained_rate(lambda v: F.mul(v, v), x, CHAIN)
    # The carry passes alone, the same count as a multiply's normalizer.
    rate_c, _ = chained_rate(lambda v: F.carry(v, passes=4), x, CHAIN)
    msgs = torch.from_numpy(rng.integers(0, 256, (batch, 32), dtype=np.uint8)).to(dev)
    log("decomp: field rates done")
    # The kernel takes contiguous rows: each link copies its digest's half.
    rate_s, _ = chained_rate(lambda m: sha512(m)[:, :32].contiguous(), msgs, SHA_CHAIN)
    out.update(field_mul_per_sec=rate, field_mul_capture_s=capture_s, carry_per_sec=rate_c,
               carry_share_of_mul=rate / rate_c, sha512_32B_per_sec=rate_s)
    log("decomp: component rates done")

    items, want = signed_pool(batch)
    pub, msg, sig = _device_tensors(items, dev)
    eager = run_stages(pub, msg, sig)  # primes every stage's constants
    if eager["valid"].cpu().tolist() != want:
        raise RuntimeError("the eager stages disagree with the oracle")
    reps = 20
    whole, (valid,) = _graph(E.verify_kernel, (pub, msg, sig), prime=False)
    window = {"ms": _replay_ms(whole, reps), **_profiled(whole.replay)}
    if valid.cpu().tolist() != want:
        raise RuntimeError("the whole window's verdicts disagree with the oracle")
    log("decomp: the whole window done")
    stages = []
    for name, fn, ins, outs in STAGES:
        # Each stage's static inputs: the previous stages' eager outputs.
        graph, got = _graph(fn, tuple(eager[k].clone() for k in ins), prime=False)
        graph.replay()
        torch.cuda.synchronize()
        equal = all(torch.equal(g, eager[k]) for g, k in zip(got, outs))
        if not equal:
            raise RuntimeError(f"stage {name}: the replayed outputs differ from the eager path's")
        stages.append({"stage": name, "kernel": STAGE_KERNELS.get(name), "ms": _replay_ms(graph, reps),
                       **_profiled(graph.replay), "outputs_equal_eager": equal})
        log(f"decomp: stage {name} done")
    stage_ms = sum(s["ms"] for s in stages)
    stage_busy_ms = sum(s["busy_ms"] for s in stages)
    # Device time against device time: a replay's CUDA-event ms also holds
    # the idle gaps between a graph's kernels, which vary with the host from
    # one replay to the next (a stage's replayed ms ran 1.0-1.25x its busy ms
    # on an H100 80GB HBM3 at 700 W).
    out.update(window=window, stages=stages, stages_ms=stage_ms, stages_busy_ms=stage_busy_ms,
               stages_over_window=stage_busy_ms / window["busy_ms"], verdicts_equal_oracle=True, **card_info())
    return out


def step_profile(batch: int, out_dir: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device()
    items, want = signed_pool(batch)
    graph, (valid,) = _graph(E.verify_kernel, _device_tensors(items, dev))
    graph.replay()
    if valid.cpu().tolist() != want:
        raise RuntimeError("the window's verdicts disagree with the oracle")
    trace_dir = out_dir / "profile"
    trace_dir.mkdir(parents=True, exist_ok=True)
    replays = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log("profile: traced")
    trace = trace_dir / "trace.json"
    prof.export_chrome_trace(str(trace))
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in dev_events) / 1e3
    return {
        "step": "profile", "batch": batch, "replays": replays, "wall_ms": wall_ms / replays,
        "device_busy_ms": busy_ms / replays, "kernels_per_window": len(dev_events) / replays,
        "idle_share": 1 - busy_ms / wall_ms if wall_ms else None, "trace": str(trace), **card_info(),
    }


WORKERS = {"kernel": step_kernel, "decomp": step_decomp, "profile": step_profile}

# The protocol step: (config, the daemon's launches in flight).
PROTOCOL_RUNS = ((0, 1), (1, 1), (1, 2))


def _protocol(out_dir: Path, timeout: float) -> Optional[dict]:
    """Configs 0-1 through bench.harness --arm native-cuda (config 1 also
    with two launches in flight), each run a step of its own; the rows go
    to ``protocol.jsonl``. None unless every run gave a row."""
    rows = []
    for cfg, inflight in PROTOCOL_RUNS:
        res = run_step(
            f"protocol-{cfg}-in{inflight}",
            [sys.executable, "-m", "pbft_tpu_torch.bench.harness", "--arm", "native-cuda", "--config", cfg,
             "--service-inflight", inflight, "--trace-dir", out_dir / f"traces_cfg{cfg}_in{inflight}"],
            timeout=timeout,
        )
        if res is not None:
            rows.append(res)
    if len(rows) != len(PROTOCOL_RUNS):
        return None
    path = out_dir / "protocol.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return {"step": "protocol", "rows": len(rows), "path": str(path),
            "requests_per_sec": [r["requests_per_sec"] for r in rows]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", default=",".join(STEPS), help=f"comma-separated from {STEPS}")
    parser.add_argument("--out-dir", default=str(REPO / "evidence"))
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--timeout", type=float, default=900.0, help="seconds per step")
    parser.add_argument("--worker", choices=sorted(WORKERS), default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    out_dir = Path(args.out_dir)

    if args.worker:
        try:
            result = WORKERS[args.worker](args.batch, out_dir)
        except Exception as e:  # noqa: BLE001 - the parent rejects the line
            result = {"step": args.worker, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(result), flush=True)
        return 1 if "error" in result else 0

    steps = [s.strip() for s in args.steps.split(",") if s.strip()]
    unknown = set(steps) - set(STEPS)
    if unknown:
        parser.error(f"unknown steps {sorted(unknown)}; known: {list(STEPS)}")
    failed = []
    for step in steps:
        if step == "protocol":
            result = _protocol(out_dir, args.timeout)
            if result is not None:
                out_dir.mkdir(parents=True, exist_ok=True)
                (out_dir / "protocol.json").write_text(json.dumps(result) + "\n")
        else:
            result = run_step(step, [sys.executable, "-m", "pbft_tpu_torch.scripts.gpu_evidence", "--worker", step,
                                     "--batch", args.batch, "--out-dir", out_dir],
                              timeout=args.timeout, out_dir=out_dir, out_json=f"{step}.json")
        if result is None:
            failed.append(step)
        else:
            print(json.dumps(result), flush=True)
    if failed:
        log(f"capture INCOMPLETE: no result from steps {failed}")
        return 1
    log("capture complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
