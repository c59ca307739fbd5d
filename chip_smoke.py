#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pbft_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # one card, no arguments

Phases, each one JSON line; any failure ends the script with a nonzero exit
and no result line, its phase and check printed on stdout (a JSON line with
"ok": false) and on stderr (the traceback and one chip_smoke line):

1. env      the card (nvidia-smi name and power limit), torch/CUDA versions,
            the kernel build from the sources in this checkout (nvcc for
            sm_90a, one process per source, all started together) with
            registers and spills; the ladder and SHA-512 kernels must not
            spill.
2. kernels  each CUDA kernel against its plain PyTorch version on the card at
            B = 4096, at 8192 (verify_many's 5,000-item window), at every
            other window shape and at the ragged sizes 1, 17 and 300: inv
            and pow_p58 on random carried limbs plus the hostile-bounds rows
            (+-1023 per limb, alternating) and zero; the ladder on random
            scalars below L and decompressed keys (small-order ones
            included), with hostile rows in place of some -A (not curve
            points); SHA-512 on random 96-byte rows with all-0x00, all-0xff
            and one-bit-apart rows first, and at 4096 also on rows of 0,
            111, 112, 128 and 200 bytes (across the padding's one-to-two
            block edge). Tolerance: exact equality of the raw limbs and
            digest bytes (digests also against hashlib on every row); at
            4096 also after canon/compress and against the big-integer
            oracle on a few curve rows.
3. verify   the first main path: verify_many at every pad shape and at
            ragged sizes, on batches signed with the port's oracle that mix in
            invalid rows; verdicts equal ref.verify row for row, and a fixed
            item set gives identical verdicts at every pad shape. Each shape's
            CUDA graph is captured at its first use, timed, before the count.
4. graphs   the compile step (pbft_tpu_torch/utils/graphs.py): three B-row
            windows in sequence through one slot's static buffers (the
            second has pad rows where the first has invalid ones), each
            replay equal to the eager on-card path (the same window op by
            op) and the oracle, the first window's verdicts unchanged after
            the others; one window's priming and capture times; an engine
            with two slots and verify_many, each from two threads at once;
            verify_many graph against eager in turns at 1,024 and 4,096; one
            replayed and one eager 4,096 window under torch.profiler (launch
            calls, device busy ms, idle share): the replayed one may make at
            most 50 kernel launch calls.
5. service  the second main path: the port's VerifyServiceDaemon warms on
            the card (a graph per shape and slot) and four client threads (an
            f = 1 cluster's replicas) send 8 requests of 1,024 triples each
            over the 128-byte protocol, with status probes between. Twice:
            with the daemon's defaults (no accumulation window, two launches
            in flight), then with a 4,096-item accumulation window
            (flush_items), which must merge requests. Verdicts correct,
            nothing served by the fallback; each then timed against a
            service with the same knobs whose backend runs the eager path
            (one turn each, 2 requests a client); then one 5,000-item engine call across the 4,096
            chunk boundary. The two daemons share one engine of two slots
            (warmed by the first), as the parallel phase's daemon does; the
            chunked call warms a one-slot engine that the protocol, asyncio
            and evidence phases' daemons share.
6. surface  the service's operator surface, at the headline window
            (flush_items=4096, flush_us=100000, the daemon's 5 shapes and
            inflight=2, metrics on): (a) the native verify pool (C++ core,
            built here with g++ unless build-core/ holds it) against the
            oracle on the pool, its verifies/s beside os.cpu_count() and the
            oracle's (64 items): the host's control arm; (b) while the daemon warms, one raw
            1,024-triple request, served by the native pool (fallback_items
            and the pool's own item count both grow by 1,024); (c) once
            ready, four port ServiceVerifier clients (an f = 1 cluster's
            replicas) send 8 requests of 1,024 triples each, none falls
            back, launches = windows x shards; (d) /metrics and /status over
            HTTP: the counters equal the status counts and the verdicts
            served, the cold compile gauge the warm's, the series set the
            manifest's; (e) that traffic with metrics on and off, in turns.
7. protocol the third main path, the protocol: BASELINE's configs 0-4
            (pbft_tpu_torch.bench.harness CONFIGS: n = 4, 4, 7, 16 and 31
            pbftd replicas, their clients and pipelines, config 4's
            Byzantine signer) at full width through the port's harness, on
            the native arm (pbftd's own C++ verify pools) and the native-cuda
            arm (every replica -> one daemon on the card, on the shared
            one-slot engine), in turns, one turn per arm, each at the
            harness's own depth (requests) but configs 0, 2, 3 and 4 at 25,
            48, 48 and 48 (cut from 100, 100, 96 and 96). Every row printed
            with the card.
            Every request commits with f + 1 matching validly signed
            replies; on the card's arm nothing is verified on the host (no
            fallback item after the warm, no verify deadline fired in the
            metrics or traces, no view change) and the daemon's items equal
            the replicas' sig_verified + sig_rejected; config 4's corrupted
            signatures are rejected on the card; launches = the daemon's
            windows x shards per config.
8. simulation the fourth main path, the Python replica cores in memory:
            BASELINE's configs 0-4 at full width and the harness's depth
            (but configs 1-3 at 25, 50 and 25 requests, cut from 200, 100
            and 50) through the port's harness (run_sim_config), on the cpu arm (the
            native pool) and the cuda arm (each step's items in windows of 256
            rows on the card, the window captured before the timed region),
            in turns, an invariant checker on every run; then one seeded fault
            schedule at n = 4 with the write-ahead log on, on both arms. Rows
            printed with the card and the capture's seconds. Every request
            commits; the arms end alike replica for replica (view,
            executed_upto, state digest, counters) with the same verifier
            calls, windows, items and rejections (config 4's Byzantine
            signatures rejected on the card), at the cpu arm's counts; no
            view change; on the cuda arm nothing verified on the host (in the
            fault run only view-change evidence, inline); launches = windows
            (+ the run's one replayed capture call).
9. asyncio  the fifth main path, the port's asyncio replica runtime
            (pbft_tpu_torch.net.server): BASELINE's configs 0-4 at full width
            as clusters of its replica processes over loopback, at 20, 64,
            20, 24 and 24 requests (cuts of the harness's 100-200). Configs
            0-2: every replica verifies its batches on the card in its own
            process (--verifier cuda: 4, 4 and 7 CUDA contexts), config 0's
            primary on an event-loop thread of this script; configs 3-4: every
            replica sends its batches to one daemon on the shared one-slot
            engine. Then two
            pbftd and two asyncio replicas commit 10 requests on that daemon.
            Rows with the card: requests/s, rounds/s, reply percentiles,
            windows per replica, ms per window, the first window's seconds
            (its capture), the compute processes nvidia-smi lists and their
            memory. Every request commits with f + 1 matching signed replies;
            every replica takes part, its verified items equal to its
            signature checks (/metrics against /status); no view change; config 4 rejects
            signatures; nvidia-smi lists one compute process per process
            that verifies on the card (replicas on the daemon hold none); on
            the daemon its items equal the replicas' checks and nothing fell
            back to the host after the warm.
10. health   the analysis layer (pbft_tpu_torch.analysis) and the operator
            scripts that read it (pbft_tpu_torch.scripts), on the port's
            asyncio replicas and one daemon on the card: (1) pbft_lint exits
            0, each of its four passes clean, with the files each read; (2)
            the daemon, a process of its own, starts on an empty --cache-dir
            (nvcc builds the kernels there), stops, and starts again on it:
            the second start compiles nothing (build_s, compiled,
            cold_compile_s, graph_pool_bytes of both); (3) that daemon serves
            chaos_bench's fault-free, crash-backup and stutter-primary arms
            at the script's shape (n = 4, 8 clients, window 8, batch 32,
            flush 2 ms, view-change timeout 600 ms, seed 12, fault at 2 s,
            heal at 6 s) but 30 requests per client (cut from 120; 320 on
            crash-backup, whose load must outlast the heal), health gate on:
            each meets its completion bar (100, 100, 97%) with no detector
            verdict, the backup crashes and heals under load and catches up,
            stutter-primary changes view; (4) pbft_top
            --gate --once (a 4 s window) over a loaded cluster exits 0; (5)
            endurance_soak for 10 s (its CI size is 180 s) with the WAL on: gate green,
            req/s, reply p50/p99, RSS, fd and WAL slopes; (6) trace_report,
            consensus_timeline and flight_dump over the crash-backup arm's
            traces and black boxes, verify_status on the daemon (ready, the
            card's name); (7) each step: the daemon's items equal the
            replicas' signature checks (a crashed replica's up to its last
            metrics line), no host fallback after ready; each kernel launched
            once per daemon window per shard (the daemon reports its counts
            in its JSON status).
11. evidence the evidence and sweep tools (pbft_tpu_torch.scripts) on the
            card: (1) gpu_evidence --steps kernel,decomp (the profile step
            dropped: the graphs phase profiles a replayed window), a process
            of its own: verify_many's rate at 4,096 with the verdicts against
            the oracle and the host time of one cudaGraphLaunch; the
            component rates (field multiply, carry, SHA-512 by chained CUDA
            graphs) and the device ms of each stage of a replayed 4,096
            window (SHA-512, mod L, decompress, ladder, compress, compare),
            each captured on the previous stage's outputs, equal to the eager
            path's, summing to within 15% of the whole window's device busy
            ms, the SHA-512 stage on its kernel (at most 8 device
            activities); every key positive. (2) chaos_soak --verifier cuda at
            n = 4, 1 seed x 120 steps in the sig and mac modes (the
            script's soak is 25 seeds x 400 steps), then --validate: every
            seed passes S1-S3 and L1, the validator trips. (3) scale_curve
            --n 4,7 --verifier daemon, 4 clients x 5 requests: both rows,
            every request completed, the daemon's items equal to the
            replicas' checks. (4) window_sweep on the daemon's cuda backend
            (the shared one-slot engine), pipeline 32 x flushes 0, 2,000 us
            at 64 requests, each row
            with its launch_cost_model projections from (1)'s rate and graph
            launch. (5) bench_compare on (3)'s rows exits 0 against them and
            1 against a copy 20% slower. Each kernel's launches equal the
            cuda_verifier's windows, or the daemon's windows, per shard.
12. bench    the port's bench entry (python -m pbft_tpu_torch.bench, the
            counterpart of bench.py), each arm a process of its own at the
            entry's defaults but PBFT_BENCH_SECS 1 (cut from 5): (1)
            --cuda-worker, 4,096 rows x a chain of 16 verify_kernel
            applications in one CUDA graph: backend cuda, a positive rate,
            its window_ms beside (1)'s of the evidence phase, each kernel
            launched once per chained application in the timed region; (2)
            the default arm with no service at its target (127.0.0.1:7600):
            it spawns the port's daemon on the card, drives it from 4
            connections x 1,024 triples and stops it: backend
            verify-service, state ready, cold_start_s, the daemon's process
            gone and nvidia-smi's compute processes as before, each kernel
            launched once per daemon window per shard (the daemon's status,
            as the entry reads it); (3) PBFT_BENCH_NATIVE=1: backend
            cpu-native; (4) PBFT_BENCH_CONSENSUS=1: 960 requests at pipeline
            64, every one committed; (5), beside (1), --cuda-worker with
            CUDA_VISIBLE_DEVICES="": exit 1, value 0.0, error backend-init,
            no backend. Every line printed with the card.
13. parallel the sixth main path, pbft_tpu_torch.parallel, on B = 4,096
            windows of COMMIT signatures for two cluster sizes: f = 1 (n = 4
            replicas, R = 1,024 rounds, threshold 3) and f = 10 (n = 31,
            R = 132, 4 pad rows at round id R, threshold 21). In each, one
            round keeps exactly its threshold of valid rows and one falls a
            row short; the state digest starts at 2^31 - 2, so the fold
            wraps in int32. (a) quorum_certify and round_step on a mesh of
            the local cards: verdicts equal the oracle row for row; counts,
            certified and the state equal a numpy model of the JAX
            semantics (round ids clipped to [0, R], an int32 running sum).
            (b) The same on a mesh of two shards on one card: bit-equal to
            (a). (c) Two processes on gloo, both on that card, each
            verifying its rows (partition_items): counts and certified equal
            on both and equal to (a). (d) The daemon over every local card:
            its status reports torch.cuda.device_count() devices and it
            serves the oracle's verdicts, on the service phase's two-slot
            engine. (a)-(c) also equal the eager path.
            (e) Per-window times (host clock after a synchronize, paths timed
            in turns) of quorum_certify in (a), (b) and (c), each beside its
            eager path, of round_step, and of verify_many on the same window;
            then one window of verify_many, (a) and (b) under torch.profiler
            (aten events, device busy ms, CUDA runtime calls).
14. timing  CUDA-event times of each kernel's wrapper and of its plain
            version at B = 4096, the bound of each (per pipe, below), the
            time of ladder_digits (the ladder wrapper's one torch op), a
            256-row verify_many window of 3 items (the simulation's shape),
            the verify_many rate at 4096 and the service rates, beside the
            card's name and power limit.

Launch counts are set to 0 just before each path (verify_many; each service
run, after its warmup; the chunked call; each protocol config, after its
daemon's warmup; each simulation run, after the window's
first capture; config 0's in-process primary of the asyncio phase, after its
warmup and a capture of shapes 16, 64 and 256 in this process, against that
replica's windows; each asyncio daemon run and the mixed cluster, after the
daemon's warm; the health phase's daemon, read from its status after its
warm and at the phase's end; the evidence phase's chaos soak and window
sweep, and each scale_curve point, read from its daemon's status; the bench
entry's card arm, over its timed region, and its spawned daemon, over the
entry's traffic, each read in the entry's process; each parallel path, in
each of its processes)
and read just after it: every kernel must have launched exactly
once per window per shard that the path formed. A replay counts the
launches its graph recorded at capture; every path's shapes are captured
(and their eager priming runs launched) before its count starts.

The line before the last is the kernel table ({"kernels": [...]}, each row
with the stage of a window that runs it and that stage's device ms from the
evidence phase); the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import glob
import json
import os
import queue
import re
import socket
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

B = 4096
VERIFY_SIZES = (16, 64, 256, 1024, 4096, 1, 17, 300, 5000)  # 5000 pads to 8192
SEED = 0x5EED
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# sm_90, per SM and clock: 64 int32 results on the IMAD pipe (multiply,
# multiply-add), 64 on the ALU pipe (and, shift, add), and one warp
# instruction issued by each of the 4 schedulers (128 results).
IMAD_PER_CLK_PER_SM = 64
ALU_PER_CLK_PER_SM = 64
SCHEDULER_PER_CLK_PER_SM = 128

# The least int32 operations per item, as (IMAD, ALU), in radix 2^8 with the
# carry schedule of field.py (so the same integers and bounds proof). A
# column's products accumulate in multiply-adds and the fold lo + 38 hi is
# one more per column. A carry pass masks and shifts all 32 limbs and adds
# the carries into limbs 1-31; 38 * carry + limb 0 is a multiply-add. Adds
# may also issue to the IMAD pipe, which lowers no bound here: the
# products alone are over half of all operations.
CARRY_PASS = np.array([1, 32 * 2 + 31])
MUL_OPS = np.array([1024 + 32, 0]) + 4 * CARRY_PASS
SQR_OPS = np.array([528 + 32, 32]) + 4 * CARRY_PASS  # 496 cross + 32 diagonal; 32 doublings
ADD_OPS = np.array([0, 32]) + 2 * CARRY_PASS  # add/sub/neg, and mul_small<2> as an add
PDBL_OPS = 4 * SQR_OPS + 4 * MUL_OPS + 8 * ADD_OPS  # ed25519.point_double
PADD_OPS = 9 * MUL_OPS + 9 * ADD_OPS  # ed25519.point_add
OPS_PER_ITEM = {
    "inv": 254 * SQR_OPS + 11 * MUL_OPS,
    "p58": 251 * SQR_OPS + 11 * MUL_OPS,
    # table: 1 doubling + 13 additions; then 128 steps of 2 dbl + 1 add
    "ladder": PDBL_OPS + 13 * PADD_OPS + 128 * (2 * PDBL_OPS + PADD_OPS),
    # One 128-byte block, in 32-bit operations with 3-input logic and adds:
    # a round is Sigma0 and Sigma1 (3 rotations of 2 funnel shifts and 2
    # xors each, 8 apiece), ch and maj (2 each) and six 64-bit adds (2
    # each); a schedule word is sigma0 and sigma1 (8 apiece) and three
    # adds; then the state's 8 adds. No multiplies.
    "sha512": np.array([0, 80 * (8 + 8 + 2 + 2 + 6 * 2) + 64 * (8 + 8 + 3 * 2) + 8 * 2]),
}
BYTES_PER_ITEM = {  # each input read once, each output written once
    "inv": 2 * 32 * 4,
    "p58": 2 * 32 * 4,
    "ladder": (128 + 4 * 32 + 4 * 32) * 4,
    "sha512": 96 + 64,
}
# Every window shape the paths form (verify_many's pad ladder, which the
# daemon and the protocol path share, 4096 for the parallel phase and 256
# for the simulation; 8192 is verify_many's 5,000-item window), then ragged
# sizes.
KERNEL_SIZES = (4096, 8192, 16, 64, 256, 1024, 1, 17, 300)
SOURCES = {
    "inv": ("pbft_tpu_torch/crypto/csrc/chains.cu", "pbft_tpu/crypto/pallas_kernels.py:184"),
    "p58": ("pbft_tpu_torch/crypto/csrc/chains.cu", "pbft_tpu/crypto/pallas_kernels.py:190"),
    "ladder": ("pbft_tpu_torch/crypto/csrc/ladder.cu", "pbft_tpu/crypto/pallas_kernels.py:210"),
    "sha512": ("pbft_tpu_torch/crypto/csrc/sha512.cu", "none: plain pbft_tpu/crypto/sha512.py"),
}
SHA512_LENGTHS = (0, 111, 112, 128, 200)  # phase_kernels at B, beside the window's 96


# The parallel phase: f -> replicas n = 3f + 1. A window holds R = B // n
# rounds of n COMMIT rows; a round certifies at 2f + 1 valid ones.
CLUSTERS = {1: 4, 10: 31}
STATE0 = np.full(8, 2**31 - 2, np.int32)
REPS = 4  # timed windows per path
# CUDA runtime and driver calls that start work on the card, as the
# profiler names them: kernels one by one, and whole graphs.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch", "cuGraphLaunch")
MAX_KERNEL_LAUNCH_CALLS = 50  # a replayed window issues its ~21.5k kernels as one graph


class PhaseFailed(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Test data: signed with the port's oracle, invalid rows mixed in.
# ---------------------------------------------------------------------------

SMALL_ORDER = [
    (1).to_bytes(32, "little"),  # identity
    (2**255 - 19 - 1).to_bytes(32, "little"),  # (0, -1), order 2
    bytes(32),  # y = 0: order 4
    bytes(31) + b"\x80",  # y = 0 with the sign bit: order 4
]


def make_pool(ref, rng, n_valid: int = 96):
    """(items, oracle verdicts): valid signatures, then corrupted R,
    corrupted message, malleated S + L, y = p, an off-curve y, small-order A
    (with R = [S]B, which the cofactorless equation accepts, and with a junk
    R) and small-order R."""
    items = []
    for _ in range(n_valid):
        seed = rng.bytes(32)
        msg = rng.bytes(32)
        pub = ref.public_key(seed)
        sig = ref.sign(seed, msg)
        s = int.from_bytes(sig[32:], "little")
        items += [
            (pub, msg, sig),
            (pub, msg, bytes([sig[0] ^ 0x40]) + sig[1:]),
            (pub, rng.bytes(32), sig),
            (pub, msg, sig[:32] + (s + ref.L).to_bytes(32, "little")),
        ]
    pub0, msg0, sig0 = items[0]
    off_curve = next(
        k.to_bytes(32, "little") for k in range(2, 1000)
        if ref.point_decompress(k.to_bytes(32, "little")) is None
    )
    items += [
        ((2**255 - 19).to_bytes(32, "little"), msg0, sig0),
        (off_curve, msg0, sig0),
    ]
    for enc in SMALL_ORDER:
        s = int.from_bytes(rng.bytes(32), "little") % ref.L
        r_enc = ref.point_compress(ref.scalar_mult(s, ref.BASE))
        items += [
            (enc, msg0, r_enc + s.to_bytes(32, "little")),
            (enc, msg0, sig0),
            (pub0, msg0, enc + sig0[32:]),
        ]
    want = [ref.verify(*it) for it in items]
    return items, want


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


def phase_env(torch, K, card: str) -> dict:
    info = K.build()
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    env = {
        "card": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "sms": props.multi_processor_count,
        "sm_clock_max_mhz": clock_mhz,
        "build_s": round(info["build_s"], 3),
        "compiled": info["compiled"],
        "kernels": info["kernels"],
    }
    for name, regs in info["kernels"].items():
        check("registers" in regs, f"no ptxas report for {name}")
    emit("env", **env)
    for name in ("ladder", "sha512"):
        check(info["kernels"][name].get("spill_store_bytes") == 0, f"the {name} kernel spills")
    return env


HOSTILE = np.array([[1023] * 32, [-1023] * 32, [1023 if i % 2 else -1023 for i in range(32)], [0] * 32],
                   np.int32)


def _chain_rows(F, rng, n: int) -> np.ndarray:
    """Random carried limbs, the hostile rows, zero, 1 and p - 1 first."""
    x = rng.integers(-(2**9) + 1, 2**9, size=(max(n, 6), F.NLIMBS)).astype(np.int32)
    x[:4] = HOSTILE
    x[4] = F.limbs_const(1)
    x[5] = F.limbs_const(F.P - 1)
    return x[:n]


def _sha512_rows(rng, rows: int, n: int = 96) -> np.ndarray:
    """Random rows, then (as far as they fit) an all-0x00, an all-0xff and
    a row one bit apart from the first random one."""
    x = rng.integers(0, 256, size=(rows + 3, n), dtype=np.uint8)
    x[0], x[1] = 0, 0xFF
    x[2] = x[3]
    if n:
        x[2, n // 2] ^= 0x10
    return x[:rows]


def _sha512_check(torch, K, x: np.ndarray) -> int:
    """Digest bytes where the kernel differs from its plain version (on the
    card) or from hashlib."""
    import hashlib

    xt = torch.from_numpy(x).to("cuda")
    got, want = K.sha512(xt), K.sha512_plain(xt)
    torch.cuda.synchronize()
    got = got.cpu().numpy()
    lib = np.stack([np.frombuffer(hashlib.sha512(r.tobytes()).digest(), np.uint8) for r in x])
    return int((got != want.cpu().numpy()).sum() + (got != lib).sum())


def phase_kernels(torch, F, E, K, ref, rng, card: str) -> dict:
    """Every kernel against its plain version at KERNEL_SIZES, raw limbs
    (digest bytes for SHA-512)."""
    dev = torch.device("cuda")
    errs = {name: 0 for name in K.KERNELS}
    keys = [ref.public_key(rng.bytes(32)) for _ in range(32)] + SMALL_ORDER  # rows 32-35: small order
    ok, key_pts = E.decompress(torch.from_numpy(np.stack([np.frombuffer(k, np.uint8) for k in keys])).to(dev))
    check(bool(ok.all()), "test keys failed to decompress")
    key_neg = E.point_neg(key_pts)
    hostile_rows = (3, 5, 7, 9)  # -A replaced by a hostile row (all four coordinates)

    def bits(vals):
        raw = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in vals])
        return F.scalar_bits(F.bytes_to_limbs(torch.from_numpy(raw).to(dev)))

    for n in KERNEL_SIZES:
        x = _chain_rows(F, rng, n)
        xt = torch.from_numpy(x).to(dev)
        for name, fn, plain, expo in (
            ("inv", K.inv, K.inv_plain, F.P - 2),
            ("p58", K.pow_p58, K.pow_p58_plain, (F.P - 5) // 8),
        ):
            got, want = fn(xt), plain(xt)
            torch.cuda.synchronize()
            err = int((got - want).abs().max().item())
            more = {}
            if n == B:
                gc = F.canon(got)
                more["canon_equal"] = torch.equal(gc, F.canon(want))
                more["oracle_ok"] = all(
                    F.limbs_to_int(gc[i]) == pow(F.limbs_to_int(x[i]) % F.P, expo, F.P) for i in range(8)
                )
            emit("kernels", kernel=name, batch=n, raw_limbs_equal=err == 0, max_abs_err=err, **more,
                 card=card)
            check(err == 0 and all(more.values()), f"{name} kernel disagrees with its plain version at {n}")
            errs[name] = max(errs[name], err)
        rows = torch.arange(n, device=dev) % len(keys)
        a_neg = tuple(c[rows] for c in key_neg)
        hostile = [r for r in hostile_rows if r < n]
        if hostile:
            for c in a_neg:
                c[hostile] = torch.from_numpy(HOSTILE[: len(hostile)]).to(dev)
        s_int = [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(n)]
        h_int = [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(n)]
        s_int[0] = h_int[0] = 0  # identity accumulator through compress
        s_int[1 % n] = 0
        h_int[2 % n] = 0
        sb, hb = bits(s_int), bits(h_int)
        got = K.ladder(sb, hb, a_neg)
        want = K.ladder_plain(sb, hb, a_neg)
        torch.cuda.synchronize()
        err = max(int((g - w).abs().max().item()) for g, w in zip(got, want))
        more = {"hostile_rows": len(hostile)}
        if n == B:
            enc_got = E.compress(got)
            more["compress_equal"] = torch.equal(enc_got, E.compress(want))
            oracle_rows = [0, 1, 2, 4, 32, 33, 34, 35]  # curve rows; 32-35 small-order keys
            oracle_ok = True
            for i in oracle_rows:
                ax, ay = ref.point_decompress(keys[i])
                expect = ref.point_add(ref.scalar_mult(s_int[i], ref.BASE),
                                       ref.scalar_mult(h_int[i], ((-ax) % F.P, ay)))
                oracle_ok &= bytes(enc_got[i].cpu().numpy()) == ref.point_compress(expect)
            more.update(oracle_rows=len(oracle_rows), oracle_ok=oracle_ok)
        emit("kernels", kernel="ladder", batch=n, raw_limbs_equal=err == 0, max_abs_err=err, **more,
             card=card)
        check(err == 0 and more.get("compress_equal", True) and more.get("oracle_ok", True),
              f"ladder kernel disagrees with its plain version at {n}")
        errs["ladder"] = max(errs["ladder"], err)
        lengths = (96,) + (SHA512_LENGTHS if n == B else ())
        bad = {length: _sha512_check(torch, K, _sha512_rows(rng, n, length)) for length in lengths}
        emit("kernels", kernel="sha512", batch=n, digests_equal=not any(bad.values()), bytes_differing=bad,
             card=card)
        check(not any(bad.values()), f"sha512 kernel disagrees with its plain version or hashlib at {n}: {bad}")
    return errs


def check_launches(K, path: str, windows: int, shards: int = 1, got=None, **labels) -> dict:
    """Read the counts after a path (or take ``got``, read in another
    process); each kernel launches once per window per shard."""
    got = dict(K.LAUNCHES) if got is None else got
    emit("launches", path=path, **labels, windows=windows, shards=shards, **got)
    check(all(got[k] == windows * shards for k in K.KERNELS),
          f"{path}: {got} launches for {windows} windows of {shards} shards")
    return got


def phase_verify(batch, pool, want, rng, card: str) -> int:
    """verify_many forms one window per call; returns the number of calls."""
    idx = np.arange(len(pool))
    for n in VERIFY_SIZES:
        pick = rng.choice(idx, size=n, replace=n > len(pool))
        items = [pool[i] for i in pick]
        t0 = time.perf_counter()
        got = batch.verify_many(items)
        secs = time.perf_counter() - t0
        expect = [want[i] for i in pick]
        emit("verify", items=n, padded=batch.pad_size(n), rejected=expect.count(False),
             equal_to_oracle=got == expect, secs=round(secs, 4), card=card)
        check(got == expect, f"verdicts differ from the oracle at {n} items")
    fixed_pick = list(range(0, len(pool), max(1, len(pool) // 16)))[:16]
    fixed = [pool[i] for i in fixed_pick]
    per_shape = {size: batch.verify_many(fixed, pad_to=size) for size in batch._PAD_LADDER}
    same = all(v == per_shape[16] for v in per_shape.values())
    emit("verify", fixed_items=len(fixed), shapes=list(per_shape), identical_across_shapes=same,
         equal_to_oracle=per_shape[16] == [want[i] for i in fixed_pick], card=card)
    check(same and per_shape[16] == [want[i] for i in fixed_pick], "verdicts depend on the pad shape")
    return len(VERIFY_SIZES) + len(per_shape)


def _request(sock, items):
    sock.sendall(len(items).to_bytes(4, "big") + b"".join(p + m + s for p, m, s in items))
    out = bytearray()
    while len(out) < len(items):
        chunk = sock.recv(len(items) - len(out))
        if not chunk:
            raise ConnectionError("service closed mid-reply")
        out += chunk
    return [bool(b) for b in out]


def drive_clients(address: str, VS, pool, want, requests: int = 8) -> dict:
    """Four client threads (an f = 1 cluster's replicas), ``requests``
    requests of 1,024 triples each, a status probe after each; verdicts
    against the oracle."""
    errors, bad = [], []

    def client(cid: int):
        crng = np.random.default_rng(SEED + cid)
        host, port = address.rsplit(":", 1)
        try:
            with socket.create_connection((host, int(port)), timeout=120) as sock:
                for _ in range(requests):
                    pick = crng.integers(0, len(pool), size=1024)
                    got = _request(sock, [pool[i] for i in pick])
                    if got != [want[i] for i in pick]:
                        bad.append(cid)
                    sock.sendall(VS.STATUS_PROBE.to_bytes(4, "big"))
                    if VS.unpack_status(VS._recv_exact(sock, VS.STATUS_LEN)) is None:
                        bad.append(cid)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    secs = time.perf_counter() - t0
    return {"secs": secs, "verifies_per_s": 4 * requests * 1024 / secs, "correct": not bad and not errors,
            "errors": errors[:3]}


SERVICE_TURNS = 1  # graph-against-eager turns per service run (cut from 2)
SERVICE_TURN_REQUESTS = 2  # requests per client in each such turn (cut from 8)


def run_service(VS, K, pool, want, card: str, path: str, eager_backend=None, engine=None,
                **daemon_kwargs) -> tuple[dict, dict]:
    """One daemon, four clients of 8 x 1,024 triples; (result, launches).
    With ``eager_backend``, then SERVICE_TURN_REQUESTS requests a client in
    SERVICE_TURNS turns (graph, eager, eager, graph, ...) against this daemon and a service with
    the same knobs whose backend runs each window op by op. ``engine`` is a
    CudaVerifyEngine to serve on, shared with other daemons (the first to
    start warms it)."""
    daemon = VS.VerifyServiceDaemon(host="127.0.0.1", port=0, engine=engine, **daemon_kwargs)
    try:
        t0 = time.perf_counter()
        daemon.start(wait_ready=True, timeout=600)
        warm_s = time.perf_counter() - t0
        st = VS.probe_status(daemon.address)
        check(st == (VS.STATE_READY, daemon.engine.device_count, 5), f"daemon status {st}")
        K.reset_launches()  # after the warmup's captures and all-pad windows
        run = drive_clients(daemon.address, VS, pool, want)
        js = VS.probe_status_json(daemon.address)
        result = {
            "path": path, **daemon_kwargs, "state": js["state"], "warmed_shapes": js["warmed_shapes"],
            "warm_s": round(warm_s, 3), "warm_stats": js["warm_stats"], "requests": js["requests"],
            "launches": js["launches"], "items": js["items"], "fallback_items": js["fallback_items"],
            "verdicts_correct": run["correct"], "secs": run["secs"],
            "verifies_per_s": run["verifies_per_s"], "card": card,
        }
        emit("service", **result, errors=run["errors"])
        check(run["correct"], "service verdicts wrong or a client failed")
        check(js["requests"] == 32, f"{js['requests']} requests reached the service")
        check(js["fallback_items"] == 0, "the fallback served traffic")
        launches = check_launches(K, path, js["launches"], daemon.engine.device_count)
        if eager_backend is not None:
            knobs = {k: v for k, v in daemon_kwargs.items() if k in ("flush_items", "flush_us")}
            eager = VS.VerifierService(host="127.0.0.1", port=0, backend=eager_backend,
                                       inflight=daemon_kwargs.get("inflight", 2), **knobs).start()
            try:
                rates = {"graph": [], "eager": []}
                for rep in range(SERVICE_TURNS):
                    for name in (("graph", "eager") if rep % 2 == 0 else ("eager", "graph")):
                        r = drive_clients(daemon.address if name == "graph" else eager.address, VS, pool, want,
                                          SERVICE_TURN_REQUESTS)
                        check(r["correct"], f"{path}: {name} service verdicts wrong")
                        rates[name].append(r["verifies_per_s"])
            finally:
                eager.stop()
            result["turns_verifies_per_s"] = rates
            emit("timing", path=path, compare="graph_vs_eager_in_turns", reps=SERVICE_TURNS, verifies_per_s=rates,
                 graph_over_eager=float(np.mean(rates["graph"]) / np.mean(rates["eager"])), card=card)
        return result, launches
    finally:
        daemon.stop()


def run_chunked(VS, K, pool, want, card: str, engine) -> dict:
    """One 5,000-item call of ``engine`` (warmed here if it is not):
    two windows across the 4,096 boundary."""
    if not engine.warmed_sizes:
        engine.warm()
    big = [pool[i % len(pool)] for i in range(5000)]
    K.reset_launches()
    ok = engine.verify(big) == [want[i % len(pool)] for i in range(5000)]
    emit("service", path="engine_chunked", items=len(big), correct=ok, card=card)
    check(ok, "chunked verify across the 4096 boundary is wrong")
    return check_launches(K, "engine_chunked", 2, engine.device_count)


# ---------------------------------------------------------------------------
# The operator surface: native pool, warm-time fallback, client, metrics.
# ---------------------------------------------------------------------------


def _scrape(port: int, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read().decode()


def _samples(text: str, replica: str = "service") -> dict:
    """The {replica="<replica>"} samples of a Prometheus scrape, by name."""
    label = f'{{replica="{replica}"}} '
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or label not in line:
            continue
        name, value = line.split(label)
        out[name] = float(value)
    return out


def phase_surface(VS, K, pool, want, card: str) -> dict:
    """(a)-(e) of the surface phase (module docstring); returns the launch
    counts of (c)."""
    from pbft_tpu_torch import native
    from pbft_tpu_torch.crypto import ref
    from pbft_tpu_torch.utils import trace_schema

    # (a) The native pool. Small-order keys (the pool's last 12 rows) may
    # pass its random-linear-combination windows where the oracle rejects
    # them (a pair of cancelling torsion defects in one 256-item window, by
    # design, as in the reference); every other row must agree.
    t0 = time.perf_counter()
    build = native.build()
    check(native.available(), "the native core does not load")
    setup_s = time.perf_counter() - t0
    small = {i for i, (pub, _, sig) in enumerate(pool) if pub in SMALL_ORDER or sig[:32] in SMALL_ORDER}
    honest = [i for i in range(len(pool)) if i not in small]
    got = native.verify_batch(pool)
    differ = [i for i in range(len(pool)) if got[i] != want[i]]
    rng = np.random.default_rng(SEED + 100)
    pick = rng.choice(honest, size=B)
    t0 = time.perf_counter()
    rate_got = native.verify_batch([pool[i] for i in pick])
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle_got = [ref.verify(*pool[i]) for i in pick[:64]]
    oracle_per_s = 64 / (time.perf_counter() - t0)
    native_run = {"built_here": build["built"], "build_or_load_s": setup_s,
                  "threads": native.verify_threads(), "cpu_count": os.cpu_count(), "pool_items": len(pool),
                  "rows_differing_from_oracle": len(differ), "small_order_rows": len(small), "batch": B,
                  "secs": native_s, "verifies_per_s": B / native_s, "oracle_verifies_per_s": oracle_per_s,
                  "native_over_oracle": B / native_s / oracle_per_s}
    emit("surface", path="native_pool", **native_run, card=card)
    check(set(differ) <= small, f"the native pool disagrees with the oracle on honest rows {sorted(set(differ) - small)}")
    check(rate_got == [want[i] for i in pick] and oracle_got == rate_got[:64],
          "the native pool disagrees with the oracle at 4,096")

    # (b) One raw request while the daemon warms: the warm-time fallback.
    pick = rng.choice(honest, size=1024)
    request, request_want = [pool[i] for i in pick], [want[i] for i in pick]
    served_false = 0
    for attempt in range(2):  # a warm that ends before the request is sent: a second daemon
        daemon = VS.VerifyServiceDaemon(host="127.0.0.1", port=0, flush_items=4096, flush_us=100_000,
                                        metrics_port=0)
        daemon.start()
        pool_items = native.verify_pool_stats()["items"]
        st = VS.probe_status(daemon.address)
        if st is not None and st[0] == VS.STATE_WARMING:
            host, port = daemon.address.rsplit(":", 1)
            t0 = time.perf_counter()
            with socket.create_connection((host, int(port)), timeout=120) as sock:
                verdicts = _request(sock, request)
            warming_ms = (time.perf_counter() - t0) * 1e3
            js = VS.probe_status_json(daemon.address)
            if js["fallback_items"] == len(request):
                break
        daemon.stop()
        daemon._warm_thread.join(600)  # its captures would count in (c)
        daemon = None
    check(daemon is not None, "the daemon finished its warm before a request reached it, twice")
    try:
        grown = native.verify_pool_stats()["items"] - pool_items
        fallback = {"attempt": attempt + 1, "state_before": VS.STATE_NAMES[st[0]], "items": len(request),
                    "fallback_items": js["fallback_items"], "host_verifier": js["host_verifier"],
                    "native_pool_items_grown": grown,
                    "equal_to_oracle": verdicts == request_want, "ms": warming_ms,
                    "verifies_per_s": len(request) / warming_ms * 1e3}
        emit("surface", path="warming_fallback", **fallback, card=card)
        check(verdicts == request_want, "the warm-time fallback disagrees with the oracle")
        check(grown >= len(request), f"the native pool verified {grown} items, not the request's {len(request)}")
        check(js["host_verifier"] == "native", f"the daemon's host verifier is {js['host_verifier']}")
        served_false += verdicts.count(False)

        # (c) Four replica-side clients once the daemon is ready.
        daemon._warm_thread.join(600)
        check(daemon.warm_error is None and daemon.state == VS.STATE_READY,
              f"the daemon did not warm: {daemon.warm_error!r}")
        warm_stats = daemon.engine.stats
        at_ready = VS.probe_status_json(daemon.address)
        errors, bad, used, false_count = [], [], [], []

        def client(cid: int):
            crng = np.random.default_rng(SEED + 200 + cid)
            sv = VS.ServiceVerifier(daemon.address)
            try:
                for _ in range(8):
                    pick = crng.integers(0, len(pool), size=1024)
                    got = sv.verify_batch([pool[i] for i in pick])
                    if got != [want[i] for i in pick]:
                        bad.append(cid)
                    false_count.append(got.count(False))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))
            finally:
                used.append(sv.used_fallback)
                sv.close()

        K.reset_launches()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        secs = time.perf_counter() - t0
        js = VS.probe_status_json(daemon.address)
        windows = js["launches"] - at_ready["launches"]
        clients = {"requests": js["requests"] - at_ready["requests"], "windows": windows,
                   "used_fallback": used, "fallback_items": js["fallback_items"], "correct": not bad and not errors,
                   "secs": secs, "verifies_per_s": 4 * 8 * 1024 / secs, "errors": errors[:3]}
        emit("surface", path="service_verifier_clients", **clients, card=card)
        check(clients["correct"] and not any(t.is_alive() for t in threads), "ServiceVerifier verdicts wrong")
        check(used == [0, 0, 0, 0], f"clients fell back: {used}")
        check(js["fallback_items"] == len(request), "the fallback served traffic after the warm")
        launches = check_launches(K, "surface_service_verifier", windows, daemon.engine.device_count)
        served_false += sum(false_count)

        # (d) The scrape against the status.
        mport = daemon.service.metrics_listen_port
        text = _scrape(mport, "/metrics")
        status = json.loads(_scrape(mport, "/status"))
        m = _samples(text)
        names = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}
        ok = {
            "items": m["pbft_verify_items_total"] == status["items"],
            "batches": m["pbft_verify_batches_total"] == status["launches"],
            "service_launches": m["pbft_verify_service_launches_total"] == status["launches"],
            "batch_size_count": m["pbft_verify_batch_size_count"] == status["launches"],
            "rejected": m["pbft_verify_rejected_total"] == served_false,
            "cold_compile": m["pbft_verify_service_cold_compile_seconds"] == warm_stats["cold_compile_s"],
            "series": names == {k for k, (_, emitters) in trace_schema.METRIC_SCHEMAS.items()
                                if emitters & {"service.py", "verify_service.py"}},
        }
        emit("surface", path="metrics_scrape", status_items=status["items"], status_launches=status["launches"],
             scraped={k: m[k] for k in ("pbft_verify_items_total", "pbft_verify_batches_total",
                                        "pbft_verify_rejected_total", "pbft_verify_service_cold_compile_seconds")},
             served_false=served_false, series_count=len(names), **ok, card=card)
        check(all(ok.values()), f"the scrape disagrees with the status: {ok}")

        # (e) Metrics on against off, in turns, on the same daemon.
        rates = {"on": [], "off": []}
        for rep in range(2):
            for name in (("on", "off") if rep % 2 == 0 else ("off", "on")):
                daemon.service.metrics_registry.set_enabled(name == "on")
                r = drive_clients(daemon.address, VS, pool, want)
                check(r["correct"], f"metrics {name}: service verdicts wrong")
                rates[name].append(r["verifies_per_s"])
        daemon.service.metrics_registry.set_enabled(True)
        emit("timing", path="surface_metrics", compare="metrics_on_vs_off_in_turns", reps=2,
             verifies_per_s=rates, on_over_off=float(np.mean(rates["on"]) / np.mean(rates["off"])), card=card)
    finally:
        daemon.stop()
    return launches


# ---------------------------------------------------------------------------
# The protocol path: pbftd clusters on their own pools and on the card.
# ---------------------------------------------------------------------------

# Requests per config where the smoke cuts the harness's own depth (100,
# 100, 96 and 96), so that the smoke fits its time; config 1 runs at the
# harness's (200).
PROTOCOL_REQUESTS = {0: 25, 2: 48, 3: 48, 4: 48}


def _trace_events(trace_dir: str, ev: str) -> int:
    needle = f'"ev":"{ev}"'
    count = 0
    for name in os.listdir(trace_dir):
        if name.startswith("replica-") and name.endswith(".jsonl"):
            with open(os.path.join(trace_dir, name)) as fh:
                count += sum(needle in line for line in fh)
    return count


def phase_protocol(K, VS, card: str, engine=None) -> dict:
    """BASELINE's configs 0-4 (pbft_tpu_torch.bench.harness CONFIGS) at
    their full replica counts as pbftd clusters, each on the native arm
    (pbftd's own C++ verify pools) and on the native-cuda arm (every replica
    -> one coalescing daemon on the card, serving on ``engine``, a one-slot
    CudaVerifyEngine shared by every config's daemon), in turns, one run an
    arm, at PROTOCOL_REQUESTS. Each run's row is printed. Checks: every driven request
    commits with f + 1 matching validly signed replies (the harness raises
    otherwise); on the card's arm nothing is verified on the host: the
    daemon's fallback served no item after the warm, no replica's verify
    deadline fired (metrics line and trace), no view change ran (whose
    evidence pbftd verifies in-process), and the daemon's items equal the
    replicas' sig_verified + sig_rejected over the cluster's life; config 4's
    Byzantine signatures are rejected on the card; the kernels launched
    once per daemon window per shard. Returns the launch counts by config."""
    import dataclasses
    import tempfile

    from pbft_tpu_torch import native
    from pbft_tpu_torch.bench import harness as H

    native.build()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-traces-") as traces:
        for index, (name, n, _clients, _requests, byzantine) in enumerate(H.CONFIGS):
            root = os.path.join(traces, f"cfg{index}")
            t0 = time.perf_counter()
            daemon = H.start_daemon("cuda", trace_dir=root, engine=engine)
            warm_s = time.perf_counter() - t0
            requests = PROTOCOL_REQUESTS.get(index)
            try:
                ready = VS.probe_status_json(daemon.address)
                K.reset_launches()  # after the warm's captures and all-pad windows
                for arm in ("native", "native-cuda") if index % 2 == 0 else ("native-cuda", "native"):
                    trace_dir = os.path.join(root, arm)
                    if arm == "native":
                        res = H.run_native_config(index, requests=requests, trace_dir=trace_dir)
                    else:
                        res = H.run_native_cuda_config(index, requests=requests, trace_dir=trace_dir,
                                                       daemon=daemon)
                    acc = res.accounting
                    deadline_events = _trace_events(trace_dir, "verify_deadline_fired")
                    emit("protocol", config_index=index, arm=arm, row=dataclasses.asdict(res),
                         deadline_events_in_traces=deadline_events,
                         cpu_count=os.cpu_count(), card=card)
                    check(res.replicas == n and acc["view_changes_started"] == 0,
                          f"config {index} {arm}: {res.replicas} replicas, {acc['view_changes_started']} view changes")
                    check(deadline_events == 0 and acc["verify_deadline_fired"] == 0,
                          f"config {index} {arm}: a replica's verify deadline fired")
                    if byzantine:
                        check(acc["replica_sig_rejected"] > 0, f"config {index} {arm}: no signature rejected")
                    if arm == "native-cuda":
                        check(res.service_fallback_items == 0 and acc["service_fallback_items"] == 0,
                              f"config {index}: the daemon's fallback served traffic after the warm")
                        check(acc["service_items"] == acc["replica_sig_checks"],
                              f"config {index}: the daemon verified {acc['service_items']} items, the "
                              f"replicas checked {acc['replica_sig_checks']}")
                        check(res.service_windows > 0 and (res.service_rejected > 0) == byzantine,
                              f"config {index}: {res.service_windows} windows, {res.service_rejected} rejected")
                end = VS.probe_status_json(daemon.address)
            finally:
                daemon.stop()
            check(end["fallback_items"] == ready["fallback_items"] == 0, f"config {index}: fallback items {end}")
            # Each window's host-clock seconds in the daemon's trace (the
            # warm's all-pad windows run before the trace sink sees traffic).
            with open(os.path.join(f"{root}-service", "service.jsonl")) as fh:
                secs = sorted(e["secs"] for e in map(json.loads, fh) if e["ev"] == "verify_batch")
            emit("protocol", config_index=index, daemon_warm_s=warm_s, warm_stats=ready["warm_stats"],
                 windows=end["launches"] - ready["launches"], items=end["items"] - ready["items"],
                 rejected=end["rejected"] - ready["rejected"], traced_windows=len(secs),
                 window_ms={"mean": 1e3 * sum(secs) / len(secs), "p50": 1e3 * secs[len(secs) // 2],
                            "p95": 1e3 * secs[int(0.95 * len(secs))], "max": 1e3 * secs[-1]},
                 window_busy_s=sum(secs), card=card)
            launches[f"protocol_cfg{index}"] = check_launches(
                K, f"protocol_cfg{index}", end["launches"] - ready["launches"], daemon.engine.device_count)
    return launches


# ---------------------------------------------------------------------------
# The simulation path: the Python replica cores in memory, windows on the card.
# ---------------------------------------------------------------------------

# Requests per config where the smoke cuts the harness's depth (200, 100
# and 50), so that the smoke fits its time; configs 0 and 4 run at the
# harness's (1 and 12).
SIM_REQUESTS = {1: 25, 2: 50, 3: 25}
# At those depths: (signatures verified, windows of 256 rows on the cuda
# arm) per config, as the port's cpu arm counts them (at the harness's full
# depth, 4,944, 8,652 and 24,720 signatures for configs 1-3, the CPU tests
# pin that arm to the JAX package's cpu arm).
SIM_EXPECTED = {0: (24, 8), 1: (612, 202), 2: (4326, 220), 3: (12240, 170), 4: (22320, 188)}
SIM_BATCH_PAD = 256
# Rows run a second time without the invariant checker, to show what of its
# cost the checked rows' seconds still hold: the cpu arm on every config
# (the cuda arm's rerun of config 4 was cut so that the smoke fits its time).
SIM_UNCHECKED = {"cpu": (0, 1, 2, 3, 4), "cuda": ()}
# Row fields that differ between two runs that ended alike.
SIM_RUN_FIELDS = {"seconds", "rounds_per_sec", "sig_verifies_per_sec", "requests_per_sec", "verifier",
                  "capture_s", "invariant_s"}
# A fault schedule at n = 4 with the write-ahead log on: a crash and its
# restart from the log, a partition, link chaos, an equivocating replica.
SIM_FAULT_SEED, SIM_FAULT_STEPS = 21, 120


def _echo(operation, seq):
    return operation


def phase_simulation(K, card: str) -> dict:
    """BASELINE's configs 0-4 (pbft_tpu_torch.bench.harness CONFIGS) at full
    width and SIM_REQUESTS in the in-memory simulation, on the cpu arm (the native pool) and
    the cuda arm (each step's items in windows of 256 rows on the card), in
    turns, with an invariant checker on every run (its seconds left out of
    the rows' times), then the SIM_UNCHECKED rows again without it. Checks:
    every request commits with f + 1 matching replies (the harness raises
    otherwise); every run of a config ends alike (every replica's view,
    executed_upto, state digest and counters; the verifier's calls, items
    and rejections; the signatures the replicas checked and rejected), with
    the signatures and the card's windows of SIM_EXPECTED; config 4's Byzantine signatures rejected on
    the card as on the host; no view change; on the cuda arm no signature
    verified on the host (native pool, host_batch_verify, the oracle, the
    replicas' inline verifier); each kernel launched once per window (the
    run's windows and the one replayed capture call before its timed
    region). Then one seeded fault schedule at n = 4 with the WAL on, on
    both arms: invariants hold, every request is answered, the outcomes are
    equal, and on the card only view-change evidence is verified on the
    host (through the replicas' inline verifier). Returns the launch
    counts, summed over the phase's paths."""
    import dataclasses

    from pbft_tpu_torch import native
    from pbft_tpu_torch.bench import harness as H
    from pbft_tpu_torch.consensus import config as C
    from pbft_tpu_torch.consensus import faults as FL
    from pbft_tpu_torch.consensus import invariants as I
    from pbft_tpu_torch.consensus import replica as R
    from pbft_tpu_torch.consensus import simulation as S
    from pbft_tpu_torch.crypto import batch, ref

    native.build()
    check(native.available(), "the native core does not load")
    host = {}
    real = {}

    def count(mod, name):
        real[(mod, name)] = fn = getattr(mod, name)
        host[name] = 0

        def counted(*args, **kwargs):
            host[name] += 1
            return fn(*args, **kwargs)

        setattr(mod, name, counted)

    for mod, name in ((native, "verify_batch"), (native, "host_batch_verify"), (ref, "verify"),
                      (R, "_host_verify")):
        count(mod, name)
    totals = {k: 0 for k in K.KERNELS}

    def add(got):
        for k in K.KERNELS:
            totals[k] += got[k]

    try:
        t0 = time.perf_counter()
        H._verifier("cuda", SIM_BATCH_PAD)([batch.PAD_ITEM])
        emit("simulation", first_capture_s=time.perf_counter() - t0, batch_pad=SIM_BATCH_PAD, card=card)
        phase_t0 = time.perf_counter()
        for index, (name, n, _clients, _requests, byzantine) in enumerate(H.CONFIGS):
            rows = {}
            turns = [(arm, True) for arm in (("cpu", "cuda") if index % 2 == 0 else ("cuda", "cpu"))]
            turns += [(arm, False) for arm in ("cpu", "cuda") if index in SIM_UNCHECKED[arm]]
            for arm, checked in turns:
                host.update({k: 0 for k in host})
                K.reset_launches()
                res = H.run_sim_config(index, arm, batch_pad=SIM_BATCH_PAD, requests=SIM_REQUESTS.get(index),
                                       invariants=checked)
                got = dict(K.LAUNCHES)
                rows[arm, checked] = res
                acc = res.accounting
                emit("simulation", config_index=index, arm=arm, checked=checked, row=dataclasses.asdict(res),
                     capture_s=res.capture_s, invariant_s=res.invariant_s, host_verifies=dict(host), card=card)
                what = f"simulation config {index} {arm}{'' if checked else ' unchecked'}"
                check(res.replicas == n and acc["view_changes_started"] == 0,
                      f"{what}: {acc['view_changes_started']} view changes")
                check(acc["items"] == acc["replica_sig_checks"] == res.sig_verifications == SIM_EXPECTED[index][0],
                      f"{what}: {acc}, expected {SIM_EXPECTED[index][0]} signatures")
                check((acc["rejected"] > 0) == byzantine, f"{what}: {acc['rejected']} signatures rejected")
                check((acc.get("invariant_checks", 0) > 0) == checked, f"{what}: {acc}")
                if arm == "cuda":
                    check(acc["windows"] == SIM_EXPECTED[index][1],
                          f"{what}: {acc['windows']} windows, expected {SIM_EXPECTED[index][1]}")
                    check(not any(host.values()), f"{what}: verified on the host: {host}")
                    add(check_launches(K, f"simulation_cfg{index}{'' if checked else '_unchecked'}",
                                       acc["windows"] + 1, got=got, capture_calls=1))
                else:
                    check("windows" not in acc and got == {k: 0 for k in K.KERNELS}, f"{what}: launched {got}")
            # Every run of the config ended alike: the row but its times and
            # the arm's own counts, the accounting but the checker's checks
            # and the card's windows.
            def ended(res):
                row = {k: v for k, v in dataclasses.asdict(res).items() if k not in SIM_RUN_FIELDS}
                row["accounting"] = {k: v for k, v in res.accounting.items() if k not in ("windows", "invariant_checks")}
                return row

            first = ended(rows["cpu", True])
            differ = sorted({k for res in rows.values() for k, v in ended(res).items() if v != first[k]})
            cpu, cuda = rows["cpu", True], rows["cuda", True]
            emit("simulation", config_index=index, arms_equal=not differ,
                 cuda_over_cpu_seconds=cuda.seconds / cpu.seconds,
                 unchecked_seconds={arm: rows[arm, False].seconds for arm, checked in turns if not checked},
                 checked_seconds={"cpu": cpu.seconds, "cuda": cuda.seconds}, card=card)
            check(not differ, f"simulation config {index}: the runs differ in {differ}")
        configs_s = time.perf_counter() - phase_t0

        outcomes = {}
        for arm in ("cpu", "cuda"):
            host.update({k: 0 for k in host})
            K.reset_launches()
            verify = H._verifier(arm, SIM_BATCH_PAD)
            tally = {"calls": 0, "items": 0}
            windows = [0]

            def counted(items, verify=verify, tally=tally, windows=windows):
                tally["calls"] += 1
                tally["items"] += len(items)
                windows[0] += -(-len(items) // SIM_BATCH_PAD)
                return verify(items)

            cfg, seeds = C.make_local_cluster(4)
            cluster = S.Cluster(config=cfg, seeds=seeds, seed=SIM_FAULT_SEED, shuffle=True, verifier=counted,
                                app=_echo, wal=True)
            checker = I.InvariantChecker(cluster)
            schedule = FL.random_schedule(SIM_FAULT_SEED, 4, SIM_FAULT_STEPS, restart_from_disk=True)
            t0 = time.perf_counter()
            out = FL.run_schedule(cluster, checker, schedule, SIM_FAULT_STEPS)
            secs = time.perf_counter() - t0
            got = dict(K.LAUNCHES)
            out.update(counters=[dict(r.counters) for r in cluster.replicas],
                       sig_verifications=cluster.sig_verifications, violations=[str(v) for v in checker.violations],
                       restarts=dict(cluster.restart_epochs), **tally)
            outcomes[arm] = out
            emit("simulation", faults=SIM_FAULT_SEED, arm=arm, steps=out["steps"], requests=out["requests"],
                 answered=out["answered"], verifier_calls=tally["calls"], items=tally["items"],
                 sig_verifications=cluster.sig_verifications, host_verifies=dict(host), secs=secs,
                 schedule=[ev.to_list() for ev in schedule.events], card=card)
            check(out["answered"] and not out["violations"], f"fault schedule on {arm}: {out}")
            if arm == "cuda":
                check(host["verify_batch"] == host["host_batch_verify"] == host["verify"] == 0,
                      f"fault schedule: verified on the host outside view-change evidence: {host}")
                add(check_launches(K, "simulation_faults", windows[0], got=got))
        check(outcomes["cpu"] == outcomes["cuda"], "the fault schedule's outcomes differ between the arms")
        emit("simulation", configs_s=configs_s, phase_s=time.perf_counter() - phase_t0, card=card)
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
    return {"simulation": totals}


# ---------------------------------------------------------------------------
# The asyncio path: the port's asyncio replicas over loopback, batches on the
# card in each replica's process or on one daemon.
# ---------------------------------------------------------------------------

# Requests driven per config: cuts of the harness's protocol depths (100,
# 200, 100, 96 and 96) to keep the phase near two minutes (3 per client on
# the 8-client configs).
ASYNCIO_REQUESTS = {0: 20, 1: 64, 2: 20, 3: 24, 4: 24}
# Configs whose every replica verifies on the card in its own process
# (--verifier cuda); the others send their batches to one daemon.
ASYNCIO_IN_PROCESS = (0, 1, 2)
ASYNCIO_MIXED = ["cxx", "cxx", "py", "py"]
ASYNCIO_MIXED_REQUESTS = 10


class ComputeApps:
    """Polls ``nvidia-smi --query-compute-apps`` on a thread while it runs:
    the most compute processes listed at once, their device memory (MiB) in
    that poll, and the largest memory seen per process id; and the card's
    memory.used. Inside a container nvidia-smi may not show the
    container's process ids (it may list every process under one id, each
    with the same used_memory), so the entries are counted as well as
    matched by id, and memory.used over the processes is the memory per
    process."""

    def __init__(self, every_s: float = 1.0):
        self.every_s = every_s
        self.mib: dict = {}  # pid -> most MiB seen
        self.entries: list = []  # (pid, MiB) of the poll that listed the most
        self.used_mib = 0  # the most memory.used seen
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def poll(self) -> None:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout
        entries = []
        for line in out.strip().splitlines():
            pid, mib = (x.strip() for x in line.split(","))
            if pid.isdigit() and mib.isdigit():
                entries.append((int(pid), int(mib)))
                self.mib[int(pid)] = max(self.mib.get(int(pid), 0), int(mib))
        if len(entries) > len(self.entries):
            self.entries = entries
        self.used_mib = max(self.used_mib, int(smi("memory.used").split()[0]))

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            self.poll()

    def __enter__(self) -> "ComputeApps":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(30)


def _trace_windows(trace_dir: str, n: int) -> list:
    """Per replica, from its trace's verify_batch events: the windows, the
    first window's seconds, the later windows that stalled on a capture,
    and the others' ms."""
    out = []
    for i in range(n):
        with open(os.path.join(trace_dir, f"replica-{i}.jsonl")) as fh:
            evs = [e for e in map(json.loads, fh) if e["ev"] == "verify_batch"]
        rest = sorted(1e3 * e["secs"] for e in evs[1:])
        out.append({
            "windows": len(evs),
            "first_window_s": evs[0]["secs"] if evs else None,
            # Later windows of half a second or more: a shape's first
            # capture (about a second), after the first window's.
            "stalls": sum(ms >= 500 for ms in rest),
            "ms_mean": sum(rest) / len(rest) if rest else None,
            "ms_p50": rest[len(rest) // 2] if rest else None,
            "ms_max": rest[-1] if rest else None,
        })
    return out


def _replica_checks(cluster) -> list:
    """Each replica's (items its verifier was given, sig_verified +
    sig_rejected), read from /metrics and /status once two reads agree."""
    last = None
    for _ in range(20):
        now = []
        for i, port in enumerate(cluster.metrics_ports):
            try:
                items = _samples(_scrape(port, "/metrics"), str(i))["pbft_verify_items_total"]
                status = json.loads(_scrape(port, "/status"))
            except OSError as e:
                log = "" if i in cluster.threads else cluster.log_path(i).read_text(errors="replace")[-2000:]
                raise PhaseFailed(f"replica {i}'s /metrics on port {port}: {e}\n{log}") from e
            check(status.get("replica") == i, f"replica {i}'s /status on port {port} is {status.get('replica')}'s")
            now.append((int(items), status.get("sig_verified", 0) + status.get("sig_rejected", 0)))
        if now == last:
            return now
        last = now
        time.sleep(0.5)
    return last


def phase_asyncio(K, VS, card: str, engine=None) -> dict:
    """BASELINE's configs 0-4 (pbft_tpu_torch.bench.harness CONFIGS) at
    full width as clusters of the port's asyncio replicas
    (pbft_tpu_torch.net.server), at the ASYNCIO_REQUESTS depths. Configs 0-2:
    every replica verifies its batches on the card in its own process
    (--verifier cuda; 4, 4 and 7 CUDA contexts on one card), config 0's
    primary on an event-loop thread of this process; configs 3-4: every
    replica sends its batches to one daemon on the card, serving on
    ``engine`` (a one-slot CudaVerifyEngine, warmed by the first daemon
    that starts on it). Then
    a mixed cluster, two pbftd and two asyncio replicas on config 4's
    daemon, commits ASYNCIO_MIXED_REQUESTS. Checks: every request commits
    with f + 1 matching signed replies (the harness raises otherwise); every
    replica verified items, as many as its signature checks (/metrics
    against /status); no view change; config 4 rejects signatures; every process
    that verifies on the card is listed by nvidia-smi, and on a daemon no
    replica is; config 0's in-process primary launched each kernel once per
    window after its warmup; on a daemon, its items equal the replicas'
    checks, nothing fell back to the host after the warm, and each kernel
    launched once per daemon window per shard. Rows are printed with the
    card. Returns the launch counts by path."""
    import dataclasses
    import tempfile

    from pbft_tpu_torch import native
    from pbft_tpu_torch.bench import harness as H
    from pbft_tpu_torch.crypto import batch

    native.build()
    launches = {}
    me = os.getpid()

    def daemon_checks(what, res, daemon, ready, end, got, byzantine):
        acc = res.accounting
        check(acc["service_items"] == acc["replica_sig_checks"] and acc["replica_service_fallbacks"] == 0,
              f"{what}: the daemon verified {acc['service_items']} items, the replicas checked "
              f"{acc['replica_sig_checks']} ({acc['replica_service_fallbacks']} batches on their hosts)")
        check(end["fallback_items"] == ready["fallback_items"] == 0, f"{what}: fallback items {end}")
        check((res.service_rejected > 0) == byzantine, f"{what}: the daemon rejected {res.service_rejected}")
        return check_launches(K, what.replace(" ", "_"), end["launches"] - ready["launches"],
                              daemon.engine.device_count, got=got)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-asyncio-") as traces:
        phase_t0 = time.perf_counter()
        for index, (name, n, _clients, _requests, byzantine) in enumerate(H.CONFIGS):
            trace_dir = os.path.join(traces, f"cfg{index}")
            in_process = index in ASYNCIO_IN_PROCESS
            seen = {}

            def on_warm(cluster, seen=seen):
                seen["pids"] = [me if p is None else p.pid for p in cluster.procs]
                if cluster.threads:
                    server = seen["server"] = cluster.threads[0].server
                    time.sleep(1.0)  # the warmup's last votes
                    t0 = time.perf_counter()
                    for k in (1, 17, 65):  # shapes 16, 64 and 256, captured in this process
                        batch.verify_many([batch.PAD_ITEM] * k)
                    seen["capture_s"] = time.perf_counter() - t0
                    seen["windows0"] = server.batches_run
                    K.reset_launches()

            def on_done(cluster, seen=seen):
                seen["checks"] = _replica_checks(cluster)
                if "server" in seen:
                    seen["windows"] = seen["server"].batches_run - seen["windows0"]
                    seen["launches"] = dict(K.LAUNCHES)

            daemon = None
            t0 = time.perf_counter()
            if not in_process:
                daemon = H.start_daemon("cuda", trace_dir=trace_dir, engine=engine)
            warm_s = time.perf_counter() - t0
            try:
                if daemon is not None:
                    ready = VS.probe_status_json(daemon.address)
                    K.reset_launches()  # after the warm's captures
                with ComputeApps() as apps:
                    res = H.run_native_config(
                        index, requests=ASYNCIO_REQUESTS[index],
                        verifier="cuda" if in_process else daemon.address,
                        impl=(["thread"] + ["py"] * (n - 1)) if index == 0 else "py",
                        tag="asyncio-cuda" if in_process else "asyncio-daemon",
                        trace_dir=trace_dir, metrics_ports=True, on_warm=on_warm, on_done=on_done)
                    apps.poll()
                if daemon is not None:
                    end = VS.probe_status_json(daemon.address)
                    launches[f"asyncio_cfg{index}"] = daemon_checks(
                        f"asyncio cfg{index}", res, daemon, ready, end, dict(K.LAUNCHES), byzantine)
                if index == len(H.CONFIGS) - 1:
                    # A mixed cluster on the same daemon.
                    mixed0 = VS.probe_status_json(daemon.address)
                    K.reset_launches()
                    mixed = H.run_native_config(0, requests=ASYNCIO_MIXED_REQUESTS, verifier=daemon.address,
                                                impl=ASYNCIO_MIXED, tag="asyncio-mixed")
                    got = dict(K.LAUNCHES)
                    mixed1 = VS.probe_status_json(daemon.address)
                    emit("asyncio", mixed=ASYNCIO_MIXED, requests=mixed.requests,
                         requests_per_sec=mixed.requests_per_sec, reply_p50_ms=mixed.reply_p50_ms,
                         row=dataclasses.asdict(mixed), card=card)
                    check(mixed.accounting["view_changes_started"] == 0, f"mixed cluster: {mixed.accounting}")
                    launches["asyncio_mixed"] = daemon_checks("asyncio mixed", mixed, daemon, mixed0, mixed1, got,
                                                              False)
            finally:
                if daemon is not None:
                    daemon.stop()
            acc = res.accounting
            windows = _trace_windows(trace_dir, n)
            checks = seen["checks"]
            # The processes with a context on the card: this one (earlier
            # phases, config 0's primary, the daemon) and each replica on
            # --verifier cuda.
            on_card = sorted(set(seen["pids"] if in_process else []) | {me})
            emit("asyncio", config_index=index, name=name, replicas=n, verifier=res.verifier,
                 requests=res.requests, requests_per_sec=res.requests_per_sec, rounds_per_sec=res.rounds_per_sec,
                 reply_ms={"p50": res.reply_p50_ms, "p95": res.reply_p95_ms, "p99": res.reply_p99_ms},
                 windows_per_replica=[w["windows"] for w in windows],
                 ms_per_window={k: [w[f"ms_{k}"] for w in windows] for k in ("mean", "p50", "max")},
                 first_window_s=[w["first_window_s"] for w in windows],
                 card_processes=len(on_card), card_pids=on_card, compute_apps=apps.entries,
                 card_mib_per_entry=sorted(mib for _, mib in apps.entries), card_used_mib=apps.used_mib,
                 card_used_mib_per_process=apps.used_mib / len(on_card),
                 capture_stalls_per_replica=[w["stalls"] for w in windows],
                 pids_listed=sorted(set(on_card) & set(apps.mib)), daemon_warm_s=warm_s if daemon else None,
                 in_process_capture_s=seen.get("capture_s"), items_and_checks=checks,
                 row=dataclasses.asdict(res), card=card)
            what = f"asyncio config {index}"
            check(res.replicas == n and acc["view_changes_started"] == 0,
                  f"{what}: {acc['view_changes_started']} view changes")
            check(len(checks) == n and all(items == sig > 0 for items, sig in checks),
                  f"{what}: (items verified, signature checks) per replica {checks}")
            check((acc["replica_sig_rejected"] > 0) == byzantine, f"{what}: {acc['replica_sig_rejected']} rejected")
            check(len(apps.entries) == len(on_card),
                  f"{what}: {len(on_card)} processes verify on the card, nvidia-smi lists {apps.entries}")
            if index == 0:
                launches["asyncio_cfg0_primary"] = check_launches(
                    K, "asyncio_cfg0_primary", seen["windows"], got=seen["launches"])
        emit("asyncio", phase_s=time.perf_counter() - phase_t0, card=card)
    return launches


# ---------------------------------------------------------------------------
# The analysis layer and its gates: lint, restart, chaos, pbft_top,
# endurance, the trace and flight tools, on one daemon on the card.
# ---------------------------------------------------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
HEALTH_ARMS = ("fault-free", "crash-backup", "stutter-primary")
# chaos_bench's own shape (its CLI defaults) but for the requests per
# client, cut from 120 to 30 so that the phase fits.
HEALTH_CHAOS = dict(n=4, clients=8, requests_each=30, window=8, batch=32, batch_flush_us=2000, impl="py",
                    gateways=1, vc_timeout_ms=600, admission_inflight=0, admission_backlog=0, fault_at_s=2.0,
                    heal_at_s=6.0, deadline_s=120.0, seed=12, blackbox_dir=None)
# The crash arm's load must outlast the heal at 6 s and the revived
# backup's catch-up, or the backup dies and comes back on an idle cluster:
# 320 per client lasted 6.2 s on an H100 with the SHA-512 kernel (~410
# req/s, too short for the catch-up), so this arm sends 700 per client
# (~14 s).
HEALTH_CRASH_REQUESTS = 700
HEALTH_TOP_WINDOW_S = 4  # pbft_top --once sampling window, under load (cut from 8)
HEALTH_ENDURANCE_S = 10  # endurance_soak's CI size is 180 s; cut so that the smoke fits its time


def _port_env() -> dict:
    return dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))


def start_daemon_process(cache_dir: str, log_path: str, backend: str = "cuda", timeout: float = 600.0):
    """The port's daemon as a process of its own (so that a restart is a
    new process): ``python -m pbft_tpu_torch.net.verify_service --port 0
    --wait-ready --cache-dir DIR``. Returns (Popen, the listening line: its
    address and JSON status, printed once warm) and the wall seconds to
    that line."""
    t0 = time.perf_counter()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pbft_tpu_torch.net.verify_service", "--port", "0", "--metrics-port", "0",
             "--wait-ready", "--backend", backend, "--cache-dir", cache_dir],
            stdout=log, stderr=subprocess.STDOUT, cwd=HERE, env=_port_env())
    deadline = time.monotonic() + timeout
    while True:
        with open(log_path, errors="replace") as fh:
            for line in fh:
                if line.startswith("{") and '"verify_service_listening"' in line:
                    return proc, json.loads(line), time.perf_counter() - t0
        if proc.poll() is not None or time.monotonic() > deadline:
            stop_process(proc)
            with open(log_path, errors="replace") as fh:
                raise PhaseFailed(f"the daemon did not warm (exit {proc.returncode}):\n{fh.read()[-3000:]}")
        time.sleep(0.2)


def stop_process(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def run_module(module: str, *args, timeout: float = 300.0):
    return subprocess.run([sys.executable, "-m", module, *map(str, args)], capture_output=True, text=True,
                          cwd=HERE, env=_port_env(), timeout=timeout)


def check_accounting(what: str, acc: dict, crashed: bool = False) -> None:
    """Every signature a replica checked was verified by the daemon, and no
    replica and not the daemon verified any on a host fallback. A replica
    killed mid-run counts its checks up to its last metrics line, so on a
    crash arm the daemon may have verified more, by at most one metrics
    interval of one replica's checks (``lost_max_items``)."""
    check(acc["service_fallback_items"] == 0 and acc["replica_service_fallbacks"] == 0,
          f"{what}: host fallback {acc}")
    check(acc["replica_sig_checks"] > 0 and all(c > 0 for c in acc["replica_checks"]), f"{what}: {acc}")
    if crashed:
        check(0 <= acc["unaccounted_items"] <= acc["lost_max_items"], f"{what}: {acc}")
    else:
        check(acc["unaccounted_items"] == 0, f"{what}: the daemon's items against the replicas' checks {acc}")


def phase_health(K, VS, card: str, backend: str = "cuda") -> dict:
    """The analysis layer and the gates that read it (pbft_tpu_torch.analysis,
    pbft_tpu_torch.scripts), on the port's asyncio replicas and one daemon
    on the card. (1) pbft_lint exits 0, every pass clean. (2) Restart: the
    daemon, a process of its own, starts on an empty --cache-dir (nvcc
    builds the kernels there), stops, and starts again on it: the second
    start compiles nothing. (3) chaos_bench's fault-free, crash-backup and
    stutter-primary arms on the second daemon, health gate on: each meets
    its completion bar with no verdict, the crashed backup heals under load
    and catches up, stutter-primary changes view.
    (4) pbft_top --gate --once over a loaded cluster exits 0. (5)
    endurance_soak for HEALTH_ENDURANCE_S with the WAL on: gate green.
    (6) trace_report, consensus_timeline and flight_dump over the
    crash-backup arm's traces and dumps, verify_status on the daemon. (7)
    Every step: the daemon's items equal the replicas' checks, nothing on a
    host fallback after ready; each kernel launched once per daemon window
    per shard. ``backend="native"`` rehearses the phase without a card
    (the restart's build checks are then skipped). Returns the launches."""
    import tempfile
    from pathlib import Path

    from pbft_tpu_torch import native
    from pbft_tpu_torch.net.launcher import LocalCluster
    from pbft_tpu_torch.scripts import chaos_bench, endurance_soak

    native.build()
    phase_t0 = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-health-") as tmp:
        # (1) the lint
        t0 = time.perf_counter()
        lint = run_module("pbft_tpu_torch.scripts.pbft_lint")
        files = dict(re.findall(r"\[pbft_lint\] ([\w-]+): ok \((\d+) files\)", lint.stdout))
        emit("health", step="lint", rc=lint.returncode, files_per_pass=files, seconds=time.perf_counter() - t0)
        check(lint.returncode == 0 and len(files) == 4 and "all passes clean" in lint.stdout,
              f"pbft_lint: {lint.stdout}{lint.stderr}")

        # (2) the restart
        cache = os.path.join(tmp, "cache")
        os.mkdir(cache)
        starts = []
        for turn in (1, 2):
            proc, line, start_s = start_daemon_process(cache, os.path.join(tmp, f"daemon-{turn}.log"), backend)
            warm = line.get("warm_stats", {})
            starts.append(warm)
            emit("health", step="restart", start=turn, start_s=start_s, state=line["state"],
                 build_s=warm.get("build_s"), build_compiled=warm.get("build_compiled"),
                 build_dir=warm.get("build_dir"), compiled=warm.get("compiled"),
                 cold_compile_s=warm.get("cold_compile_s"), warm_load_s=warm.get("warm_load_s"),
                 graph_pool_bytes=warm.get("graph_pool_bytes"), card=card)
            if turn == 1:
                stop_process(proc)
        address = line["addr"]
        try:
            if backend == "cuda":
                first, second = starts
                check(sorted(first["build_compiled"]) == sorted(K._SOURCES) and second["build_compiled"] == [],
                      f"restart: the second start compiled {second['build_compiled']}")
                check(first["build_dir"] == second["build_dir"]
                      and first["build_dir"].startswith(os.path.join(cache, "")), f"restart: {starts}")
                check(line["state"] == "ready" and first["compiled"] == second["compiled"] > 0, f"restart: {line}")
            ready = VS.probe_status_json(address)
            check(ready is not None and ready["fallback_items"] == 0, f"daemon after ready: {ready}")

            # (3) chaos, health gate on
            keep = os.path.join(tmp, "kept")
            for arm in HEALTH_ARMS:
                t0 = time.perf_counter()
                shape = dict(HEALTH_CHAOS)
                if arm == "crash-backup":
                    shape["requests_each"] = HEALTH_CRASH_REQUESTS
                row = chaos_bench.run_arm_traced(arm=arm, **shape, health_gate=True, verifier=address,
                                                 keep_dir=keep)
                emit("health", step="chaos", arm_s=time.perf_counter() - t0, row=row, card=card)
                check(row["ok"] and row["completed_pct"] >= chaos_bench.COMPLETION_BAR[arm]
                      and row["health_verdicts"] == [] and row["health_snapshots"] > 0, f"chaos {arm}: {row}")
                if arm == "stutter-primary":
                    check(row["view_changes_started"] >= 1 and row["vc_latency_ms"]["count"] >= 1,
                          f"chaos {arm}: no view change {row}")
                elif arm == "crash-backup":
                    check(row["seconds"] > shape["heal_at_s"] and row["recovery_after_heal_s"] >= 0,
                          f"chaos {arm}: the load ended before the heal, or the backup never caught up {row}")
                else:
                    check(row["view_changes_started"] == 0, f"chaos {arm}: view changes {row}")
                check_accounting(f"chaos {arm}", row["verify_accounting"], crashed=arm == "crash-backup")

            # (4) pbft_top --gate --once over a loaded cluster
            t0 = time.perf_counter()
            status0 = VS.probe_status_json(address)
            flight = os.path.join(tmp, "top-flight")
            with LocalCluster(n=4, impl="py", verifier=address, metrics_ports=True, batch_max_items=32,
                              batch_flush_us=2000, flight_dir=flight) as cluster:
                cfg = os.path.join(cluster.tmpdir.name, "network.json")
                gw, gw_port = chaos_bench.start_gateway(cfg, Path(tmp) / "top-gateway.log")
                try:
                    load = endurance_soak.LoadThread(gw_port, 4, 50, 8, quorum=2,
                                                     deadline=time.monotonic() + HEALTH_TOP_WINDOW_S + 4)
                    load.start()
                    top = run_module("pbft_tpu_torch.scripts.pbft_top", "--targets",
                                     ",".join(f"127.0.0.1:{p}" for p in cluster.metrics_ports), "--gate", "--once",
                                     "--window-s", HEALTH_TOP_WINDOW_S, "--interval", 1, "--flight-dir", flight)
                    load.join(timeout=90)
                    acc = chaos_bench.verify_accounting(cluster, address, status0, read=lambda: [
                        [[json.loads(_scrape(p, "/status"))]] for p in cluster.metrics_ports])
                finally:
                    stop_process(gw)
            verdict = json.loads(top.stdout.strip().splitlines()[-1]) if top.stdout.strip() else {}
            emit("health", step="pbft_top", rc=top.returncode, verdict=verdict, load_completed=load.completed,
                 load_attempted=load.attempted, accounting=acc, seconds=time.perf_counter() - t0, card=card)
            check(top.returncode == 0 and verdict.get("ok") is True and verdict.get("snapshots", 0) >= 2,
                  f"pbft_top: {top.stdout[-2000:]}{top.stderr[-2000:]}")
            check(load.error is None and load.completed > 0, f"pbft_top load: {load.error}")
            check_accounting("pbft_top", acc)

            # (5) endurance, WAL on
            t0 = time.perf_counter()
            out = os.path.join(tmp, "endurance.jsonl")
            soak = run_module("pbft_tpu_torch.scripts.endurance_soak", "--duration-s", HEALTH_ENDURANCE_S,
                              "--verifier", address, "--out", out, timeout=HEALTH_ENDURANCE_S + 300)
            row = json.loads(open(out).read().splitlines()[-1]) if os.path.exists(out) else {}
            emit("health", step="endurance", rc=soak.returncode, seconds=time.perf_counter() - t0,
                 requests_per_sec=row.get("requests_per_sec"), reply_p50_ms=row.get("reply_p50_ms"),
                 reply_p99_ms=row.get("reply_p99_ms"), slopes_per_s=row.get("slopes_per_s"), row=row, card=card)
            check(soak.returncode == 0 and row.get("ok") and row["health_verdicts"] == [] and row["requests"] > 0,
                  f"endurance: {soak.stdout[-2000:]}{soak.stderr[-2000:]}")
            check_accounting("endurance", row["verify_accounting"])

            # (6) the trace and flight tools, verify_status
            kept = os.path.join(keep, f"crash-backup-seed{HEALTH_CHAOS['seed']}")
            report = run_module("pbft_tpu_torch.scripts.trace_report", os.path.join(kept, "traces"))
            m = re.search(r"cluster: (\d+) verifications in (\d+) launches", report.stdout)
            timeline = run_module("pbft_tpu_torch.scripts.consensus_timeline", os.path.join(kept, "traces"), "--json")
            rounds = len(json.loads(timeline.stdout)["slots"]) if timeline.returncode == 0 else 0
            dumps = sorted(glob.glob(os.path.join(kept, "flight", "replica-*.flight")))
            fdump = run_module("pbft_tpu_torch.scripts.flight_dump", *dumps, "--json")
            records = {os.path.basename(k): len(v) for k, v in json.loads(fdump.stdout or "{}").items()}
            vstatus = run_module("pbft_tpu_torch.scripts.verify_status", address)
            emit("health", step="tools", trace_report_rc=report.returncode,
                 batches=int(m.group(2)) if m else 0, items=int(m.group(1)) if m else 0,
                 consensus_timeline_rc=timeline.returncode, rounds=rounds, flight_dump_rc=fdump.returncode,
                 flight_records=records, verify_status_rc=vstatus.returncode, verify_status=vstatus.stdout,
                 card=card)
            check(report.returncode == 0 and m and int(m.group(2)) > 0, f"trace_report: {report.stdout}{report.stderr}")
            check(timeline.returncode == 0 and rounds > 0, f"consensus_timeline: {timeline.stderr[-2000:]}")
            check(fdump.returncode == 0 and any(n > 0 for n in records.values()), f"flight_dump: {fdump.stderr}")
            want_state = "ready" if backend == "cuda" else "cpu-only"
            check(vstatus.returncode == 0 and f"state           {want_state}" in vstatus.stdout
                  and (backend != "cuda" or torch_card_name(card) in vstatus.stdout),
                  f"verify_status: {vstatus.stdout}{vstatus.stderr}")

            # (7) the daemon's windows against each kernel's launches
            end = VS.probe_status_json(address)
            check(end["fallback_items"] == 0, f"daemon fallback items {end}")
            if backend == "cuda":
                got = {k: end["kernel_launches"][k] - ready["kernel_launches"][k] for k in K.KERNELS}
                launches["health"] = check_launches(K, "health", end["launches"] - ready["launches"],
                                                    end["devices"], got=got)
            emit("health", daemon_items=end["items"] - ready["items"], daemon_windows=end["launches"] - ready["launches"],
                 phase_s=time.perf_counter() - phase_t0, card=card)
        finally:
            stop_process(proc)
    return launches


# ---------------------------------------------------------------------------
# The evidence and sweep tools (pbft_tpu_torch.scripts), on the card.
# ---------------------------------------------------------------------------

# The protocol phase runs configs 0-1; the graphs phase profiles a replayed
# 4,096 window as the profile step would (dropped so that the smoke fits).
EVIDENCE_STEPS = "kernel,decomp"
EVIDENCE_STAGE_TOLERANCE = 0.15  # the stages' device busy ms against the whole window's
# The SHA-512 stage's device activities: its concatenation and its kernel
# (the plain version's ~14.5k elementwise kernels would read far above).
SHA512_STAGE_MAX_ACTIVITIES = 8
# chaos_soak at n = 4: seeds x modes of this many steps (the script's soak
# is 25 seeds x 400 steps x n = 4, 7 x both modes).
EVIDENCE_CHAOS = dict(seeds=1, steps=120, modes=("sig", "mac"))
# scale_curve at n = 4 and 7 through one gateway, few requests per client
# (the script's default is 8 clients x 50 at n = 4, 7, 16, 31).
EVIDENCE_SCALE = dict(ns=(4, 7), clients=4, requests=5)
# window_sweep's grid (the script's is pipelines 8-64 x flushes 0-2,000 us
# at 192 requests).
EVIDENCE_SWEEP = dict(pipelines=(32,), flushes=(0, 2000), requests=64)


def _positive(doc: dict, keys) -> bool:
    return all(isinstance(doc.get(k), (int, float)) and doc[k] > 0 for k in keys)


def phase_evidence(K, VS, card: str, backend: str = "cuda", engine=None) -> tuple:
    """The evidence and sweep tools on the card. (1) gpu_evidence --steps
    kernel,decomp, a process of its own (each step in one more):
    every key present and positive, verdicts equal to the oracle, the
    stages' busy ms within 15% of the whole window's device busy ms, each stage's
    outputs equal to the eager path's. (2) chaos_soak --verifier cuda at
    n = 4 (EVIDENCE_CHAOS seeds and modes), then its validator: every seed
    passes S1-S3 and L1, the validator trips, each kernel launched once per
    cuda_verifier window. (3) scale_curve --n 4,7 --verifier daemon: both
    rows, every request completed, the daemon's items equal to the
    replicas' checks, launches = daemon windows. (4) window_sweep on the
    daemon's cuda backend over EVIDENCE_SWEEP (on ``engine``, a one-slot
    CudaVerifyEngine, warmed here unless it is), each row with its
    launch_cost_model projections at 100 us and at step 1's graph launch,
    from step 1's rate; launches = daemon windows. (5) bench_compare on
    step 3's rows: against themselves exit 0, against a copy with
    requests_per_sec cut by 20% exit 1. ``backend="native"`` rehearses the
    phase without a card (steps 1-2 then run on the CPU's arms and launch
    counts are not checked). Returns (launches by path, each kernel's
    stage and its device ms from step 1, step 1's kernel record)."""
    import tempfile
    from pathlib import Path

    import torch

    from pbft_tpu_torch.net.verify_service import CudaVerifyEngine
    from pbft_tpu_torch.scripts import bench_compare, chaos_soak, scale_curve, window_sweep

    phase_t0 = time.perf_counter()
    on_card = backend == "cuda"
    shards = torch.cuda.device_count() if on_card else 1
    launches, stage_ms = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-evidence-") as tmp:
        # (1) gpu_evidence
        t0 = time.perf_counter()
        if on_card:
            out_dir = os.path.join(tmp, "evidence")
            ev = run_module("pbft_tpu_torch.scripts.gpu_evidence", "--steps", EVIDENCE_STEPS, "--out-dir", out_dir,
                            "--timeout", 300, timeout=900)
            docs = {}
            for step in EVIDENCE_STEPS.split(","):
                path = os.path.join(out_dir, f"{step}.json")
                docs[step] = json.loads(Path(path).read_text()) if os.path.exists(path) else {}
                emit("evidence", step=f"gpu_evidence_{step}", rc=ev.returncode, row=docs[step], card=card)
            emit("evidence", step="gpu_evidence_log", lines=[ln for ln in ev.stderr.splitlines()
                                                             if ln.startswith("[gpu_evidence")])
            check(ev.returncode == 0, f"gpu_evidence exit {ev.returncode}: {ev.stdout[-2000:]}{ev.stderr[-3000:]}")
            kernel, decomp = docs["kernel"], docs["decomp"]
            check(_positive(kernel, ("value", "graph_launch_us", "window_ms", "capture_s"))
                  and kernel["verdicts_equal_oracle"] is True and kernel["invalid_rows"] == 1, f"kernel: {kernel}")
            check(_positive(decomp, ("field_mul_per_sec", "carry_per_sec", "carry_share_of_mul",
                                     "sha512_32B_per_sec", "stages_ms", "stages_busy_ms"))
                  and decomp["verdicts_equal_oracle"] is True
                  and _positive(decomp["window"], ("ms", "busy_ms", "activities")), f"decomp: {decomp}")
            stages = decomp["stages"]
            check([st["stage"] for st in stages] == ["sha512", "mod_l", "decompress", "ladder", "compress", "compare"]
                  and all(_positive(st, ("ms", "busy_ms", "activities")) and st["outputs_equal_eager"] is True
                          for st in stages), f"decomp stages: {stages}")
            check(stages[0]["kernel"] == "sha512" and stages[0]["activities"] <= SHA512_STAGE_MAX_ACTIVITIES,
                  f"the sha512 stage does not run the kernel: {stages[0]}")
            check(abs(decomp["stages_over_window"] - 1) <= EVIDENCE_STAGE_TOLERANCE,
                  f"the stages' {decomp['stages_busy_ms']} busy ms against the window's "
                  f"{decomp['window']['busy_ms']} busy ms")
            stage_ms = {st["kernel"]: {"stage": st["stage"], "stage_ms": st["ms"], "stage_busy_ms": st["busy_ms"]}
                        for st in stages if st["kernel"]}
        else:
            kernel = {"value": 100_000.0, "graph_launch_us": 1000.0}  # the rehearsal's stand-in record
        emit("evidence", step="gpu_evidence", seconds=time.perf_counter() - t0, card=card)

        # (2) chaos_soak, every window on the card, then its validator
        t0 = time.perf_counter()
        verifier = "cuda" if on_card else "native"
        K.reset_launches()
        runs = [chaos_soak.run_one(seed, 4, EVIDENCE_CHAOS["steps"], mode=mode, verifier=verifier)
                for seed in range(EVIDENCE_CHAOS["seeds"]) for mode in EVIDENCE_CHAOS["modes"]]
        valid = chaos_soak.validate_checker(verifier=verifier)
        got = dict(K.LAUNCHES)
        windows = sum(r["windows"] for r in runs) + valid["windows"]
        for r in runs:
            emit("evidence", step="chaos_soak", **{k: v for k, v in r.items() if k != "schedule"},
                 schedule=r["schedule"].describe(), card=card)
        emit("evidence", step="chaos_soak_validate", result=valid, seconds=time.perf_counter() - t0, card=card)
        check(all(r["ok"] for r in runs), f"chaos_soak: {[r.get('violation') for r in runs if not r['ok']]}")
        check(valid["tripped"], "chaos_soak --validate: f+1 equivocators ran clean")
        if on_card:
            launches["evidence_chaos_soak"] = check_launches(K, "evidence_chaos_soak", windows, shards, got=got)

        # (3) scale_curve on the daemon
        t0 = time.perf_counter()
        out = os.path.join(tmp, "scale.jsonl")
        rc = scale_curve.main(["--n", ",".join(map(str, EVIDENCE_SCALE["ns"])), "--clients", str(EVIDENCE_SCALE["clients"]),
                               "--requests", str(EVIDENCE_SCALE["requests"]), "--verifier", "daemon",
                               "--service-backend", backend, "--out", out])
        rows = [json.loads(line) for line in Path(out).read_text().splitlines()] if os.path.exists(out) else []
        emit("evidence", step="scale_curve", rc=rc, rows=rows, seconds=time.perf_counter() - t0, card=card)
        want_requests = EVIDENCE_SCALE["clients"] * EVIDENCE_SCALE["requests"]
        check(rc == 0 and [r["replicas"] for r in rows] == list(EVIDENCE_SCALE["ns"])
              and all(r["completed_pct"] == 100.0 and r["requests"] == want_requests for r in rows),
              f"scale_curve exit {rc}: {rows}")
        for r in rows:
            check_accounting(f"scale_curve n={r['replicas']}", r["verify_accounting"])
        if on_card:
            accs = [r["verify_accounting"] for r in rows]
            launches["evidence_scale_curve"] = check_launches(
                K, "evidence_scale_curve", sum(a["service_windows"] for a in accs), accs[0]["service_devices"],
                got={k: sum(a["kernel_launches"][k] for a in accs) for k in K.KERNELS})

        # (4) window_sweep on the card's daemon, projected from step 1
        t0 = time.perf_counter()
        if not on_card:
            engine = None
        elif engine is None or not engine.warmed_sizes:
            engine = engine or CudaVerifyEngine(slots=1)
            engine.warm()
        K.reset_launches()
        sweep = window_sweep.sweep(EVIDENCE_SWEEP["pipelines"], EVIDENCE_SWEEP["flushes"],
                                   EVIDENCE_SWEEP["requests"], kernel, backend, engine)
        got = dict(K.LAUNCHES)
        emit("evidence", step="window_sweep", rows=sweep, seconds=time.perf_counter() - t0, card=card)
        want_costs = {"launch_100us", f"launch_{int(kernel['graph_launch_us'])}us"}
        check(len(sweep) == len(EVIDENCE_SWEEP["pipelines"]) * len(EVIDENCE_SWEEP["flushes"])
              and all(r["items_per_launch"] > 0 and set(r["projected"]) == want_costs
                      and r["service_items"] == r["replica_sig_checks"] and r["service_fallback_items"] == 0
                      for r in sweep), f"window_sweep: {sweep}")
        if on_card:
            launches["evidence_window_sweep"] = check_launches(
                K, "evidence_window_sweep", sum(r["launches"] for r in sweep), engine.device_count, got=got)

        # (5) bench_compare on step 3's rows
        cut = os.path.join(tmp, "scale-cut.jsonl")
        with open(cut, "w") as fh:
            for r in rows:
                fh.write(json.dumps(dict(r, requests_per_sec=r["requests_per_sec"] * 0.8)) + "\n")
        same = bench_compare.main([out, out, "--group-by", "replicas"])
        slower = bench_compare.main([out, cut, "--group-by", "replicas"])
        emit("evidence", step="bench_compare", same_rc=same, cut_20pct_rc=slower,
             phase_s=time.perf_counter() - phase_t0, card=card)
        check(same == 0 and slower == 1, f"bench_compare: {same} against itself, {slower} against a 20% cut")
    return launches, stage_ms, kernel


BENCH_SECS = 1  # PBFT_BENCH_SECS, cut from the entry's 5 so that the smoke fits its time
BENCH_DEFAULT_SERVICE = "127.0.0.1:7600"  # the service arm's default target


def start_bench(*args, **env):
    """``python -m pbft_tpu_torch.bench ARGS`` started with ``env`` added (and
    no ``PBFT_VERIFY_SERVICE``: the service arm probes its default target)."""
    base = {k: v for k, v in _port_env().items() if k != "PBFT_VERIFY_SERVICE"}
    return subprocess.Popen([sys.executable, "-m", "pbft_tpu_torch.bench", *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=HERE, env={**base, **env})


def finish_bench(proc, timeout: float = 900.0) -> tuple:
    """Wait for ``start_bench``'s process: (exit code, its last line of
    standard output as a dict, its standard error)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop_process(proc)
        raise PhaseFailed(f"bench {proc.args[3:]} did not end in {timeout} s")
    lines = out.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else {}
    except ValueError:
        line = {}
    return proc.returncode, line, err


def _compute_apps() -> int:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=30).stdout
    return len([ln for ln in out.splitlines() if ln.strip()])


def phase_bench(K, card: str, evidence_window_ms=None) -> dict:
    """The bench entry, python -m pbft_tpu_torch.bench, each arm a process of
    its own at the entry's defaults but PBFT_BENCH_SECS (BENCH_SECS): (1)
    --cuda-worker (one CUDA graph of a chain of 16 verify_kernel
    applications at 4,096 rows); (2) the default arm with no service at its
    target: it spawns the port's daemon on the card, drives it and stops
    it; (3) PBFT_BENCH_NATIVE=1; (4) PBFT_BENCH_CONSENSUS=1; (5), started
    beside (1), --cuda-worker with no visible card: the backend-init
    failure line. Each line is checked; the launches of (1)'s
    timed region and of (2)'s daemon over the entry's traffic are read from
    the lines. Returns the launches by path."""
    from pbft_tpu_torch.net.verify_service import probe_status_json

    phase_t0 = time.perf_counter()
    launches = {}
    secs = {"PBFT_BENCH_SECS": str(BENCH_SECS)}

    def arm(name: str, *args, proc=None, **env) -> tuple:
        t0 = time.perf_counter()
        rc, line, err = finish_bench(proc or start_bench(*args, **{**secs, **env}))
        emit("bench", arm=name, rc=rc, line=line, seconds=time.perf_counter() - t0, card=card)
        return rc, line, f"rc={rc} {line} {err[-3000:]}"

    # (5) starts beside (1): a process that sees no card
    no_card = start_bench("--cuda-worker", CUDA_VISIBLE_DEVICES="")
    try:
        # (1) the card, in process: the chain of verify_kernel applications
        rc, line, what = arm("cuda", "--cuda-worker")
        emit("bench", arm="cuda", window_ms=line.get("window_ms"), evidence_window_ms=evidence_window_ms,
             capture_s=line.get("capture_s"), card=card)
        check(rc == 0 and line.get("backend") == "cuda" and line.get("value", 0) > 0
              and (line.get("batch"), line.get("chain")) == (B, 16) and line.get("window_ms", 0) > 0
              and line.get("card"), f"bench --cuda-worker: {what}")
        launches["bench_cuda"] = check_launches(K, "bench_cuda", line["applications"], got=line["launches"])

        # (5) no visible card: the failure line, never a number under cuda
        rc, line, what = arm("cuda_no_card", proc=no_card)
        check(rc == 1 and line.get("value") == 0.0 and str(line.get("error", "")).startswith("backend-init")
              and "backend" not in line, f"bench --cuda-worker without a card: {what}")
    finally:
        stop_process(no_card)

    # (2) the default arm: nothing at its target, so it spawns the daemon
    check(probe_status_json(BENCH_DEFAULT_SERVICE, timeout=2.0) is None,
          f"a verify service already answers at {BENCH_DEFAULT_SERVICE}")
    apps_before = _compute_apps()
    rc, line, what = arm("service")
    apps_after = _compute_apps()
    emit("bench", arm="service", compute_apps_before=apps_before, compute_apps_after=apps_after, card=card)
    check(rc == 0 and line.get("backend") == "verify-service" and line.get("service_state") == "ready"
          and line.get("value", 0) > 0 and line.get("cold_start_s", 0) > 0 and line.get("devices", 0) >= 1
          and line.get("service_windows", 0) > 0, f"bench (service arm): {what}")
    check(not os.path.exists(f"/proc/{line['service_pid']}") and apps_after <= apps_before,
          f"the spawned daemon outlived the entry: pid {line['service_pid']}, compute processes "
          f"{apps_before} -> {apps_after}")
    launches["bench_service"] = check_launches(K, "bench_service", line["service_windows"], line["devices"],
                                               got=line["kernel_launches"])

    # (3) the host's native pool
    rc, line, what = arm("native", PBFT_BENCH_NATIVE="1")
    check(rc == 0 and line.get("backend") == "cpu-native" and line.get("value", 0) > 0
          and line.get("threads", 0) >= 1, f"bench PBFT_BENCH_NATIVE=1: {what}")

    # (4) the f = 1 firehose on pbftd
    rc, line, what = arm("consensus", PBFT_BENCH_CONSENSUS="1")
    check(rc == 0 and line.get("backend") == "consensus-native" and line.get("metric") == "pbft_requests_per_sec"
          and line.get("requests") == 960 and line.get("value", 0) > 0, f"bench PBFT_BENCH_CONSENSUS=1: {what}")
    emit("bench", phase_s=time.perf_counter() - phase_t0, card=card)
    return launches


def torch_card_name(card: str) -> str:
    """The card's name from the nvidia-smi line (``name, power limit``)."""
    return card.split(",")[0].strip()


# ---------------------------------------------------------------------------
# The compile step: captured windows against the eager path.
# ---------------------------------------------------------------------------


def eager_verify(torch, E, pubs, msgs, sigs):
    """One window op by op on the card, as the port ran every window before
    the compile step: staged, ed25519.verify_kernel, verdicts to the host."""
    dev = torch.device("cuda")
    return E.verify_kernel(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pubs, msgs, sigs))).cpu()


def eager_many(torch, E, batch, items) -> list:
    pubs, msgs, sigs, n = batch.pad_batch(items, batch.pad_size(len(items)))
    return [bool(v) for v in eager_verify(torch, E, pubs, msgs, sigs)[:n]]


def capture_verify_shapes(batch, pool, sizes, card: str) -> dict:
    """verify_many's window of each shape captured ahead of the verify
    phase's count: its first use (priming run, capture, instantiation and
    one replay), timed."""
    out = {}
    for size in sizes:
        t0 = time.perf_counter()
        batch.verify_many(pool[:1], pad_to=size)
        out[size] = time.perf_counter() - t0
    emit("graphs", path="verify_many_first_use", seconds_by_shape=out, card=card)
    return out


def _together(fns) -> list:
    """Each fn in a thread of its own, all released at once; their results."""
    gate = threading.Barrier(len(fns), timeout=120)
    out, errors = [None] * len(fns), []

    def run(i):
        try:
            gate.wait()
            out[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 - checked below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not errors and not any(t.is_alive() for t in threads), f"concurrent windows failed: {errors[:2]}")
    return out


def phase_graphs(torch, E, K, VS, batch, pool, want, rng, card: str) -> dict:
    """The compile step on its own: (1) windows of B rows in sequence through
    one slot's static buffers (the second has pad rows where the first has
    invalid ones), each replay against the eager path and the oracle, and
    the first window's verdicts unchanged after the others; (2) an engine
    with two slots, and verify_many, each from two threads at once; (3)
    verify_many, graph against eager, in turns; (4) one replayed and one
    eager window under the profiler. Returns the timings."""
    want_arr = np.asarray(want)
    bad = np.flatnonzero(~want_arr)
    picks = [rng.choice(len(pool), size=n) for n in (B, 3000, B)]
    picks[0][3000:3100] = rng.choice(bad, size=100)
    K.reset_launches()
    kept = []
    for k, pick in enumerate(picks):
        pubs, msgs, sigs, n = batch.pad_batch([pool[i] for i in pick], B)
        graph = batch.verify_batch(pubs, msgs, sigs).cpu()
        eager = eager_verify(torch, E, pubs, msgs, sigs)
        oracle = np.ones(B, bool)
        oracle[:n] = want_arr[pick]
        ok = {"equal_to_eager": torch.equal(graph, eager), "equal_to_oracle": np.array_equal(graph.numpy(), oracle)}
        emit("graphs", path="window_sequence", window=k, items=n, rejected=int((~oracle).sum()), **ok, card=card)
        check(all(ok.values()), f"window {k} of the sequence: {ok}")
        kept.append((graph, oracle))
    check(np.array_equal(kept[0][0].numpy(), kept[0][1]), "an earlier window's verdicts changed")
    check_launches(K, "graphs_window_sequence", 2 * len(picks))  # one replay and one eager window each

    from pbft_tpu_torch.utils import graphs as G

    window = G.CapturedWindow(E.verify_kernel, [((B, w), torch.uint8) for w in (32, 32, 64)], "cuda").capture()
    emit("graphs", path="capture_one_window", batch=B, prime_s=window.prime_s,
         capture_and_instantiate_s=window.capture_s, launches_per_replay=window.launches, card=card)
    check(all(n == 1 for n in window.launches.values()), f"one capture recorded {window.launches}")
    del window
    engine = VS.CudaVerifyEngine(shapes=(B,), slots=2)
    stats = engine.warm()
    emit("graphs", path="engine_two_slots", warm_stats=stats, card=card)
    check(stats["compiled"] == 2 * engine.device_count, f"the engine captured {stats['compiled']} graphs")
    pairs = [rng.choice(len(pool), size=B) for _ in range(2)]
    batches = [[pool[i] for i in pick] for pick in pairs]
    expect = [want_arr[pick].tolist() for pick in pairs]
    rounds = 3
    K.reset_launches()
    for _ in range(rounds):
        got = _together([lambda b=b: engine.verify(b) for b in batches])
        check(got == expect, "two slots of one engine at once: wrong verdicts")
    emit("graphs", path="engine_two_slots", rounds=rounds, threads=2, correct=True, card=card)
    check_launches(K, "graphs_engine_two_slots", 2 * rounds, engine.device_count)
    for _ in range(rounds):  # a second slot of a lazily captured shape, captured while the first replays
        got = _together([lambda b=b: batch.verify_many(b) for b in batches])
        check(got == expect, "verify_many from two threads at once: wrong verdicts")
    emit("graphs", path="verify_many_two_threads", rounds=rounds, threads=2, correct=True, card=card)

    out = {}
    for size in (1024, B):
        items = batches[0][:size]
        ms = turns_ms(torch, {"graph": lambda: batch.verify_many(items),
                              "eager": lambda: eager_many(torch, E, batch, items)})
        out[size] = {name: {"ms_per_window": t, "verifies_per_s": size / t * 1e3} for name, t in ms.items()}
        emit("timing", path="verify_many", compare="graph_vs_eager_in_turns", batch=size, reps=REPS,
             **out[size], graph_over_eager=ms["eager"] / ms["graph"], card=card)
    prof = {}
    for name, fn in (("graph", lambda: batch.verify_many(batches[0])),
                     ("eager", lambda: eager_many(torch, E, batch, batches[0]))):
        prof[name] = profile_window(torch, fn)
        if "device_busy_ms" in prof[name]:
            prof[name]["idle_share"] = 1 - prof[name]["device_busy_ms"] / out[B][name]["ms_per_window"]
        emit("profile", path=f"verify_many_{name}", batch=B, **prof[name], card=card)
    calls = prof["graph"].get("launch_calls")
    if calls is not None:
        kernel_calls = sum(v for k, v in calls.items() if "Graph" not in k)
        check(kernel_calls <= MAX_KERNEL_LAUNCH_CALLS, f"a replayed window made {kernel_calls} kernel launch calls")
    return {"verify_many": out, "profile": prof, "engine_two_slots": stats}


# ---------------------------------------------------------------------------
# The parallel phase.
# ---------------------------------------------------------------------------


def quorum_window(batch, pool, want, f: int, rng) -> dict:
    """One B-row window of COMMIT signatures of an n = 3f + 1 cluster: R
    rounds of n rows drawn from the pool's valid items, then pad rows at
    round id R. Round 1 keeps exactly 2f + 1 valid rows (it certifies),
    round 2 keeps 2f (it does not), and 8 more rounds each lose one row."""
    n = CLUSTERS[f]
    R = B // n
    thr = 2 * f + 1
    good = np.flatnonzero(want)
    bad = np.flatnonzero(~np.asarray(want))
    pick = rng.choice(good, size=(R, n))
    pick[1, : n - thr] = rng.choice(bad, size=n - thr)
    pick[2, : n - thr + 1] = rng.choice(bad, size=n - thr + 1)
    for r in rng.choice(np.arange(3, R), size=min(8, R - 3), replace=False):
        pick[r, 0] = rng.choice(bad)
    items = [pool[i] for i in pick.ravel()]
    pubs, msgs, sigs, _ = batch.pad_batch(items, B)
    round_ids = np.full(B, R, np.int32)
    round_ids[: R * n] = np.repeat(np.arange(R, dtype=np.int32), n)
    oracle = np.ones(B, bool)  # pad rows hold the known-good pad triple
    oracle[: R * n] = np.asarray(want)[pick.ravel()]
    return {"f": f, "R": R, "items": items, "args": (pubs, msgs, sigs, round_ids, np.full(R, thr, np.int32)),
            "oracle": oracle}


def quorum_model(valid, round_ids, thresholds):
    """The JAX quorum_certify on verdicts, in numpy: ids clipped to [0, R],
    segment R dropped."""
    R = len(thresholds)
    counts = np.zeros(R + 1, np.int32)
    np.add.at(counts, np.clip(round_ids.astype(np.int32), 0, R), valid.astype(np.int32))
    return counts[:R], counts[:R] >= thresholds


def step_model(state, counts, certified):
    """The JAX round_step fold in numpy: an int32 running sum (it wraps),
    the last 8, mod 2^31 - 1 (floored)."""
    contrib = np.where(certified, counts, 0).astype(np.int32)
    run = np.cumsum(np.concatenate([state.astype(np.int32), contrib]), dtype=np.int32)
    return run[-len(state):] % np.int32(2**31 - 1)


def host_ms(torch, fn) -> float:
    """Milliseconds of one call on the host clock, ended by a synchronize (a
    window's own host work is most of its time)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def turns_ms(torch, fns: dict, reps: int = REPS) -> dict:
    """Mean ms per call of each path, timed in turns (forward, then
    backward order, ...) so that drift over the run falls on all alike."""
    total = dict.fromkeys(fns, 0.0)
    for rep in range(reps):
        for name in (list(fns) if rep % 2 == 0 else list(fns)[::-1]):
            total[name] += host_ms(torch, fns[name])
    return {name: t / reps for name, t in total.items()}


def profile_window(torch, fn) -> dict:
    """One call under torch.profiler (host and device activity): the aten
    events it recorded (nested calls included), the device's busy ms (kernel time summed) beside the
    call's wall ms under the profiler, and the CUDA runtime calls that took
    the most host time. A diagnostic: a profiler that cannot trace here is
    reported, not a failure of the run."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
    except Exception as e:  # noqa: BLE001 - reported in the line, see above
        return {"profile_error": f"{type(e).__name__}: {e}"}

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    runtime = sorted((e for e in events if e.key.startswith("cu")), key=lambda e: -e.cpu_time_total)
    return {
        "aten_events": sum(e.count for e in events if e.key.startswith("aten::")),
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": sum(device_us(e) for e in events) / 1e3,
        "launch_calls": {k: sum(e.count for e in runtime if e.key == k) for k in LAUNCH_CALLS},
        "runtime_calls": {e.key: [e.count, e.cpu_time_total / 1e3] for e in runtime[:6]},
    }


def eager_certify(torch, E, mesh, R: int):
    """quorum_certify op by op, as the port ran it before the compile step:
    each shard's rows staged and verified eagerly on its card, counted per
    round, the counts summed and all-reduced; (valid, counts, certified) on
    the host."""

    def certify(pubs, msgs, sigs, round_ids, thresholds):
        k = len(mesh.devices)
        step = len(pubs) // k
        valid, counts = [], []
        for i, dev in enumerate(mesh.devices):
            rows = slice(i * step, (i + 1) * step)
            ok = E.verify_kernel(*(torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)
                                   for a in (pubs, msgs, sigs)))
            rid = torch.from_numpy(np.asarray(round_ids[rows], np.int32)).to(dev).clamp(0, R).long()
            c = torch.zeros(R + 1, dtype=torch.int32, device=dev)
            c.scatter_add_(0, rid, ok.to(torch.int32))
            valid.append(ok.cpu())
            counts.append(c[:R].cpu())
        total = torch.stack(counts).sum(0, dtype=torch.int32)
        if mesh.group is not None:
            import torch.distributed as dist

            dist.all_reduce(total, group=mesh.group)
        return torch.cat(valid), total, total >= torch.from_numpy(np.asarray(thresholds, np.int32))

    return certify


def run_mesh(torch, P, K, E, mesh, path: str, windows, card: str) -> dict:
    """quorum_certify and round_step on one mesh at every window, checked
    against the oracle, the numpy model and the eager path; launches once
    per window per shard. Each (window shape, R) is captured at its first
    use, before the count. Returns the results and the callables per
    window."""
    out = {}
    certify = {w["f"]: P.quorum_certify(mesh, w["R"]) for w in windows}
    step = {w["f"]: P.round_step(mesh, w["R"]) for w in windows}
    eager = {w["f"]: eager_certify(torch, E, mesh, w["R"]) for w in windows}
    first_use_s = {}
    for w in windows:
        t0 = time.perf_counter()
        certify[w["f"]](*w["args"])
        first_use_s[w["f"]] = time.perf_counter() - t0
    emit("graphs", path=path, first_use_s_by_f=first_use_s, shards=len(mesh.devices), card=card)
    K.reset_launches()
    for w in windows:
        res = certify[w["f"]](*w["args"])
        state, sres = step[w["f"]](STATE0, *w["args"])
        got = {k: getattr(res, k).cpu().numpy() for k in ("valid", "counts", "certified")}
        got["state"] = state.cpu().numpy()
        counts, certified = quorum_model(w["oracle"], w["args"][3], w["args"][4])
        want_state = step_model(STATE0, counts, certified)
        ok = {
            "valid_equal_oracle": np.array_equal(got["valid"], w["oracle"]),
            "counts_equal_model": np.array_equal(got["counts"], counts) and got["counts"].dtype == np.int32,
            "certified_equal_model": np.array_equal(got["certified"], certified),
            "state_equal_model": np.array_equal(got["state"], want_state) and got["state"].dtype == np.int32,
            "step_equal_certify": all(torch.equal(getattr(res, k), getattr(sres, k))
                                      for k in ("valid", "counts", "certified")),
            "planted_rounds": bool(certified[1]) and not bool(certified[2]),
            "state_wrapped": bool((np.cumsum(np.concatenate([STATE0, np.where(certified, counts, 0)])
                                             .astype(np.int64)) > 2**31 - 1).any()),
        }
        emit("parallel", path=path, f=w["f"], rounds=w["R"], shards=len(mesh.devices),
             rejected=int((~w["oracle"]).sum()), certified_rounds=int(certified.sum()), **ok,
             state=got["state"].tolist(), card=card)
        check(all(ok.values()), f"{path} f={w['f']}: {ok}")
        out[w["f"]] = got
    out["launches"] = check_launches(K, path, 2 * len(windows), len(mesh.devices))
    for w in windows:
        valid, counts, certified = eager[w["f"]](*w["args"])
        got = out[w["f"]]
        same = (np.array_equal(valid.numpy(), got["valid"]) and np.array_equal(counts.numpy(), got["counts"])
                and np.array_equal(certified.numpy(), got["certified"]))
        emit("parallel", path=path, f=w["f"], equal_to_eager=same, card=card)
        check(same, f"{path} f={w['f']}: the captured path differs from the eager one")
    out["certify"], out["step"], out["eager"] = certify, step, eager
    return out


def _gloo_worker(rank: int, port: int, device: str, windows, q) -> None:
    """One of two processes on gloo: its rows of each window (round-robin)
    on a one-shard mesh of ``device``; counts all-reduced over both."""
    try:
        import torch
        import torch.distributed as dist

        from pbft_tpu_torch import parallel as P
        from pbft_tpu_torch.crypto import ed25519 as E
        from pbft_tpu_torch.crypto import kernels as K

        P.initialize_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=rank, backend="gloo")
        try:
            mesh = P.global_mesh(devices=[device])
            rows = P.partition_items(list(range(B)))
            local = {w["f"]: [a[rows] for a in w["args"][:4]] + [w["args"][4]] for w in windows}
            certify = {w["f"]: P.quorum_certify(mesh, w["R"]) for w in windows}
            eager = {w["f"]: eager_certify(torch, E, mesh, w["R"]) for w in windows}
            out = {"rank": rank, "size": mesh.size, "rows": rows}
            for f, args in local.items():  # each (shape, R) captured at its first use
                certify[f](*args)
            K.reset_launches()
            for f, (pubs, msgs, sigs, rids, thr) in local.items():
                staged = [P.host_shard_to_global(mesh, a) for a in (pubs, msgs, sigs, rids)]
                res = certify[f](*staged, thr)
                out[f] = {k: getattr(res, k).cpu().numpy() for k in ("valid", "counts", "certified")}
            out["launches"] = dict(K.LAUNCHES)
            for f, args in local.items():
                valid, counts, certified = eager[f](*args)
                out[f]["equal_to_eager"] = (np.array_equal(valid.numpy(), out[f]["valid"])
                                            and np.array_equal(counts.numpy(), out[f]["counts"])
                                            and np.array_equal(certified.numpy(), out[f]["certified"]))
                dist.barrier()
                ms = turns_ms(torch, {"certify": lambda: certify[f](*args), "eager": lambda: eager[f](*args)})
                out[f]["certify_ms"], out[f]["eager_ms"] = ms["certify"], ms["eager"]
            q.put(out)
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the phase
        q.put({"rank": rank, "error": traceback.format_exc()})
        raise


def run_gloo_pair(device: str, windows, card: str) -> dict:
    """(c): two processes on gloo, each verifying its rows of every window
    on ``device``; returns both processes' results by rank."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    slim = [{"f": w["f"], "R": w["R"], "args": w["args"]} for w in windows]
    procs = [ctx.Process(target=_gloo_worker, args=(r, port, device, slim, q)) for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = time.monotonic() + 600
        while len(results) < 2:
            try:
                res = q.get(timeout=5)
            except queue.Empty:
                check(time.monotonic() < deadline and all(p.exitcode in (None, 0) for p in procs),
                      f"gloo workers: exit codes {[p.exitcode for p in procs]}")
                continue
            check("error" not in res, f"gloo worker {res['rank']} failed:\n{res.get('error')}")
            results[res["rank"]] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    return results


def phase_parallel(torch, P, K, E, VS, batch, pool, want, rng, card: str, engine=None) -> dict:
    windows = [quorum_window(batch, pool, want, f, rng) for f in CLUSTERS]
    launches = {}
    mesh_a = P.make_mesh()
    card0 = mesh_a.devices[0]
    a = run_mesh(torch, P, K, E, mesh_a, "parallel_a_local_cards", windows, card)
    launches["parallel_a_local_cards"] = a["launches"]
    b = run_mesh(torch, P, K, E, P.make_mesh(devices=[card0, card0]), "parallel_b_two_shards_one_card", windows,
                 card)
    launches["parallel_b_two_shards_one_card"] = b["launches"]
    for w in windows:
        same = all(np.array_equal(a[w["f"]][k], b[w["f"]][k]) for k in ("valid", "counts", "certified", "state"))
        emit("parallel", path="parallel_b_two_shards_one_card", f=w["f"], bit_equal_to_a=same, card=card)
        check(same, f"two shards on one card differ from the mesh of the local cards at f={w['f']}")

    c = run_gloo_pair(str(card0), windows, card)
    for w in windows:
        f = w["f"]
        ok = {
            "mesh_size": [c[r]["size"] for r in (0, 1)] == [2, 2],
            "ranks_agree": all(np.array_equal(c[0][f][k], c[1][f][k]) for k in ("counts", "certified")),
            "equal_to_a": all(np.array_equal(c[0][f][k], a[f][k]) for k in ("counts", "certified")),
            "valid_of_own_rows": all(np.array_equal(c[r][f]["valid"], a[f]["valid"][c[r]["rows"]]) for r in (0, 1)),
            "equal_to_eager": all(c[r][f]["equal_to_eager"] for r in (0, 1)),
        }
        emit("parallel", path="parallel_c_gloo_two_processes", f=f, **ok, card=card)
        check(all(ok.values()), f"two processes on gloo at f={f}: {ok}")
    for r in (0, 1):
        check_launches(K, "parallel_c_gloo_two_processes", len(windows), got=c[r]["launches"], rank=r)
    launches["parallel_c_gloo_two_processes"] = {k: c[0]["launches"][k] + c[1]["launches"][k] for k in K.KERNELS}

    daemon = VS.VerifyServiceDaemon(host="127.0.0.1", port=0, engine=engine)
    try:
        daemon.start(wait_ready=True, timeout=600)
        js = VS.probe_status_json(daemon.address)
        check(js["devices"] == torch.cuda.device_count(), f"daemon reports {js['devices']} devices")
        K.reset_launches()
        host, port = daemon.address.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=300) as sock:
            got = _request(sock, windows[0]["items"])
        served = VS.probe_status_json(daemon.address)
        ok = got == windows[0]["oracle"][: len(windows[0]["items"])].tolist()
        emit("parallel", path="parallel_d_daemon_all_cards", devices=js["devices"],
             card_count=torch.cuda.device_count(), items=len(got), equal_to_oracle=ok,
             launches=served["launches"], fallback_items=served["fallback_items"], card=card)
        check(ok and served["fallback_items"] == 0, "the daemon over every card served wrong verdicts")
        launches["parallel_d_daemon_all_cards"] = check_launches(K, "parallel_d_daemon_all_cards",
                                                                 served["launches"], js["devices"])
    finally:
        daemon.stop()

    for w in windows:
        f, args = w["f"], w["args"]
        ms = turns_ms(torch, {
            "verify_many": lambda: batch.verify_many(w["items"]),
            "certify_a": lambda: a["certify"][f](*args),
            "round_step_a": lambda: a["step"][f](STATE0, *args),
            "certify_b": lambda: b["certify"][f](*args),
            "round_step_b": lambda: b["step"][f](STATE0, *args),
            "eager_certify_a": lambda: a["eager"][f](*args),
            "eager_certify_b": lambda: b["eager"][f](*args),
        })
        emit("timing", path="parallel_same_window", f=f, batch=B, reps=REPS, ms_per_window=ms,
             certify_c_ms=[c[r][f]["certify_ms"] for r in (0, 1)],
             eager_certify_c_ms=[c[r][f]["eager_ms"] for r in (0, 1)], card=card)
    w = windows[0]
    for path, fn in (("verify_many", lambda: batch.verify_many(w["items"])),
                     ("certify_a", lambda: a["certify"][w["f"]](*w["args"])),
                     ("certify_b", lambda: b["certify"][w["f"]](*w["args"]))):
        emit("profile", path=path, f=w["f"], batch=B, **profile_window(torch, fn), card=card)
    return launches


def phase_timing(torch, F, E, K, batch, pool, rng, card, env) -> dict:
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.integers(-(2**9) + 1, 2**9, size=(B, F.NLIMBS)).astype(np.int32)).to(dev)
    pubs = np.stack([np.frombuffer(pool[i % len(pool)][0], np.uint8) for i in range(B)])
    _, a_pt = E.decompress(torch.from_numpy(pubs).to(dev))
    a_neg = E.point_neg(a_pt)
    sb = torch.from_numpy(rng.integers(0, 2, size=(B, 256)).astype(np.int32)).to(dev)
    hb = torch.from_numpy(rng.integers(0, 2, size=(B, 256)).astype(np.int32)).to(dev)
    rows = torch.from_numpy(_sha512_rows(rng, B)).to(dev)
    sm_clk = env["sms"] * env["sm_clock_max_mhz"] * 1e6  # SM-clocks per second
    out = {}
    for name, fn, plain, iters, plain_iters in (
        ("inv", lambda: K.inv(x), lambda: K.inv_plain(x), 20, 3),
        ("p58", lambda: K.pow_p58(x), lambda: K.pow_p58_plain(x), 20, 3),
        ("ladder", lambda: K.ladder(sb, hb, a_neg), lambda: K.ladder_plain(sb, hb, a_neg), 5, 1),
        ("sha512", lambda: K.sha512(rows), lambda: K.sha512_plain(rows), 50, 3),
    ):
        ms = cuda_ms(fn, iters, warmup=2)
        plain_ms = cuda_ms(plain, plain_iters, warmup=1)
        imad, alu = (int(v) for v in OPS_PER_ITEM[name] * B)
        nbytes = BYTES_PER_ITEM[name] * B
        limits = {  # ms of each limit; the bound is the largest
            "imad": imad / (IMAD_PER_CLK_PER_SM * sm_clk) * 1e3,
            "alu": alu / (ALU_PER_CLK_PER_SM * sm_clk) * 1e3,
            "schedulers": (imad + alu) / (SCHEDULER_PER_CLK_PER_SM * sm_clk) * 1e3,
            "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        bound = max(limits.values())
        out[name] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if limits["bytes"] == bound else "operations",
            "limits_ms": limits, "imad_ops": imad, "alu_ops": alu, "bytes": nbytes,
        }
        if name == "ladder":
            out[name]["digits_ms"] = cuda_ms(lambda: K.ladder_digits(sb, hb), 20, warmup=2)
        emit("timing", kernel=name, batch=B, **out[name], card=card)
    # The simulation's window: 256 rows, a few of them items.
    few = pool[:3]
    batch.verify_many(few, pad_to=256)
    t0 = time.perf_counter()
    for _ in range(20):
        batch.verify_many(few, pad_to=256)
    emit("timing", path="verify_many", batch=256, items=len(few), ms_per_window=(time.perf_counter() - t0) / 20 * 1e3,
         card=card)
    items = [pool[i % len(pool)] for i in range(B)]
    batch.verify_many(items)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        batch.verify_many(items)
    secs = time.perf_counter() - t0
    out["verify_many_per_s"] = reps * B / secs
    emit("timing", path="verify_many", batch=B, verifies_per_s=out["verify_many_per_s"],
         ms_per_window=secs / reps * 1e3, card=card)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pbft_tpu_torch.crypto import batch, kernels as K, ref
    from pbft_tpu_torch.crypto import ed25519 as E
    from pbft_tpu_torch.crypto import field as F
    from pbft_tpu_torch import parallel as P
    from pbft_tpu_torch.net import verify_service as VS

    card = smi("name,power.limit")
    print(card, flush=True)
    rng = np.random.default_rng(SEED)
    phase, t_phase, walls = "env", time.perf_counter(), {}

    def enter(name: str) -> None:
        """The next phase: the one that ends gets its wall seconds."""
        nonlocal phase, t_phase
        walls[phase] = round(time.perf_counter() - t_phase, 1)
        phase, t_phase = name, time.perf_counter()

    try:
        env = phase_env(torch, K, card)
        enter("kernels")
        shapes = set(batch._PAD_LADDER) | {batch.pad_size(n) for n in VERIFY_SIZES} | {B, SIM_BATCH_PAD}
        check(shapes <= set(KERNEL_SIZES), f"window shapes {sorted(shapes - set(KERNEL_SIZES))} not in KERNEL_SIZES")
        errs = phase_kernels(torch, F, E, K, ref, rng, card)
        enter("verify")
        t0 = time.perf_counter()
        pool, want = make_pool(ref, rng)
        emit("verify", pool_items=len(pool), pool_rejected=want.count(False),
             oracle_s=round(time.perf_counter() - t0, 3))
        capture_verify_shapes(batch, pool, sorted({batch.pad_size(n) for n in VERIFY_SIZES}), card)
        K.reset_launches()
        windows = phase_verify(batch, pool, want, rng, card)
        launches = {"verify_many": check_launches(K, "verify_many", windows)}
        enter("graphs")
        phase_graphs(torch, E, K, VS, batch, pool, want, rng, card)
        enter("service")
        # Engines that daemons started one after another share, each warmed
        # once: two slots (the daemon's default inflight) for the service
        # phase's daemons and the parallel phase's, one for the chunked call
        # and the protocol, asyncio and evidence phases' daemons.
        engine2, engine1 = VS.CudaVerifyEngine(slots=2), VS.CudaVerifyEngine(slots=1)
        services = {}
        for path, kwargs in (("service_default", {}),
                             ("service_window_4096", {"flush_items": 4096, "flush_us": 100_000})):
            services[path], launches[path] = run_service(
                VS, K, pool, want, card, path, eager_backend=lambda items: eager_many(torch, E, batch, items),
                engine=engine2, **kwargs)
        window_run = services["service_window_4096"]
        check(window_run["launches"] < window_run["requests"], "no coalescing in the 4,096-item window")
        launches["engine_chunked"] = run_chunked(VS, K, pool, want, card, engine1)
        enter("surface")
        launches["surface_service_verifier"] = phase_surface(VS, K, pool, want, card)
        enter("protocol")
        launches.update(phase_protocol(K, VS, card, engine1))
        enter("simulation")
        launches.update(phase_simulation(K, card))
        enter("asyncio")
        launches.update(phase_asyncio(K, VS, card, engine1))
        enter("health")
        launches.update(phase_health(K, VS, card))
        enter("evidence")
        evidence_launches, stage_ms, evidence_kernel = phase_evidence(K, VS, card, engine=engine1)
        launches.update(evidence_launches)
        enter("bench")
        launches.update(phase_bench(K, card, evidence_kernel.get("window_ms")))
        enter("parallel")
        launches.update(phase_parallel(torch, P, K, E, VS, batch, pool, want, rng, card, engine2))
        enter("timing")
        times = phase_timing(torch, F, E, K, batch, pool, rng, card, env)
        for path, run in services.items():
            emit("timing", path=path, verifies_per_s=run["verifies_per_s"],
                 launches=run["launches"], requests=run["requests"], card=card)
        enter("done")
    except Exception as e:  # noqa: BLE001 - every phase failure ends the run
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}", phase_wall_s=walls)
        # The failure also goes to stderr, whose end is what a caller that
        # keeps only the tail of that stream sees.
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} failed: {type(e).__name__}: {str(e)[:4000]}", file=sys.stderr, flush=True)
        return 1
    emit("smoke", phase_wall_s=walls, total_s=round(sum(walls.values()), 1))
    table = []
    for name in K.KERNELS:
        source, replaces = SOURCES[name]
        t = times[name]
        by_path = {path: counts[name] for path, counts in launches.items()}
        table.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": float(errs[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, **stage_ms[name],
            "registers": env["kernels"][name].get("registers"),
            "spill_store_bytes": env["kernels"][name].get("spill_store_bytes"),
        })
    print(card, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
