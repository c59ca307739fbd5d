"""Occupancy sweep: pipeline depth x flush window -> items/launch, and
(batch arm) request-batch size x verify window -> requests/sec. The port's
copy of the reference's ``scripts/window_sweep.py``.

Runs the f=1 firehose config (``bench.harness`` config 1: four ``pbftd``)
through the coalescing verify daemon across a grid of in-flight depths and
bounded-accumulation windows, and prints one JSON line per cell with the
measured merged-window occupancy (from the daemon's per-window trace) and
the launch-cost-model projection at on-host launch cost and, with
``--kernel``, at the card's measured graph launch.

The BATCH arm (``--batches``) sweeps the two batching knobs together:
batch_max_items (requests per three-phase instance) x the verify flush
window, each cell on ``pbftd``'s own host verify pools, reporting
requests/sec, rounds/sec and the measured mean batch occupancy.

    # on the card (the daemon's cuda backend), rate from gpu_evidence:
    python -m pbft_tpu_torch.scripts.window_sweep --pipelines 8,32 \\
        --flushes 0,2000 --kernel evidence/kernel.json
    # on the CPU (the daemon's native backend):
    python -m pbft_tpu_torch.scripts.window_sweep --service-backend native \\
        --pipelines 8 --flushes 0 --requests 20 --kernel-rate 100000
    # the batch arm:
    python -m pbft_tpu_torch.scripts.window_sweep --batches 1,8,32

Differences from the reference: a cell runs ``run_native_cuda_config``
with ``--service-backend cuda`` (the default: the card's daemon, which
raises without a card) or ``native`` (the C++ pool, the CPU arm tests
use), where the reference ran ``run_native_tpu_config`` on the native
backend; on the card one engine is warmed once and served by every cell's
daemon. The kernel rate comes from ``--kernel`` (a ``gpu_evidence``
kernel record) or ``--kernel-rate``, never from ``benchmarks/``; rows go
to stdout and to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from .launch_cost_model import ON_HOST_LAUNCH_US, kernel_line, launch_costs, project, window_stats
from .trace_report import expand_trace_args


def run_cell(pipeline: int, flush_us: int, requests: int, kernel: dict,
             service_backend: str = "cuda", engine=None):
    """One occupancy cell: config 1 at ``pipeline`` requests in flight on a
    daemon with a ``flush_us`` accumulation window (serving ``engine`` when
    given). ``kernel`` holds ``value`` (verifies/s) and, optionally,
    ``graph_launch_us``: each launch cost is projected."""
    from ..bench.harness import run_native_cuda_config, start_daemon

    with tempfile.TemporaryDirectory(prefix="sweep-") as td:
        trace_dir = os.path.join(td, "traces")
        os.makedirs(trace_dir)
        daemon = start_daemon(service_backend, flush_us=flush_us, trace_dir=trace_dir, engine=engine)
        try:
            res = run_native_cuda_config(
                1,  # firehose f=1
                requests=requests,
                trace_dir=trace_dir,
                pipeline=pipeline,
                flush_us=flush_us,
                service_backend=service_backend,
                daemon=daemon,
            )
        finally:
            daemon.stop()
        files = expand_trace_args([f"{trace_dir}-service"])
        win = window_stats(files)
    kernel_rate = float(kernel["value"])
    projected = {
        f"launch_{int(lus)}us": project(kernel_rate, lus, win["items_per_launch"])
        for lus in launch_costs(kernel)
    }
    return {
        "config": "firehose f=1",
        "pipeline": pipeline,
        "flush_us": flush_us,
        "service_backend": service_backend,
        "requests": res.requests,
        "requests_per_sec": res.requests_per_sec,
        "rounds_per_sec": res.rounds_per_sec,
        "items_per_launch": round(win["items_per_launch"], 2),
        "launches": win["launches"],
        "service_windows": res.service_windows,
        "service_items": res.accounting["service_items"],
        "replica_sig_checks": res.accounting["replica_sig_checks"],
        "service_fallback_items": res.accounting["service_fallback_items"],
        "kernel_verifies_per_sec": kernel_rate,
        "projected_100us_per_sec": project(kernel_rate, ON_HOST_LAUNCH_US, win["items_per_launch"])["verifies_per_sec"],
        "projected": projected,
    }


def sweep(pipelines, flushes, requests: int, kernel: dict,
          service_backend: str = "cuda", engine=None) -> list:
    """Every (pipeline, flush) cell, each row printed as it lands. On
    ``cuda`` one engine serves every cell's daemon: ``engine`` (with one
    slot, the harness's ``service_inflight``), or one warmed here."""
    if service_backend == "cuda" and engine is None:
        from ..net.verify_service import CudaVerifyEngine

        engine = CudaVerifyEngine(slots=1)
        engine.warm()
    rows = []
    for pipeline in pipelines:
        for flush_us in flushes:
            row = run_cell(pipeline, flush_us, requests, kernel, service_backend, engine)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def run_batch_cell(
    batch_max_items: int, flush_us: int, requests: int, pipeline: int
):
    """One batch-arm cell: real pbftd daemons (in-process cpu verifier),
    batch_max_items x verify_flush window, reporting the request-rate
    side of the trade instead of verifier occupancy."""
    from ..bench.harness import run_native_config

    res = run_native_config(
        1,  # firehose f=1
        requests=requests,
        pipeline=pipeline,
        flush_us=flush_us,
        batch_max_items=batch_max_items,
        batch_flush_us=min(2000, max(500, flush_us)) if batch_max_items > 1 else 0,
    )
    return {
        "config": "firehose f=1",
        "arm": "batch",
        "batch_max_items": batch_max_items,
        "flush_us": flush_us,
        "pipeline": pipeline,
        "requests": res.requests,
        "requests_per_sec": res.requests_per_sec,
        "rounds_per_sec": res.rounds_per_sec,
        "mean_batch": res.mean_batch,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--out", default=None)
    parser.add_argument("--pipelines", default="8,16,32,64")
    parser.add_argument("--flushes", default="0,1000,2000")
    parser.add_argument("--requests", type=int, default=192)
    parser.add_argument(
        "--batches",
        default=None,
        help="comma list of batch_max_items values; selects the BATCH arm "
        "(batch size x verify window -> requests/sec) instead of the "
        "pipeline-occupancy arm",
    )
    parser.add_argument(
        "--pipeline",
        type=int,
        default=64,
        help="in-flight requests for the batch arm's load generator",
    )
    parser.add_argument(
        "--service-backend", default="cuda", choices=("cuda", "native"),
        help="the daemon's backend in the occupancy arm: cuda (the card; "
        "raises without one) or native (the C++ verify pool)",
    )
    parser.add_argument("--kernel", default=None,
                        help="a gpu_evidence kernel record for the projection")
    parser.add_argument("--kernel-rate", type=float, default=None,
                        help="verifies/s for the projection, instead of --kernel")
    args = parser.parse_args(argv)

    rows = []
    if args.batches:
        for batch in [int(x) for x in args.batches.split(",")]:
            for flush_us in [int(x) for x in args.flushes.split(",")]:
                row = run_batch_cell(
                    batch, flush_us, args.requests, args.pipeline
                )
                print(json.dumps(row), flush=True)
                rows.append(row)
    else:
        if (args.kernel is None) == (args.kernel_rate is None):
            parser.error("the occupancy arm takes one of --kernel and --kernel-rate")
        kernel = kernel_line(args.kernel) if args.kernel else {"value": args.kernel_rate}
        rows = sweep([int(x) for x in args.pipelines.split(",")],
                     [int(x) for x in args.flushes.split(",")], args.requests,
                     kernel, args.service_backend)
    if args.out:
        with open(args.out, "w") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
