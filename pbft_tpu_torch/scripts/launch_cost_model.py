"""Launch-cost model: turn "production would see X" into a computed
number. The port's copy of the reference's ``scripts/launch_cost_model.py``.

  inputs
    --traces DIR|FILES   per-replica (or the verify service's) JSONL traces
                         from a real cluster run (``pbftd --trace``, the
                         port's daemon ``--trace``): the measured window
                         occupancy (items per launch) and launch frequency.
    --kernel PATH        the JSON line that ``gpu_evidence``'s ``kernel``
                         step writes (``evidence/kernel.json``): the
                         sustained verifies/s of a replayed 4,096 window on
                         the card (``value``), and the host time of one
                         ``cudaGraphLaunch`` of it (``graph_launch_us``),
                         with the card's name and power limit.
    --kernel-rate N      the same rate as a number, instead of --kernel.
    --launch-us N        per-launch overhead to model (repeatable).
                         Defaults: 100 (on-host dispatch,
                         ``ON_HOST_LAUNCH_US``) and, with --kernel, the
                         card's measured graph launch.

  model
    For each modeled launch cost L and the trace-measured window occupancy
    W (items/launch), per-item cost = 1/kernel_rate + L/W, so a cluster
    that sustains the traces' launch frequency sees
        verifies/sec = 1 / (1/kernel_rate + L/W)
    per verifier stream: the launch-amortization identity.

Prints one JSON line with the inputs and the projected rates.

Differences from the reference: the reference's default launch costs were
200,000 µs (a tunneled TPU's round trip, which the card does not have)
and 100 µs; its kernel rate came from a committed TPU measurement. Here
the rate and the graph launch come from the card (``--kernel``) or the
command line (``--kernel-rate``), and nothing is read from
``benchmarks/``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from .trace_report import expand_trace_args, load


def window_stats(files) -> dict:
    batches = 0
    items = 0
    first_ts = None
    last_ts = None
    for path in files:
        events = [e for e in load(path) if e.get("ev") == "verify_batch"]
        if not events:
            continue
        batches += len(events)
        items += sum(e["size"] for e in events)
        f, l = events[0]["ts"], events[-1]["ts"]
        first_ts = f if first_ts is None else min(first_ts, f)
        last_ts = l if last_ts is None else max(last_ts, l)
    if batches == 0:
        sys.exit("no verify_batch events in the given traces")
    return {
        "launches": batches,
        "items": items,
        "items_per_launch": items / batches,
        "span_secs": (last_ts - first_ts) if last_ts else 0.0,
    }


def project(kernel_rate: float, launch_us: float, items_per_launch: float):
    """The launch-amortization identity, shared with window_sweep:
    per-item cost = 1/kernel_rate + launch/window."""
    l_secs = launch_us / 1e6
    per_item = 1.0 / kernel_rate + l_secs / items_per_launch
    return {
        "verifies_per_sec": round(1.0 / per_item, 1),
        "launch_share": round((l_secs / items_per_launch) / per_item, 4),
    }


# On-host dispatch: the launch cost the headline projections quote.
ON_HOST_LAUNCH_US = 100.0


def kernel_line(path) -> dict:
    """The last JSON object line of ``path``: a ``gpu_evidence`` kernel
    record (its file, or a log that ends with it)."""
    for line in reversed(pathlib.Path(path).read_text().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise ValueError(f"{path}: no JSON line")


def launch_costs(kernel: dict, launch_us=None) -> list:
    """The launch costs to model: ``launch_us`` when given, else on-host
    dispatch and the kernel record's measured graph launch, if any."""
    if launch_us:
        return list(launch_us)
    costs = [ON_HOST_LAUNCH_US]
    if kernel.get("graph_launch_us"):
        costs.append(float(kernel["graph_launch_us"]))
    return costs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--traces", nargs="+", required=True)
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--kernel", help="a gpu_evidence kernel record")
    source.add_argument("--kernel-rate", type=float,
                        help="verifies/s of a launch-amortized window")
    parser.add_argument(
        "--launch-us",
        type=float,
        action="append",
        default=None,
        help="per-launch overhead to model, microseconds (repeatable)",
    )
    args = parser.parse_args(argv)

    files = expand_trace_args(args.traces)
    # Occupancy is a PER-CONFIG property: blending several sequentially-run
    # configs (a parent --trace-dir with cfg<i>/ subdirs) would average
    # unrelated windows plus the idle gaps between runs into one
    # plausible-looking but meaningless number. Demand one config's traces.
    parents = {pathlib.Path(f).parent for f in files}
    if len(parents) > 1:
        sys.exit(
            "traces span multiple directories (one per config?): "
            f"{sorted(str(p) for p in parents)}\n"
            "run the model once per config, e.g. --traces <dir>/cfg1"
        )
    win = window_stats(files)

    kernel = kernel_line(args.kernel) if args.kernel else {"value": args.kernel_rate}
    kernel_rate = float(kernel["value"])  # verifies/sec, launch-amortized

    projections = {
        f"launch_{int(lus)}us": project(
            kernel_rate, lus, win["items_per_launch"]
        )
        for lus in launch_costs(kernel, args.launch_us)
    }

    print(
        json.dumps(
            {
                "kernel_verifies_per_sec": kernel_rate,
                "kernel_backend": kernel.get("backend"),
                "kernel_device": kernel.get("device"),
                "kernel_power_limit": kernel.get("power_limit"),
                "graph_launch_us": kernel.get("graph_launch_us"),
                "window": {
                    "items_per_launch": round(win["items_per_launch"], 2),
                    "launches": win["launches"],
                    "items": win["items"],
                    "span_secs": round(win["span_secs"], 3),
                },
                "projected": projections,
            }
        )
    )


if __name__ == "__main__":
    main()
