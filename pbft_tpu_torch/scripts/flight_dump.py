"""flight_dump — decode black-box flight-recorder dumps (the port's copy
of the reference's ``scripts/flight_dump.py``).

Both runtimes keep a fixed-size ring of the last N protocol events
(core/flight.cc in pbftd, pbft_tpu_torch/utils/flight.py in the port's
asyncio runtime and gateway) and dump it on SIGTERM/fatal/
invariant-failure. This tool turns a dump back into ordered, named
protocol events — what the dead replica was doing in its final moments.

    python -m pbft_tpu_torch.scripts.flight_dump flight/replica-2.flight
    python -m pbft_tpu_torch.scripts.flight_dump blackbox/*.flight --json
    python -m pbft_tpu_torch.scripts.flight_dump dump.flight --tail 50

    # live-tail ONE dump file as the process re-dumps it: waits for the
    # file to appear, then prints only records newer than what it
    # already showed each time the dump is rewritten
    python -m pbft_tpu_torch.scripts.flight_dump flight/replica-2.flight --follow

Record fields: t_ns (CLOCK_MONOTONIC), event, view, seq, peer. The seq
slot is context-dependent: the sequence number for consensus phases, the
client request timestamp for request_rx/reply_tx, the batch size for
verify_batch, the timer backoff for view_timer_fired.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..utils.flight import decode_file


def render(path: str, records, tail: int) -> None:
    shown = records[-tail:] if tail else records
    print(f"{path}: {len(records)} records"
          + (f" (last {len(shown)})" if len(shown) < len(records) else ""))
    if not records:
        return
    t0 = records[0]["t_ns"]
    for r in shown:
        extra = f" peer={r['peer']}" if r["peer"] >= 0 else ""
        print(
            "  +%12.3fms  %-20s v=%-4d seq=%d%s"
            % ((r["t_ns"] - t0) / 1e6, r["event"], r["view"], r["seq"], extra)
        )


def _print_record(r, t0, as_json: bool) -> None:
    if as_json:
        print(json.dumps(r), flush=True)
        return
    extra = f" peer={r['peer']}" if r["peer"] >= 0 else ""
    print(
        "  +%12.3fms  %-20s v=%-4d seq=%d%s"
        % ((r["t_ns"] - t0) / 1e6, r["event"], r["view"], r["seq"], extra),
        flush=True,
    )


def follow(path: str, poll_s: float, as_json: bool) -> int:
    """Live-tail one dump file. The recorder rewrites the WHOLE ring on
    every dump (flight.py dump() / core flight.cc are truncate-writes),
    so each rewrite is re-decoded and only records strictly newer than
    the last one shown are printed; a decode error mid-rewrite just
    retries on the next poll. Runs until interrupted."""
    last_t = -1
    last_sig = None
    t0 = None
    waiting = False
    while True:
        try:
            st = os.stat(path)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            if not waiting:
                print(f"flight_dump: waiting for {path} ...",
                      file=sys.stderr)
                waiting = True
            time.sleep(poll_s)
            continue
        waiting = False
        if sig != last_sig:
            try:
                records = decode_file(path)
            except (OSError, ValueError):
                time.sleep(poll_s)  # caught the writer mid-rewrite
                continue
            last_sig = sig
            fresh = [r for r in records if r["t_ns"] > last_t]
            if fresh:
                if t0 is None:
                    t0 = fresh[0]["t_ns"]
                    if not as_json:
                        print(f"{path}: following (Ctrl-C to stop)")
                for r in fresh:
                    _print_record(r, t0, as_json)
                last_t = fresh[-1]["t_ns"]
        time.sleep(poll_s)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("dumps", nargs="+", help="*.flight dump files")
    parser.add_argument("--json", action="store_true", help="machine output")
    parser.add_argument(
        "--tail", type=int, default=0,
        help="only the last N records per dump (0 = all)")
    parser.add_argument(
        "--follow", action="store_true",
        help="live-tail ONE dump file as it is rewritten (waits for it "
        "to appear; with --json emits one JSON record per line)")
    parser.add_argument(
        "--poll-s", type=float, default=0.25,
        help="--follow poll interval")
    args = parser.parse_args(argv)
    if args.follow:
        if len(args.dumps) != 1:
            print("flight_dump: --follow takes exactly one dump file",
                  file=sys.stderr)
            return 2
        return follow(args.dumps[0], args.poll_s, args.json)
    rc = 0
    out = {}
    for path in args.dumps:
        try:
            records = decode_file(path)
        except (OSError, ValueError) as e:
            print(f"flight_dump: {path}: {e}", file=sys.stderr)
            rc = 2
            continue
        if args.json:
            out[path] = records
        else:
            render(path, records, args.tail)
    if args.json:
        print(json.dumps(out))
    return rc


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # `flight_dump ... | head` closing stdout early
        sys.stderr.close()
        sys.exit(0)
