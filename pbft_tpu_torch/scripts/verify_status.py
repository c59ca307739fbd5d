"""verify_status — introspect a running verify service (the port's
``python -m pbft_tpu_torch.net.verify_service``).

Sends the 0xFFFFFFFF JSON-status probe and pretty-prints what the daemon
is actually doing: state, devices, warmed window shapes, and the
once-per-start warm timings — the kernel build (``build_s``; nothing
compiled when the build cache was warm), the graph captures
(``cold_compile_s``, ``compiled``) and the card they run on (``device``).

    python -m pbft_tpu_torch.scripts.verify_status           # default target
    python -m pbft_tpu_torch.scripts.verify_status 127.0.0.1:7600
    PBFT_VERIFY_SERVICE=host:7600 python -m pbft_tpu_torch.scripts.verify_status --json

Exit codes: 0 reachable, 1 unreachable/no answer.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "target",
        nargs="?",
        default=os.environ.get("PBFT_VERIFY_SERVICE", "127.0.0.1:7600"),
        help="host:port or unix-socket path (default: $PBFT_VERIFY_SERVICE "
        "or 127.0.0.1:7600)",
    )
    parser.add_argument("--timeout", type=float, default=2.0)
    parser.add_argument("--json", action="store_true", help="raw status JSON")
    args = parser.parse_args(argv)

    from ..net.verify_service import probe_status_json

    status = probe_status_json(args.target, timeout=args.timeout)
    if status is None:
        print(
            f"verify_status: no JSON status from {args.target} "
            "(unreachable, pre-handshake legacy service, or not a verify "
            "service)",
            file=sys.stderr,
        )
        return 1
    if args.json:
        print(json.dumps(status, sort_keys=True))
        return 0

    print(f"verify service @ {args.target}")
    print(f"  state           {status.get('state', '?')}")
    print(f"  devices         {status.get('devices', 0)}")
    if "uptime_s" in status:
        print(f"  uptime          {status['uptime_s']:.1f}s")
    shapes = status.get("warmed_shapes") or []
    print(
        "  warmed shapes   %s"
        % (", ".join(str(s) for s in shapes) if shapes else "(none)")
    )
    warm = status.get("warm_stats") or {}
    if warm:
        cold = warm.get("cold_compile_s")
        if cold is not None:
            print(f"  cold compile    {cold:.3f}s (traced+compiled shapes)")
        loaded = warm.get("warm_load_s")
        if loaded is not None:
            print(f"  warm load       {loaded:.3f}s (cache reloads)")
        for k in sorted(warm):
            if k in ("cold_compile_s", "warm_load_s"):
                continue
            print(f"  {k:<15} {warm[k]}")
    # Anything else the daemon reports rides along un-dropped.
    known = {"state", "devices", "uptime_s", "warmed_shapes", "warm_stats"}
    for k in sorted(set(status) - known):
        print(f"  {k:<15} {status[k]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
