"""The control and the planted faults, on the card at a cell's own size:
``python -m cardbench.control --workload <name> --seeds 1,2,3 --seconds <s>
[--fault accept_all|half_unverified|flip_one|none]``.

Each seed is one whole run of the cell (``run.run``) with the fault planted
where the verdicts are produced (``deploy.FAULTS``); the runs share one
warm engine. One JSON line per seed: ``correct`` and each check's number.
The benchmark's own runs never plant a fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import manifest, run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m cardbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--fault", default="accept_all")
    args = parser.parse_args(argv)
    for var, rel in run.CACHE_DIRS.items():
        os.environ[var] = str(manifest.ROOT / rel)
    from pbft_tpu_torch.net.verify_service import CudaVerifyEngine

    cfg = manifest.cell(args.workload)["config"]["verify_service"]
    engine = CudaVerifyEngine(devices=cfg["devices"], slots=cfg["inflight"])
    engine.warm()
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run(args.workload, seed, args.seconds, False, time.monotonic(),
                      fault=None if args.fault == "none" else args.fault, engine=engine)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"], "failed": res["failed"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()},
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
