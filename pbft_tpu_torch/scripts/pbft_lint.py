"""pbft_lint — run every static-analysis pass over both runtimes.

One entry point for the port's conformance-and-lint layer
(pbft_tpu_torch/analysis/): cross-runtime constant conformance between
core/ and the port, the no-blocking-calls-in-async check over
pbft_tpu_torch/net, the metrics/trace manifest lint, and the socket
discipline lint.

    python -m pbft_tpu_torch.scripts.pbft_lint               # all passes
    python -m pbft_tpu_torch.scripts.pbft_lint --passes constants,metrics
    python -m pbft_tpu_torch.scripts.pbft_lint --root /tmp/shadow-tree

Exit codes: 0 clean, 1 findings, 2 usage error. Wired into tier 1 via
tests/test_torch_lint.py — drift between the runtimes fails the build.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from .. import analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path, default=analysis.REPO,
                    help="tree to lint (default: this repo)")
    ap.add_argument("--passes", default=None,
                    help=f"comma-separated subset of {sorted(analysis.PASSES)}")
    ap.add_argument("--list", action="store_true",
                    help="list available passes and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name in analysis.PASSES:
            print(name)
        return 0

    passes = None
    if args.passes:
        passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    root = args.root.resolve()
    try:
        results = analysis.run_all(root, passes)
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return 2

    files = analysis.files_per_pass(root)
    total = 0
    for name, errors in results.items():
        status = "ok" if not errors else f"{len(errors)} problem(s)"
        print(f"[pbft_lint] {name}: {status} ({files[name]} files)")
        for e in errors:
            print(f"  {e}")
        total += len(errors)
    if total:
        print(f"[pbft_lint] FAILED: {total} problem(s) across "
              f"{sum(1 for e in results.values() if e)} pass(es)")
        return 1
    print("[pbft_lint] all passes clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
