"""Schema drift lint — a thin shim over the port's
``pbft_tpu_torch.analysis.metrics_lint`` (which also sweeps every
pbft_tpu_torch module for unregistered ``pbft_*`` metric lookups). It
keeps the reference's ``scripts/check_trace_schema.py`` entry point and
its ``check()`` API; ``pbft_tpu_torch.scripts.pbft_lint`` runs this pass
beside the constant-conformance, async-blocking and sockets passes.

    python -m pbft_tpu_torch.scripts.check_trace_schema
"""

from __future__ import annotations

import sys

from ..analysis import metrics_lint


def check() -> list:
    return metrics_lint.check()


def main() -> int:
    errors = check()
    if errors:
        print(f"trace/metric schema drift ({len(errors)} problems):")
        for e in errors:
            print(f"  {e}")
        return 1
    print("trace/metric schema: all emitters match the manifest")
    return 0


if __name__ == "__main__":
    sys.exit(main())
