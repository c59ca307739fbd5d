"""``python -m pbft_tpu_torch.bench [--cuda-worker]``: ``verify_bench.main``."""

import sys

from .verify_bench import main

if __name__ == "__main__":
    sys.exit(main())
