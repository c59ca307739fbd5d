"""``python -m cardbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``."""

import time

T_START = time.monotonic()

if __name__ == "__main__":
    import sys

    from cardbench.run import main

    sys.exit(main(sys.argv[1:], t_start=T_START))
