"""The benchmark's command: one run of one cell (harness.py).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
"""

import pathlib
import sys

if __name__ == "__main__":
    # the checkout's root, in place of this folder, heads the path: the
    # package portbench and the program are imported from it
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])
    from portbench.harness import main
    sys.exit(main())
