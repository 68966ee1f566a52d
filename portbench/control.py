"""The control of the benchmark's comparison: the reference put in the
program's place, with its count products in bfloat16 (the precision below
the float32 that holds the counts exactly), judged as a run's calls are.
It has to come out not correct, on every seed.

    python3 portbench/control.py --workload <cell> --seeds <n>,<n>,...

For each seed it makes the cell's corpus and database (as a run's set-up,
cached alike), computes the rows the run would check in both precisions,
and prints one JSON line with the numbers the check compares.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time


def control_numbers(bench: dict, cell_name: str, seed: int,
                    root: pathlib.Path, cache: pathlib.Path,
                    device) -> dict:
    import torch
    from . import harness, judge, registry
    cell = registry.workload(bench, cell_name)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = registry.config(bench, cell["config"], root)
    traffic = registry.traffic(cell["traffic"])
    list_path, _, _ = harness.prepare(config, root / entry["file"], seed,
                                      cache)
    n = config["corpus"]["n_samples"]
    rows = harness.check_rows(n, seed)
    expected = harness.expected_lines(config, traffic, list_path, rows,
                                      device)
    lowered = harness.expected_lines(config, traffic, list_path, rows,
                                     device, dtype=torch.bfloat16)
    report = {"crc32": 0, "bytes": 0, "lines": n + 2,
              "kept": {str(k): v.rstrip("\n") for k, v in lowered.items()}}
    return judge.judge(expected, n + 2, [{"rc": 0, "report": report}])


def main(argv=None) -> int:
    from . import judge, registry
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    bench = registry.load_bench()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        numbers = control_numbers(bench, args.workload, seed, registry.ROOT,
                                  registry.HERE / ".cache", device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": judge.correct(numbers),
                          "numbers": numbers, "device": device,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])
    from portbench.control import main as _main
    sys.exit(_main())
