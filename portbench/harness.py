"""One run of one cell: set-up, warm-up, the measured window, the check.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

1. Set-up.  The program is imported.  The cell's corpus is made from the
   seed and built into a database by the program's own CLI, each in a
   child process, as a user runs `build`; both are kept in
   portbench/.cache/<config>-<seed>/, so a later run of that configuration
   and seed in this checkout finds them.  Their making (prepare_s on
   standard error) is timed apart and kept out of setup_s, which would
   otherwise read whether the cache hit, not the program.
2. Warm-up: one call of the cell's traffic.
3. The window: one client calls the CLI in process
   (kmerdb_tpu_torch.cli.main.main) back to back, each call writing its CSV
   into the sink (sink.py), until --seconds have passed; the call that
   crosses the mark finishes.  No KMERDB_* setting is made.
4. The check, once the window has closed: the reference (reference/)
   works out the header, the totals and rows drawn from the seed from the
   genomes, and every call's CSV is held to them (judge.py).
5. The last line of standard output: one JSON object.  --trace 0 reports
   the cell's end-to-end metrics, --trace 1 its per-layer metrics, which
   the readers in metrics/ take from the calls' stats, the benchmark's
   host spans and one profiler session over the window (devtrace.py).

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
reports nothing; it exits 3 if jax, jaxlib, flax or kmerdb_tpu is loaded
once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import resource
import shutil
import subprocess
import sys
import time
import types

from . import devtrace, judge, registry
from .corpus import LIST_NAME, rng_for
from .reference import counts as ref_counts
from .reference import csvfmt

HERE = registry.HERE
ROOT = registry.ROOT
CACHE = HERE / ".cache"
READY = ".ready"
DB_NAME = "db.kdb"
#: rows of the CSV that the check compares at the least, drawn from the
#: seed; the first and the last (the longest) always among them
CHECK_ROWS = 64
#: the streamed route's tile of rows (gram_pk_rows launches one a block of
#: TILE_ROWS rows): the check draws at least one row from each
TILE_ROWS = 128
FORBIDDEN = ("jax", "jaxlib", "flax", "kmerdb_tpu")
CHILD_TIMEOUT_S = 900
#: the program's per-call seconds that each call's log line shows
CALL_STATS = ("total_s", "handler_s", "fill_s", "push_s", "gram_s", "pull_s",
              "filter_s")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against the boot clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# set-up
# --------------------------------------------------------------------------

def _child(cmd, what: str) -> float:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p)
    t = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=env, stdout=2,
                       timeout=CHILD_TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(f"{what} exited {r.returncode}")
    return time.perf_counter() - t


def prepare(config: dict, config_file: pathlib.Path, seed: int,
            cache: pathlib.Path = CACHE) -> tuple:
    """(list path, database path, seconds by step): the corpus and database
    of the configuration and seed, made in child processes on a miss."""
    d = cache / f"{config['name']}-{seed}"
    steps: dict = {}
    if not (d / READY).exists():
        shutil.rmtree(d, ignore_errors=True)
        steps["corpus_s"] = _child(
            [sys.executable, str(HERE / "corpus.py"), str(config_file),
             str(seed), str(d)], "corpus")
        steps["build_s"] = _child(
            [sys.executable, "-m", "kmerdb_tpu_torch", "build",
             *config["build"], str(d / LIST_NAME), str(d / DB_NAME)],
            "build")
        (d / READY).write_text("ok")
    return d / LIST_NAME, d / DB_NAME, steps


def check_rows(n_samples: int, seed: int, n: int = CHECK_ROWS,
               tile: int = TILE_ROWS) -> list:
    """The rows the check compares: the first, the last, one drawn from
    each tile of rows, and more drawn from the seed up to n in all."""
    rng = rng_for(seed ^ 0x5EED_C0DE)
    rows = {0, n_samples - 1}
    for t0 in range(0, n_samples, tile):
        rows.add(t0 + int(rng.integers(min(tile, n_samples - t0))))
    rest = sorted(set(range(n_samples)) - rows)
    if len(rows) < n and rest:
        pick = rng.choice(len(rest), size=min(n - len(rows), len(rest)),
                          replace=False)
        rows.update(rest[int(i)] for i in pick)
    return sorted(rows)


def kmer_length(config: dict) -> int:
    args = config["build"]
    return int(args[args.index("-k") + 1]) if "-k" in args else 18


def expected_lines(config: dict, traffic: dict, list_path, rows,
                   device, dtype=None) -> dict:
    """{line number: line} of the reference for the header, the totals
    row and the given rows."""
    import torch
    with open(list_path) as f:
        entries = [ln.strip() for ln in f if ln.strip()]
    paths = [e + ".fasta" for e in entries]
    names = [os.path.basename(e) for e in entries]
    k = kmer_length(config)
    totals, counts = ref_counts.row_counts(
        paths, k, rows, device=device,
        dtype=dtype if dtype is not None else torch.float32)
    out_spec = csvfmt.Output(traffic["args"])
    lines = {0: csvfmt.header(k, 1.0, names), 1: csvfmt.totals(totals)}
    for c, i in enumerate(rows):
        lines[2 + i] = out_spec.row(names[i], int(totals[i]),
                                    counts[c, :i].tolist())
    return lines


def pairs_per_call(traffic: dict, n_samples: int) -> int:
    rule = traffic["pairs"]
    if rule == "all2all":
        return n_samples * (n_samples - 1) // 2
    raise ValueError(f"no pair count {rule!r}")


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------

def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, root: pathlib.Path = ROOT,
             cache: pathlib.Path = CACHE, ref_device=None,
             t_start: float | None = None) -> tuple:
    """(result, numbers): the result line's object and the numbers the
    check compared.  The caller has made sure that the cell's cards are
    there (run.py), or drives the program on the CPU (the tests)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cell = registry.workload(bench, cell_name)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = registry.config(bench, cell["config"], root)
    traffic = registry.traffic(cell["traffic"])
    cuda = torch.cuda.is_available()
    # the program first: a checkout without it fails before any set-up
    from kmerdb_tpu_torch.cli import consoles
    from kmerdb_tpu_torch.cli.main import main as cli_main
    from kmerdb_tpu_torch.io import dbfile
    from kmerdb_tpu_torch.ops import device_a2a
    from . import sink as sink_mod
    tp = time.perf_counter()
    list_path, db_path, steps = prepare(config, root / cfg_entry["file"],
                                        seed, cache)
    prepare_s = time.perf_counter() - tp
    n = config["corpus"]["n_samples"]
    log(f"{cell_name} seed {seed}: "
        + ("miss, " + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
           if steps else "hit") + f", prepare_s {prepare_s:.3f}")

    rows = check_rows(n, seed)
    sink = sink_mod.Sink([0, 1, *(2 + i for i in rows)])
    argv = [traffic["mode"], *traffic["args"], str(db_path), sink.path]
    calls: list = []
    spans = devtrace.Spans()
    db_sizes: dict = {}

    def call() -> dict:
        device_a2a.last_stats.clear()
        r0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        rc = cli_main(list(argv))
        rep = sink.report() if rc == 0 else None
        t1 = time.perf_counter()
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        c = {"rc": rc, "report": rep, "t0": t0, "t1": t1,
             "wall_s": t1 - t0, "stats": dict(device_a2a.last_stats),
             "cpu_s": (r1.ru_utime - r0.ru_utime)
             + (r1.ru_stime - r0.ru_stime)}
        calls.append(c)
        log(f"call {c['wall_s']:.3f} s, cpu {c['cpu_s']:.3f} s, rc {rc}: "
            + ", ".join(f"{k} {c['stats'][k]:.3f}" for k in CALL_STATS
                        if k in c["stats"]))
        return c

    try:
        first = call()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start - prepare_s
        restore = []
        dev_trace = None
        if traced:
            def load(*a, _load=dbfile.load_db, **kw):
                db = _load(*a, **kw)
                db_sizes.update(S=int(db.n_samples), P=int(db.n_patterns))
                return db
            for mod, attr, fn, name, merge in (
                    (dbfile, "load_db", load, "load", False),
                    (consoles, "_emit_matrix_row",
                     consoles._emit_matrix_row, "writer", True),
                    (device_a2a._Packer, "push", device_a2a._Packer.push,
                     "fill_push", False)):
                restore.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, spans.wrap(fn, name, merge))
            if cuda:
                dev_trace = devtrace.DeviceTrace().__enter__()
        window: list = []
        t0 = time.perf_counter()
        try:
            while first["rc"] == 0:
                c = call()
                spans.items.append(("call", c["t0"], c["t1"]))
                window.append(c)
                if c["rc"] != 0 or c["t1"] - t0 >= seconds:
                    break
        finally:
            if dev_trace is not None:
                dev_trace.__exit__(None, None, None)
            for mod, attr, fn in restore:
                setattr(mod, attr, fn)
        t_end = window[-1]["t1"] if window else time.perf_counter()
        peak_dev = torch.cuda.max_memory_allocated() if cuda else 0
        peak_host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    finally:
        sink.close()
    kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    log(f"window {t_end - t0:.3f} s, {len(window)} calls: "
        + ", ".join(f"{c['wall_s']:.3f}" for c in window)
        + f"; child processes' cpu (the sink, and on a miss the corpus and"
        f" build) user {kids.ru_utime:.3f} s, system {kids.ru_stime:.3f} s")

    summary = None
    if dev_trace is not None:
        summary = devtrace.summarize(dev_trace.events(), dev_trace.t0, spans)
    if cuda:
        torch.cuda.empty_cache()
        log(card_line())
    tr = time.perf_counter()
    expected = expected_lines(config, traffic, list_path, rows,
                              ref_device or ("cuda" if cuda else "cpu"))
    numbers = judge.judge(expected, n + 2, calls)
    log(f"reference and check {time.perf_counter() - tr:.3f} s, "
        f"{len(rows)} rows")

    ok_calls = [c for c in window if c["rc"] == 0]
    run = types.SimpleNamespace(
        cell=cell, config=config, traffic=traffic, calls=ok_calls,
        spans=spans, trace=summary, db=db_sizes,
        pairs_per_call=pairs_per_call(traffic, n), window_s=t_end - t0,
        setup_s=setup_s, peak_dev_bytes=peak_dev, peak_host_bytes=peak_host)
    metrics = {}
    if traced:
        for m in registry.per_layer(bench, cell_name):
            v = registry.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in registry.end_to_end(bench, cell_name):
            metrics[m["name"]] = {"value": END_TO_END[m["name"]](run),
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell["chips"], "memory_peak_bytes": peak_dev}
    result = {"correct": judge.correct(numbers),
              "attempted": len(window),
              "failed": len(window) - len(ok_calls),
              "metrics": metrics, "device": device}
    if traced and summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        log("idle by span: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in summary["idle_by_span"]))
    result["checks"] = judge.record(numbers)
    return result, numbers


END_TO_END = {
    "pairs_per_s": lambda r: len(r.calls) * r.pairs_per_call / r.window_s,
    "peak_dev_mib": lambda r: r.peak_dev_bytes / 2**20,
    "peak_host_mib": lambda r: r.peak_host_bytes / 2**20,
    "setup_s": lambda r: r.setup_s,
}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return "card: " + r.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"card: nvidia-smi failed ({e})"


def main(argv=None) -> int:
    try:
        t_start = time.perf_counter() - process_age_s()
    except (OSError, ValueError):
        t_start = time.perf_counter()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    set_knobs = sorted(k for k in os.environ if k.startswith("KMERDB_"))
    if set_knobs:
        log(f"refused: {', '.join(set_knobs)} set; the benchmark runs "
            "every knob at its default")
        return 2
    bench = registry.load_bench()
    cell = registry.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        log(f"refused: {args.workload} needs {cell['chips']} CUDA card(s), "
            f"this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    result, numbers = run_cell(bench, args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        log(f"refused: loaded {', '.join(found)}")
        return 3
    for line in judge.lines(numbers):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
