#!/usr/bin/env python3
"""Smoke run of kmerdb_tpu_torch on one CUDA card: kernels, main path, oracle.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
NVIDIA Hopper card, the CUDA toolkit (nvcc) and g++, and builds the
kernels from ``kmerdb_tpu_torch/csrc``.  Phases, one output line each:

1. environment: torch, CUDA, and the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. the kernel build and its seconds;
3. the 4,096-sample x 30 kbp scale corpus (the ICTV-scale stand-in of
   bench.py) and its database, built through the port's CLI entry point;
4. each kernel against its plain PyTorch version on the card, exact
   equality, at the shapes the main path gives it (the database's light
   pattern group at S_pad = 4096; distinct random weights for 1 and 5
   limbs, a K block other than the default, C seeded non-zero), with the
   times of both;
5. ``all2all`` on the device tier through the same entry point, the
   kernels' launch counters reset just before and read just after, and the
   device tier's phase times;
6. the oracle: the device C equals the host C++ tier's exactly, and the
   CSV equals the host tier's CSV byte for byte.

The next-to-last line is a JSON object of the kernels, the last
``{"ok": true, "device": {...}}``.  A failure exits non-zero without them.
The script and the port import nothing of JAX.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

SEED = 20270101
N_SAMPLES, GENOME_LEN, BRANCH_RATE = 4096, 30_000, 0.0008


class PhaseError(RuntimeError):
    pass


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseError(what)


def _cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of fn over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _u32(torch, t):
    return t.to(torch.int64) & 0xFFFFFFFF


def check_kernels(torch, gram, device_a2a, db, rng) -> dict:
    """Phase 4: kernel == plain version on the database's light group."""
    dev = torch.device("cuda")
    w_db = db.pattern_num_kmers
    kt, tile, S_pad = device_a2a._geometry(db.n_samples)
    light, heavy, heavy_limbs = device_a2a._limb_split(w_db)
    group_rows, groups = device_a2a._group_plan(light, heavy, heavy_limbs,
                                                S_pad, kt)
    gp, _, rows = groups[0]
    buf = np.empty((group_rows // 8, S_pad), np.uint8)
    wbuf = np.zeros(group_rows, np.uint32)
    device_a2a._fill_packed(gp, rows, db.pattern_offsets.astype(np.int64),
                            db.pattern_sample_ids.astype(np.uint32), w_db,
                            buf, wbuf)
    kt_check = 4 * kt                      # a K block other than the default
    rows_check = -(-rows // kt_check) * kt_check
    Bp_np = np.zeros((rows_check // 8, S_pad), np.uint8)
    Bp_np[:rows // 8] = buf[:rows // 8]
    C0_np = rng.integers(0, 1 << 32, size=(S_pad, S_pad), dtype=np.uint64)
    C0_np = C0_np.astype(np.uint32)
    out = {"gram_pk_tri": [], "tril_tiles": []}
    for n_limbs in (1, 5):
        w_np = rng.integers(0, 1 << min(32, 7 * n_limbs), size=rows_check,
                            dtype=np.uint64).astype(np.uint32)
        Bp, w, C0 = gram.from_jax_layout(
            Bp_np, gram.pk_weight_order(w_np, kt_check), C0_np, dev)
        kw = dict(n_limbs=n_limbs, kt=kt_check, tile=tile)
        Ck = gram.gram_u32_pk_tri(Bp, w, C0.clone(), **kw)
        Cp = gram.gram_u32_pk_tri_plain(Bp, w, C0.clone(), **kw)
        torch.cuda.synchronize()
        err = int((_u32(torch, Ck) - _u32(torch, Cp)).abs().max())
        _check(torch.equal(Ck, Cp) and not torch.equal(Ck, C0),
               f"gram_pk_tri differs from its plain version "
               f"(n_limbs={n_limbs}, max_abs_err={err})")
        Ct = C0.clone()
        ms = _cuda_ms(torch, lambda: gram.gram_u32_pk_tri(Bp, w, Ct, **kw), 5)
        plain_ms = _cuda_ms(
            torch, lambda: gram.gram_u32_pk_tri_plain(Bp, w, Ct, **kw), 2)
        nt = S_pad // tile
        ops = 2.0 * rows_check * S_pad * S_pad * (nt + 1) / (2 * nt) * n_limbs
        out["gram_pk_tri"].append(dict(
            n_limbs=n_limbs, rows=rows_check, S_pad=S_pad, kt=kt_check,
            tile=tile, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            tops=ops / ms / 1e9))
    for dtype in (torch.int16, torch.int32):
        tk = gram.tril_tiles(Ck, dtype)
        tp = gram.tril_tiles_plain(Ck, dtype)
        torch.cuda.synchronize()
        err = int((tk.to(torch.int64) - tp.to(torch.int64)).abs().max())
        _check(torch.equal(tk, tp), f"tril_tiles differs from its plain "
                                    f"version ({dtype}, max_abs_err={err})")
        ms = _cuda_ms(torch, lambda: gram.tril_tiles(Ck, dtype), 50)
        plain_ms = _cuda_ms(torch, lambda: gram.tril_tiles_plain(Ck, dtype), 10)
        moved = Ck.element_size() * tk.numel() + tk.element_size() * tk.numel()
        out["tril_tiles"].append(dict(
            dtype="uint16" if dtype == torch.int16 else "uint32",
            S_pad=S_pad, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            gb_per_s=moved / ms / 1e6))
    return out


def run(workdir: str) -> list:
    def say(line: str) -> None:
        print(line, flush=True)

    sys.modules["jax"] = None             # any JAX import below fails loudly
    import torch
    _check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    say(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    say(smi[0] if smi else "nvidia-smi gave no output")

    from kmerdb_tpu_torch.cli.main import main as cli
    from kmerdb_tpu_torch.host import bench_corpus, dbfile
    from kmerdb_tpu_torch.ops import _cuda, device_a2a, gram, intersect

    t = time.perf_counter()
    _cuda.lib()
    say(f"[2 build] {time.perf_counter() - t:.2f} s nvcc -> "
        f"{os.path.relpath(_cuda.library_path())}; ptxas: " + "; ".join(
            ln.split("info    : ")[1] for ln in _cuda.build_log().splitlines()
            if "registers" in ln))

    t = time.perf_counter()
    lst = bench_corpus.generate_scale(
        os.path.join(workdir, "corpus"), n_samples=N_SAMPLES,
        genome_len=GENOME_LEN, branch_rate=BRANCH_RATE)
    t_corpus = time.perf_counter() - t
    db_path = os.path.join(workdir, "scale.db")
    t = time.perf_counter()
    _check(cli(["build", "-k", "18", lst, db_path]) == 0, "build failed")
    t_build = time.perf_counter() - t
    db = dbfile.load_db(db_path, dbfile.PATTERNS)
    say(f"[3 corpus+build] {db.n_samples} samples x {GENOME_LEN} bp, "
        f"{db.n_patterns} patterns; corpus {t_corpus:.2f} s, "
        f"build {t_build:.2f} s")

    rng = np.random.default_rng(SEED)
    kres = check_kernels(torch, gram, device_a2a, db, rng)
    for name, cases in kres.items():
        for c in cases:
            say(f"[4 kernel] {name} == plain: " + " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in c.items()))

    dev_csv = os.path.join(workdir, "device.csv")
    host_csv = os.path.join(workdir, "host.csv")
    os.environ["KMERDB_A2A_DEVICE"] = "1"
    torch.cuda.reset_peak_memory_stats()
    gram.gram_u32_pk_tri.launches = 0
    gram.tril_tiles.launches = 0
    t = time.perf_counter()
    rc = cli(["all2all", db_path, dev_csv])
    t_cli = time.perf_counter() - t
    launches = {"gram_pk_tri": gram.gram_u32_pk_tri.launches,
                "tril_tiles": gram.tril_tiles.launches}
    _check(rc == 0, f"all2all on the device tier exited {rc}")
    _check(all(n > 0 for n in launches.values()),
           f"a kernel of the main path was not launched: {launches}")
    st = dict(device_a2a.last_stats)
    t = time.perf_counter()
    dbfile.load_db(db_path, dbfile.PATTERNS)
    t_load = time.perf_counter() - t
    busy = st["gram_s"] + st["tril_s"]
    say(f"[5 all2all] device tier, CLI call {t_cli:.3f} s (database load "
        f"{t_load:.3f} s; kernels busy {busy:.4f} s = "
        f"{100 * busy / t_cli:.1f}% of the call), launches {launches}, "
        f"peak device memory {torch.cuda.max_memory_allocated() >> 20} MiB; "
        + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in st.items()))

    # as a user runs it: a fresh process pays interpreter, torch and CUDA
    # start-up and the loading of the built kernel library
    cold_csv = os.path.join(workdir, "cold.csv")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, KMERDB_A2A_DEVICE="1", PYTHONPATH=os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")])))
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "kmerdb_tpu_torch", "all2all",
                        db_path, cold_csv], env=env, capture_output=True,
                       text=True, timeout=600)
    t_cold = time.perf_counter() - t
    _check(r.returncode == 0, f"all2all in a fresh process exited "
                              f"{r.returncode}: {r.stderr[-2000:]}")
    _check(filecmp.cmp(cold_csv, dev_csv, shallow=False),
           "the fresh process's CSV differs from the in-process CSV")
    say(f"[5 all2all] fresh process `python -m kmerdb_tpu_torch all2all`: "
        f"{t_cold:.3f} s wall")

    C_dev = device_a2a.all2all_device(db)
    os.environ["KMERDB_A2A_DEVICE"] = "0"
    t = time.perf_counter()
    C_host = intersect.all2all_counts(db)
    t_host = time.perf_counter() - t
    _check(C_dev.dtype == C_host.dtype == np.uint32
           and C_dev.shape == C_host.shape == (db.n_samples,) * 2,
           "device and host C differ in type or shape")
    n_diff = int(np.count_nonzero(C_dev != C_host))
    _check(n_diff == 0, f"device C differs from the host C++ tier in "
                        f"{n_diff} cells")
    _check(cli(["all2all", db_path, host_csv]) == 0, "host all2all failed")
    _check(filecmp.cmp(dev_csv, host_csv, shallow=False),
           "device CSV differs from the host tier's CSV")
    say(f"[6 oracle] device C == host C++ tier C ({db.n_samples}^2 cells, "
        f"host tier {t_host:.2f} s); CSV byte-equal "
        f"({os.path.getsize(dev_csv)} bytes)")

    g1 = kres["gram_pk_tri"][0]
    t16 = kres["tril_tiles"][0]
    return [
        {"name": "gram_pk_tri", "route": "cuda",
         "source": "kmerdb_tpu_torch/csrc/gram_pk_tri.cu",
         "replaces": "kmerdb_tpu/ops/pallas_gram.py:196",
         "launches": launches["gram_pk_tri"],
         "max_abs_err": max(c["max_abs_err"] for c in kres["gram_pk_tri"]),
         "ms": g1["ms"], "plain_ms": g1["plain_ms"]},
        {"name": "tril_tiles", "route": "cuda",
         "source": "kmerdb_tpu_torch/csrc/tril_tiles.cu",
         "replaces": "kmerdb_tpu/ops/pallas_gram.py:392",
         "launches": launches["tril_tiles"],
         "max_abs_err": max(c["max_abs_err"] for c in kres["tril_tiles"]),
         "ms": t16["ms"], "plain_ms": t16["plain_ms"]},
    ]


def main() -> int:
    workdir = tempfile.mkdtemp(prefix="kmerdb_chip_smoke_")
    try:
        kernels = run(workdir)
    except Exception as e:  # noqa: BLE001 — report any phase's failure
        traceback.print_exc()
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    import torch
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
