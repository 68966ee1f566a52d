#!/usr/bin/env python3
"""Smoke run of kmerdb_tpu_torch on one CUDA card: kernels, main paths, oracle.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
NVIDIA Hopper card, the CUDA toolkit (nvcc) and g++, and builds the
kernels from ``kmerdb_tpu_torch/csrc``.  Phases, one output line each (or
one per case), each with its seconds:

1. environment: torch, CUDA, and the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. the kernel build (one nvcc per source, in parallel);
3. the 4,096-sample x 30 kbp scale corpus (the ICTV-scale stand-in of
   bench.py) and its database, built through the port's CLI entry point;
4. the matrix route's kernels against their plain PyTorch versions on the
   card, exact equality, at the shapes the route gives them (the
   database's light pattern group at S_pad = 4096; distinct random
   weights for 1 and 5 limbs, a K block other than the default, C seeded
   non-zero), with the times of both;
5. ``all2all`` on the matrix route (KMERDB_A2A_DEVICE=1) through the same
   entry point, the launch counters reset just before and read just
   after, and the device tier's phase times; then the same in a fresh
   process;
6. the oracle: the device C equals the host C++ tier's exactly, and the
   CSV equals the host tier's CSV byte for byte;
7. the 20,480-sample corpus (the same generator, 5x the samples) and its
   database: above the 16,384-sample gate, so ``all2all`` streams;
8. the streamed route's kernels against their plain versions on the card,
   exactly, at its shapes (the default 1,536-row stripe at S_pad 20,480,
   a stripe other than the first, the database's first light group),
   with the times of both;
9. the streamed route through the CLI with no route setting, dense and
   ``-sparse -min num-kmers:27000``, launch counters reset before each
   call and read after it, with ``last_stats`` and peak device memory;
10. the oracle: (a) both streamed CSVs equal the matrix route's byte for
    byte at 20,480 samples; (b) at 4,096 samples, all2all_device_rows
    with several stripes and an overlapping last one hands out phase 6's
    host C++ tier rows exactly, unfiltered and filtered;
11. the query and cross kernels against their plain versions, exactly,
    with the times of both: ``matmul_u32_acc`` at new2all's shapes on the
    4,096-sample database (Q_pad 512, S_pad 4096, the P_pad of the first
    m2a_prepare chunk; uint8 H over 0..255, and uint32 H of 4 limbs at
    2^31 and above, C seeded non-zero), ``cross_u32_pk`` at the parts
    grid's shape (weight 1, 1,024 x 1,024) and at a db2db shape (1,024 x
    640, distinct weights past 2^14, a K block other than the default);
12. ``new2all`` through the CLI on the device tier (KMERDB_N2A_DEVICE=1):
    the database of phase 3 against the first 1,100 genomes of its own
    list (flushes of 512, 512 and 76 queries), dense and ``-sparse -min
    num-kmers:27000``, launch counters reset before each call and read
    after it, with the device tier's phase times;
13. the oracle: both new2all CSVs equal the host tier's byte for byte, and
    ``one2all`` of one genome gives its new2all row;
14. ``all2all-parts`` over the scale corpus in 4 parts of 1,024 samples,
    each part built through the CLI: (a) the device grid, (b) the
    streamed device grid, (c) per cell on the device tiers, each with its
    launches;
15. the oracle: the CSVs of (a), (b) and (c) equal the host tiers' byte
    for byte.

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
#: the streamed route's corpus: above kmerdb_tpu's 16,384-sample gate
N_LARGE = 20_480
#: -sparse bound: close relatives only, so few tiles hold survivors (pairs
#: share about 17k-29k of ~30k k-mers, nearest neighbours the most)
SPARSE_MIN = 27_000
#: phase 10b: 11 tiles a stripe at S_pad 4096, the last stripe overlapping
STRIPE_CHECK = 11 * 128
#: phase 12: new2all's queries, the reference CI shape (bench.py:98-99)
N_QUERIES = 1100
#: phase 14: all2all-parts over the scale corpus in parts of this size
PART_SIZE = 1024


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


def _err(torch, a, b) -> int:
    """Largest absolute difference of two count tensors, as uint32."""
    return int((_u32(torch, a) - _u32(torch, b)).abs().max()) if a.numel() \
        else 0


def _fmt(d: dict) -> str:
    return " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in d.items())


def _first_group(device_a2a, db, kt_check):
    """The database's first light group: (its packed incidence padded with
    zero rows to a multiple of kt_check patterns, its weights at the
    route's own padding, the padded pattern count, kt, tile, S_pad)."""
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
    rows_check = -(-rows // kt_check) * kt_check
    Bp_np = np.zeros((rows_check // 8, S_pad), np.uint8)
    Bp_np[:rows // 8] = buf[:rows // 8]
    return Bp_np, wbuf[:rows].copy(), rows_check, kt, tile, S_pad


def check_kernels(torch, gram, device_a2a, db, rng) -> dict:
    """Phase 4: the matrix route's kernels == plain versions on the
    database's light group."""
    dev = torch.device("cuda")
    kt_check = 4 * device_a2a.KT           # a K block other than the default
    Bp_np, _, rows_check, _, tile, S_pad = _first_group(device_a2a, db,
                                                        kt_check)
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
        err = _err(torch, Ck, Cp)
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


def check_stripe_kernels(torch, gram, device_a2a, db, rng) -> dict:
    """Phase 8: the streamed route's kernels == plain versions at its
    shapes: the default stripe of the large database, its first light
    group, a stripe other than the first."""
    dev = torch.device("cuda")
    T = gram.PULL_TILE
    kt_check = 4 * device_a2a.KT           # a K block other than the default
    Bp_np, w_db, rows_check, kt, tile, S_pad = _first_group(device_a2a, db,
                                                            kt_check)
    R = max(tile, device_a2a.STRIPE_BYTES // (S_pad * 4) // tile * tile)
    rt0 = (S_pad - R) // tile // 2                     # a middle stripe
    out = {"gram_pk_rows": [], "cast_rows": [], "filter_colsum": [],
           "gather_tiles": []}

    C0_np = rng.integers(0, 1 << 32, size=(R, S_pad), dtype=np.uint64)
    C0_np = C0_np.astype(np.uint32)
    for n_limbs in (1, 5):
        w_np = rng.integers(0, 1 << min(32, 7 * n_limbs), size=rows_check,
                            dtype=np.uint64).astype(np.uint32)
        Bp, w, C0 = gram.from_jax_layout(
            Bp_np, gram.pk_weight_order(w_np, kt_check), C0_np, dev)
        kw = dict(n_limbs=n_limbs, kt=kt_check, tile=tile)
        Ck = gram.gram_u32_pk_rows(Bp, w, C0.clone(), rt0, **kw)
        Cp = gram.gram_u32_pk_rows_plain(Bp, w, C0.clone(), rt0, **kw)
        torch.cuda.synchronize()
        err = _err(torch, Ck, Cp)
        _check(torch.equal(Ck, Cp) and not torch.equal(Ck, C0),
               f"gram_pk_rows differs from its plain version "
               f"(n_limbs={n_limbs}, max_abs_err={err})")
        Ct = C0.clone()
        ms = _cuda_ms(torch, lambda: gram.gram_u32_pk_rows(Bp, w, Ct, rt0,
                                                           **kw), 3)
        plain_ms = _cuda_ms(torch, lambda: gram.gram_u32_pk_rows_plain(
            Bp, w, Ct, rt0, **kw), 1)
        ops = 2.0 * rows_check * R * S_pad * n_limbs
        out["gram_pk_rows"].append(dict(
            n_limbs=n_limbs, rows=rows_check, R=R, rt0=rt0, S_pad=S_pad,
            kt=kt_check, tile=tile, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, tops=ops / ms / 1e9))
        del Bp, w, C0, Cp, Ct

    # the group's real counts in that stripe, at the route's own kt
    rows = w_db.size                       # a multiple of kt
    Bp = torch.from_numpy(Bp_np[:rows // 8]).to(dev)
    wg = torch.from_numpy(gram.pk_weight_order(w_db, kt).view(np.int32)).to(dev)
    Cr = torch.zeros((R, S_pad), dtype=torch.int32, device=dev)
    gram.gram_u32_pk_rows(Bp, wg, Cr, rt0, n_limbs=1, kt=kt, tile=tile)

    for name, C in (("random", Ck), ("counts", Cr)):
        ck, cp = gram.cast_rows(C), gram.cast_rows_plain(C)
        torch.cuda.synchronize()
        err = _err(torch, ck.to(torch.int32) & 0xFFFF,
                   cp.to(torch.int32) & 0xFFFF)
        _check(torch.equal(ck, cp), f"cast_rows differs from its plain "
                                    f"version ({name}, max_abs_err={err})")
        ms = _cuda_ms(torch, lambda: gram.cast_rows(C), 50)
        plain_ms = _cuda_ms(torch, lambda: gram.cast_rows_plain(C), 10)
        out["cast_rows"].append(dict(
            stripe=name, shape=f"{R}x{S_pad}", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, gb_per_s=6 * C.numel() / ms / 1e6))

    top = int(_u32(torch, Cr).max())
    survivors = None
    for name, lo, hi in (("selective", top * 9 // 10, 0xFFFFFFFF),
                         ("full", 0, 0xFFFFFFFF),
                         ("unsigned", 1 << 31, 0xFFFFFFFF)):
        C = Ck if name == "unsigned" else Cr
        b = gram.bias_bounds(lo, hi)
        fk, fp = gram.filter_colsum(C, b), gram.filter_colsum_plain(C, b)
        torch.cuda.synchronize()
        err = _err(torch, fk, fp)
        _check(torch.equal(fk, fp), f"filter_colsum differs from its plain "
                                    f"version ({name}, max_abs_err={err})")
        tile_cnt = fk.cpu().numpy().reshape(R // T, S_pad // T, T).sum(2)
        if name == "selective":
            survivors = np.nonzero(tile_cnt)
        ms = _cuda_ms(torch, lambda: gram.filter_colsum(C, b), 20)
        plain_ms = _cuda_ms(torch, lambda: gram.filter_colsum_plain(C, b), 5)
        out["filter_colsum"].append(dict(
            bounds=name, lo=lo, tiles_with_survivors=int(
                np.count_nonzero(tile_cnt)), tiles=tile_cnt.size,
            max_abs_err=err, ms=ms, plain_ms=plain_ms))

    _check(survivors[0].size > 0, "the selective bound kept no tile")
    i_tab, j_tab = gram.tile_tables(*survivors, dev)
    for dtype in (torch.int16, torch.int32):
        gk = gram.gather_tiles(Cr, i_tab, j_tab, dtype)
        gp = gram.gather_tiles_plain(Cr, i_tab, j_tab, dtype)
        torch.cuda.synchronize()
        err = int((gk.to(torch.int64) - gp.to(torch.int64)).abs().max())
        _check(torch.equal(gk, gp), f"gather_tiles differs from its plain "
                                    f"version ({dtype}, max_abs_err={err})")
        ms = _cuda_ms(torch, lambda: gram.gather_tiles(Cr, i_tab, j_tab,
                                                       dtype), 50)
        plain_ms = _cuda_ms(torch, lambda: gram.gather_tiles_plain(
            Cr, i_tab, j_tab, dtype), 10)
        out["gather_tiles"].append(dict(
            dtype="uint16" if dtype == torch.int16 else "uint32",
            tiles=int(i_tab.numel()), max_abs_err=err, ms=ms,
            plain_ms=plain_ms))
    return out


def check_query_kernels(torch, gram, intersect, db, queries, rng) -> list:
    """Phase 11: matmul_u32_acc == plain at new2all's shapes: Q_pad and
    S_pad of the first flush and the first m2a_prepare chunk's B, with H
    over every uint8 byte and uint32 H of 4 limbs at 2^31 and above."""
    dev = torch.device("cuda")
    H_all, B_all, route_limbs = intersect.m2a_prepare(db, queries)
    n_chunks, Q_pad, P_pad = H_all.shape
    S_pad = B_all.shape[2]
    B = torch.from_numpy(B_all[0]).to(dev)
    del H_all, B_all
    C0 = torch.from_numpy(rng.integers(0, 1 << 32, size=(Q_pad, S_pad),
                                       dtype=np.uint64).astype(np.uint32)
                          .view(np.int32)).to(dev)
    out = []
    for h_type, n_limbs in (("uint8", 1), ("uint32", 4)):
        if n_limbs == 1:
            H = rng.integers(0, 256, size=(Q_pad, P_pad), dtype=np.uint8)
            H[:, :256] = np.arange(256, dtype=np.uint8)    # every byte
        else:
            H = rng.integers(1 << 31, 1 << 32, size=(Q_pad, P_pad),
                             dtype=np.uint64).astype(np.uint32).view(np.int32)
        H = torch.from_numpy(H).to(dev)
        Ck = gram.matmul_u32_acc(H, B, C0.clone(), n_limbs=n_limbs)
        Cp = gram.matmul_u32_acc_plain(H, B, C0.clone(), n_limbs=n_limbs)
        torch.cuda.synchronize()
        err = _err(torch, Ck, Cp)
        _check(torch.equal(Ck, Cp) and not torch.equal(Ck, C0),
               f"matmul_u32_acc differs from its plain version "
               f"({h_type} H, max_abs_err={err})")
        Ct = C0.clone()
        ms = _cuda_ms(torch, lambda: gram.matmul_u32_acc(
            H, B, Ct, n_limbs=n_limbs), 5)
        plain_ms = _cuda_ms(torch, lambda: gram.matmul_u32_acc_plain(
            H, B, Ct, n_limbs=n_limbs), 2)
        ops = 2.0 * Q_pad * P_pad * S_pad * n_limbs
        out.append(dict(H=h_type, n_limbs=n_limbs, Q_pad=Q_pad, P_pad=P_pad,
                        S_pad=S_pad, chunks=n_chunks, route_limbs=route_limbs,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        tops=ops / ms / 1e9))
        del H, Ck, Cp, Ct
    return out


def check_cross_kernels(torch, gram, device_a2a, db, rng) -> list:
    """Phase 11: cross_u32_pk == plain on the database's first light group:
    the parts grid's shape (samples 0..1023 x 1024..2047, weight 1, the
    port's K block) and a db2db shape (1,024 x 640, distinct weights up to
    2^15, three limbs, another K block)."""
    dev = torch.device("cuda")
    kt_check = 4 * device_a2a.KT
    Bp_np, _, rows, _, _, _ = _first_group(device_a2a, db, kt_check)

    def cols(a, b):
        return torch.from_numpy(np.ascontiguousarray(Bp_np[:, a:b])).to(dev)

    part = min(PART_SIZE, Bp_np.shape[1] // 4)      # 1,024 at S_pad 4096
    d2d = max(128, part * 5 // 8 // 128 * 128)      # 640
    Up = cols(0, part)
    w_d2d = rng.integers(1, 1 << 15, size=rows, dtype=np.uint64)
    _check(int(w_d2d.max()) >= 1 << 14, "db2db weights below 2^14")
    out = []
    for shape, Vp, w_np, n_limbs, kt in (
            ("grid", cols(part, 2 * part), np.ones(rows, np.uint32), 1,
             device_a2a.KT),
            ("d2d", cols(2 * part, 2 * part + d2d), w_d2d.astype(np.uint32),
             3, kt_check)):
        w = torch.from_numpy(gram.pk_weight_order(w_np, kt).view(np.int32)) \
            .to(dev)
        S1, S2 = Up.shape[1], Vp.shape[1]
        C0 = torch.from_numpy(rng.integers(0, 1 << 32, size=(S1, S2),
                                           dtype=np.uint64).astype(np.uint32)
                              .view(np.int32)).to(dev)
        kw = dict(n_limbs=n_limbs, kt=kt)
        Ck = gram.cross_u32_pk(Up, Vp, w, C0.clone(), **kw)
        Cp = gram.cross_u32_pk_plain(Up, Vp, w, C0.clone(), **kw)
        torch.cuda.synchronize()
        err = _err(torch, Ck, Cp)
        _check(torch.equal(Ck, Cp) and not torch.equal(Ck, C0),
               f"cross_u32_pk differs from its plain version ({shape}, "
               f"max_abs_err={err})")
        Ct = C0.clone()
        ms = _cuda_ms(torch, lambda: gram.cross_u32_pk(Up, Vp, w, Ct, **kw),
                      5)
        plain_ms = _cuda_ms(torch, lambda: gram.cross_u32_pk_plain(
            Up, Vp, w, Ct, **kw), 1)
        ops = 2.0 * rows * S1 * S2 * n_limbs
        out.append(dict(shape=shape, S1=S1, S2=S2, rows=rows, kt=kt,
                        n_limbs=n_limbs, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, tops=ops / ms / 1e9))
    return out


def new2all_phases(torch, cli, gram, intersect, workdir, db_path, paths,
                   say) -> dict:
    """Phases 12 and 13: new2all through the CLI on the device and host
    tiers, dense and sparse, and one2all of one genome."""
    query_list = os.path.join(workdir, "queries.list")
    with open(query_list, "w") as f:
        f.write("\n".join(paths[:N_QUERIES]) + "\n")
    flushes = -(-N_QUERIES // 512)
    csvs, runs = {}, {}
    for tier in ("1", "0"):
        os.environ["KMERDB_N2A_DEVICE"] = tier
        for form, opts in (("dense", []),
                           ("sparse", ["-sparse", "-min",
                                       f"num-kmers:{SPARSE_MIN}"])):
            csvs[tier, form] = os.path.join(workdir, f"n2a{tier}-{form}.csv")
            intersect.n2a_stats.clear()
            _reset_launches(gram)
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            rc = cli(["new2all", *opts, db_path, query_list,
                      csvs[tier, form]])
            wall = time.perf_counter() - t
            n = _launches(gram)
            st = dict(intersect.n2a_stats)
            _check(rc == 0, f"new2all {form} (KMERDB_N2A_DEVICE={tier}) "
                            f"exited {rc}")
            runs[tier, form] = dict(wall=wall, launches=n, stats=st)
            if tier == "0":
                _check(not st and not any(n.values()),
                       f"the host tier of new2all ran the device: {n}")
                continue
            _check(n["matmul_u32_acc"] > 0 and st.get("calls") == flushes,
                   f"new2all {form}: matmul_u32_acc not launched on every "
                   f"flush: {n}, {st}")
            busy = st.get("matmul_s", 0.0)
            say(f"[12 new2all {form}] {wall:.3f} s CLI call ({N_QUERIES} "
                f"queries x {N_SAMPLES} samples; kernel busy {busy:.4f} s = "
                f"{100 * busy / wall:.1f}%), launches "
                f"{ {k: v for k, v in n.items() if v} }, peak device memory "
                f"{torch.cuda.max_memory_allocated() >> 20} MiB, CSV "
                f"{os.path.getsize(csvs[tier, form])} bytes; device tier "
                + _fmt(st))
    os.environ.pop("KMERDB_N2A_DEVICE")

    t = time.perf_counter()
    for form in ("dense", "sparse"):
        _check(filecmp.cmp(csvs["1", form], csvs["0", form], shallow=False),
               f"new2all {form}: the device CSV differs from the host tier's")
        say(f"[13 oracle] new2all {form}: device CSV == host tier CSV "
            f"({os.path.getsize(csvs['1', form])} bytes); host tier "
            f"{runs['0', form]['wall']:.3f} s vs device tier "
            f"{runs['1', form]['wall']:.3f} s")
    pick = 7
    o2a = os.path.join(workdir, "o2a.csv")
    _check(cli(["one2all", db_path, paths[pick] + ".fasta", o2a]) == 0,
           "one2all failed")
    with open(o2a) as f:
        want = f.read().splitlines()[-1].split(",")[1:]
    with open(csvs["1", "dense"]) as f:
        got = f.read().splitlines()[2 + pick].split(",")[1:]
    _check(got == want, f"one2all of genome {pick} differs from its "
                        f"new2all row")
    for path in (*csvs.values(), o2a, query_list):
        os.remove(path)
    say(f"[13 oracle] one2all of genome {pick} == its new2all row "
        f"({len([v for v in want if v])} fields); "
        f"{time.perf_counter() - t:.2f} s")
    return runs


_PARTS_KNOBS = ("KMERDB_GRID_DEVICE", "KMERDB_GRID_STREAM",
                "KMERDB_D2D_DEVICE", "KMERDB_A2A_DEVICE")
_PARTS_TIERS = {
    "a grid": {"KMERDB_GRID_DEVICE": "1"},
    "b streamed grid": {"KMERDB_GRID_DEVICE": "1", "KMERDB_GRID_STREAM": "1"},
    "c per cell": {"KMERDB_GRID_DEVICE": "0", "KMERDB_D2D_DEVICE": "1",
                   "KMERDB_A2A_DEVICE": "1"},
    "host": {"KMERDB_GRID_DEVICE": "0", "KMERDB_D2D_DEVICE": "0",
             "KMERDB_A2A_DEVICE": "0"},
}


def parts_phases(torch, cli, gram, fused, workdir, paths, say) -> dict:
    """Phases 14 and 15: all2all-parts over the corpus in parts, on the
    device grid, the streamed grid and per cell, against the host tiers."""
    t = time.perf_counter()
    part_dbs = []
    for pi in range(len(paths) // PART_SIZE):
        lst = os.path.join(workdir, f"part{pi}.list")
        with open(lst, "w") as f:
            f.write("\n".join(paths[pi * PART_SIZE:(pi + 1) * PART_SIZE])
                    + "\n")
        part_dbs.append(os.path.join(workdir, f"part{pi}.db"))
        _check(cli(["build", "-k", "18", lst, part_dbs[-1]]) == 0,
               f"build of part {pi} failed")
    parts_list = os.path.join(workdir, "parts.list")
    with open(parts_list, "w") as f:
        f.write("\n".join(part_dbs) + "\n")
    say(f"[14 parts build] {time.perf_counter() - t:.2f} s; "
        f"{len(part_dbs)} parts of {PART_SIZE} samples")

    csvs, runs = {}, {}
    for name, env in _PARTS_TIERS.items():
        for k in _PARTS_KNOBS:
            os.environ.pop(k, None)
        os.environ.update(env)
        csvs[name] = os.path.join(workdir, f"parts-{name[0]}.csv")
        fused.last_stats.clear()
        _reset_launches(gram)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rc = cli(["all2all-parts", parts_list, csvs[name]])
        wall = time.perf_counter() - t
        n = _launches(gram)
        _check(rc == 0, f"all2all-parts ({name}) exited {rc}")
        runs[name] = dict(wall=wall, launches=n)
        want = {"cross_u32_pk"} | (
            {"cast_rows"} if "grid" in name else
            {"gram_pk_tri", "tril_tiles"} if name == "c per cell" else set())
        if name == "host":
            want = set()
        _check({k for k, v in n.items() if v} == want,
               f"all2all-parts ({name}) launched {n}, expected {want}")
        shown = {k: n[k] for k in ("cross_u32_pk", "cast_rows", "gram_pk_tri",
                                   "tril_tiles")}
        say(f"[14 all2all-parts {name}] {wall:.3f} s CLI call, launches "
            f"{shown}, peak device memory "
            f"{torch.cuda.max_memory_allocated() >> 20} MiB, CSV "
            f"{os.path.getsize(csvs[name])} bytes"
            + ("; grid " + _fmt(fused.last_stats) if fused.last_stats
               else ""))
    for k in _PARTS_KNOBS:
        os.environ.pop(k, None)

    for name in ("a grid", "b streamed grid", "c per cell"):
        _check(filecmp.cmp(csvs[name], csvs["host"], shallow=False),
               f"all2all-parts ({name}) CSV differs from the host tiers'")
        say(f"[15 oracle] all2all-parts ({name}) CSV == host tiers' CSV; "
            f"{runs[name]['wall']:.3f} s vs host {runs['host']['wall']:.3f} s")
    for path in (*csvs.values(), *part_dbs):
        os.remove(path)
    return runs


def _kernel_fns(gram) -> dict:
    return {"gram_pk_tri": gram.gram_u32_pk_tri,
            "tril_tiles": gram.tril_tiles,
            "gram_pk_rows": gram.gram_u32_pk_rows,
            "cast_rows": gram.cast_rows,
            "filter_colsum": gram.filter_colsum,
            "gather_tiles": gram.gather_tiles,
            "matmul_u32_acc": gram.matmul_u32_acc,
            "cross_u32_pk": gram.cross_u32_pk}


def _launches(gram) -> dict:
    return {name: fn.launches for name, fn in _kernel_fns(gram).items()}


def _reset_launches(gram) -> None:
    for fn in _kernel_fns(gram).values():
        fn.launches = 0


def _corpus(cli, bench_corpus, dbfile, workdir, name, n_samples,
            keep=False):
    """(database path, loaded database, corpus s, build s, the corpus
    list when `keep`, else None: the genomes are deleted)."""
    t = time.perf_counter()
    lst = bench_corpus.generate_scale(
        os.path.join(workdir, f"corpus{n_samples}"), n_samples=n_samples,
        genome_len=GENOME_LEN, branch_rate=BRANCH_RATE, seed=SEED)
    t_corpus = time.perf_counter() - t
    db_path = os.path.join(workdir, name)
    t = time.perf_counter()
    _check(cli(["build", "-k", "18", lst, db_path]) == 0, "build failed")
    t_build = time.perf_counter() - t
    if not keep:
        shutil.rmtree(os.path.dirname(lst), ignore_errors=True)
    return db_path, dbfile.load_db(db_path, dbfile.PATTERNS), t_corpus, \
        t_build, lst if keep else None


def _set_route(stream=None, device=None) -> None:
    for var, value in (("KMERDB_A2A_STREAM", stream),
                       ("KMERDB_A2A_DEVICE", device)):
        if value is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = value


def run(workdir: str) -> list:
    def say(line: str) -> None:
        print(line, flush=True)

    sys.modules["jax"] = None             # any JAX import below fails loudly
    t = time.perf_counter()
    import torch
    _check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    say(f"[1 env] {time.perf_counter() - t:.2f} s; python "
        f"{sys.version.split()[0]} torch {torch.__version__} "
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
    db_path, db, t_corpus, t_build, scale_list = _corpus(
        cli, bench_corpus, dbfile, workdir, "scale.db", N_SAMPLES, keep=True)
    say(f"[3 corpus+build] {time.perf_counter() - t:.2f} s; {db.n_samples} "
        f"samples x {GENOME_LEN} bp, {db.n_patterns} patterns; corpus "
        f"{t_corpus:.2f} s, build {t_build:.2f} s")

    rng = np.random.default_rng(SEED)
    t = time.perf_counter()
    kres = check_kernels(torch, gram, device_a2a, db, rng)
    say(f"[4 kernels] {time.perf_counter() - t:.2f} s")
    for name, cases in kres.items():
        for c in cases:
            say(f"[4 kernel] {name} == plain: {_fmt(c)}")

    dev_csv = os.path.join(workdir, "device.csv")
    host_csv = os.path.join(workdir, "host.csv")
    _set_route(device="1")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(gram)
    t = time.perf_counter()
    rc = cli(["all2all", db_path, dev_csv])
    t_cli = time.perf_counter() - t
    launches_matrix = _launches(gram)
    _check(rc == 0, f"all2all on the device tier exited {rc}")
    _check(launches_matrix["gram_pk_tri"] > 0
           and launches_matrix["tril_tiles"] > 0,
           f"a kernel of the matrix route was not launched: "
           f"{launches_matrix}")
    st = dict(device_a2a.last_stats)
    t = time.perf_counter()
    dbfile.load_db(db_path, dbfile.PATTERNS)
    t_load = time.perf_counter() - t
    busy = st["gram_s"] + st["tril_s"]
    say(f"[5 all2all] {t_cli:.3f} s device tier, CLI call (database load "
        f"{t_load:.3f} s; kernels busy {busy:.4f} s = "
        f"{100 * busy / t_cli:.1f}% of the call), launches {launches_matrix}, "
        f"peak device memory {torch.cuda.max_memory_allocated() >> 20} MiB; "
        + _fmt(st))

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
    os.remove(cold_csv)
    say(f"[5 all2all] {t_cold:.3f} s fresh process "
        f"`python -m kmerdb_tpu_torch all2all`")

    t = time.perf_counter()
    C_dev = device_a2a.all2all_device(db)
    _set_route(device="0")
    th = time.perf_counter()
    C_host = intersect.all2all_counts(db)
    t_host = time.perf_counter() - th
    _check(C_dev.dtype == C_host.dtype == np.uint32
           and C_dev.shape == C_host.shape == (db.n_samples,) * 2,
           "device and host C differ in type or shape")
    n_diff = int(np.count_nonzero(C_dev != C_host))
    _check(n_diff == 0, f"device C differs from the host C++ tier in "
                        f"{n_diff} cells")
    del C_dev
    _check(cli(["all2all", db_path, host_csv]) == 0, "host all2all failed")
    _check(filecmp.cmp(dev_csv, host_csv, shallow=False),
           "device CSV differs from the host tier's CSV")
    csv_bytes = os.path.getsize(dev_csv)
    os.remove(dev_csv)
    os.remove(host_csv)
    say(f"[6 oracle] {time.perf_counter() - t:.2f} s; device C == host C++ "
        f"tier C ({db.n_samples}^2 cells, host tier {t_host:.2f} s); CSV "
        f"byte-equal ({csv_bytes} bytes)")

    t = time.perf_counter()
    big_path, big, t_corpus, t_build, _ = _corpus(
        cli, bench_corpus, dbfile, workdir, "large.db", N_LARGE)
    kt, tile, S_pad = device_a2a._geometry(big.n_samples)
    light, heavy, heavy_limbs = device_a2a._limb_split(big.pattern_num_kmers)
    _, groups = device_a2a._group_plan(light, heavy, heavy_limbs, S_pad, kt)
    packed = sum(rows // 8 * S_pad for _, _, rows in groups)
    _check(big.n_samples == N_LARGE, f"{big.n_samples} samples built")
    say(f"[7 corpus+build] {time.perf_counter() - t:.2f} s; S {big.n_samples}"
        f" (S_pad {S_pad}), {big.n_patterns} patterns: {light.size} light, "
        f"{heavy.size} heavy ({heavy_limbs} limbs), {len(groups)} groups, "
        f"{packed} packed bytes; max sample k-mers "
        f"{int(big.sample_kmer_counts.max())}; corpus {t_corpus:.2f} s, "
        f"build {t_build:.2f} s")

    t = time.perf_counter()
    sres = check_stripe_kernels(torch, gram, device_a2a, big, rng)
    torch.cuda.empty_cache()
    say(f"[8 kernels] {time.perf_counter() - t:.2f} s")
    for name, cases in sres.items():
        for c in cases:
            say(f"[8 kernel] {name} == plain: {_fmt(c)}")

    csvs = {}
    runs = {}
    for route, stream, device in (("streamed", None, None),
                                  ("matrix", "0", "1")):
        for form, opts in (("dense", []),
                           ("sparse", ["-sparse", "-min",
                                       f"num-kmers:{SPARSE_MIN}"])):
            _set_route(stream, device)
            csvs[route, form] = os.path.join(workdir, f"{route}-{form}.csv")
            device_a2a.last_stats.clear()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches(gram)
            t = time.perf_counter()
            rc = cli(["all2all", *opts, big_path, csvs[route, form]])
            wall = time.perf_counter() - t
            _check(rc == 0, f"{route} {form} all2all exited {rc}")
            runs[route, form] = dict(
                wall=wall, launches=_launches(gram),
                peak_mib=torch.cuda.max_memory_allocated() >> 20,
                stats=dict(device_a2a.last_stats))
            if route == "matrix":
                continue
            n = runs[route, form]["launches"]
            st = runs[route, form]["stats"]
            _check(st.get("streamed") is True, "the default route did not "
                                               "stream at 20,480 samples")
            _check(n["gram_pk_rows"] > 0 and n["gram_pk_tri"] == 0
                   and n["tril_tiles"] == 0,
                   f"streamed {form}: wrong kernels launched: {n}")
            if form == "dense":
                _check(n["cast_rows"] > 0, f"cast_rows not launched: {n}")
            else:
                sp = st["sparse_pull"]
                _check(n["filter_colsum"] > 0 and n["gather_tiles"] > 0,
                       f"sparse pull kernels not launched: {n}")
                _check(sp["tiles_pulled"] < sp["tiles_total"],
                       f"the sparse pull took every tile: {sp}")
            busy = sum(st.get(k, 0.0) for k in ("gram_s", "pull_s",
                                                "filter_s"))
            say(f"[9 {route} {form}] {wall:.3f} s CLI call (kernels and "
                f"pulls busy {busy:.4f} s = {100 * busy / wall:.1f}%), "
                f"launches {n}, peak device memory "
                f"{runs[route, form]['peak_mib']} MiB, CSV "
                f"{os.path.getsize(csvs[route, form])} bytes; " + _fmt(
                    {k: v for k, v in st.items() if k != "sparse_pull"})
                + (f" sparse_pull={st['sparse_pull']} tile share "
                   f"{st['sparse_pull']['tiles_pulled'] / st['sparse_pull']['tiles_total']:.4f}"
                   if form == "sparse" else ""))
    _set_route()

    t = time.perf_counter()
    for form in ("dense", "sparse"):
        m = runs["matrix", form]
        _check(m["launches"]["gram_pk_tri"] > 0
               and m["launches"]["gram_pk_rows"] == 0,
               f"the matrix route ran the wrong kernels: {m['launches']}")
        _check(filecmp.cmp(csvs["streamed", form], csvs["matrix", form],
                           shallow=False),
               f"streamed {form} CSV differs from the matrix route's")
        size = os.path.getsize(csvs["matrix", form])
        for route in ("streamed", "matrix"):
            os.remove(csvs[route, form])
        say(f"[10a oracle] {form}: streamed CSV == matrix route CSV "
            f"({size} bytes); matrix route {m['wall']:.3f} s, launches "
            f"{m['launches']}, peak device memory {m['peak_mib']} MiB, "
            f"device tier {_fmt({k: v for k, v in m['stats'].items() if k.endswith('_s')})}")
    say(f"[10a oracle] {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    lo = SPARSE_MIN
    for bounds in (None, (lo, 0xFFFFFFFF)):
        seen = []

        def check_row(i, row):
            want = C_host[i]
            if bounds is not None:
                want = np.where((want >= bounds[0]) & (want <= bounds[1]),
                                want, 0)
            _check(row.dtype == np.uint32 and np.array_equal(row, want),
                   f"streamed row {i} differs from the host C++ tier "
                   f"(bounds {bounds})")
            seen.append(i)

        device_a2a.all2all_device_rows(db, check_row,
                                       stripe_rows=STRIPE_CHECK,
                                       cell_bounds=bounds)
        _check(seen == list(range(db.n_samples)),
               "rows were not handed out once each, in order")
        st = device_a2a.last_stats
        nt, nrt = st["S_pad"] // st["tile"], st["stripe_rows"] // st["tile"]
        say(f"[10b oracle] streamed rows == host C++ tier C at S "
            f"{db.n_samples}, stripe_rows {st['stripe_rows']} (stripes at "
            f"row tiles {[min(r, nt - nrt) for r in range(0, nt, nrt)]}), "
            f"bounds {bounds}"
            + (f", sparse_pull {st['sparse_pull']}" if bounds else ""))
    say(f"[10b oracle] {time.perf_counter() - t:.2f} s")
    del C_host

    from kmerdb_tpu_torch.host import loader, params
    from kmerdb_tpu_torch.ops import fused
    with open(scale_list) as f:
        paths = [ln for ln in f.read().split() if ln]
    t = time.perf_counter()
    dbq = dbfile.load_db(db_path, dbfile.EVERYTHING)
    first = os.path.join(workdir, "first-flush.list")
    with open(first, "w") as f:
        f.write("\n".join(paths[:512]) + "\n")
    queries = [s.kmers for s in loader.iter_samples(
        first, params.GENOME, dbq.kmer_length, dbq.fraction,
        dbq.start_fraction, dbq.alphabet_name, False)]
    qres = check_query_kernels(torch, gram, intersect, dbq, queries, rng)
    del dbq, queries
    cres = check_cross_kernels(torch, gram, device_a2a, db, rng)
    torch.cuda.empty_cache()
    say(f"[11 kernels] {time.perf_counter() - t:.2f} s")
    for name, cases in (("matmul_u32_acc", qres), ("cross_u32_pk", cres)):
        for c in cases:
            say(f"[11 kernel] {name} == plain: {_fmt(c)}")

    n2a = new2all_phases(torch, cli, gram, intersect, workdir, db_path,
                         paths, say)
    parts = parts_phases(torch, cli, gram, fused, workdir, paths, say)

    def entry(name, source, replaces, res, launches, timed=0):
        """res[timed] gives the times: the case nearest the route's own."""
        return {"name": name, "route": "cuda",
                "source": f"kmerdb_tpu_torch/csrc/{source}",
                "replaces": f"kmerdb_tpu/ops/pallas_gram.py:{replaces}",
                "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in res),
                "ms": res[timed]["ms"], "plain_ms": res[timed]["plain_ms"]}

    dense = runs["streamed", "dense"]["launches"]
    sparse = runs["streamed", "sparse"]["launches"]
    return [
        entry("gram_pk_tri", "gram_pk_tri.cu", 196, kres["gram_pk_tri"],
              launches_matrix),
        entry("tril_tiles", "tril_tiles.cu", 392, kres["tril_tiles"],
              launches_matrix),
        entry("gram_pk_rows", "gram_pk_rows.cu", 337, sres["gram_pk_rows"],
              dense),
        entry("cast_rows", "cast_rows.cu", 551, sres["cast_rows"], dense,
              timed=1),
        entry("filter_colsum", "filter_colsum.cu", 454,
              sres["filter_colsum"], sparse),
        entry("gather_tiles", "tril_tiles.cu", 482, sres["gather_tiles"],
              sparse),
        entry("matmul_u32_acc", "matmul_acc.cu", 686, qres,
              n2a["1", "dense"]["launches"]),
        entry("cross_u32_pk", "cross_pk.cu", 727, cres,
              parts["a grid"]["launches"]),
    ]


def main() -> int:
    workdir = tempfile.mkdtemp(prefix="kmerdb_chip_smoke_")
    t = time.perf_counter()
    try:
        kernels = run(workdir)
    except Exception as e:  # noqa: BLE001 — report any phase's failure
        traceback.print_exc()
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    import torch
    print(f"[done] {time.perf_counter() - t:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
