#!/usr/bin/env python3
"""Smoke run of kmerdb_tpu_torch on one CUDA card: kernels, main paths, oracle.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
NVIDIA Hopper card, the CUDA toolkit (nvcc) and g++, and builds the
kernels from ``kmerdb_tpu_torch/csrc``.  Phases, one output line each (or
one per case), each with its seconds:

1. environment: torch, CUDA, and the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. the kernel build (one nvcc per source, in parallel), with ptxas's
   registers, shared memory and spill bytes of the kernels on the int8
   tensor cores, which their records in the kernels' line carry: the
   packed Gram's four (gram_pk.cuh's block: the triangle, stripe and cross
   Grams and the sweep's int8) and the unpacked block's four (gram_u8.cuh:
   gram_u32_tri, gram_u32, the sweep's dotonly_s8 and the query
   contraction's matmul_acc_kernel, the records matmul_u32_acc and
   matmul_u32, whose shared memory is dynamic: the library's
   kmerdb_gram_u8_smem_bytes);
3. the 4,096-sample x 30 kbp scale corpus (the ICTV-scale stand-in of
   bench.py) and its database, built through the port's CLI entry point;
4. the matrix route's kernels against their plain PyTorch versions on the
   card, exact equality, at the shapes the route gives them (the
   database's light pattern group at S_pad = 4096; distinct random
   weights for 1, 5 and 2 limbs, and every bit set with both 7-bit limbs
   127; a K block other than the default, C seeded non-zero), with the
   times of both;
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
   a stripe other than the first, the database's first light group; the
   cases of phase 4), with the times of both; then ``cast_rows`` and its
   library call ``C.to(torch.int16)`` on the group's stripe, timed in turns
   over 21 rounds (medians, spreads, the rounds the kernel won);
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
    2^31 and above, C seeded non-zero; then Q_pad 128, the 76-query flush
    and a mesh slot, on a split-K grid), each with its ``k_splits`` and
    blocks and ``torch._int_mm`` of int8 operands of its shape as a
    yardstick (signed, one limb: not the same function); ``cross_u32_pk``
    at the parts grid's shape (weight 1, 1,024 x 1,024), at a db2db shape
    (1,024 x 640, distinct weights past 2^14, a K block other than the
    default), at that shape with two limbs of distinct weights, and at the
    grid's shape with every bit set and both limbs 127;
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
15. the oracle: all2all-parts on its own host tiers (KMERDB_GRID_DEVICE=0
    KMERDB_D2D_DEVICE=0 KMERDB_A2A_DEVICE=0: the host diagonal and the
    per-cell host db2db, no launch) over the first 2 parts, a cell taking
    them ~20 s, and (a), (b) and (c) over the same 2 parts, each CSV
    byte-equal to the host tiers'.  Then the CSVs of (a), (b) and (c)
    over all 4 parts equal, byte for byte, the CSV that ``all2all-sp`` of
    the whole database writes on the host C++ tier (the two modes write
    the same rows; the CPU tests hold them to each other);
16. the scan tier's kernels (KMERDB_A2A_PALLAS=0) against their plain
    versions, exactly, at its shapes on the 4,096-sample database: the
    first chunk of ``_scan_chunks`` (its incidence, P_pad, S_pad 4096),
    ``gram_u32_tri`` and ``gram_u32`` at the database's own limb count and
    at 4 limbs with distinct random weights (255, 2^8, 2^31 and above), and
    at 4 limbs on an all-ones operand with every weight 2^32 - 1 (every
    limb byte 255), with ``torch._int_mm(B.T, B)`` on the chunk's operand
    timed as their yardstick (unweighted, one limb: no route calls it),
    ``matmul_u32`` at Q_pad 512 with uint8 H over every byte and uint32 H
    of 4 limbs at 2^31 and above, with its ``k_splits`` and
    ``torch._int_mm`` of its shape as the yardstick;
17. ``all2all`` on the scan tier through the CLI (KMERDB_A2A_DEVICE=1
    KMERDB_A2A_PALLAS=0): one ``gram_u32_tri`` launch a chunk and no
    packed kernel, its ``scan_stats``, the CSV byte-equal to phase 6's
    host tier CSV; then C of the triangle and of the full grid
    (``gram_u32``), each equal to phase 6's host C++ tier C;
18. ``new2all`` of phase 12's 1,100 queries on the scan tier through the
    CLI (KMERDB_N2A_DEVICE=1 KMERDB_A2A_PALLAS=0), dense: one
    ``matmul_u32`` launch a chunk, the CSV byte-equal to phase 13's host
    tier CSV;
19. (printed after phase 8, on its stripes) ``bounds_zero_rows`` against
    its plain version, exactly, at the streamed route's stripe (1,536 x
    20,480): uint16 and uint32 output, the bounds ``lo = 1`` and a
    selective ``-min num-kmers`` window on the database's counts, and a
    window that straddles 2^31 on random cells;
20. the device mesh.  The machine has one card, so the script builds a
    mesh of 4 slots on it (``_torchinit.devices`` replaced; each slot has a
    CUDA stream of its own) and runs the CLI with ``-mesh 4`` on the
    20,480-sample database, dense and ``-sparse -min num-kmers:27000``:
    the default route streams through ``all2all_rows_sharded``
    (``gram_pk_rows`` once a round, slot and group, then ``cast_rows`` or
    ``bounds_zero_rows`` once a round and slot; the last round's stripes
    are clamped backwards).  Both CSVs byte-equal to phase 9's; each call
    made twice with equal bytes, which a missing stream dependency would
    break;
21. ``-mesh 4`` on the 4,096-sample database, each call made twice with
    equal bytes: ``all2all`` (the matrix through
    ``all2all_counts_sharded``, CSV == phase 6's host tier CSV),
    ``all2all-sp`` (CSV == phase 15's all2all-sp CSV, the host tier's of
    the same command), ``all2all-sp -sample-rows 3`` on the first 1,024-sample
    part (its sampler walks every cell in Python; CSV == the host tier's
    of the same command), ``new2all`` of phase 12's queries
    (``many2all_counts_sharded``, CSV == phase 13's host tier CSV) and
    ``all2all-parts`` over phase 14's parts (``db2db_counts_sharded`` and
    ``all2all_counts_sharded``, CSV == phase 15's all2all-sp CSV).  The
    launches of each call equal what its own plan comes to: one
    ``gram_u32_tri`` a chunk of a slot's patterns, one ``matmul_u32_acc``
    a chunk, slot and flush, one ``cross_u32_pk`` a chunk of a slot's pair
    share over the 6 cells;
22. (printed after phase 18, before the mesh phases, which remove the CSVs
    it is held to) the fused path on the scale corpus's list, no database
    built: (a) ``all2all -from-fasta`` with no knob (the card, raw groups),
    (b) ``KMERDB_FUSED_DEVICE=1 KMERDB_FUSED_DEDUP=0`` (raw groups: ~1.8 M
    groups in ~16 merge partitions, one ``gram_pk_tri`` a chunk and one
    ``tril_tiles``), (c) ``KMERDB_FUSED_DEDUP=1`` (the database's patterns:
    phase 5's launches) and (d) ``all2all-sp -from-fasta``.  Each call's
    launches equal its plan (``fused.last_stats``); the CSVs of (a)-(c)
    equal phase 6's host tier CSV and (d)'s phase 15's ``all2all-sp`` CSV,
    byte for byte.  The fused host tier is not run at this size (hours);
    the CPU tests hold it to kmerdb_tpu;
23. the kernel sweep (``kmerdb_tpu_torch/tools/kernel_sweep.py``, its seven
    Gram variants in ``csrc/gram_sweep.cu``): (a) each variant against its
    plain version, exactly, at S 512, P 8,192, (kt, tile) (512, 128) and
    (1024, 256), Bi != Bj, weights of 128 and 256 and above, C seeded
    non-zero; (b) the tool's ``run_variant`` of each at its defaults (S
    2,048, P 2^20, 2^17 for ``dotonly*``, kt 512, tile 128; a chain of 1 +
    5 calls, the launch counters reset before it and read after), then one
    call against the plain version, exactly, with the plain version's
    time, and for ``dotonly_s8`` ``torch._int_mm`` on the same operands;
    (c) ``sweep_on_db`` on the 4,096-sample database at kts 256, 512, 1024 x
    tiles 128, 256 (``kernel_bench``; its ``gram_pk_tri`` launches those of
    its chains, the knobs restored); (d) the ``int8`` variant equals
    ``gram_u32_pk_tri`` at phase 4's shape and takes its time within 10%.

Each kernel's record holds its time, its plain version's, the time of a
PyTorch call that computes the same function where one exists
(``library_ms``, else null), and its bound: the larger of its integer
operations over the int8 peak (the bf16 peak for the sweep's bf16
variants) and its bytes (inputs read once, outputs written once) over the
memory rate, all of an H100 SXM at 700 W; the kernels on the int8 tensor
cores also hold ptxas's ``registers`` and ``spill_bytes`` and their
``smem_bytes``; the query contraction's ``library_ms`` is its yardstick.  The next-to-last line
is a JSON object of the kernels, the last ``{"ok": true, "device":
{...}}``.  A failure exits non-zero without them.
The script and the port import nothing of JAX: an import blocker refuses
kmerdb_tpu and jax before the port is imported.
"""

import filecmp
import importlib.abc
import json
import os
import re
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
#: phase 16: matmul_u32's query rows, new2all's flush
SCAN_Q_PAD = 512
#: the query contraction's yardstick (phases 11 and 16)
INT_MM = "torch._int_mm on int8 operands of the same shapes: signed, one limb"
#: phase 8: rounds of cast_rows and its library call timed in turns
CAST_ROUNDS = 21
#: phases 20 and 21: slots of the mesh, all on the one card
MESH_SLOTS = 4
#: an H100 SXM's dense int8 tensor-core peak and memory rate (NVIDIA's data
#: sheet, at its 700 W limit): the bounds of every kernel record
INT8_OPS_PER_S = 1979e12
BYTES_PER_S = 3.35e12


class PhaseError(RuntimeError):
    pass


class _RefuseJax(importlib.abc.MetaPathFinder):
    """Refuses kmerdb_tpu, kmerdb_tpu.* and jax, jax.*; lets the rest,
    kmerdb_tpu_torch among it, through."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("kmerdb_tpu", "jax"):
            raise ImportError(f"{name} is refused: kmerdb_tpu_torch stands "
                              f"alone")
        return None


def refuse_jax_imports() -> None:
    """Install the import blocker before anything of the port is imported:
    any import of the JAX package or of JAX then fails loudly."""
    if not any(isinstance(f, _RefuseJax) for f in sys.meta_path):
        sys.meta_path.insert(0, _RefuseJax())


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


def _bound(ops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for `ops`
    int8 operations and `nbytes` bytes moved, and which of the two sets
    it."""
    t_ops, t_bytes = ops / INT8_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


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


#: the packed Gram's cases in phases 4 and 8: (bits, limbs), "ones" every
#: bit set and every 7-bit limb 127 (the largest products; counts past 2^31)
PK_CASES = (("random", 1), ("random", 5), ("random", 2), ("ones", 2))


def _pk_case(rng, Bp_np, bits, n_limbs):
    """(packed operand, natural-order weights) of one PK_CASES case:
    the group's bits with distinct random weights of n_limbs limbs, or
    every bit set with every limb 127."""
    rows = 8 * Bp_np.shape[0]
    if bits == "ones":
        return np.full_like(Bp_np, 255), np.full(
            rows, (1 << min(32, 7 * n_limbs)) - 1, np.uint64).astype(np.uint32)
    return Bp_np, rng.integers(0, 1 << min(32, 7 * n_limbs), size=rows,
                               dtype=np.uint64).astype(np.uint32)


def check_kernels(torch, gram, device_a2a, db, rng) -> dict:
    """Phase 4: the matrix route's kernels == plain versions on the
    database's light group."""
    dev = torch.device("cuda")
    kt_check = 4 * device_a2a.geom.KT      # a K block other than the default
    Bp_np, _, rows_check, _, tile, S_pad = _first_group(device_a2a, db,
                                                        kt_check)
    C0_np = rng.integers(0, 1 << 32, size=(S_pad, S_pad), dtype=np.uint64)
    C0_np = C0_np.astype(np.uint32)
    out = {"gram_pk_tri": [], "tril_tiles": []}
    for bits, n_limbs in PK_CASES:
        B_np, w_np = _pk_case(rng, Bp_np, bits, n_limbs)
        Bp, w, C0 = gram.from_jax_layout(
            B_np, gram.pk_weight_order(w_np, kt_check), C0_np, dev)
        kw = dict(n_limbs=n_limbs, kt=kt_check, tile=tile)
        Ck_case = gram.gram_u32_pk_tri(Bp, w, C0.clone(), **kw)
        Cp = gram.gram_u32_pk_tri_plain(Bp, w, C0.clone(), **kw)
        torch.cuda.synchronize()
        err = _err(torch, Ck_case, Cp)
        _check(torch.equal(Ck_case, Cp) and not torch.equal(Ck_case, C0),
               f"gram_pk_tri differs from its plain version "
               f"({bits}, n_limbs={n_limbs}, max_abs_err={err})")
        if (bits, n_limbs) == PK_CASES[1]:
            Ck = Ck_case               # random cells for tril_tiles
        Ct = C0.clone()
        ms = _cuda_ms(torch, lambda: gram.gram_u32_pk_tri(Bp, w, Ct, **kw), 5)
        plain_ms = _cuda_ms(
            torch, lambda: gram.gram_u32_pk_tri_plain(Bp, w, Ct, **kw), 2)
        nt = S_pad // tile
        tri = (nt + 1) / (2 * nt)
        ops = 2.0 * rows_check * S_pad * S_pad * tri * n_limbs
        out["gram_pk_tri"].append(dict(
            bits=bits, n_limbs=n_limbs, rows=rows_check, S_pad=S_pad,
            kt=kt_check, tile=tile, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            tops=ops / ms / 1e9, ops=ops,
            bytes=rows_check * (S_pad // 8 + 4) + 8 * S_pad * S_pad * tri))
        del Bp, w, C0, Cp, Ct, Ck_case
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
            gb_per_s=moved / ms / 1e6, ops=0.0, bytes=moved))
    return out


def check_stripe_kernels(torch, gram, device_a2a, db, rng) -> dict:
    """Phase 8: the streamed route's kernels == plain versions at its
    shapes: the default stripe of the large database, its first light
    group, a stripe other than the first.  Also returns the two stripes
    (random cells; the group's real counts) for phase 19."""
    dev = torch.device("cuda")
    T = gram.PULL_TILE
    kt_check = 4 * device_a2a.geom.KT      # a K block other than the default
    Bp_np, w_db, rows_check, kt, tile, S_pad = _first_group(device_a2a, db,
                                                            kt_check)
    R = max(tile, device_a2a.STRIPE_BYTES // (S_pad * 4) // tile * tile)
    rt0 = (S_pad - R) // tile // 2                     # a middle stripe
    out = {"gram_pk_rows": [], "cast_rows": [], "filter_colsum": [],
           "gather_tiles": []}

    C0_np = rng.integers(0, 1 << 32, size=(R, S_pad), dtype=np.uint64)
    C0_np = C0_np.astype(np.uint32)
    for bits, n_limbs in PK_CASES:
        B_np, w_np = _pk_case(rng, Bp_np, bits, n_limbs)
        Bp, w, C0 = gram.from_jax_layout(
            B_np, gram.pk_weight_order(w_np, kt_check), C0_np, dev)
        del B_np
        kw = dict(n_limbs=n_limbs, kt=kt_check, tile=tile)
        Ck_case = gram.gram_u32_pk_rows(Bp, w, C0.clone(), rt0, **kw)
        Cp = gram.gram_u32_pk_rows_plain(Bp, w, C0.clone(), rt0, **kw)
        torch.cuda.synchronize()
        err = _err(torch, Ck_case, Cp)
        _check(torch.equal(Ck_case, Cp) and not torch.equal(Ck_case, C0),
               f"gram_pk_rows differs from its plain version "
               f"({bits}, n_limbs={n_limbs}, max_abs_err={err})")
        if (bits, n_limbs) == PK_CASES[1]:
            Ck = Ck_case               # random cells for phase 19
        Ct = C0.clone()
        ms = _cuda_ms(torch, lambda: gram.gram_u32_pk_rows(Bp, w, Ct, rt0,
                                                           **kw), 3)
        plain_ms = _cuda_ms(torch, lambda: gram.gram_u32_pk_rows_plain(
            Bp, w, Ct, rt0, **kw), 1)
        ops = 2.0 * rows_check * R * S_pad * n_limbs
        out["gram_pk_rows"].append(dict(
            bits=bits, n_limbs=n_limbs, rows=rows_check, R=R, rt0=rt0,
            S_pad=S_pad, kt=kt_check, tile=tile, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, tops=ops / ms / 1e9, ops=ops,
            bytes=rows_check * (S_pad // 8 + 4) + 8 * R * S_pad))
        del Bp, w, C0, Cp, Ct, Ck_case

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
        # the library call: one PyTorch cast, for the same low 16 bits
        library_ms = _cuda_ms(torch, lambda: C.to(torch.int16), 50)
        out["cast_rows"].append(dict(
            stripe=name, shape=f"{R}x{S_pad}", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms,
            library_equal=torch.equal(C.to(torch.int16), ck),
            gb_per_s=6 * C.numel() / ms / 1e6, ops=0.0,
            bytes=6 * C.numel()))
    # kernel and library call in turns, which goes first alternating:
    # whether the kernel is slower than the cast beyond the runs' spread
    kern, lib = [], []
    for r in range(CAST_ROUNDS):
        pair = ((kern, lambda: gram.cast_rows(Cr)),
                (lib, lambda: Cr.to(torch.int16)))
        for times, fn in pair[::1 if r % 2 == 0 else -1]:
            times.append(_cuda_ms(torch, fn, 20))
    out["cast_rows"][1].update(
        rounds=CAST_ROUNDS, kernel_median_ms=float(np.median(kern)),
        library_median_ms=float(np.median(lib)),
        kernel_spread_ms=float(np.ptp(kern)),
        library_spread_ms=float(np.ptp(lib)),
        kernel_faster_rounds=int(sum(k < l for k, l in zip(kern, lib))))

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
            max_abs_err=err, ms=ms, plain_ms=plain_ms, ops=0.0,
            bytes=4 * C.numel() + 4 * fk.numel()))

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
            plain_ms=plain_ms, ops=0.0,
            bytes=gk.numel() * (4 + gk.element_size()) + 8 * i_tab.numel()))
    return out, Ck, Cr


def check_bounds_zero(torch, gram, C_random, C_counts) -> list:
    """Phase 19: bounds_zero_rows == plain on the streamed route's stripe,
    uint16 and uint32 output: the CLI's lo = 1 and a selective window on
    the group's counts, a window across 2^31 on random cells.  The first
    case (counts, lo = 1, uint16) is the route's own."""
    top = int(_u32(torch, C_counts).max())
    out = []
    for name, C, lo, hi in (("lo=1", C_counts, 1, 0xFFFFFFFF),
                            ("selective", C_counts, top * 9 // 10, 0xFFFFFFFF),
                            ("across 2^31", C_random, 1 << 30, 3 << 30)):
        b = gram.bias_bounds(lo, hi)
        for dtype in (torch.int16, torch.int32):
            zk = gram.bounds_zero_rows(C, b, dtype)
            zp = gram.bounds_zero_rows_plain(C, b, dtype)
            torch.cuda.synchronize()
            mask = 0xFFFF if dtype == torch.int16 else 0xFFFFFFFF
            err = int(((zk.to(torch.int64) & mask)
                       - (zp.to(torch.int64) & mask)).abs().max())
            kept = int(torch.count_nonzero(zk))
            _check(torch.equal(zk, zp), f"bounds_zero_rows differs from its "
                   f"plain version ({name}, {dtype}, max_abs_err={err})")
            # every pair of the corpus shares k-mers: lo = 1 keeps them all
            _check(0 < kept and (kept < C.numel() or lo == 1),
                   f"bounds_zero_rows ({name}, {dtype}) kept {kept} of "
                   f"{C.numel()} cells")
            del zk, zp
            ms = _cuda_ms(torch, lambda: gram.bounds_zero_rows(C, b, dtype), 50)
            plain_ms = _cuda_ms(
                torch, lambda: gram.bounds_zero_rows_plain(C, b, dtype), 10)
            moved = C.numel() * (4 + (2 if dtype == torch.int16 else 4))
            out.append(dict(
                bounds=name, lo=lo, hi=hi,
                dtype="uint16" if dtype == torch.int16 else "uint32",
                shape=f"{C.shape[0]}x{C.shape[1]}", kept=kept,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                gb_per_s=moved / ms / 1e6, ops=0.0, bytes=moved))
    return out


def _int_mm_ms(torch, rng, q: int, B) -> float:
    """torch._int_mm of random int8 [q, P] by B [P, S]: the query
    contraction's yardstick (signed, one limb: not the same function)."""
    A = torch.from_numpy(rng.integers(-128, 128, size=(q, B.shape[0]),
                                      dtype=np.int8)).to(B.device)
    return _cuda_ms(torch, lambda: torch._int_mm(A, B), 10)


def _splits(torch, gram, Q: int, P: int, S: int) -> dict:
    """The planner's k_splits for a query contraction on this card and the
    blocks of its grid."""
    k = gram.matmul_splits(Q, S, P, torch.cuda.get_device_properties(
        0).multi_processor_count)
    return dict(k_splits=k, blocks=(Q // 128) * (S // 128) * k)


def check_query_kernels(torch, gram, intersect, db, queries, rng) -> list:
    """Phase 11: matmul_u32_acc == plain at new2all's shapes: Q_pad and
    S_pad of the first flush and the first m2a_prepare chunk's B, with H
    over every uint8 byte and uint32 H of 4 limbs at 2^31 and above; then
    Q_pad 128 (the 76-query flush, a mesh slot), whose grid is split.
    torch._int_mm of int8 operands of each shape is the yardstick."""
    dev = torch.device("cuda")
    H_all, B_all, route_limbs = intersect.m2a_prepare(db, queries)
    n_chunks, Q_pad, P_pad = H_all.shape
    S_pad = B_all.shape[2]
    B = torch.from_numpy(B_all[0]).to(dev)
    del H_all, B_all
    library_ms = {q: _int_mm_ms(torch, rng, q, B) for q in (Q_pad, 128)}
    out = []
    for h_type, n_limbs, Q in (("uint8", 1, Q_pad), ("uint32", 4, Q_pad),
                               ("uint8", 1, 128)):
        if n_limbs == 1:
            H = rng.integers(0, 256, size=(Q, P_pad), dtype=np.uint8)
            H[:, :256] = np.arange(256, dtype=np.uint8)    # every byte
        else:
            H = rng.integers(1 << 31, 1 << 32, size=(Q, P_pad),
                             dtype=np.uint64).astype(np.uint32).view(np.int32)
        H = torch.from_numpy(H).to(dev)
        C0 = torch.from_numpy(rng.integers(0, 1 << 32, size=(Q, S_pad),
                                           dtype=np.uint64).astype(np.uint32)
                              .view(np.int32)).to(dev)
        Ck = gram.matmul_u32_acc(H, B, C0.clone(), n_limbs=n_limbs)
        Cp = gram.matmul_u32_acc_plain(H, B, C0.clone(), n_limbs=n_limbs)
        torch.cuda.synchronize()
        err = _err(torch, Ck, Cp)
        _check(torch.equal(Ck, Cp) and not torch.equal(Ck, C0),
               f"matmul_u32_acc differs from its plain version "
               f"({h_type} H, Q_pad {Q}, max_abs_err={err})")
        Ct = C0.clone()
        ms = _cuda_ms(torch, lambda: gram.matmul_u32_acc(
            H, B, Ct, n_limbs=n_limbs), 10)
        plain_ms = _cuda_ms(torch, lambda: gram.matmul_u32_acc_plain(
            H, B, Ct, n_limbs=n_limbs), 2)
        ops = 2.0 * Q * P_pad * S_pad * n_limbs
        out.append(dict(H=h_type, n_limbs=n_limbs, Q_pad=Q, P_pad=P_pad,
                        S_pad=S_pad, **_splits(torch, gram, Q, P_pad, S_pad),
                        chunks=n_chunks, route_limbs=route_limbs,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms[Q], library=INT_MM,
                        tops=ops / ms / 1e9, ops=ops,
                        bytes=Q * P_pad * H.element_size()
                        + P_pad * S_pad + 8 * Q * S_pad))
        del H, C0, Ck, Cp, Ct
    return out


def check_cross_kernels(torch, gram, device_a2a, db, rng) -> list:
    """Phase 11: cross_u32_pk == plain on the database's first light group:
    the parts grid's shape (samples 0..1023 x 1024..2047, weight 1, the
    port's K block), a db2db shape (1,024 x 640, distinct weights up to
    2^15, three limbs, another K block), the db2db shape at two limbs of
    distinct weights, and the grid's shape with every bit set and both
    limbs 127."""
    dev = torch.device("cuda")
    kt_check = 4 * device_a2a.geom.KT
    Bp_np, _, rows, _, _, _ = _first_group(device_a2a, db, kt_check)

    def cols(a, b):
        return torch.from_numpy(np.ascontiguousarray(Bp_np[:, a:b])).to(dev)

    part = min(PART_SIZE, Bp_np.shape[1] // 4)      # 1,024 at S_pad 4096
    d2d = max(128, part * 5 // 8 // 128 * 128)      # 640
    Up = cols(0, part)
    w_d2d = rng.integers(1, 1 << 15, size=rows, dtype=np.uint64)
    _check(int(w_d2d.max()) >= 1 << 14, "db2db weights below 2^14")
    w_2 = rng.integers(1, 1 << 14, size=rows, dtype=np.uint64)
    ones = torch.full((rows // 8, part), 255, dtype=torch.uint8, device=dev)
    out = []
    for shape, Up, Vp, w_np, n_limbs, kt in (
            ("grid", Up, cols(part, 2 * part), np.ones(rows, np.uint32), 1,
             device_a2a.geom.KT),
            ("d2d", Up, cols(2 * part, 2 * part + d2d),
             w_d2d.astype(np.uint32), 3, kt_check),
            ("d2d 2 limbs", Up, cols(2 * part, 2 * part + d2d),
             w_2.astype(np.uint32), 2, kt_check),
            ("ones", ones, ones, np.full(rows, (1 << 14) - 1, np.uint32), 2,
             device_a2a.geom.KT)):
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
                        plain_ms=plain_ms, tops=ops / ms / 1e9, ops=ops,
                        bytes=rows * ((S1 + S2) // 8 + 4) + 8 * S1 * S2))
    return out


def new2all_phases(torch, cli, gram, intersect, workdir, db_path, paths,
                   say) -> dict:
    """Phases 12 and 13: new2all through the CLI on the device and host
    tiers, dense and sparse, and one2all of one genome.  The query list
    and the host tier's dense CSV stay for phase 18 (runs["files"])."""
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
    for key, path in csvs.items():
        if key != ("0", "dense"):
            os.remove(path)
    os.remove(o2a)
    say(f"[13 oracle] one2all of genome {pick} == its new2all row "
        f"({len([v for v in want if v])} fields); "
        f"{time.perf_counter() - t:.2f} s")
    runs["files"] = dict(queries=query_list, host_csv=csvs["0", "dense"],
                         flushes=flushes)
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
#: phase 15: the parts that all2all-parts' host tiers are run on
HOST_PARTS = 2


def parts_phases(torch, cli, gram, fused, workdir, paths, db_path,
                 say) -> dict:
    """Phases 14 and 15: all2all-parts over the corpus in parts, on the
    device grid, the streamed grid and per cell, against its own host tiers
    on the first HOST_PARTS parts and against all2all-sp of the whole
    database (db_path) on the host tier."""
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
    lists = {}
    for n_parts in (len(part_dbs), HOST_PARTS):
        lists[n_parts] = os.path.join(workdir, f"parts{n_parts}.list")
        with open(lists[n_parts], "w") as f:
            f.write("\n".join(part_dbs[:n_parts]) + "\n")
    parts_list = lists[len(part_dbs)]
    say(f"[14 parts build] {time.perf_counter() - t:.2f} s; "
        f"{len(part_dbs)} parts of {PART_SIZE} samples")

    def run_tier(phase, name, n_parts) -> tuple:
        """all2all-parts over the first n_parts parts on the tier `name`:
        (CSV path, seconds, launches); fails unless the tier's kernels and
        no other were launched."""
        for k in _PARTS_KNOBS:
            os.environ.pop(k, None)
        os.environ.update(_PARTS_TIERS[name])
        out = os.path.join(workdir, f"parts{n_parts}-{name[0]}.csv")
        fused.last_stats.clear()
        _reset_launches(gram)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rc = cli(["all2all-parts", lists[n_parts], out])
        wall = time.perf_counter() - t
        n = _launches(gram)
        for k in _PARTS_KNOBS:
            os.environ.pop(k, None)
        _check(rc == 0, f"all2all-parts ({name}, {n_parts} parts) exited {rc}")
        want = set() if name == "host" else {"cross_u32_pk"} | (
            {"cast_rows"} if "grid" in name else {"gram_pk_tri", "tril_tiles"})
        _check({k for k, v in n.items() if v} == want,
               f"all2all-parts ({name}, {n_parts} parts) launched {n}, "
               f"expected {want}")
        shown = {k: n[k] for k in ("cross_u32_pk", "cast_rows", "gram_pk_tri",
                                   "tril_tiles")}
        say(f"[{phase} all2all-parts {name}, {n_parts} parts] {wall:.3f} s "
            f"CLI call, launches {shown}, peak device memory "
            f"{torch.cuda.max_memory_allocated() >> 20} MiB, CSV "
            f"{os.path.getsize(out)} bytes"
            + ("; grid " + _fmt(fused.last_stats) if fused.last_stats
               else ""))
        return out, wall, n

    device_tiers = [name for name in _PARTS_TIERS if name != "host"]
    csvs, runs = {}, {}
    for name in device_tiers:
        csvs[name], wall, n = run_tier(14, name, len(part_dbs))
        runs[name] = dict(wall=wall, launches=n)

    # 15: all2all-parts' own host tiers (the host diagonal and the per-cell
    # host db2db), on fewer parts: a cell takes them ~20 s
    want_csv, host_wall, _ = run_tier(15, "host", HOST_PARTS)
    for name in device_tiers:
        got_csv, wall, _ = run_tier(15, name, HOST_PARTS)
        _check(filecmp.cmp(got_csv, want_csv, shallow=False),
               f"all2all-parts ({name}, {HOST_PARTS} parts) CSV differs from "
               f"the host tiers'")
        say(f"[15 oracle] all2all-parts ({name}) CSV == host tiers' CSV on "
            f"{HOST_PARTS} parts; {wall:.3f} s vs host {host_wall:.3f} s")
        os.remove(got_csv)
    os.remove(want_csv)
    os.remove(lists[HOST_PARTS])
    runs["host"] = dict(wall=host_wall, n_parts=HOST_PARTS)

    # the whole corpus: all2all-sp of the whole database on the host tier
    # writes the rows that all2all-parts writes over every part
    host_csv = os.path.join(workdir, "sp-host.csv")
    _set_route(device="0")
    _reset_launches(gram)
    t = time.perf_counter()
    _check(cli(["all2all-sp", db_path, host_csv]) == 0,
           "all2all-sp on the host tier failed")
    sp_wall = time.perf_counter() - t
    _check(not any(_launches(gram).values()),
           f"the host tier of all2all-sp ran the device: {_launches(gram)}")
    _set_route()
    for name in device_tiers:
        _check(filecmp.cmp(csvs[name], host_csv, shallow=False),
               f"all2all-parts ({name}) CSV differs from the host tier's "
               f"all2all-sp of the whole database")
        say(f"[15 oracle] all2all-parts ({name}) CSV over {len(part_dbs)} "
            f"parts == the host tier's all2all-sp CSV of the whole database; "
            f"{runs[name]['wall']:.3f} s vs {sp_wall:.3f} s")
        os.remove(csvs[name])
    # the parts and the host tier's CSV stay for phase 21
    runs["files"] = dict(parts_list=parts_list, part_dbs=part_dbs,
                         host_csv=host_csv)
    return runs


def _distinct_weights(rng, n: int) -> np.ndarray:
    """n distinct random uint32 weights among them 255, 2^8, 2^31 and
    2^32 - 1."""
    while True:
        w = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
        w[:4] = (255, 256, 1 << 31, (1 << 32) - 1)
        if np.unique(w).size == n:
            return w.astype(np.uint32)


def check_scan_kernels(torch, gram, intersect, db, rng) -> dict:
    """Phase 16: the scan tier's kernels == plain versions at its shapes on
    the first chunk of _scan_chunks: gram_u32_tri and gram_u32 at the
    database's limb count (the bits above it dropped) and at 4 limbs, and
    on all ones with every weight 2^32 - 1 at 4 limbs, with torch._int_mm
    of the chunk's operand as their library_ms; matmul_u32 at Q_pad 512
    with uint8 H over every byte and uint32 H of 4 limbs at 2^31 and
    above."""
    dev = torch.device("cuda")
    bounds, P_pad, S_pad = intersect._scan_chunks(db)
    B_np = np.zeros((P_pad, S_pad), np.int8)
    intersect._fill_incidence(*intersect._chunk_cells(
        db, db.element_pattern_ids(), bounds[0], bounds[1]), B_np)
    B = torch.from_numpy(B_np).to(dev)
    del B_np
    route_limbs = max(1, (int(db.pattern_num_kmers.max()).bit_length() + 7)
                      // 8)
    w = torch.from_numpy(_distinct_weights(rng, P_pad).view(np.int32)).to(dev)
    nt = S_pad // gram.BLOCK
    shape = dict(P_pad=P_pad, S_pad=S_pad, chunks=len(bounds) - 1,
                 route_limbs=route_limbs)
    # the yardstick: cuBLAS's int8 square of the same operand (unweighted,
    # one limb; the rows of B.T made contiguous once, outside the time)
    Bt = B.T.contiguous()
    library_ms = _cuda_ms(torch, lambda: torch._int_mm(Bt, B), 5)
    del Bt
    ones = torch.ones_like(B), torch.full_like(w, -1)
    out = {"gram_u32_tri": [], "gram_u32": [], "matmul_u32": []}
    cases = [("random", n) for n in sorted({route_limbs, 4})] \
        + [("ones", 4)]
    for operands, n_limbs in cases:
        Bc, wc = (B, w) if operands == "random" else ones
        for name, frac in (("gram_u32_tri", (nt + 1) / (2 * nt)),
                           ("gram_u32", 1.0)):
            kern, plain = getattr(gram, name), getattr(gram, name + "_plain")
            Ck = kern(Bc, wc, n_limbs=n_limbs)
            Cp = plain(Bc, wc, n_limbs=n_limbs)
            torch.cuda.synchronize()
            err = _err(torch, Ck, Cp)
            _check(torch.equal(Ck, Cp) and bool(Ck.any()),
                   f"{name} differs from its plain version ({operands}, "
                   f"n_limbs={n_limbs}, max_abs_err={err})")
            del Ck, Cp
            ms = _cuda_ms(torch, lambda: kern(Bc, wc, n_limbs=n_limbs), 5)
            plain_ms = _cuda_ms(torch, lambda: plain(Bc, wc,
                                                     n_limbs=n_limbs), 1)
            ops = 2.0 * P_pad * S_pad * S_pad * frac * n_limbs
            out[name].append(dict(
                operands=operands, n_limbs=n_limbs, **shape,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, tops=ops / ms / 1e9, ops=ops,
                bytes=P_pad * (S_pad + 4) + 4 * S_pad * S_pad))
    del ones
    mm_library_ms = _int_mm_ms(torch, rng, SCAN_Q_PAD, B)
    for h_type, n_limbs in (("uint8", 1), ("uint32", 4)):
        if n_limbs == 1:
            H = rng.integers(0, 256, size=(SCAN_Q_PAD, P_pad), dtype=np.uint8)
            H[:, :256] = np.arange(256, dtype=np.uint8)    # every byte
        else:
            H = rng.integers(1 << 31, 1 << 32, size=(SCAN_Q_PAD, P_pad),
                             dtype=np.uint64).astype(np.uint32).view(np.int32)
        H = torch.from_numpy(H).to(dev)
        Ck = gram.matmul_u32(H, B, n_limbs=n_limbs)
        Cp = gram.matmul_u32_plain(H, B, n_limbs=n_limbs)
        torch.cuda.synchronize()
        err = _err(torch, Ck, Cp)
        _check(torch.equal(Ck, Cp) and bool(Ck.any()),
               f"matmul_u32 differs from its plain version ({h_type} H, "
               f"max_abs_err={err})")
        del Ck, Cp
        ms = _cuda_ms(torch, lambda: gram.matmul_u32(H, B, n_limbs=n_limbs),
                      10)
        plain_ms = _cuda_ms(torch, lambda: gram.matmul_u32_plain(
            H, B, n_limbs=n_limbs), 2)
        ops = 2.0 * SCAN_Q_PAD * P_pad * S_pad * n_limbs
        out["matmul_u32"].append(dict(
            H=h_type, n_limbs=n_limbs, Q_pad=SCAN_Q_PAD, **shape,
            **_splits(torch, gram, SCAN_Q_PAD, P_pad, S_pad),
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=mm_library_ms, library=INT_MM, tops=ops / ms / 1e9,
            ops=ops, bytes=SCAN_Q_PAD * P_pad * H.element_size()
            + P_pad * S_pad + 4 * SCAN_Q_PAD * S_pad))
        del H
    return out


def _only(n: dict, name: str) -> bool:
    """Whether `name` is the one kernel launched in n."""
    return n[name] > 0 and not any(v for k, v in n.items() if k != name)


def scan_phases(torch, cli, gram, intersect, db, db_path, C_host, host_csv,
                n2a_files, workdir, say) -> dict:
    """Phases 17 and 18: all2all and new2all on the scan tier through the
    CLI, and the scan's C of both grids, against the host tiers."""
    runs = {}
    os.environ["KMERDB_A2A_PALLAS"] = "0"
    _set_route(device="1")
    scan_csv = os.path.join(workdir, "scan.csv")
    intersect.scan_stats.clear()
    _reset_launches(gram)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    rc = cli(["all2all", db_path, scan_csv])
    wall = time.perf_counter() - t
    n, st = _launches(gram), dict(intersect.scan_stats)
    _check(rc == 0, f"all2all on the scan tier exited {rc}")
    _check(_only(n, "gram_u32_tri") and n["gram_u32_tri"] == st["chunks"],
           f"all2all's scan tier launched {n}, expected one gram_u32_tri a "
           f"chunk ({st.get('chunks')})")
    runs["tri"] = dict(wall=wall, launches=n, stats=st)
    busy = st.get("gram_s", 0.0)
    say(f"[17 all2all scan] {wall:.3f} s CLI call (kernels busy {busy:.4f} s "
        f"= {100 * busy / wall:.1f}%), launches "
        f"{ {k: v for k, v in n.items() if v} }, peak device memory "
        f"{torch.cuda.max_memory_allocated() >> 20} MiB; scan_stats "
        + _fmt(st))
    _check(filecmp.cmp(scan_csv, host_csv, shallow=False),
           "the scan tier's all2all CSV differs from the host tier's")
    say(f"[17 oracle] all2all scan CSV == host tier CSV "
        f"({os.path.getsize(scan_csv)} bytes)")
    os.remove(scan_csv)
    for triangle, name in ((True, "gram_u32_tri"), (False, "gram_u32")):
        intersect.scan_stats.clear()
        _reset_launches(gram)
        C = intersect._a2a_scan(db, triangle=triangle)
        n, st = _launches(gram), dict(intersect.scan_stats)
        _check(_only(n, name) and n[name] == st["chunks"],
               f"_a2a_scan(triangle={triangle}) launched {n}")
        n_diff = int(np.count_nonzero(C != C_host))
        _check(n_diff == 0, f"the scan tier's C ({name}) differs from the "
                            f"host C++ tier in {n_diff} cells")
        runs["full" if name == "gram_u32" else "tri_direct"] = dict(
            launches=n, stats=st)
        say(f"[17 oracle] scan C ({name}, {n[name]} launches) == host C++ "
            f"tier C; " + _fmt(st))
        del C

    os.environ["KMERDB_N2A_DEVICE"] = "1"
    n2a_csv = os.path.join(workdir, "n2a-scan.csv")
    intersect.scan_stats.clear()
    intersect.n2a_stats.clear()
    _reset_launches(gram)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    rc = cli(["new2all", db_path, n2a_files["queries"], n2a_csv])
    wall = time.perf_counter() - t
    n, st = _launches(gram), dict(intersect.scan_stats)
    _check(rc == 0, f"new2all on the scan tier exited {rc}")
    _check(_only(n, "matmul_u32") and n["matmul_u32"] == st["chunks"]
           and st["calls"] == n2a_files["flushes"],
           f"new2all's scan tier launched {n}, scan_stats {st}")
    runs["n2a"] = dict(wall=wall, launches=n, stats=st)
    busy = st.get("matmul_s", 0.0)
    say(f"[18 new2all scan] {wall:.3f} s CLI call ({N_QUERIES} queries x "
        f"{N_SAMPLES} samples; kernels busy {busy:.4f} s = "
        f"{100 * busy / wall:.1f}%), launches "
        f"{ {k: v for k, v in n.items() if v} }, peak device memory "
        f"{torch.cuda.max_memory_allocated() >> 20} MiB; scan_stats "
        + _fmt(st) + "; n2a_stats " + _fmt(intersect.n2a_stats))
    _check(filecmp.cmp(n2a_csv, n2a_files["host_csv"], shallow=False),
           "the scan tier's new2all CSV differs from the host tier's")
    say(f"[18 oracle] new2all scan CSV == host tier CSV "
        f"({os.path.getsize(n2a_csv)} bytes)")
    os.remove(n2a_csv)      # the queries and the host CSV stay for phase 21
    for var in ("KMERDB_A2A_PALLAS", "KMERDB_N2A_DEVICE"):
        os.environ.pop(var)
    _set_route()
    return runs


def mesh_phases(torch, cli, gram, intersect, workdir, say, *, big_path,
                streamed_csvs, db_path, host_csv, n2a_files,
                parts_files) -> dict:
    """Phases 20 and 21: the CLI under ``-mesh`` on a mesh of MESH_SLOTS
    slots of the one card.  Every call is made twice; both CSVs must equal
    the reference's bytes (a single-card or host tier CSV of an earlier
    phase, or the host tier's of the same command), and the launch
    counters, reset before each call, must show the route's kernels and no
    other.  Removes the earlier phases' files it was given."""
    from kmerdb_tpu_torch import _torchinit
    from kmerdb_tpu_torch.parallel import sharded

    real_devices = _torchinit.devices
    _torchinit.devices = lambda: [torch.device("cuda", 0)] * MESH_SLOTS
    _set_route()
    say(f"[20 mesh] mesh of {MESH_SLOTS} slots on 1 card (cuda:0), a CUDA "
        f"stream a slot; {torch.cuda.device_count()} card(s) visible")
    runs = {}

    def twice(key, argv, want_csv, check):
        """The call `argv` + [out] twice under the mesh; check(n, stats)
        names what is wrong with the launches, or returns None."""
        walls = []
        for rep in (1, 2):
            out = os.path.join(workdir, f"mesh-{rep}.csv")
            for st in (sharded.last_stats, sharded.plan_stats,
                       intersect.scan_stats):
                st.clear()
            _reset_launches(gram)
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            rc = cli([argv[0], "-mesh", str(MESH_SLOTS), *argv[1:], out])
            walls.append(time.perf_counter() - t)
            _check(rc == 0, f"{key}: {argv[0]} -mesh {MESH_SLOTS} exited {rc}")
            n = _launches(gram)
            stats = {**sharded.last_stats, **intersect.scan_stats,
                     **sharded.plan_stats}
            wrong = check(n, stats)
            _check(wrong is None, f"{key}: {wrong}; launches {n}, {stats}")
            _check(filecmp.cmp(out, want_csv, shallow=False),
                   f"{key}: run {rep} under the mesh differs from "
                   f"{os.path.basename(want_csv)}")
            size = os.path.getsize(out)
            os.remove(out)
        runs[key] = dict(walls=walls, launches=n, stats=stats,
                         peak_mib=torch.cuda.max_memory_allocated() >> 20)
        return walls, n, stats, size

    def only(n, *names):
        return all((v > 0) == (k in names) for k, v in n.items())

    # 20: the streamed route over the mesh at 20,480 samples
    for form, opts, tail in (
            ("dense", [], "cast_rows"),
            ("sparse", ["-sparse", "-min", f"num-kmers:{SPARSE_MIN}"],
             "bounds_zero_rows")):
        def check(n, st, tail=tail):
            per_round = st.get("rounds", 0) * MESH_SLOTS
            if not only(n, "gram_pk_rows", tail):
                return "the wrong kernels ran"
            if n["gram_pk_rows"] != per_round * st["groups"] \
                    or n[tail] != per_round:
                return (f"expected {per_round * st['groups']} gram_pk_rows "
                        f"and {per_round} {tail}")
            return None

        walls, n, st, size = twice(("streamed", form),
                                   ["all2all", *opts, big_path],
                                   streamed_csvs[form], check)
        kernels_s = sum(st.get(k, 0.0) for k in ("gram_s", "cast_s",
                                                 "filter_s"))
        say(f"[20 all2all -mesh {MESH_SLOTS} {form}] {walls[0]:.3f} s and "
            f"{walls[1]:.3f} s CLI calls, both CSVs == the single-card "
            f"streamed route's ({size} bytes); launches "
            f"{ {k: v for k, v in n.items() if v} } in {st['rounds']} rounds "
            f"of {MESH_SLOTS} stripes x {st['groups']} groups; rounds on the "
            f"card {st['device_s']:.4f} s = "
            f"{100 * st['device_s'] / walls[1]:.1f}% of the call, kernel "
            f"spans summed over the slots {kernels_s:.4f} s (overlap "
            f"{kernels_s / st['device_s']:.2f}x); peak device memory "
            f"{runs['streamed', form]['peak_mib']} MiB; " + _fmt(st))
        os.remove(streamed_csvs[form])

    # 21: the matrix routes over the mesh at 4,096 samples
    # the launches each call's own plan comes to, exactly
    def scan_only(n, st):
        if not only(n, "gram_u32_tri") or st["calls"] != 1 \
                or n["gram_u32_tri"] != st["chunks"]:
            return ("expected one scan with one gram_u32_tri a chunk of a "
                    "slot's patterns and nothing else")
        return None

    def n2a_only(n, st):
        if not only(n, "matmul_u32_acc") \
                or st["m2a_calls"] != n2a_files["flushes"] \
                or n["matmul_u32_acc"] != st["m2a_chunks"] * MESH_SLOTS:
            return (f"expected {n2a_files['flushes']} flushes with "
                    f"matmul_u32_acc once a chunk and slot and nothing else")
        return None

    n_parts = len(parts_files["part_dbs"])

    def parts_only(n, st):
        if not only(n, "gram_u32_tri", "cross_u32_pk") \
                or st["calls"] != n_parts \
                or n["gram_u32_tri"] != st["chunks"] \
                or st["d2d_calls"] != n_parts * (n_parts - 1) // 2 \
                or st["d2d_shares"] != st["d2d_calls"] * MESH_SLOTS \
                or n["cross_u32_pk"] != st["d2d_launches"]:
            return (f"expected {n_parts} diagonal scans with one gram_u32_tri "
                    f"a chunk, {n_parts * (n_parts - 1) // 2} cells of "
                    f"{MESH_SLOTS} pair shares with one cross_u32_pk a chunk "
                    f"of pairs, and nothing else")
        return None

    sampled = ["all2all-sp", "-sample-rows", "3", parts_files["part_dbs"][0]]
    sampled_csv = os.path.join(workdir, "sampled-host.csv")
    _set_route(device="0")
    t = time.perf_counter()
    _check(cli([*sampled, sampled_csv]) == 0,
           "all2all-sp -sample-rows on the host tier failed")
    say(f"[21 reference] all2all-sp -sample-rows of {PART_SIZE} samples on "
        f"the host tier: {time.perf_counter() - t:.3f} s")
    _set_route()
    for key, argv, want, check in (
            ("all2all", ["all2all", db_path], host_csv, scan_only),
            ("all2all-sp", ["all2all-sp", db_path], parts_files["host_csv"],
             scan_only),
            ("all2all-sp -sample-rows", sampled, sampled_csv, scan_only),
            ("new2all", ["new2all", db_path, n2a_files["queries"]],
             n2a_files["host_csv"], n2a_only),
            ("all2all-parts", ["all2all-parts", parts_files["parts_list"]],
             parts_files["host_csv"], parts_only)):
        walls, n, st, size = twice(key, argv, want, check)
        say(f"[21 {key} -mesh {MESH_SLOTS}] {walls[0]:.3f} s and "
            f"{walls[1]:.3f} s CLI calls, both CSVs == the host tier's "
            f"({size} bytes); launches "
            f"{ {k: v for k, v in n.items() if v} }, peak device memory "
            f"{runs[key]['peak_mib']} MiB"
            + ("; stats " + _fmt(st) if st else ""))

    for path in (sampled_csv, host_csv, n2a_files["queries"],
                 n2a_files["host_csv"], parts_files["parts_list"],
                 parts_files["host_csv"], *parts_files["part_dbs"]):
        os.remove(path)
    _torchinit.devices = real_devices
    return runs


#: phase 22: the fused calls (label, mode, knobs) on the scale corpus's list
_FUSED_CALLS = (
    ("a default", "all2all", {}),
    ("b raw groups", "all2all", {"KMERDB_FUSED_DEVICE": "1",
                                 "KMERDB_FUSED_DEDUP": "0"}),
    ("c patterns", "all2all", {"KMERDB_FUSED_DEVICE": "1",
                               "KMERDB_FUSED_DEDUP": "1"}),
    ("d all2all-sp", "all2all-sp", {}))


def fused_phases(torch, cli, gram, fused, workdir, say, *, scale_list,
                 host_csv, sp_csv, matrix_launches) -> dict:
    """Phase 22: ``all2all -from-fasta`` and ``all2all-sp -from-fasta`` on
    the scale corpus's list (no database): each call's launches equal its
    own plan (fused.last_stats), (c)'s those of phase 5 (the same
    patterns), and each CSV the host tier's of the database form (phase
    6's all2all, phase 15's all2all-sp)."""
    runs = {}
    for key, mode, env in _FUSED_CALLS:
        for var in ("KMERDB_FUSED_DEVICE", "KMERDB_FUSED_DEDUP"):
            os.environ.pop(var, None)
        os.environ.update(env)
        out = os.path.join(workdir, "fused.csv")
        want = sp_csv if mode == "all2all-sp" else host_csv
        fused.last_stats.clear()
        _reset_launches(gram)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rc = cli([mode, "-from-fasta", "-k", "18", scale_list, out])
        wall = time.perf_counter() - t
        n = _launches(gram)
        st = dict(fused.last_stats)
        for var in env:
            os.environ.pop(var)
        _check(rc == 0, f"{mode} -from-fasta ({key}) exited {rc}")
        _check(st.get("tier") == "device", f"{mode} -from-fasta ({key}) ran "
                                           f"on the {st.get('tier')} tier")
        plan = st["launches"]
        _check({k: v for k, v in n.items() if v} == plan,
               f"{mode} -from-fasta ({key}) launched {n}, its plan {plan}")
        if key.startswith("b"):
            _check(st["route"] == "raw", f"({key}) took the {st['route']} "
                                         f"route")
        if key.startswith("c"):
            _check(st["route"] == "dedup" and n == matrix_launches,
                   f"({key}) launched {n}, phase 5 {matrix_launches}")
        _check(filecmp.cmp(out, want, shallow=False),
               f"{mode} -from-fasta ({key}) CSV differs from "
               f"{os.path.basename(want)}")
        size = os.path.getsize(out)
        os.remove(out)
        runs[key] = dict(wall=wall, launches=n, stats=st,
                         peak_mib=torch.cuda.max_memory_allocated() >> 20)
        busy = st.get("gram_s", 0.0) + st.get("tril_s", 0.0)
        say(f"[22 {mode} -from-fasta, {key}] {wall:.3f} s CLI call "
            f"(kernels busy {busy:.4f} s = {100 * busy / wall:.1f}%), route "
            f"{st['route']}, launches {plan} == plan, peak device memory "
            f"{runs[key]['peak_mib']} MiB, CSV == {os.path.basename(want)} "
            f"({size} bytes); " + _fmt({k: v for k, v in st.items()
                                        if k != "launches"}))
    return runs


#: phase 23: the sweep's operands at the tool's defaults
SWEEP_S, SWEEP_P, SWEEP_P_UNPACKED, SWEEP_KT, SWEEP_TILE = \
    2048, 1 << 20, 1 << 17, 512, 128
#: the body of tools/kernel_sweep.py that each variant replaces
SWEEP_BODY = {"bf16": 72, "bf16_ns": 72, "int8": 88, "nodot": 104,
              "dotonly": 116, "dotonly_T": 116, "dotonly_s8": 116}


def _sweep_operands(torch, sweep, variant, S, P, rng, dev) -> tuple:
    """(w, Bi, Bj): Bi != Bj, weights over every bit with 127, 128, 255
    and 256 among them (each body masks its own)."""
    if variant in sweep.PACKED:
        Bi, Bj = (torch.from_numpy(rng.integers(0, 256, size=(P // 8, S),
                                                dtype=np.uint8)).to(dev)
                  for _ in range(2))
    else:
        Bi, Bj = (torch.from_numpy(rng.integers(0, 2, size=(P, S),
                                                dtype=np.int8)).to(dev)
                  for _ in range(2))
        if variant == "dotonly_T":
            Bi = Bi.T.contiguous()
        dt = sweep.operand_dtype(variant)
        Bi, Bj = Bi.to(dt), Bj.to(dt)
    w = rng.integers(0, 1 << 32, size=P, dtype=np.uint64).astype(np.uint32)
    w[:4] = (127, 128, 255, 256)
    return torch.from_numpy(w.view(np.int32)).to(dev), Bi, Bj


def _random_c(torch, rng, S, dev):
    return torch.from_numpy(rng.integers(0, 1 << 32, size=(S, S),
                                         dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).to(dev)


def sweep_phases(torch, gram, device_a2a, db, db_path, gram_tri_case, rng,
                 say) -> dict:
    """Phase 23: the kernel sweep (kmerdb_tpu_torch/tools/kernel_sweep.py,
    csrc/gram_sweep.cu).  (a) each variant == its plain version, exactly,
    at S 512, P 8,192 and two geometries; (b) the tool's run_variant of
    each at its defaults, the launch counters reset before and read after,
    then one call against the plain version, timed; (c) sweep_on_db on the
    4,096-sample database at kts 256, 512, 1024 x tiles 128, 256, its
    gram_u32_pk_tri launches those of its chains; (d) the int8 variant at
    phase 4's shape equals gram_u32_pk_tri there and takes its time within
    10%."""
    from kmerdb_tpu_torch.ops import sweep
    from kmerdb_tpu_torch.tools import kernel_sweep
    dev = torch.device("cuda")
    res = {v: dict(errs=[]) for v in sweep.VARIANTS}

    t = time.perf_counter()
    for kt, tile in ((512, 128), (1024, 256)):
        for v in sweep.VARIANTS:
            w, Bi, Bj = _sweep_operands(torch, sweep, v, 512, 8192, rng, dev)
            C0 = _random_c(torch, rng, 512, dev)
            Ck = sweep.KERNELS[v](w, Bi, Bj, C0.clone(), kt=kt, tile=tile)
            Cp = sweep.plain(v, w, Bi, Bj, C0.clone(), kt=kt, tile=tile)
            torch.cuda.synchronize()
            err = _err(torch, Ck, Cp)
            _check(torch.equal(Ck, Cp) and not torch.equal(Ck, C0),
                   f"sweep {v} differs from its plain version (kt {kt}, "
                   f"tile {tile}, max_abs_err={err})")
            res[v]["errs"].append(err)
    say(f"[23a sweep] {time.perf_counter() - t:.2f} s; all "
        f"{len(sweep.VARIANTS)} variants == plain at S 512, P 8192, (kt, "
        f"tile) (512, 128) and (1024, 256), Bi != Bj, C seeded non-zero")

    for v in sweep.VARIANTS:
        t = time.perf_counter()
        P = SWEEP_P if v in sweep.PACKED else SWEEP_P_UNPACKED
        ops = kernel_sweep.operands(v, SWEEP_S, P, dev)
        kern = sweep.KERNELS[v]
        kern.launches = 0
        rec = kernel_sweep.run_variant(v, SWEEP_S, P, SWEEP_KT, SWEEP_TILE,
                                       n1=1, n2=5, out=None, given=ops)
        launches = kern.launches
        _check(launches == 6, f"sweep {v}: {launches} launches, expected 6")
        C0 = _random_c(torch, rng, SWEEP_S, dev)
        Ck = kern(*ops, C0.clone(), kt=SWEEP_KT, tile=SWEEP_TILE)
        Cp = C0.clone()
        plain_ms = _cuda_ms(torch, lambda: sweep.plain(
            v, *ops, Cp.copy_(C0), kt=SWEEP_KT, tile=SWEEP_TILE), 1)
        err = _err(torch, Ck, Cp)
        _check(torch.equal(Ck, Cp), f"sweep {v} differs from its plain "
                                    f"version at the tool's defaults "
                                    f"(max_abs_err={err})")
        res[v].update(rec, launches=launches, plain_ms=plain_ms)
        res[v]["errs"].append(err)
        del ops, C0, Ck, Cp
        torch.cuda.empty_cache()
        say(f"[23b sweep {v}] {time.perf_counter() - t:.2f} s; S {SWEEP_S}, "
            f"P {P}, kt {SWEEP_KT}, tile {SWEEP_TILE}: "
            f"{rec['per_call_ms']:.4f} ms a call ({rec['tops']:.2f} Tops), "
            f"plain {plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), library "
            + (f"{rec['library_ms']:.4f} ms (torch._int_mm, the full square)"
               if rec["library_ms"] is not None else "none")
            + f", {launches} launches, == plain")

    t = time.perf_counter()
    _reset_launches(gram)
    rows = kernel_sweep.sweep_on_db(db_path, [256, 512, 1024], [128, 256],
                                    out=None)
    n = _launches(gram)
    want = sum(sum(r["kernel_chain_lens"]) * r["groups"] for r in rows)
    _check(_only(n, "gram_pk_tri") and n["gram_pk_tri"] == want,
           f"sweep_on_db launched {n}, its chains {want}")
    _check(not any(os.environ.get(k) for k in kernel_sweep.GEOMETRY_KNOBS),
           "sweep_on_db left a geometry knob set")
    for r in rows:
        say(f"[23c sweep_on_db] kt {r['kt']} tile {r['tile']}: "
            f"{1e3 * r['kernel_s_per_pass']:.4f} ms a pass of {r['groups']} "
            f"groups ({r['benched_rows']} rows), {r['kernel_tops']:.2f} Tops "
            f"= {r['int8_peak_share_pct']}% of the int8 peak")
    say(f"[23c sweep_on_db] {time.perf_counter() - t:.2f} s; {n['gram_pk_tri']}"
        f" gram_u32_pk_tri launches == its chains")

    # (d) the int8 variant is the production body: phase 4's light group
    kt_check = gram_tri_case["kt"]
    Bp_np, _, rows_check, _, tile, S_pad = _first_group(device_a2a, db,
                                                        kt_check)
    Bp = torch.from_numpy(Bp_np).to(dev)
    w = torch.from_numpy(rng.integers(0, 1 << 7, size=rows_check,
                                      dtype=np.uint32).view(np.int32)).to(dev)
    C0 = _random_c(torch, rng, S_pad, dev)
    kw = dict(kt=kt_check, tile=tile)
    Ck = sweep.KERNELS["int8"](w, Bp, Bp, C0.clone(), **kw)
    Cg = gram.gram_u32_pk_tri(Bp, w, C0.clone(), n_limbs=1, **kw)
    torch.cuda.synchronize()
    _check(torch.equal(Ck, Cg), "the int8 variant differs from "
                                "gram_u32_pk_tri at phase 4's shape")
    ms = _cuda_ms(torch, lambda: sweep.KERNELS["int8"](w, Bp, Bp, Ck, **kw),
                  5)
    ratio = ms / gram_tri_case["ms"]
    _check(abs(ratio - 1) <= 0.10,
           f"the int8 variant takes {ms:.4f} ms at phase 4's shape, "
           f"gram_u32_pk_tri {gram_tri_case['ms']:.4f} ms")
    say(f"[23d sweep] int8 at phase 4's shape ({rows_check} rows, S_pad "
        f"{S_pad}, kt {kt_check}, tile {tile}) == gram_u32_pk_tri, "
        f"{ms:.4f} ms against phase 4's {gram_tri_case['ms']:.4f} ms "
        f"(ratio {ratio:.3f})")
    del Bp, w, C0, Ck, Cg
    torch.cuda.empty_cache()
    return {"variants": res, "on_db": rows, "int8_ratio": ratio}


#: the kernels on the int8 tensor cores by their records' names, with a
#: part of their (mangled) names: the packed Gram's (gram_pk.cuh's block)
#: and the unpacked Gram's (gram_u8.cuh's block)
MMA_KERNELS = {"gram_pk_tri": "gram_pk_tri_kernel",
               "gram_pk_rows": "gram_pk_rows_kernel",
               "cross_u32_pk": "cross_pk_kernel",
               "sweep_int8": "sweep_int8_kernel",
               "gram_u32_tri": "gram_u32_kernelILb1E",
               "gram_u32": "gram_u32_kernelILb0E",
               "sweep_dotonly_s8": "sweep_s8_kernel",
               "matmul_u32_acc": "matmul_acc_kernel",
               "matmul_u32": "matmul_acc_kernel"}
#: those of gram_u8.cuh's block, whose shared memory is dynamic
U8_KERNELS = ("gram_u32_tri", "gram_u32", "sweep_dotonly_s8",
              "matmul_u32_acc", "matmul_u32")


def _mma_resources(log: str, u8_smem: int) -> dict:
    """MMA_KERNELS' registers, spill bytes (stores + loads) and shared
    memory by record name, from nvcc's -Xptxas -v output (static shared
    memory; U8_KERNELS add their `u8_smem` dynamic bytes); fails if one is
    missing."""
    out, recs = {}, []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            recs = [r for r, k in MMA_KERNELS.items() if k in m[1]]
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
        regs = re.search(r"Used (\d+) registers", ln)
        for rec in recs:
            if spill:
                out[rec] = dict(spill_bytes=int(spill[1]) + int(spill[2]))
            if rec in out and regs:
                smem = re.search(r"(\d+) bytes smem", ln)
                out[rec].update(registers=int(regs[1]),
                                smem_bytes=(int(smem[1]) if smem else 0)
                                + (u8_smem if rec in U8_KERNELS else 0))
    _check(all(len(out.get(r, {})) == 3 for r in MMA_KERNELS),
           f"ptxas gave no resources for some of {MMA_KERNELS}: {out}")
    return out


def _kernel_fns(gram) -> dict:
    return {"gram_pk_tri": gram.gram_u32_pk_tri,
            "tril_tiles": gram.tril_tiles,
            "gram_pk_rows": gram.gram_u32_pk_rows,
            "cast_rows": gram.cast_rows,
            "filter_colsum": gram.filter_colsum,
            "gather_tiles": gram.gather_tiles,
            "bounds_zero_rows": gram.bounds_zero_rows,
            "matmul_u32_acc": gram.matmul_u32_acc,
            "cross_u32_pk": gram.cross_u32_pk,
            "gram_u32_tri": gram.gram_u32_tri,
            "gram_u32": gram.gram_u32,
            "matmul_u32": gram.matmul_u32}


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

    refuse_jax_imports()
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
    from kmerdb_tpu_torch.io import dbfile
    from kmerdb_tpu_torch.ops import _cuda, device_a2a, gram, intersect
    from kmerdb_tpu_torch.utils import bench_corpus

    t = time.perf_counter()
    _cuda.lib()
    say(f"[2 build] {time.perf_counter() - t:.2f} s nvcc -> "
        f"{os.path.relpath(_cuda.library_path())}; ptxas: " + "; ".join(
            ln.split("info    : ")[1] for ln in _cuda.build_log().splitlines()
            if "registers" in ln))
    mma_res = _mma_resources(_cuda.build_log(),
                             _cuda.lib().kmerdb_gram_u8_smem_bytes())
    say("[2 build] int8 tensor-core blocks (gram_pk.cuh, gram_u8.cuh): "
        + "; ".join(f"{rec} {_fmt(r)}" for rec, r in mma_res.items()))

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
    os.remove(dev_csv)          # host_csv and C_host stay for phase 17
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
    sres, C_random, C_counts = check_stripe_kernels(torch, gram, device_a2a,
                                                    big, rng)
    say(f"[8 kernels] {time.perf_counter() - t:.2f} s")
    for name, cases in sres.items():
        for c in cases:
            say(f"[8 kernel] {name} == plain: {_fmt(c)}")
    t = time.perf_counter()
    bres = check_bounds_zero(torch, gram, C_random, C_counts)
    del C_random, C_counts
    torch.cuda.empty_cache()
    say(f"[19 kernels] {time.perf_counter() - t:.2f} s")
    for c in bres:
        say(f"[19 kernel] bounds_zero_rows == plain: {_fmt(c)}")

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
        os.remove(csvs["matrix", form])    # the streamed CSV stays for phase 20
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

    from kmerdb_tpu_torch.cli import loader, params
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
    parts = parts_phases(torch, cli, gram, fused, workdir, paths, db_path,
                         say)

    t = time.perf_counter()
    scres = check_scan_kernels(torch, gram, intersect, db, rng)
    torch.cuda.empty_cache()
    say(f"[16 kernels] {time.perf_counter() - t:.2f} s")
    for name, cases in scres.items():
        for c in cases:
            say(f"[16 kernel] {name} == plain: {_fmt(c)}")
    scan = scan_phases(torch, cli, gram, intersect, db, db_path, C_host,
                       host_csv, n2a["files"], workdir, say)
    del C_host
    t = time.perf_counter()
    fused_phases(torch, cli, gram, fused, workdir, say,
                 scale_list=scale_list, host_csv=host_csv,
                 sp_csv=parts["files"]["host_csv"],
                 matrix_launches=launches_matrix)
    say(f"[22 fused] {time.perf_counter() - t:.2f} s")
    mesh = mesh_phases(
        torch, cli, gram, intersect, workdir, say, big_path=big_path,
        streamed_csvs={form: csvs["streamed", form]
                       for form in ("dense", "sparse")},
        db_path=db_path, host_csv=host_csv, n2a_files=n2a["files"],
        parts_files=parts["files"])
    t = time.perf_counter()
    sw = sweep_phases(torch, gram, device_a2a, db, db_path,
                      kres["gram_pk_tri"][0], rng, say)
    say(f"[23 sweep] {time.perf_counter() - t:.2f} s")

    def entry(name, source, replaces, res, launches, timed=0):
        """res[timed] gives the times and the bound: the case nearest the
        route's own."""
        c = res[timed]
        bound_ms, bound_by = _bound(c["ops"], c["bytes"])
        return {"name": name, "route": "cuda",
                "source": f"kmerdb_tpu_torch/csrc/{source}",
                "replaces": f"kmerdb_tpu/ops/pallas_gram.py:{replaces}",
                "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in res),
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": c.get("library_ms")}

    dense = runs["streamed", "dense"]["launches"]
    sparse = runs["streamed", "sparse"]["launches"]
    kernels = [
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
        entry("bounds_zero_rows", "bounds_zero.cu", 519, bres,
              mesh["streamed", "sparse"]["launches"]),
        entry("matmul_u32_acc", "matmul_acc.cu", 686, qres,
              n2a["1", "dense"]["launches"]),
        entry("cross_u32_pk", "cross_pk.cu", 727, cres,
              parts["a grid"]["launches"]),
        entry("gram_u32_tri", "gram_u32.cu", 119, scres["gram_u32_tri"],
              scan["tri"]["launches"]),
        entry("gram_u32", "gram_u32.cu", 83, scres["gram_u32"],
              scan["full"]["launches"]),
        entry("matmul_u32", "matmul_acc.cu", 631, scres["matmul_u32"],
              scan["n2a"]["launches"]),
    ] + [{"name": f"sweep_{v}", "route": "cuda",
          "source": "kmerdb_tpu_torch/csrc/gram_sweep.cu",
          "replaces": f"tools/kernel_sweep.py:{SWEEP_BODY[v]}",
          "launches": r["launches"], "max_abs_err": max(r["errs"]),
          "ms": r["per_call_ms"], "plain_ms": r["plain_ms"],
          "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
          "library_ms": r["library_ms"]}
         for v, r in sw["variants"].items()]
    for k in kernels:
        if k["name"] in mma_res:
            k.update(mma_res[k["name"]])
    return kernels


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
