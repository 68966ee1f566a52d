"""The counting kernels over a device mesh (counterpart of
kmerdb_tpu/parallel/sharded.py, without its device build and ingest).

Every count decomposes exactly: all2all over patterns
(C = sum_p w_p b_p b_p^T), db2db over pattern pairs, new2all over queries,
the streamed all2all over row stripes of C.  Each slot of the mesh
computes its share with the single-card tiers' kernels (ops/gram.py), and
the shares are summed or laid side by side.  Partial counts are int32
storage of uint32 bits: their sum wraps mod 2^32, exact in any order, so
the merge that kmerdb_tpu writes as a psum is a copy of each slot's
partial to the first slot and an add.

A replicated operand (the packed incidence of the streamed all2all, B of
new2all) is one tensor on each distinct device of the mesh, shared by the
slots on it; a sharded operand is one tensor a slot.  parallel/mesh.py
states the stream order that Mesh.run keeps.  A failure on a device
propagates: nothing is recomputed on another route.
"""

import os
import time

import numpy as np
import torch

from ..models.database import KmerPatternDb
from ..ops import device_a2a, gram, intersect
from ..ops.geom import TILE
from ..utils import native
from .mesh import Mesh

#: plan and seconds of the last all2all_rows_sharded call: host clock,
#: but gram_s, cast_s and filter_s by CUDA events summed over the slots,
#: and device_s the rounds' time on the first device
last_stats: dict = {}
#: what the calls of many2all_counts_sharded (m2a_*) and
#: db2db_counts_sharded (d2d_*) since the last clear() cut over the slots,
#: taken from their plans before anything is queued: calls, m2a_chunks
#: (each one matmul_u32_acc launch a slot), the non-empty d2d_shares and
#: the cross_u32_pk launches (d2d_launches) their chunks come to
plan_stats: dict = {}


def _sum_to_first(parts: list) -> torch.Tensor:
    """The slots' partial counts summed on the first slot's device, mod
    2^32 (kmerdb_tpu's psum).  Called after Mesh.run, on the devices'
    current streams, which run() ordered after the slots' work."""
    C = parts[0]
    for part in parts[1:]:
        C.add_(part.to(C.device))
    return C


def _shares(n: int, D: int) -> list:
    """D + 1 bounds cutting [0, n) into D contiguous shares of
    ceil(n / D), the last ones short or empty."""
    per = -(-n // D)
    return [min(n, d * per) for d in range(D + 1)]


def all2all_counts_sharded(db: KmerPatternDb, mesh: Mesh) -> np.ndarray:
    """uint32[S, S] all2all over the mesh: the patterns are cut into one
    contiguous slice a slot, each slot adds up the Gram of its slice
    (ops/intersect._a2a_scan_partial: unpacked int8 chunks through
    ops/gram.gram_u32_tri, 8-bit weight limbs), and the partial counts are
    summed, mirrored and pulled once."""
    S = db.n_samples
    if db.n_patterns == 0 or S == 0:
        return np.zeros((S, S), dtype=np.uint32)
    t0 = time.perf_counter()
    bounds = _shares(db.n_patterns, mesh.size)
    stats: dict = {}
    parts = mesh.run(lambda d, slot: intersect._a2a_scan_partial(
        db, bounds[d], bounds[d + 1], slot.device, stats))
    C = _sum_to_first(parts)
    return intersect._scan_finish(db, C, True, t0, stats)


def many2all_counts_sharded(db: KmerPatternDb, queries: list,
                            mesh: Mesh) -> np.ndarray:
    """uint32[Q, S] new2all over the mesh: the query rows of H are cut into
    one share a slot, each chunk's incidence B is replicated, and each slot
    accumulates its rows of sims = H @ B (ops/gram.matmul_u32_acc).  Rows
    come back in query order.  Without the C++ host runtime, which the
    batched probes need, the per-query host path answers."""
    Q, S = len(queries), db.n_samples
    if Q == 0 or S == 0 or db.n_patterns == 0:
        return np.zeros((Q, S), dtype=np.uint32)
    if not native.available:
        return intersect.many2all_counts(db, queries, use_device=False)
    D = mesh.size
    # a share of whole 128-row blocks for every slot (kmerdb_tpu pads Q to
    # D * 8, its sublane count)
    H_all, B_all, n_limbs = intersect.m2a_prepare(db, queries,
                                                  q_align=D * TILE)
    q = H_all.shape[1] // D
    S_pad = B_all.shape[2]
    h_view = np.uint8 if H_all.dtype == np.uint8 else np.int32
    intersect._add_stats(plan_stats, m2a_calls=1, m2a_chunks=H_all.shape[0])
    C = mesh.run(lambda d, slot: torch.zeros(
        (q, S_pad), dtype=torch.int32, device=slot.device))
    for c in range(H_all.shape[0]):
        B = {dev: torch.from_numpy(B_all[c]).to(dev) for dev in mesh.devices}

        def step(d, slot):
            H = torch.from_numpy(H_all[c, d * q:(d + 1) * q].view(h_view))
            gram.matmul_u32_acc(H.to(slot.device), B[slot.device], C[d],
                                n_limbs=n_limbs)

        mesh.run(step)
    out = np.concatenate([Cd.cpu().numpy() for Cd in C]).view(np.uint32)
    return np.ascontiguousarray(out[:Q, :S])


def db2db_counts_sharded(db_row: KmerPatternDb, db_col: KmerPatternDb,
                         mesh: Mesh) -> np.ndarray:
    """uint32[S_row, S_col] db2db over the mesh: the matched pattern pairs
    are cut into one contiguous share a slot, each slot contracts its pairs
    (ops/intersect._d2d_partial: packed operands through
    ops/gram.cross_u32_pk), and the partial counts are summed and pulled
    once."""
    S1, S2 = db_row.n_samples, db_col.n_samples
    pairs = intersect.d2d_pairs(db_row, db_col)
    if pairs is None:
        return np.zeros((S1, S2), dtype=np.uint32)
    if not native.available:
        return intersect.db2db_counts(db_row, db_col)
    up1, up2, cnts = pairs
    bounds = _shares(up1.size, mesh.size)
    shares = [n for n in np.diff(bounds).tolist() if n]
    intersect._add_stats(
        plan_stats, d2d_calls=1, d2d_shares=len(shares),
        d2d_launches=sum(-(-n // intersect._d2d_chunk_rows(n))
                         for n in shares))

    def step(d, slot):
        sl = slice(bounds[d], bounds[d + 1])
        return intersect._d2d_partial(db_row, db_col, up1[sl], up2[sl],
                                      cnts[sl], slot.device)

    C = _sum_to_first(mesh.run(step))
    return np.ascontiguousarray(C.cpu().numpy().view(np.uint32)[:S1, :S2])


def all2all_rows_sharded(db: KmerPatternDb, mesh: Mesh, row_handler,
                         stripe_rows: int | None = None,
                         cell_bounds: tuple | None = None) -> None:
    """Streamed all2all over the mesh: the slots own row stripes of C.

    In each round slot d computes the stripe of stripe_rows rows that
    starts at tile r0 + d * nrt over the full pattern axis
    (ops/gram.gram_u32_pk_rows on the replicated packed incidence), so no
    device holds more of C than one stripe and nothing is summed across
    slots.  The last round's stripes are clamped backwards to end at the
    last tile, and rows already handed out are skipped.  The round's
    stripes are pulled, as uint16 when every count fits
    (ops/gram.cast_rows), and handed to row_handler(i, uint32[S]) in
    global row order.

    The plan is the single-card streamed route's
    (ops/device_a2a.all2all_device_rows): the light and heavy pattern
    classes in groups of KMERDB_A2A_GROUP_MB, the default stripe of 128 MB
    of counts, groups resident on every device when they fit
    KMERDB_A2A_RESIDENT_MB and re-packed every round otherwise.

    cell_bounds=(lo, hi): sparse output.  Each slot zeroes the cells of
    its stripe outside the inclusive bounds before the pull
    (ops/gram.bounds_zero_rows), so the handed rows carry survivors only,
    as the single-card route's do."""
    S = db.n_samples
    if S == 0:
        return
    t0 = time.perf_counter()
    kt, tile, S_pad = device_a2a._geometry(S)
    nt = S_pad // tile
    D = mesh.size
    light, heavy, heavy_limbs = device_a2a._limb_split(db.pattern_num_kmers)
    group_rows, groups = device_a2a._group_plan(light, heavy, heavy_limbs,
                                                S_pad, kt)
    if stripe_rows is None:
        stripe_rows = max(tile, device_a2a.STRIPE_BYTES // (S_pad * 4)
                          // tile * tile)
    nrt = max(1, min(nt, stripe_rows // tile))
    stripe_rows = nrt * tile

    first, *others = mesh.devices
    packer = device_a2a._Packer(db, group_rows, S_pad, kt, first)

    def replicated(gp, rows) -> dict:
        """{device: (Bp, w)} of one group: packed and pushed once, then
        copied from the first device to the others."""
        Bp, wg = packer.push(gp, rows)
        return {first: (Bp, wg),
                **{dev: (Bp.to(dev), wg.to(dev)) for dev in others}}

    resident_mb = int(os.environ.get("KMERDB_A2A_RESIDENT_MB", "4096"))
    # the incidence is replicated: every device holds the whole set
    resident = sum(rows // 8 * S_pad for _, _, rows in groups) \
        <= (resident_mb << 20)
    dev_groups = [(replicated(gp, rows), n_limbs)
                  for gp, n_limbs, rows in groups] if resident else None

    narrow = device_a2a._narrow_pull(db)
    pull_dtype, host_dtype = (torch.int16, np.uint16) if narrow \
        else (torch.int32, np.uint32)
    bounds = gram.bias_bounds(*cell_bounds) if cell_bounds is not None \
        else None
    events = device_a2a._Events(first)

    def finish(d, slot):
        """Slot d's stripe as it leaves the device."""
        with events.span("filter_s" if bounds is not None else "cast_s"):
            if bounds is not None:
                return gram.bounds_zero_rows(C[d], bounds, pull_dtype)
            return gram.cast_rows(C[d]) if narrow else C[d]

    C = mesh.run(lambda d, slot: torch.empty(
        (stripe_rows, S_pad), dtype=torch.int32, device=slot.device))
    next_row = 0
    rounds = 0
    pull_s = handler_s = 0.0
    for r0 in range(0, nt, D * nrt):
        rounds += 1
        # slot d owns tiles [rt0[d], rt0[d] + nrt); the last round clamps
        # backwards
        rt0 = [min(r0 + d * nrt, nt - nrt) for d in range(D)]
        # on the first device's own stream, which waits for the slots: the
        # round's time on the device, whatever the slots overlap
        with events.span("device_s"):
            mesh.run(lambda d, slot: C[d].zero_())
            round_groups = dev_groups if resident else (
                (replicated(gp, rows), n_limbs)
                for gp, n_limbs, rows in groups)
            for ops, n_limbs in round_groups:

                def step(d, slot):
                    with events.span("gram_s"):
                        gram.gram_u32_pk_rows(*ops[slot.device], C[d], rt0[d],
                                              n_limbs=n_limbs, kt=kt,
                                              tile=tile)

                mesh.run(step)
            outs = mesh.run(finish)
        # the first pull waits for the round's kernels: pull_s holds that
        # wait as well as the copies
        tp = time.perf_counter()
        stripes = [o.cpu().numpy().view(host_dtype)
                   .astype(np.uint32, copy=False) for o in outs]
        th = time.perf_counter()
        pull_s += th - tp
        for d, stripe in enumerate(stripes):
            base = rt0[d] * tile
            for i in range(max(next_row, base), min(base + stripe_rows, S)):
                row_handler(i, stripe[i - base, :S])
            next_row = max(next_row, min(base + stripe_rows, S))
        handler_s += time.perf_counter() - th
        if next_row >= S:
            break

    last_stats.clear()
    last_stats.update({
        "S": S, "S_pad": S_pad, "slots": D, "devices": len(mesh.devices),
        "stripe_rows": stripe_rows, "rounds": rounds, "groups": len(groups),
        "resident_groups": resident, "narrow": narrow,
        "fill_s": packer.fill_s, "push_s": packer.push_s, "pull_s": pull_s,
        "handler_s": handler_s, "total_s": time.perf_counter() - t0,
        **events.seconds(),
    })
