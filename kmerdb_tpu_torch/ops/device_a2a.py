"""Device tier of all2all on a CUDA card: C = B^T diag(w) B, exact uint32.

Counterpart of all2all_device in kmerdb_tpu/ops/device_a2a.py, with the
same plan:

1. split the patterns into a light class (weight < 2^7: one limb) and a
   heavy class (limbed to the class maximum) — the Gram is invariant to
   pattern order;
2. fill bit-packed, pattern-axis groups on the host from the pattern CSR
   (native.fill_incidence_bits) into one reused scratch buffer, whose size
   KMERDB_A2A_GROUP_MB bounds;
3. push each group and accumulate C on the card over the lower triangle
   (ops/gram.gram_u32_pk_tri);
4. pull the triangle once, as uint16 when every count fits
   (ops/gram.tril_tiles), and mirror it on the host (untile_symmetric).

all2all_device_rows is the streamed route for large collections
(kmerdb_tpu's all2all_device_rows): the card holds one row stripe of C at
a time and hands finished rows to the caller, so neither the card nor the
host ever holds S^2 counts.  Its stripes come from ops/gram.gram_u32_pk_rows,
its pulls from ops/gram.cast_rows or, for a count filter,
ops/gram.filter_colsum and ops/gram.gather_tiles.

The TPU rig's workarounds (the compile warm-up thread, the AOT memo, the
xprof hook) have no counterpart: CUDA kernels are built once per checkout
and launched directly.
"""

import contextlib
import os
import time

import numpy as np
import torch

from .. import _torchinit
from ..models.database import KmerPatternDb
from ..utils import native
from . import gram
from .geom import KT, LIMB_BITS, TILE

#: phase timings and plan of the last all2all_device or
#: all2all_device_rows call
last_stats: dict = {}
#: default stripe of the streamed route: 128 MB of uint32 counts
STRIPE_BYTES = 128 << 20


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _geometry(S: int) -> tuple:
    """(kt, tile, S_pad) for S samples."""
    return KT, TILE, _round_up(max(S, 1), TILE)


def _limb_split(w: np.ndarray, limb_bits: int = LIMB_BITS):
    """(light_pids, heavy_pids, heavy_limbs): light patterns fit one limb;
    heavy patterns are limbed to the heavy-class maximum."""
    light_mask = w < (1 << limb_bits)
    light = np.flatnonzero(light_mask).astype(np.int64)
    heavy = np.flatnonzero(~light_mask).astype(np.int64)
    heavy_limbs = 0
    if heavy.size:
        heavy_limbs = -(-int(w[heavy].max()).bit_length() // limb_bits)
    return light, heavy, heavy_limbs


def _group_plan(light, heavy, heavy_limbs: int, S_pad: int, kt: int):
    """(group_rows, [(pattern ids, n_limbs, padded rows)]): each class of
    _limb_split in groups of at most group_rows patterns, padded to kt."""
    group_bytes = int(os.environ.get("KMERDB_A2A_GROUP_MB", "256")) << 20
    group_rows = max(kt, (group_bytes * 8 // S_pad) // kt * kt)
    # no point sizing the scratch beyond the largest class
    group_rows = min(group_rows,
                     _round_up(max(light.size, heavy.size, 1), kt))
    groups = []
    for pids, n_limbs in ((light, 1), (heavy, heavy_limbs)):
        for g0 in range(0, pids.size, group_rows):
            gp = pids[g0:g0 + group_rows]
            groups.append((gp, n_limbs, _round_up(gp.size, kt)))
    return group_rows, groups


def _fill_packed(gp, rows, offs, sids, w, buf, wbuf):
    """Zero the reused scratch and fill one group's bit-packed incidence
    (bit i & 7 of buf[i >> 3, s]: pattern gp[i] holds sample s) and
    weights."""
    buf[:rows // 8] = 0
    wbuf[:rows] = 0
    if native.available:
        native.fill_incidence_bits(gp, offs, sids, buf)
    else:
        for i, p in enumerate(gp):
            buf[i >> 3, sids[offs[p]:offs[p + 1]]] |= np.uint8(1 << (i & 7))
    wbuf[:gp.size] = w[gp]


class _Packer:
    """Fills pattern groups into one reused host scratch, whose size
    group_rows bounds, and copies each group to `dev`; sums the host
    seconds of both steps in fill_s and push_s."""

    def __init__(self, db: KmerPatternDb, group_rows: int, S_pad: int,
                 kt: int, dev: torch.device):
        self.offs = np.ascontiguousarray(db.pattern_offsets, dtype=np.int64)
        self.sids = np.ascontiguousarray(db.pattern_sample_ids,
                                         dtype=np.uint32)
        self.w = db.pattern_num_kmers
        self.buf = np.empty((group_rows // 8, S_pad), dtype=np.uint8)
        self.wbuf = np.zeros(group_rows, dtype=np.uint32)
        self.kt, self.dev = kt, dev
        self.fill_s = self.push_s = 0.0

    def push(self, gp, rows: int) -> tuple:
        """(Bp, w) of the group gp, padded to rows patterns, on the device."""
        ta = time.perf_counter()
        _fill_packed(gp, rows, self.offs, self.sids, self.w, self.buf,
                     self.wbuf)
        tb = time.perf_counter()
        # copies: the scratch is refilled for the next group
        pushed = (torch.from_numpy(self.buf[:rows // 8]).to(self.dev,
                                                            copy=True),
                  torch.from_numpy(gram.pk_weight_order(self.wbuf[:rows],
                                                        self.kt)
                                   .view(np.int32)).to(self.dev, copy=True))
        self.fill_s += tb - ta
        self.push_s += time.perf_counter() - tb
        return pushed


def plan_flops(db: KmerPatternDb) -> float:
    """Integer operations (2 per multiply-add) of the triangle plan,
    counting the zero padding the kernel multiplies too."""
    kt, tile, S_pad = _geometry(db.n_samples)
    _, groups = _group_plan(*_limb_split(db.pattern_num_kmers), S_pad, kt)
    return _plan_flops(groups, S_pad, tile)


def _plan_flops(groups, S_pad: int, tile: int) -> float:
    nt = S_pad // tile
    tri_frac = (nt + 1) / (2 * nt)
    return sum(2.0 * rows * S_pad * S_pad * tri_frac * n_limbs
               for _, n_limbs, rows in groups)


def _narrow_pull(db: KmerPatternDb) -> bool:
    """Whether every count fits uint16: each is at most the smaller of
    its two samples' k-mer counts, so it is enough that the largest
    sample's does."""
    return db.sample_kmer_counts.size == 0 \
        or int(db.sample_kmer_counts.max()) < (1 << 16)


def all2all_device(db: KmerPatternDb, device=None) -> np.ndarray:
    """Full symmetric uint32[S, S] common-k-mer matrix computed on
    `device` (default: the CUDA card, _torchinit.device()).  On a CPU
    device the kernels' plain versions run; a failure on the card
    propagates to the caller."""
    dev = torch.device(device) if device is not None \
        else _torchinit.device()
    t0 = time.perf_counter()
    S = db.n_samples
    kt, tile, S_pad = _geometry(S)
    light, heavy, heavy_limbs = _limb_split(db.pattern_num_kmers)
    group_rows, groups = _group_plan(light, heavy, heavy_limbs, S_pad, kt)
    narrow = _narrow_pull(db)

    C = torch.zeros((S_pad, S_pad), dtype=torch.int32, device=dev)
    packer = _Packer(db, group_rows, S_pad, kt, dev)
    # device-side kernel times: the host clock cannot split them from the
    # pushes, which wait on the stream for the previous group's Gram
    events = _Events(dev)
    for gp, n_limbs, rows in groups:
        Bp, wg = packer.push(gp, rows)
        with events.span("gram_s"):
            gram.gram_u32_pk_tri(Bp, wg, C, n_limbs=n_limbs, kt=kt,
                                 tile=tile)

    t1 = time.perf_counter()
    with events.span("tril_s"):
        tiles = gram.tril_tiles(C, torch.int16 if narrow else torch.int32)
    tiles = tiles.cpu().numpy().view(np.uint16 if narrow else np.uint32)
    t2 = time.perf_counter()
    out = gram.untile_symmetric(tiles.astype(np.uint32, copy=False), S)
    t3 = time.perf_counter()

    last_stats.clear()
    last_stats.update({
        "S": S, "S_pad": S_pad, "n_patterns": int(db.n_patterns),
        "light_patterns": int(light.size), "heavy_patterns": int(heavy.size),
        "heavy_limbs": heavy_limbs,
        "groups": len(groups), "flops": _plan_flops(groups, S_pad, tile),
        "kt": kt, "tile": tile, "device": str(dev),
        "pull_bytes": int(tiles.nbytes),
        "fill_s": packer.fill_s, "push_s": packer.push_s,
        "compute_pull_s": t2 - t1, "mirror_s": t3 - t2,
        "total_s": t3 - t0, **events.seconds(),
    })
    return out


def all2all_device_rows(db: KmerPatternDb, row_handler,
                        stripe_rows: int | None = None,
                        cell_bounds: tuple | None = None,
                        device=None) -> None:
    """Streamed all2all: C is computed on `device` (default: the CUDA card)
    in row stripes, and each finished row i is handed, in order, to
    row_handler(i, uint32[S]) as C's full row (cells j > i included).

    The card holds one stripe of stripe_rows rows (default STRIPE_BYTES of
    counts, whole tiles, at least one tile); the last stripe overlaps the
    one before it backwards, and rows already handed out are skipped.
    Packed pattern groups are pushed once and stay on the card when they
    fit KMERDB_A2A_RESIDENT_MB (default 4096), and are re-packed from the
    bounded host scratch for every stripe otherwise.  A stripe is pulled as
    uint16 when every count fits.

    cell_bounds=(lo, hi): sparse output.  The card counts the cells inside
    the inclusive bounds per 128 x 128 tile (filter_colsum) and only tiles
    holding any are pulled (gather_tiles); cells outside the bounds arrive
    as 0, so the caller passes bounds at least as wide as its own filter.
    A stripe whose survivor tiles would move as many bytes as the stripe is
    pulled whole instead.  On a CPU device the kernels' plain versions run;
    a failure on the card propagates to the caller."""
    dev = torch.device(device) if device is not None \
        else _torchinit.device()
    t0 = time.perf_counter()
    S = db.n_samples
    if S == 0:
        return
    kt, tile, S_pad = _geometry(S)
    nt = S_pad // tile
    light, heavy, heavy_limbs = _limb_split(db.pattern_num_kmers)
    group_rows, groups = _group_plan(light, heavy, heavy_limbs, S_pad, kt)

    if stripe_rows is None:
        stripe_rows = max(tile, STRIPE_BYTES // (S_pad * 4) // tile * tile)
    # a sub-tile request still needs one whole tile per stripe
    nrt = max(1, min(nt, stripe_rows // tile))
    stripe_rows = nrt * tile

    narrow = _narrow_pull(db)
    pull_dtype, host_dtype = (torch.int16, np.uint16) if narrow \
        else (torch.int32, np.uint32)
    packer = _Packer(db, group_rows, S_pad, kt, dev)
    events = _Events(dev)

    def pull_dense(C) -> np.ndarray:
        with events.span("pull_s"):
            host = (gram.cast_rows(C) if narrow else C).cpu().numpy()
        return host.view(host_dtype).astype(np.uint32, copy=False)

    bounds = gram.bias_bounds(*cell_bounds) if cell_bounds is not None \
        else None
    sparse = {"tiles_pulled": 0, "tiles_total": 0, "dense_fallbacks": 0}

    def pull_sparse(C) -> np.ndarray:
        """The stripe with every cell outside the bounds zeroed, pulled as
        its survivor tiles."""
        T = gram.PULL_TILE
        lo, hi = cell_bounds
        with events.span("filter_s"):
            cnts = gram.filter_colsum(C, bounds).cpu().numpy()
        tile_cnt = cnts.reshape(stripe_rows // T, S_pad // T, T).sum(2)
        it, jt = np.nonzero(tile_cnt)
        sparse["tiles_total"] += tile_cnt.size
        if it.size * T * T >= stripe_rows * S_pad:
            # no fewer bytes than the whole stripe: pull it whole, and zero
            # on the host what the survivor pull would have zeroed
            sparse["dense_fallbacks"] += 1
            sparse["tiles_pulled"] += tile_cnt.size
            d = pull_dense(C)
            return np.where((d >= lo) & (d <= hi), d, 0)
        out = np.zeros((stripe_rows, S_pad), dtype=np.uint32)
        if it.size:
            i_tab, j_tab = gram.tile_tables(it, jt, dev)
            with events.span("pull_s"):
                tiles = gram.gather_tiles(C, i_tab, j_tab, pull_dtype)
                tiles = tiles.cpu().numpy()
            tiles = tiles.view(host_dtype).astype(np.uint32, copy=False)
            # a survivor tile still holds its other cells
            tiles = np.where((tiles >= lo) & (tiles <= hi), tiles, 0)
            out.reshape(stripe_rows // T, T, S_pad // T, T) \
               .transpose(0, 2, 1, 3)[it, jt] = tiles
            sparse["tiles_pulled"] += int(it.size)
        return out

    resident_mb = int(os.environ.get("KMERDB_A2A_RESIDENT_MB", "4096"))
    resident = sum(rows // 8 * S_pad for _, _, rows in groups) \
        <= (resident_mb << 20)
    dev_groups = [(packer.push(gp, rows), n_limbs)
                  for gp, n_limbs, rows in groups] if resident else None

    C = torch.empty((stripe_rows, S_pad), dtype=torch.int32, device=dev)
    next_row = 0
    flops = handler_s = 0.0
    for rt0 in range(0, nt, nrt):
        rt0 = min(rt0, nt - nrt)       # the last stripe overlaps backwards
        C.zero_()
        stripe_groups = dev_groups if resident else (
            (packer.push(gp, rows), n_limbs) for gp, n_limbs, rows in groups)
        for (Bp, wg), n_limbs in stripe_groups:
            with events.span("gram_s"):
                gram.gram_u32_pk_rows(Bp, wg, C, rt0, n_limbs=n_limbs, kt=kt,
                                      tile=tile)
            flops += 2.0 * Bp.shape[0] * 8 * stripe_rows * S_pad * n_limbs
        stripe = pull_sparse(C) if cell_bounds is not None \
            else pull_dense(C)
        base = rt0 * tile
        th = time.perf_counter()
        for i in range(max(next_row, base), min(base + stripe_rows, S)):
            row_handler(i, stripe[i - base, :S])
        handler_s += time.perf_counter() - th
        next_row = min(base + stripe_rows, S)
        if next_row >= S:
            break

    last_stats.clear()
    last_stats.update({
        "S": S, "S_pad": S_pad, "n_patterns": int(db.n_patterns),
        "streamed": True, "stripe_rows": stripe_rows,
        "light_patterns": int(light.size), "heavy_patterns": int(heavy.size),
        "heavy_limbs": heavy_limbs, "groups": len(groups),
        "resident_groups": resident, "flops": flops,
        "kt": kt, "tile": tile, "device": str(dev),
        "fill_s": packer.fill_s, "push_s": packer.push_s,
        "handler_s": handler_s, "total_s": time.perf_counter() - t0,
        **events.seconds(),
    })
    if cell_bounds is not None:
        last_stats["sparse_pull"] = dict(sparse)


class _Events:
    """Device seconds of named spans of CUDA work, summed per name, from
    CUDA events; records nothing on other devices."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.pairs: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.cuda:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.pairs.append((name, start, end))

    def seconds(self) -> dict:
        """{name: seconds}; waits for the recorded work to finish."""
        out: dict = {}
        for name, start, end in self.pairs:
            end.synchronize()
            out[name] = out.get(name, 0.0) + start.elapsed_time(end) / 1e3
        return out
