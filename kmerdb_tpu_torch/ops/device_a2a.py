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
from ..host import KmerPatternDb, native
from . import gram
from .geom import KT, LIMB_BITS, TILE

#: phase timings and plan of the last all2all_device call
last_stats: dict = {}


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
    offs = np.ascontiguousarray(db.pattern_offsets, dtype=np.int64)
    sids = np.ascontiguousarray(db.pattern_sample_ids, dtype=np.uint32)
    w = db.pattern_num_kmers
    light, heavy, heavy_limbs = _limb_split(w)
    group_rows, groups = _group_plan(light, heavy, heavy_limbs, S_pad, kt)

    # every count is at most min(sample k-mer counts): when the largest
    # sample fits 16 bits, so does the whole pull
    counts_max = int(db.sample_kmer_counts.max()) \
        if db.sample_kmer_counts.size else 0
    narrow = counts_max < (1 << 16)

    C = torch.zeros((S_pad, S_pad), dtype=torch.int32, device=dev)
    buf = np.empty((group_rows // 8, S_pad), dtype=np.uint8)
    wbuf = np.zeros(group_rows, dtype=np.uint32)
    # device-side kernel times: the host clock cannot split them from the
    # pushes, which wait on the stream for the previous group's Gram
    events = _Events(dev)
    t_fill = t_push = 0.0
    for gp, n_limbs, rows in groups:
        ta = time.perf_counter()
        _fill_packed(gp, rows, offs, sids, w, buf, wbuf)
        tb = time.perf_counter()
        # copies: the scratch is refilled for the next group
        Bp = torch.from_numpy(buf[:rows // 8]).to(dev, copy=True)
        wg = torch.from_numpy(gram.pk_weight_order(wbuf[:rows], kt)
                              .view(np.int32)).to(dev, copy=True)
        tc = time.perf_counter()
        with events.span("gram_s"):
            gram.gram_u32_pk_tri(Bp, wg, C, n_limbs=n_limbs, kt=kt,
                                 tile=tile)
        t_fill += tb - ta
        t_push += tc - tb

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
        "fill_s": t_fill, "push_s": t_push,
        "compute_pull_s": t2 - t1, "mirror_s": t3 - t2,
        "total_s": t3 - t0, **events.seconds(),
    })
    return out


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
