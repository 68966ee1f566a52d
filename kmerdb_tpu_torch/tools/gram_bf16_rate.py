"""Rate of the bf16 blocks (csrc/gram_bf16.cuh) on one CUDA card.

Prints ptxas's registers and spills of the kernel sweep's bf16 kernels
(``dotonly`` and ``dotonly_T`` on unpacked operands through block()'s
mma.sync, ``bf16`` and ``bf16_ns`` on packed ones through packed_block's
wgmma, ``nodot`` on packed_block's staging alone) and of their split sum,
then, for each of the five at the sweep's defaults (S 2,048, P 2^17 for
``dotonly*`` and 2^20 for the packed three, as ``kernel_sweep.main``;
``--P`` sets one P for every variant), kt 512, tile 128, the tool's
operands, after one call held to its plain version exactly:

* the time a call (CUDA events over a chain) at k_splits 1, 2, 4, 8, 16
  and 32 and at ``sweep.dot_splits``' choice, each with its share of the
  bound (``kernel_sweep.bound``);
* at that choice, the profiler's device time of the block kernel and of
  the split sum (``torch.profiler``, summed over the chain);
* the library call of ``kernel_sweep.library_call`` where the variant has
  one (cuBLAS's bf16 product with an f32 result, over the full square);

and, where ``nodot`` ran beside ``bf16`` or ``bf16_ns``, the staging
split of packed_block at each k_splits both ran: the staging (``nodot``,
which also runs adds that ``bf16`` does not), staging and product
(``bf16``), their difference and ``nodot``'s share of ``bf16``'s time.

One JSON line a case.  Usage, on a machine with a CUDA card (exits 1
without one):

    python -m kmerdb_tpu_torch.tools.gram_bf16_rate [--splits 1,2,4,8,16,32]
        [--variants bf16,bf16_ns,nodot,dotonly,dotonly_T] [--P N]
"""

import argparse
import json
import sys

import torch

from ..ops import _cuda, gram, sweep
from . import gram_u8_rate, kernel_sweep

KERNELS = ("sweep_dot_bf16_kernel", "sweep_pk_bf16_kernel",
           "sweep_nodot_kernel", "dot_split_sum_kernel")


def _profile_ms(fn, reps: int) -> dict:
    """Device milliseconds a call of each of KERNELS over reps calls of
    fn, by torch.profiler (None where it saw none)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in KERNELS}
    for ev in prof.key_averages():
        for k in KERNELS:
            if k in ev.key:
                us = getattr(ev, "device_time_total", None)
                if us is None:
                    us = ev.cuda_time_total
                out[k] += us / 1e3 / reps
    return {k: (v or None) for k, v in out.items()}


def run(variant: str, S: int, P: int, kt: int, tile: int, splits,
        reps: int) -> list:
    dev = torch.device("cuda")
    kern = sweep.KERNELS[variant]
    w, Bi, Bj = kernel_sweep.operands(variant, S, P, dev)
    C = torch.zeros((S, S), dtype=torch.int32, device=dev)
    got = kern(w, Bi, Bj, C.clone(), kt=kt, tile=tile)
    want = sweep.plain(variant, w, Bi, Bj, C.clone(), kt=kt, tile=tile)
    if not torch.equal(got, want):
        raise SystemExit(f"{variant} differs from its plain version")
    del got, want
    b = kernel_sweep.bound(variant, S, P, tile)
    blocks = sweep.n_blocks(S, tile)
    plan = sweep.dot_splits(blocks, P // kt, gram._n_sm(0))
    base = {"variant": variant, "S": S, "P": P, "kt": kt, "tile": tile,
            "blocks": blocks, "device": torch.cuda.get_device_name(0),
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
    recs = []
    for z in sorted({*splits, plan}):
        def call():
            return kern(w, Bi, Bj, C, kt=kt, tile=tile, k_splits=z)
        ms = gram_u8_rate._ms(call, reps)
        rec = {**base, "k_splits": z, "planned": z == plan, "ms": ms,
               "tflops": b["ops"] / ms / 1e9,
               "bound_share": b["bound_ms"] / ms}
        if z == plan:
            prof = _profile_ms(call, reps)
            rec["device_ms"] = {k.split("_kernel")[0]: v
                                for k, v in prof.items()}
        recs.append(rec)
    lib = kernel_sweep.library_call(variant, Bi, Bj)
    if lib is not None:
        ms = gram_u8_rate._ms(lib, reps)
        recs.append({**base, "library_op": kernel_sweep.LIBRARY_OPS[variant],
                     "library_ms": ms,
                     "library_tflops": 2.0 * S * S * P / ms / 1e9})
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kmerdb_tpu_torch.tools.gram_bf16_rate",
        description="Time the bf16 blocks of the sweep's bf16 variants.")
    ap.add_argument("--S", type=int, default=2048)
    ap.add_argument("--P", type=int, default=None,
                    help="patterns of every variant (default: 2^20, and "
                         "2^17 for the unpacked dotonly*, whose operands "
                         "are 8-16x larger)")
    ap.add_argument("--variants", default=",".join(sweep.SPLIT))
    ap.add_argument("--kt", type=int, default=512)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--splits", default="1,2,4,8,16,32")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gram_bf16_rate times kernels on a CUDA card, and "
              "torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    _cuda.lib()
    for ln in gram_u8_rate._ptxas(_cuda.build_log(), KERNELS):
        print(ln)
    ms = {}
    for v in args.variants.split(","):
        P = args.P or (1 << 20 if v in sweep.PACKED else 1 << 17)
        for rec in run(v, args.S, P, args.kt, args.tile,
                       [int(x) for x in args.splits.split(",")], args.reps):
            print(json.dumps(rec), flush=True)
            if "k_splits" in rec:
                ms[v, rec["k_splits"]] = (rec["ms"], rec["planned"])
    for rec in staging_split(ms):
        print(json.dumps(rec), flush=True)
    return 0


def staging_split(ms: dict) -> list:
    """packed_block's time split at each k_splits where nodot and bf16
    (bf16_ns) both ran: nodot's time (the staging and its adds), bf16's,
    and bf16 less nodot; ms maps (variant, k_splits) to (ms, planned)."""
    out = []
    for (v, z), (full, planned) in sorted(ms.items()):
        if v in sweep.PACKED_BF16 and ("nodot", z) in ms:
            stage = ms["nodot", z][0]
            out.append({"split": v, "k_splits": z, "planned": planned,
                        "nodot_ms": stage, f"{v}_ms": full,
                        "less_nodot_ms": full - stage,
                        "nodot_share": stage / full})
    return out


if __name__ == "__main__":
    sys.exit(main())
