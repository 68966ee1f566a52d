"""Gram kernel variant sweep of kmerdb_tpu_torch on one CUDA card.

The port of kmerdb_tpu's tools/kernel_sweep.py.  It times the variants of
ops/sweep.py (csrc/gram_sweep.cu) on synthetic operands resident on the
card, so that the triangle Gram's time splits into its parts:

  int8        the production s8 body (unpack, weight limb, mma.sync)
  bf16        packed operands expanded to bf16 with the weight on chip, the
              product on the bf16 tensor cores (mma.sync)
  bf16_ns     the same without the weight
  nodot       the unpack alone
  dotonly     pre-unpacked bf16 operands, the product alone (mma.sync)
  dotonly_T   the same with Bi laid out [S, P]
  dotonly_s8  pre-unpacked int8 operands, the product alone (mma.sync)

and, with --on-db, sweeps the production kernel's geometry (kt, tile) on a
database's own packed groups (ops/device_a2a.kernel_bench under
KMERDB_A2A_KT and KMERDB_A2A_TILE).

Each run chains calls C = k(C, ...) on one stream after a warm-up and
times the chain with CUDA events; the chain lengths are in the record.
Each record carries its bound, the larger of the operations (2 per
multiply-add over the lower tile triangle) over the card's peak for the
variant's type (int8 1,979 Tops, bf16 989 TFLOP/s; nodot has no product)
and the bytes (each operand read once, C's triangle read and written) over
3.35 TB/s, both of an H100 SXM at 700 W; for dotonly_s8, dotonly and
dotonly_T also the time of one PyTorch call on the same operands over the
full square (``library_call``): torch._int_mm, and cuBLAS's bf16 product
with an f32 result, which on the tool's 0/1 operands gives every K block's
sum exactly, so its truncation changes nothing.

Usage (on a machine with a CUDA card):

    python -m kmerdb_tpu_torch.tools.kernel_sweep [variant ...] [--S 2048]
        [--P 1048576] [--kt 512] [--tile 128] [--out FILE]
    python -m kmerdb_tpu_torch.tools.kernel_sweep --on-db DB
        [--kts 512,1024,2048] [--tiles 128,256,512] [--out FILE]

Records are printed as JSON lines and appended to --out (default
kernel_sweep_torch.jsonl in the temp directory).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .. import _torchinit
from ..io import dbfile
from ..ops import device_a2a, sweep

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "kernel_sweep_torch.jsonl")
#: an H100 SXM's dense bf16 peak and memory rate (NVIDIA's data sheet,
#: 700 W); the int8 peak is device_a2a.INT8_OPS_PER_S
BF16_FLOP_PER_S = 989e12
BYTES_PER_S = 3.35e12
#: the knobs sweep_on_db sets
GEOMETRY_KNOBS = ("KMERDB_A2A_KT", "KMERDB_A2A_TILE")


def build(variant: str, S: int, P: int, kt: int, tile: int) -> tuple:
    """(step, packed): step(w, Bi, Bj, C) runs the variant's kernel for
    (S, P, kt, tile) on C in place and returns C; packed says whether Bi
    and Bj are bit-packed."""
    if variant not in sweep.VARIANTS:
        raise ValueError(f"unknown variant {variant}; one of "
                         f"{', '.join(sweep.VARIANTS)}")
    kern = sweep.KERNELS[variant]

    def step(w, Bi, Bj, C):
        return kern(w, Bi, Bj, C, kt=kt, tile=tile)

    return step, variant in sweep.PACKED


def operands(variant: str, S: int, P: int, device, seed: int = 0) -> tuple:
    """(w, Bi, Bj) on `device` as kmerdb_tpu's run_variant makes them:
    random bytes for the packed variants (Bi is Bj), 0/1 for the unpacked
    ones, weights in 1..127."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    if variant.startswith("dotonly"):
        raw = torch.from_numpy(rng.integers(0, 2, size=(P, S),
                                            dtype=np.int8)).to(dev)
        dt = sweep.operand_dtype(variant)
        Bj = raw.to(dt)
        Bi = raw.T.contiguous().to(dt) if variant == "dotonly_T" \
            else raw.to(dt)
        del raw
    else:
        Bi = Bj = torch.from_numpy(rng.integers(0, 256, size=(P // 8, S),
                                                dtype=np.uint8)).to(dev)
    w = torch.from_numpy(rng.integers(1, 128, size=P, dtype=np.uint32)
                         .view(np.int32)).to(dev)
    return w, Bi, Bj


def bound(variant: str, S: int, P: int, tile: int) -> dict:
    """The variant's operations and bytes at (S, P, tile), and the least
    time the card could take for them (bound_ms, bound_by)."""
    nt = S // tile
    cells = nt * (nt + 1) // 2 * tile * tile
    ops = 0.0 if variant == "nodot" else 2.0 * cells * P
    peak = device_a2a.INT8_OPS_PER_S if variant in ("int8", "dotonly_s8") \
        else BF16_FLOP_PER_S
    operand = {torch.uint8: P // 8, torch.int8: P, torch.bfloat16: 2 * P}[
        sweep.operand_dtype(variant)] * S
    nbytes = 2 * operand + 8 * cells \
        + (4 * P if variant in ("int8", "bf16") else 0)
    t_ops, t_bytes = ops / peak * 1e3, nbytes / BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


#: the yardstick of each variant that has one: a PyTorch call on the same
#: operands over the full S x S square
LIBRARY_OPS = {
    "dotonly_s8": "torch._int_mm(Bi.T, Bj), the full S x S square",
    "dotonly": "torch.mm(Bi.T, Bj, out_dtype=torch.float32) (cuBLAS bf16, "
               "f32 result), the full S x S square",
    "dotonly_T": "torch.mm(Bi, Bj, out_dtype=torch.float32) (cuBLAS bf16, "
                 "f32 result), the full S x S square",
}


def library_call(variant: str, Bi: torch.Tensor, Bj: torch.Tensor):
    """The call of LIBRARY_OPS[variant] on (Bi, Bj), as a function of no
    arguments, or None where the variant has none.  A contiguous copy it
    needs is made here, outside any timing of the call."""
    if variant == "dotonly_s8":
        A = Bi.T.contiguous()
        return lambda: torch._int_mm(A, Bj)
    if variant in ("dotonly", "dotonly_T"):
        A = Bi.T if variant == "dotonly" else Bi     # cuBLAS reads Bi.T as is
        return lambda: torch.mm(A, Bj, out_dtype=torch.float32)
    return None


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _emit(rec: dict, out: str | None) -> None:
    """Print the record and append it to the JSON-lines file `out`; with
    no `out`, a caller that keeps the records itself, do neither."""
    if out is None:
        return
    line = json.dumps(rec)
    print(line, flush=True)
    with open(out, "a") as f:
        f.write(line + "\n")


def run_variant(variant: str, S: int, P: int, kt: int, tile: int,
                n1: int = 4, n2: int = 20, device=None,
                out: str | None = DEFAULT_OUT, given=None) -> dict:
    """One variant at (S, P, kt, tile) on `device` (default: the CUDA
    card): n1 chained calls warm up, n2 are timed.  `given` is (w, Bi, Bj)
    on the device, by default operands(variant, S, P).  Returns the
    record."""
    dev = torch.device(device) if device is not None \
        else _torchinit.device()
    w, Bi, Bj = given if given is not None else operands(variant, S, P, dev)
    step, _ = build(variant, S, P, kt, tile)
    C = torch.zeros((S, S), dtype=torch.int32, device=dev)
    for _ in range(n1):
        step(w, Bi, Bj, C)
    ms = device_a2a.time_ms(lambda: step(w, Bi, Bj, C), n2, dev) / max(n2, 1)
    b = bound(variant, S, P, tile)
    rec = {"variant": variant, "S": S, "P": P, "kt": kt, "tile": tile,
           "device": _device_name(dev), "per_call_ms": ms,
           "tops": b["ops"] / ms / 1e9 if ms > 0 else None,
           "chain_lens": [n1, n2], **b, "library_ms": None,
           "library_op": LIBRARY_OPS.get(variant)}
    lib = library_call(variant, Bi, Bj) if dev.type == "cuda" else None
    if lib is not None:
        try:
            lib()
        except (RuntimeError, TypeError, NotImplementedError) as e:
            # this torch refuses the call (an older one has no out_dtype):
            # no yardstick, and no other call in its place
            rec["library_error"] = f"{type(e).__name__}: {e}"
        else:
            rec["library_ms"] = device_a2a.time_ms(lib, n2, dev) / max(n2, 1)
    del w, Bi, Bj, C, lib
    _emit(rec, out)
    return rec


def sweep_on_db(db_path: str, kts, tiles, device=None,
                out: str | None = DEFAULT_OUT) -> list:
    """kernel_bench on the database's packed groups at every (kt, tile),
    set through KMERDB_A2A_KT and KMERDB_A2A_TILE; the knobs are restored
    afterwards.  Returns the records."""
    db = dbfile.load_db(db_path, dbfile.PATTERNS)
    saved = {k: os.environ.get(k) for k in GEOMETRY_KNOBS}
    rows = []
    try:
        for kt in kts:
            for tile in tiles:
                os.environ["KMERDB_A2A_KT"] = str(kt)
                os.environ["KMERDB_A2A_TILE"] = str(tile)
                rec = {"on_db": db_path,
                       **device_a2a.kernel_bench(db, device=device)}
                _emit(rec, out)
                rows.append(rec)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kmerdb_tpu_torch.tools.kernel_sweep",
        description="Time the Gram kernel variants on the CUDA card.")
    ap.add_argument("variants", nargs="*",
                    help=f"any of {', '.join(sweep.VARIANTS)}")
    ap.add_argument("--S", type=int, default=2048)
    ap.add_argument("--P", type=int, default=1 << 20)
    ap.add_argument("--kt", type=int, default=512)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--on-db", default=None, metavar="DB",
                    help="sweep the production kernel's (kt, tile) on a "
                         "database's own packed groups")
    ap.add_argument("--kts", default="512,1024,2048")
    ap.add_argument("--tiles", default="128,256,512")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSON lines are appended here (default %(default)s)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_sweep times kernels on a CUDA card, and "
              "torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"# {smi or torch.cuda.get_device_name(0)}", flush=True)
    if args.on_db:
        sweep_on_db(args.on_db, [int(x) for x in args.kts.split(",")],
                    [int(x) for x in args.tiles.split(",")], out=args.out)
        return 0
    for v in args.variants:
        # unpacked operands are 8-16x larger
        P = min(args.P, 1 << 17) if v.startswith("dotonly") else args.P
        run_variant(v, args.S, P, args.kt, args.tile, out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
