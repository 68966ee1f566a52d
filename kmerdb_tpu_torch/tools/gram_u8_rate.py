"""Rate of the unpacked block (csrc/gram_u8.cuh) on one CUDA card.

Prints ptxas's registers and spills of the block's four kernels (and of
the query contraction's limb split), then, each case held to its plain
version exactly where the plain version fits:

* ``gram_u32_tri`` and ``gram_u32`` at the scan tier's chunk shape (P
  10,496 x S 4,096, random 0/1 incidence, random uint32 weights) at 1 and
  4 limbs, and ``torch._int_mm`` of the same operand (unweighted, one
  limb: a yardstick, not the same function);
* ``dotonly_s8`` at the kernel sweep's defaults (S 2,048, P 2^17, kt 512,
  tile 128) on signed operands over -128..127, and ``torch._int_mm``;
* ``matmul_u32_acc`` (csrc/matmul_acc.cu) at new2all's chunk shape (P
  10,496 x S 4,096) for Q_pad 512 and 128, uint8 H and uint32 H of 4
  limbs, at one split and at ``matmul_splits``' split of the patterns, and
  ``torch._int_mm`` of int8 operands of the same shapes (signed, one limb:
  a yardstick, not the same function);
* the block rate: ``gram_u32_tri`` (weighted) and ``dotonly_s8``
  (unweighted) at P 2^16 on 136 blocks (S 2,048: about one block an SM)
  and on 528 blocks (S 4,096: two waves of two blocks an SM), in Tops a
  resident block, and ``torch._int_mm``'s full square.

Times are CUDA-event means after a warm-up; the matmul cases also give
the card's time with their launches queued behind a sleep (no host gap
between them) and the host's time a call.  Usage, on a machine with a
CUDA card (exits 1 without one):

    python -m kmerdb_tpu_torch.tools.gram_u8_rate
"""

import re
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import _cuda, gram, sweep

#: the card's blocks of gram_u8.cuh's body in flight: two an SM on 132 SMs
RESIDENT = 2 * 132
#: clock cycles of the sleep that _queued_ms puts ahead of its launches:
#: ~5 ms, more than the host takes to queue them
SLEEP_CYCLES = 10_000_000
KERNELS = ("gram_u32_kernel", "sweep_s8_kernel", "matmul_acc_kernel",
           "limb_planes_kernel")


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn over reps runs queued behind a sleep
    on the stream, so that the host's time between launches is not
    counted: the card's time for the kernels alone."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _host_us(fn, reps: int) -> float:
    """Mean host microseconds a call of fn takes to return (its launches
    queued, not waited for)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / reps * 1e6


def _ptxas(log: str) -> list:
    """The -Xptxas -v lines of KERNELS, under their entry names."""
    out, keep = [], False
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            keep = any(k in m[1] for k in KERNELS)
            if keep:
                out.append(m[1])
        elif keep and ("spill" in ln or "registers" in ln):
            out.append("  " + ln.strip())
    return out


def _weights(rng, P: int, dev) -> torch.Tensor:
    w = rng.integers(0, 1 << 32, size=P, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(dev)


def _matmul_cases(rng, B: torch.Tensor, dev) -> None:
    P, S = B.shape
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for Q, n_limbs in ((1024, 1), (512, 1), (512, 4), (128, 1)):
        if n_limbs == 1:
            H = torch.from_numpy(rng.integers(0, 256, size=(Q, P),
                                              dtype=np.uint8)).to(dev)
        else:
            H = torch.from_numpy(rng.integers(0, 1 << 32, size=(Q, P),
                                              dtype=np.uint64)
                                 .astype(np.uint32).view(np.int32)).to(dev)
        C0 = torch.from_numpy(rng.integers(0, 1 << 32, size=(Q, S),
                                           dtype=np.uint64)
                              .astype(np.uint32).view(np.int32)).to(dev)
        want = gram.matmul_u32_acc_plain(H, B, C0.clone(), n_limbs=n_limbs)
        ops = 2.0 * Q * P * S * n_limbs
        planned = gram.matmul_splits(Q, S, P, n_sm)
        for k in sorted({1, 2, 4, 8, planned}):
            C = C0.clone()
            eq = torch.equal(gram.matmul_u32_acc(H, B, C, n_limbs=n_limbs,
                                                 k_splits=k), want)
            def fn():
                gram.matmul_u32_acc(H, B, C, n_limbs=n_limbs, k_splits=k)
            t, tq = _ms(fn, 10), _queued_ms(fn, 10)
            print(f"matmul_u32_acc Q {Q} P {P} S {S} limbs {n_limbs} "
                  f"k_splits {k} ({(Q // 128) * (S // 128) * k} blocks): "
                  f"== plain {eq}, {t:.4f} ms, {ops / t / 1e9:.1f} Tops; "
                  f"queued {tq:.4f} ms, {ops / tq / 1e9:.1f} Tops; host "
                  f"{_host_us(fn, 10):.1f} us a call", flush=True)
        A = torch.from_numpy(rng.integers(-128, 128, size=(Q, P),
                                          dtype=np.int8)).to(dev)
        print(f"torch._int_mm Q {Q} P {P} S {S}: "
              f"{_ms(lambda: torch._int_mm(A, B), 10):.4f} ms", flush=True)
        del H, C0, want, A


def run() -> None:
    dev = torch.device("cuda")
    _cuda.lib()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("\n".join(_ptxas(_cuda.build_log())))
    print(f"dynamic shared memory {_cuda.lib().kmerdb_gram_u8_smem_bytes()} "
          f"bytes a block")

    rng = np.random.default_rng(1)
    P, S = 10496, 4096
    B = torch.from_numpy((rng.random((P, S)) < 0.3).astype(np.int8)).to(dev)
    w = _weights(rng, P, dev)
    nt = S // 128
    for n_limbs in (1, 4):
        for name, frac in (("gram_u32_tri", (nt + 1) / (2 * nt)),
                           ("gram_u32", 1.0)):
            kern, plain = getattr(gram, name), getattr(gram, name + "_plain")
            eq = torch.equal(kern(B, w, n_limbs=n_limbs),
                             plain(B, w, n_limbs=n_limbs))
            t = _ms(lambda: kern(B, w, n_limbs=n_limbs), 10)
            ops = 2.0 * P * S * S * frac * n_limbs
            print(f"{name} P {P} S {S} limbs {n_limbs}: == plain {eq}, "
                  f"{t:.4f} ms, {ops / t / 1e9:.1f} Tops", flush=True)
    Bt = B.T.contiguous()
    print(f"torch._int_mm P {P} S {S}: {_ms(lambda: torch._int_mm(Bt, B), 10):.4f} ms")
    del Bt
    _matmul_cases(rng, B, dev)
    del B

    S, P, kt, tile = 2048, 1 << 17, 512, 128
    Bi, Bj = (torch.from_numpy(rng.integers(-128, 128, size=(P, S),
                                            dtype=np.int8)).to(dev)
              for _ in range(2))
    wz = torch.zeros(P, dtype=torch.int32, device=dev)
    C = torch.zeros((S, S), dtype=torch.int32, device=dev)
    kern = sweep.KERNELS["dotonly_s8"]
    eq = torch.equal(kern(wz, Bi, Bj, C.clone(), kt=kt, tile=tile),
                     sweep.plain("dotonly_s8", wz, Bi, Bj, C.clone(), kt=kt,
                                 tile=tile))
    t = _ms(lambda: kern(wz, Bi, Bj, C, kt=kt, tile=tile), 6)
    ops = 2.0 * P * S * S * (S // tile + 1) / (2 * (S // tile))
    A = Bi.T.contiguous()
    tl = _ms(lambda: torch._int_mm(A, Bj), 6)
    print(f"dotonly_s8 signed S {S} P {P}: == plain {eq}, {t:.4f} ms, "
          f"{ops / t / 1e9:.1f} Tops; torch._int_mm {tl:.4f} ms", flush=True)
    del Bi, Bj, A

    rng = np.random.default_rng(2)
    for S, P in ((2048, 1 << 16), (4096, 1 << 16)):
        nt = S // 128
        blocks = nt * (nt + 1) // 2
        per = min(blocks, RESIDENT)
        B = torch.from_numpy((rng.random((P, S)) < 0.3).astype(np.int8)) \
            .to(dev)
        w = _weights(rng, P, dev)
        ops = 2.0 * P * 128 * 128 * blocks
        C = torch.zeros((S, S), dtype=torch.int32, device=dev)
        wz = torch.zeros(P, dtype=torch.int32, device=dev)
        for name, fn in (
                ("gram_u32_tri", lambda: gram.gram_u32_tri(B, w, n_limbs=1)),
                ("dotonly_s8", lambda: sweep.KERNELS["dotonly_s8"](
                    wz, B, B, C, kt=512, tile=128))):
            t = _ms(fn, 10)
            print(f"{name} S {S} P {P}, {blocks} blocks: {t:.4f} ms, "
                  f"{ops / t / 1e9:.1f} Tops, {ops / t / 1e9 / per:.3f} Tops "
                  f"a resident block", flush=True)
        Bt = B.T.contiguous()
        t = _ms(lambda: torch._int_mm(Bt, B), 10)
        print(f"torch._int_mm S {S} P {P} (full square): {t:.4f} ms, "
              f"{2.0 * P * S * S / t / 1e9:.1f} Tops", flush=True)
        del B, Bt


def main(argv=None) -> int:
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("gram_u8_rate measures a CUDA card: "
              "torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
