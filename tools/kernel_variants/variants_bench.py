"""Time design variants of the banded matvec and rolling-moments kernels on
one NVIDIA GPU, each held against the port's plain version.

    python3 tools/kernel_variants/variants_bench.py [banded|moments|all]

Builds the two variant files with nvcc into build/kernel_variants/ and, at
the shapes of chip_smoke.py (banded: x (2,047, 131,072), b = 4; moments:
2^22 x 64, w = 64 and 1,024), prints one line per variant: the median of 5
samples of 10 back-to-back launches (CUDA events), the extremes, and the
largest error against the plain version relative to its largest value.
The banded run also times a 1.07 GB `copy_` as the card's copy rate.
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "src"))
HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "kernel_variants")


def build(name: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, f"{name}.so")
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
                    os.path.join(HERE, f"{name}.cu")], check=True)
    return ctypes.CDLL(lib)


def median_ms(run) -> tuple:
    run()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(5):
        start.record()
        for _ in range(10):
            run()
        stop.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(stop) / 10)
    samples.sort()
    return samples[2], samples[0], samples[-1]


def banded(gen, dev) -> None:
    from repro_torch.kernels.banded_matvec.ref import banded_matvec_ref

    class BP(ctypes.Structure):
        _fields_ = [("coef", ctypes.c_void_p), ("x", ctypes.c_void_p), ("y", ctypes.c_void_p)] + [
            (k, ctypes.c_int) for k in ("m", "d", "b", "h", "rpc")]

    lib = build("banded_matvec_variants")
    lib.launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    m, d, b = 2047, 131072, 4
    diags = torch.randn((d, 2 * b + 1), generator=gen, device=dev) * 0.05
    x = torch.randn((m, d), generator=gen, device=dev)
    coef = diags.t().contiguous()
    want = banded_matvec_ref(diags, x)
    # (variant, rows per CTA, columns per CTA, rows staged per pass)
    for variant, rpc, cols, passes in [(0, 228, 256, 8), (0, 64, 256, 8), (1, 256, 256, 16),
                                       (2, 256, 256, 32), (3, 64, 256, 0), (3, 16, 256, 0),
                                       (4, 64, 256, 0), (5, 16, 1024, 0), (5, 64, 1024, 0)]:
        y = torch.empty_like(x)
        p = BP(coef.data_ptr(), x.data_ptr(), y.data_ptr(), m, d, b, b, rpc)
        ctas = -(-d // cols) * -(-m // rpc)
        smem = passes * (256 + 2 * b) * 4

        def run():
            if lib.launch(variant, ctypes.byref(p), ctas, smem) != 0:
                raise RuntimeError(f"variant {variant}: launch failed")
        ms, lo, hi = median_ms(run)
        err = ((y - want).abs().max() / want.abs().max()).item()
        print(f"banded variant {variant} rows/CTA {rpc}: ms {ms:.4f} (min {lo:.4f} max {hi:.4f}) "
              f"err {err:.2e} ctas {ctas}", flush=True)
    y = torch.empty_like(x)
    ms, lo, hi = median_ms(lambda: y.copy_(x))
    print(f"copy_ of 1.07 GB: ms {ms:.4f} (min {lo:.4f} max {hi:.4f})", flush=True)


def moments(gen, dev) -> None:
    from repro_torch.kernels.window_stats.ref import window_moments_ref

    class MP(ctypes.Structure):
        _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p)] + [
            (k, ctypes.c_int) for k in ("n", "d", "w", "n_out", "chain", "ctas")]

    lib = build("window_moments_variants")
    lib.launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    n, d = 2**22, 64
    x = torch.randn((n, d), generator=gen, device=dev)
    for w in (64, 1024):
        want = window_moments_ref(x, w)
        n_out = n - w + 1
        for variant, chain in [(0, 1024), (0, 2048), (0, 512), (1, 1024), (1, 2048), (1, 512),
                               (1, 256), (2, 1024), (2, 2048)]:
            out = torch.empty((n_out, 2, d), device=dev)
            per = d if variant == 0 else d // 4
            chains = -(-n_out // chain)
            p = MP(x.data_ptr(), out.data_ptr(), n, d, w, n_out, chain, -(-chains * per // 256))

            def run():
                if lib.launch(variant, ctypes.byref(p)) != 0:
                    raise RuntimeError(f"variant {variant}: launch failed")
            ms, lo, hi = median_ms(run)
            err = ((out - want).abs().max() / want.abs().max()).item()
            print(f"moments w {w} variant {variant} chain {chain}: ms {ms:.4f} (min {lo:.4f} "
                  f"max {hi:.4f}) err {err:.2e} ctas {p.ctas}", flush=True)


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    if which in ("banded", "all"):
        banded(gen, dev)
    if which in ("moments", "all"):
        moments(gen, dev)


if __name__ == "__main__":
    main()
