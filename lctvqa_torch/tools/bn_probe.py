"""Where a BatchNorm kernel call's time goes, on the card.

    python -m lctvqa_torch.tools.bn_probe --variants base nohint base
    python -m lctvqa_torch.tools.bn_probe --host

`--variants` builds `csrc/bn.cu` alone once per named variant (a source
edit, e.g. the L2 policies off) into `build/bn_probe/<name>/`, with
`%globaltimer` marks at the phase boundaries of both kernels, and runs
each on the same seeded inputs at the supernet's shapes: the device time
of the kernel and of the memset (torch.profiler, every call of the window
seen), the launch shape its own `lctvqa_bn_plan` gives, the median and
largest time of each phase over the blocks (the rows read from device
memory with the copies issued, the staged rows, the block's sums and the
barrier, the sums after it, the stores), when the blocks arrive at the
barrier, and the error against the formulas in fp32. Names repeat to run
a variant again in the same process. `--host` times a wrapper call's host
enqueue and its parts (the allocations, the ctypes call, the plan).
Needs CUDA PyTorch and nvcc; not part of any test or of chip_smoke.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parents[1] / "csrc"
OUT = Path(__file__).resolve().parents[2] / "build" / "bn_probe"
F32, BF16 = torch.float32, torch.bfloat16
CODE = {F32: 0, BF16: 1}
MARKS = [  # (text of bn.cu, the same with a phase mark), both kernels
    ("const int C = L.C;\n", "const int C = L.C;\n  mark(0);\n"),
    ("    int lo = 0;\n", "    if (g0 == 0) mark(1);\n    int lo = 0;\n"),
    ("    block_partial<VEC, NT>(",
     "    if (g0 == 0) mark(2);\n    block_partial<VEC, NT>("),
    ("  seq::grid_wait(ctr, gridDim.x);\n",
     "  seq::grid_wait(ctr, gridDim.x);\n  mark(3);\n"),
    ("  __syncthreads();\n\n  for (int g0 = 0; g0 < groups; g0 += lanes) {\n",
     "  __syncthreads();\n  mark(4);\n\n"
     "  for (int g0 = 0; g0 < groups; g0 += lanes) {\n"),
    ("      store_out<kHint, TO, VEC>(yb + at, v);\n    }\n  }\n}",
     "      store_out<kHint, TO, VEC>(yb + at, v);\n    }\n  }\n"
     "  __syncthreads();\n  mark(5);\n}"),
    ("      store_out<kHint, T, VEC>(db + at, v);\n    }\n  }\n}",
     "      store_out<kHint, T, VEC>(db + at, v);\n    }\n  }\n"
     "  __syncthreads();\n  mark(5);\n}"),
]
CLOCK = '''
__device__ unsigned long long bn_clk[264 * 8];
__device__ __forceinline__ void mark(int i) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    bn_clk[blockIdx.x * 8 + i] = t;
  }
}
'''
READ = '''
extern "C" int bn_clk_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lctvqa::bn_clk, sizeof(lctvqa::bn_clk));
}
'''
HINT = "constexpr bool kHint = NT == kManyThreads;"
VARIANTS = {  # name -> source edits
    "base": [],
    "nohint": [(HINT, "constexpr bool kHint = false;")],
    "allhint": [(HINT, "constexpr bool kHint = true;")],
    "t512": [("kFewThreads = 256", "kFewThreads = 512")],
    "t256": [("kManyThreads = 512", "kManyThreads = 256")],
}
CASES = [  # (shape, x dtype, y or g dtype, backward)
    ((64, 64, 64, 32), F32, BF16, False), ((64, 64, 64, 32), F32, F32, False),
    ((64, 64, 64, 32), BF16, BF16, False), ((64, 64, 64, 32), F32, BF16, True),
    ((64, 64, 64, 32), F32, F32, True), ((64, 64, 64, 16), F32, BF16, True),
    ((64, 32, 32, 64), F32, BF16, False), ((64, 32, 32, 64), F32, BF16, True),
    ((64, 16, 16, 64), F32, BF16, False), ((64, 16, 16, 64), F32, BF16, True),
    ((64, 32, 32, 8), BF16, BF16, False), ((64, 32, 32, 8), BF16, BF16, True),
    ((64, 16, 16, 16), F32, F32, False), ((64, 16, 16, 16), F32, F32, True),
    ((64, 32, 32, 8), F32, BF16, False), ((64, 32, 32, 8), F32, BF16, True),
    ((64, 16, 16, 16), F32, BF16, False), ((64, 16, 16, 16), F32, BF16, True)]


def build(name: str) -> subprocess.Popen:
    """Start nvcc on variant `name` of bn.cu with the marks; the library
    is OUT / name / libbn.so."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for h in ("fragments.cuh", "lstm_common.cuh", "lstm_seq.cuh"):
        shutil.copy(SRC / h, d / h)
    s = (SRC / "bn.cu").read_text()
    for a, b in VARIANTS[name] + MARKS:
        if a not in s:
            raise ValueError(f"{name}: bn.cu has no {a!r}")
        s = s.replace(a, b)
    s = s.replace("namespace lctvqa {\nnamespace {\nnamespace bn {",
                  "namespace lctvqa {\n" + CLOCK
                  + "namespace {\nnamespace bn {") + READ
    (d / "bn.cu").write_text(s)
    cmd = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(d / "libbn.so"),
           str(d / "bn.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _device_us(fn, iters=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kern = [e.time_range.elapsed_us() for e in ks if "bn_" in e.name]
    other = [e.time_range.elapsed_us() for e in ks if "bn_" not in e.name]
    return sum(kern) / iters, sum(other) / iters, len(ks) / iters


def run(name: str) -> None:
    lib = ctypes.CDLL(str(OUT / name / "libbn.so"))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lctvqa_bn_plan.argtypes = [LL, I, I, I, ctypes.POINTER(I * 5)]
    lib.lctvqa_bn_fwd.argtypes = [P] * 4 + [I, LL, I, ctypes.c_float, I, I, P]
    lib.lctvqa_bn_bwd.argtypes = [P] * 5 + [I, LL, I, I, I, P]
    lib.bn_clk_read.argtypes = [P]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for shape, xd, od, bwd in CASES:
        c, m = shape[-1], shape[0] * shape[1] * shape[2]
        gen = torch.Generator().manual_seed(5)
        x = (1.5 * torch.randn(shape, generator=gen) + 0.3).to(dev, xd)
        g = torch.randn(shape, generator=gen).to(dev, od)
        plans = {}
        for back in (False, True):
            p = (I * 5)()
            rc = lib.lctvqa_bn_plan(m, c, CODE[xd], CODE[od] if back else -1,
                                    ctypes.byref(p))
            if rc:
                raise RuntimeError(f"lctvqa_bn_plan: cudaError {rc}")
            plans[back] = list(p)
        scratch = {b: torch.empty(4 + p[0] * 2 * c, dtype=F32, device=dev)
                   for b, p in plans.items()}
        stat = torch.empty(2, c, dtype=F32, device=dev)
        y = torch.empty(shape, dtype=F32 if bwd else od, device=dev)
        dx = torch.empty(shape, dtype=xd, device=dev)

        def fwd():
            return lib.lctvqa_bn_fwd(
                x.data_ptr(), y.data_ptr(), stat.data_ptr(),
                scratch[False].data_ptr(), plans[False][0], m, c, 1e-5,
                CODE[xd], CODE[y.dtype], stream)

        def bwd_call():
            return lib.lctvqa_bn_bwd(
                x.data_ptr(), g.data_ptr(), stat.data_ptr(), dx.data_ptr(),
                scratch[True].data_ptr(), plans[True][0], m, c, CODE[xd],
                CODE[od], stream)

        fn = bwd_call if bwd else fwd
        for call in (fwd, fn):
            rc = call()
            if rc:
                raise RuntimeError(f"launch: cudaError {rc}")
        torch.cuda.synchronize()
        k_us, other_us, ops = _device_us(fn)
        fn()
        torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * (264 * 8))()
        lib.bn_clk_read(ctypes.cast(clk, P))
        blocks = plans[bwd][0]
        t = [[clk[b * 8 + i] for i in range(6)] for b in range(blocks)]
        t0 = min(r[0] for r in t)
        phases = []
        for i in range(1, 6):
            d = [r[i] - r[i - 1] for r in t]
            phases.append(f"{statistics.median(d) / 1e3:.1f}/"
                          f"{max(d) / 1e3:.1f}")
        arrive = [r[2] - t0 for r in t]
        x32 = x.float()
        mean = x32.mean((0, 1, 2))
        rstd = torch.rsqrt((x32 * x32).mean((0, 1, 2)) - mean * mean + 1e-5)
        xh = (x32 - mean) * rstd
        if bwd:
            g32 = g.float()
            want = rstd * (g32 - g32.mean((0, 1, 2))
                           - xh * (g32 * xh).mean((0, 1, 2)))
            err = float((dx.float() - want).abs().max() / want.abs().max())
        else:
            err = float((y.float() - xh).abs().max())
        print(f"{name:8s} {'bwd' if bwd else 'fwd'} {list(shape)} "
              f"{str(xd)[6:]} {str(od)[6:]}: kernel {k_us:.1f} us + memset "
              f"{other_us:.1f} ({ops:g} ops); plan {plans[bwd]}; phases "
              f"med/max us: tail {phases[0]}, staged {phases[1]}, barrier "
              f"{phases[2]}, finish {phases[3]}, write {phases[4]}; arrive "
              f"{min(arrive) / 1e3:.1f}..{max(arrive) / 1e3:.1f}; span "
              f"{(max(r[5] for r in t) - t0) / 1e3:.1f}; err {err:.2e}",
              flush=True)


def host() -> None:
    """Host time a call of the wrapper and of its parts (best and median
    of five rounds of 200 calls, enqueued without a synchronize)."""
    from lctvqa_torch.ops import _build as K
    from lctvqa_torch.ops import cuda_bn

    dev = torch.device("cuda")

    def per_call_us(fn, iters=200):
        fn()
        torch.cuda.synchronize()
        rounds = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            rounds.append(1e6 * (time.perf_counter() - t0) / iters)
            torch.cuda.synchronize()
        return min(rounds), statistics.median(rounds)

    for shape in ((64, 64, 64, 32), (64, 32, 32, 8)):
        c = shape[-1]
        m = shape[0] * shape[1] * shape[2]
        x = torch.randn(shape, device=dev)
        g = torch.randn(shape, device=dev).to(BF16)
        y, stat, _ = cuda_bn.batchnorm_fwd_stat(x, BF16)
        plan = cuda_bn.bn_plan(m, c, F32, BF16, False, *cuda_bn._card(0))
        lay = cuda_bn.bn_scratch(plan, c)
        buf = torch.empty((lay["rows"], c), dtype=F32, device=dev)
        scratch = buf.data_ptr() + lay["counter"]
        raw = cuda_bn.BN_FWD._bind()
        stream = torch.cuda.current_stream().cuda_stream
        parts = {
            "wrapper fwd": lambda: cuda_bn.batchnorm_fwd_stat(x, BF16),
            "wrapper bwd": lambda: cuda_bn.batchnorm_bwd(x, g, stat),
            "F.batch_norm": lambda: torch.nn.functional.batch_norm(
                x.permute(0, 3, 1, 2), None, None, training=True, eps=1e-5),
            "Kernel.launch": lambda: cuda_bn.BN_FWD.launch(
                dev, x, y, stat, scratch, plan["blocks"], m, c, 1e-5, 0, 1),
            "ctypes call": lambda: raw(
                x.data_ptr(), y.data_ptr(), stat.data_ptr(), scratch,
                plan["blocks"], m, c, 1e-5, 0, 1, stream),
            "bn_plan": lambda: cuda_bn.bn_plan(m, c, F32, BF16, False,
                                               *cuda_bn._card(0)),
            "torch.empty y": lambda: torch.empty(shape, dtype=BF16,
                                                 device=dev),
            "torch.empty scratch": lambda: torch.empty(
                (lay["rows"], c), dtype=F32, device=dev),
            "current stream": lambda: K._current_stream(
                torch.cuda.current_device()),
        }
        for name, fn in parts.items():
            best, med = per_call_us(fn)
            print(f"host {list(shape)} {name}: {best:.1f} us (median of 5 "
                  f"rounds {med:.1f})", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="*", default=[],
                        choices=sorted(VARIANTS))
    parser.add_argument("--host", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bn_probe: needs an NVIDIA GPU")
    procs = {name: build(name) for name in dict.fromkeys(args.variants)}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"bn_probe: nvcc failed for {name}:\n{out}")
    for name in args.variants:
        run(name)
    if args.host:
        host()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
