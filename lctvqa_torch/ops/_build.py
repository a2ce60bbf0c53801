"""Builds the port's CUDA kernels at first use and launches them.

The sources are `lctvqa_torch/csrc/*.cu`. At the first launch `nvcc`
compiles them for `sm_90a`, one process per source and all at once, and
links the objects into one shared library with a plain C interface, which
is loaded with `ctypes` (a few seconds, against minutes for
`torch.utils.cpp_extension.load`, whose sources include PyTorch's
headers). The library goes to `build/kernels/` at the repo root, named
by a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is not. A failed build raises; nothing falls back.

Every kernel is a `Kernel`: its C symbol, its argument types and a count
of its launches, which a run reads to show that its main path went
through the kernel.

The forward kernels of a served call are also PyTorch operators of the
namespace `lctvqa_torch` (`define_op`, used by each `cuda_*.py` beside
its kernel): the CUDA implementation is the kernel's path, the CPU one
its plain version, and a fake one gives the output's shape and dtype, so
that `torch.export` traces a serving function through them
(`export.export_programs`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

# dtype codes of the C interface (lstm_common.cuh, enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "CUDA_HOME); the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is already
    built for these exact sources; returns its path. Raises on failure.
    nvcc's output, with ptxas's register and shared-memory report, is
    kept in build/kernels/build.log."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode() + p.read_bytes())
    out = BUILD_DIR / f"liblctvqa_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmds = [[nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outputs = [proc.communicate()[0] for proc in procs]
        cmds.append([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)])
        codes = [proc.returncode for proc in procs]
        if not any(codes):
            link = subprocess.run(cmds[-1], capture_output=True, text=True,
                                  check=False)
            outputs.append(link.stdout + link.stderr)
            codes.append(link.returncode)
        log = [" ".join(cmd) + "\n" + text
               for cmd, text in zip(cmds, outputs)]
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if any(codes):
            raise RuntimeError(f"nvcc failed with codes {codes}:\n"
                               f"{''.join(log)[-6000:]}")
        os.replace(tmp, out)
    finally:
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.lctvqa_cuda_error_string.argtypes = [ctypes.c_int]
            lib.lctvqa_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong


def _current_stream(index: int) -> int:
    """PyTorch's current stream on CUDA device `index`, as a raw
    cudaStream_t."""
    return torch._C._cuda_getCurrentRawStream(index)


class Kernel:
    """One C entry point of the kernel library and its launch count.

    `launch` takes tensors (passed as device pointers) and ints in the
    order of the C function, appends PyTorch's current stream, and raises
    if the launch was refused. `launches` counts successful launches. It
    makes `device` the current one only where it is not already."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes) + [PTR]  # + the stream
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = INT
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        fn = self._fn or self._bind()
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args]
        current = torch.cuda.current_device()
        if device.index is None or device.index == current:
            rc = fn(*c_args, _current_stream(current))
        else:
            with torch.cuda.device(device):
                rc = fn(*c_args, _current_stream(device.index))
        if rc != 0:
            msg = library().lctvqa_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: kernel launch failed: {msg} "
                               f"(cudaError {rc})")
        with _lock:
            self.launches += 1


KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def reset_launch_counts() -> None:
    with _lock:
        for k in KERNELS.values():
            k.launches = 0


def launch_counts() -> Dict[str, int]:
    with _lock:
        return {name: k.launches for name, k in KERNELS.items()}


def check_cuda_tensors(name: str, **tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device; returns it. Raises otherwise."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices: "
                         f"{sorted(map(str, devices))}")
    (device,) = devices
    if device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {device}")
    return device


def check(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def dtype_code(name: str, dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: compute dtype {dtype} is not supported by "
                         "the kernel (float32 or bfloat16)")
    return DTYPE_CODES[dtype]


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

OPS_NAMESPACE = "lctvqa_torch"
_LIB = torch.library.Library(OPS_NAMESPACE, "DEF")
# the devices an operator is implemented for; a wrapper given a tensor on
# another (a meta tensor) raises as it always has
OP_DEVICES = ("cpu", "cuda")


def define_op(schema: str, cuda, cpu, fake):
    """Define `lctvqa_torch::<schema>` with its CUDA implementation (the
    kernel's path: it launches or raises), its CPU implementation (the
    plain version, run without autograd) and its fake one (shapes and
    dtypes only) -> the operator's overload, to call. The operators carry
    no gradient: a caller that needs one takes the kernel's autograd
    Function instead."""
    name = schema.split("(", 1)[0]

    def on_cpu(*args):
        with torch.no_grad():
            return cpu(*args)

    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, on_cpu, "CPU")
    torch.library.register_fake(f"{OPS_NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, OPS_NAMESPACE), name).default


def fresh(out: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    """`out`, or a copy of it where it shares memory with an input: an
    operator's output must not alias its inputs."""
    if any(out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
           for t in inputs):
        return out.clone()
    return out
