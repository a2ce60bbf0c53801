"""Build the port's C++ data-loader core:

    python -m lctvqa_torch.native.build

`lctvqa_torch.native` calls `build()` at its first use, so this command
is needed only to build ahead of time. The library goes to `build/native/`
at the repo root, named by a hash of the compiler, its flags and the
source: an edited source is rebuilt, an unchanged one is not. It is
written under a temporary name and moved into place, so processes that
build at once (test workers, data-parallel ranks) each find either no
library or a whole one. A failed build raises with the compiler's output;
nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src" / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> Path:
    """Where the library for this source, compiler and flags lives."""
    digest = hashlib.sha256(" ".join((CXX,) + FLAGS).encode()
                            + SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"liblctvqa_native_{digest}.so"


def build(verbose: bool = False) -> Path:
    """Compile src/native.cpp unless it is built already; -> its path.
    Raises RuntimeError if the compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *FLAGS, "-o", str(tmp), str(SRC)]
    if verbose:
        print(" ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode:
            raise RuntimeError(
                f"building the C++ data-loader core failed (code "
                f"{proc.returncode}): {' '.join(cmd)}\n"
                f"{(proc.stdout + proc.stderr)[-4000:]}")
        os.replace(tmp, out)
    except FileNotFoundError as exc:
        raise RuntimeError(f"the C++ compiler {CXX!r} was not found; the "
                           "data-loader core cannot be built") from exc
    finally:
        tmp.unlink(missing_ok=True)
    return out


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
    sys.exit(0)
