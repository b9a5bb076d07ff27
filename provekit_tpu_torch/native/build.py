"""Build the port's two host libraries with ``g++``.

    python -m provekit_tpu_torch.native.build

The curve engine (``curve.cpp``, the Groth16 wrap's host work) and the host
library (``solver.cpp`` over ``field256.hpp``: the witness solve, the
Skyscraper permutation and compression, Merkle path checks) build from this
package's own sources, at first use, into ``build/provekit_tpu_torch/`` at
the root of the checkout, as ``kernels.py`` builds the CUDA kernels.  A
library's file name carries a hash of its sources, the flags and the host's
name, since ``-march=native`` builds for the CPU it runs on.  Processes that
build at once each compile into a temporary file of their own and rename it
into place.  There is no fallback: a build that fails raises with the
compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent.parent / "build" / "provekit_tpu_torch"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]


@dataclass(frozen=True)
class Library:
    name: str
    sources: tuple  # the file compiled, then the headers it includes
    link_flags: tuple = ()


CURVE = Library("libpkcurve", (HERE / "curve.cpp",), ("-lpthread",))
HOST = Library("libpkhost", (HERE / "solver.cpp", HERE / "field256.hpp"))
LIBRARIES = (CURVE, HOST)

_lock = threading.Lock()


def library_path(lib: Library) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + list(lib.link_flags)).encode())
    h.update(platform.node().encode())
    for src in lib.sources:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{lib.name}_{h.hexdigest()[:16]}.so"


def make(lib: Library) -> Path:
    """Compile ``lib`` unless it is up to date; returns its path.  Raises
    with the compiler's output when the build fails."""
    with _lock:
        out = library_path(lib)
        if out.exists():
            return out
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found: {lib.name} cannot be built")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                               str(lib.sources[0]), *lib.link_flags],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                               f"{lib.sources[0]}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        return out


def main() -> int:
    for lib in LIBRARIES:
        t0 = time.perf_counter()
        path = make(lib)
        print(f"{path} ({time.perf_counter() - t0:.3f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
