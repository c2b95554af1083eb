"""Build-at-first-use for the port's native sources under ``csrc/``.

A CUDA kernel is one ``csrc/<name>.cu`` file with a plain C interface
(it may include the shared ``csrc/*.cuh`` headers), compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/lib<name>.so`` and loaded with
``ctypes``. A host helper is one ``csrc/<name>.c`` file compiled by the
C compiler. A library is rebuilt when its source or a header is newer,
the same rule as ``_native.py``. Nothing here runs at
import time, so hosts without ``nvcc`` import the package freely.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> seconds the last build of that library took in this process
BUILD_SECONDS: dict[str, float] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source at "
                       "first use")


def _compile(name: str, src: str, out: str, cmd_head: list[str],
             cmd_tail: list[str], headers: tuple[str, ...] = ()) -> str:
    """Run one compiler command into ``out`` if it is missing or older
    than ``src`` or one of ``headers``. The compiler's output is kept in
    ``build/<out>.log`` (for nvcc: registers, shared memory and spills
    per kernel)."""
    if os.path.exists(out) and os.path.getmtime(out) >= max(
            os.path.getmtime(p) for p in (src, *headers)):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [*cmd_head, "-o", tmp, src, *cmd_tail]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    with open(f"{out}.log", "w") as f:
        f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"building {src} failed:\n{res.stderr}")
    os.replace(tmp, out)          # atomic for concurrent builds
    return out


def build(name: str) -> str:
    """Compile the CUDA source ``csrc/<name>.cu`` for sm_90a if needed;
    return the library path."""
    return _compile(name, os.path.join(CSRC_DIR, f"{name}.cu"),
                    os.path.join(BUILD_DIR, f"lib{name}.so"),
                    [find_nvcc(), *NVCC_FLAGS], [],
                    tuple(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))))


def build_host(name: str, soname: str, libs: list[str]) -> str:
    """Compile the C source ``csrc/<name>.c`` into ``build/<soname>``
    (with that soname) if needed; return the library path."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError(f"no C compiler to build csrc/{name}.c")
    return _compile(name, os.path.join(CSRC_DIR, f"{name}.c"),
                    os.path.join(BUILD_DIR, soname),
                    [cc, "-O2", "-shared", "-fPIC", f"-Wl,-soname,{soname}"],
                    libs)


def load(name: str) -> ctypes.CDLL:
    """Build the CUDA library if needed, then load it (once per
    process)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(build(name))
    return lib
