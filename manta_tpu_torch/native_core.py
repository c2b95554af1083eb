"""Load the native core on hosts with or without libdeflate.

The core (``native/libmanta_core.so``, built from
``native/manta_core.cpp`` and loaded by the port's ``_native``)
links ``libdeflate.so.0`` for BGZF inflate and deflate. Where the host
has no such library, the subset of its ABI the core uses is built from
``csrc/deflate_compat.c`` over zlib, under the soname ``libdeflate.so.0``,
and loaded before the core, so the dynamic loader resolves the core's
dependency to it. Child processes (fork workers, a workload generator,
``_native``'s own ``g++ ... -ldeflate`` rebuild) find it
through ``LD_LIBRARY_PATH`` and ``LIBRARY_PATH``, which ``load`` extends
in that case.
"""

from __future__ import annotations

import ctypes
import os

from . import _build

SONAME = "libdeflate.so.0"


def _prepend_env(var: str, path: str) -> None:
    old = os.environ.get(var)
    os.environ[var] = path if not old else f"{path}{os.pathsep}{old}"


def ensure_libdeflate() -> str | None:
    """Make ``libdeflate.so.0`` resolvable in this process. Returns the
    compat library's path where it had to be built, else None."""
    try:
        ctypes.CDLL(SONAME, mode=ctypes.RTLD_GLOBAL)
        return None
    except OSError:
        pass
    path = _build.build_host("deflate_compat", SONAME, ["-l:libz.so.1"])
    ctypes.CDLL(path, mode=ctypes.RTLD_GLOBAL)
    link = os.path.join(_build.BUILD_DIR, "libdeflate.so")
    if not os.path.lexists(link):
        try:
            os.symlink(SONAME, link)
        except FileExistsError:   # a concurrent loader made it
            pass
    if _build.BUILD_DIR not in os.environ.get("LD_LIBRARY_PATH", ""):
        _prepend_env("LD_LIBRARY_PATH", _build.BUILD_DIR)
        _prepend_env("LIBRARY_PATH", _build.BUILD_DIR)
    return path


def load() -> ctypes.CDLL:
    """The native core, loaded once per process. Raises RuntimeError
    naming what the loader could not find."""
    ensure_libdeflate()
    from . import _native
    try:
        return _native.get_lib()
    except OSError as e:
        raise RuntimeError(
            f"cannot load the native core: {e}") from e
