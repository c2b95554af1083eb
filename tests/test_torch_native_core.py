"""manta_tpu_torch.native_core: the native core over the libdeflate
compat library (csrc/deflate_compat.c), for hosts without libdeflate.

Here the host has libdeflate, so the compat library is loaded first in
a subprocess, where the dynamic loader then resolves the core's
libdeflate.so.0 to it. Byte streams are checked against Python's zlib
and gzip (exact)."""

import ctypes
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from manta_tpu_torch import _build, native_core

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def compat_path():
    return _build.build_host("deflate_compat", native_core.SONAME,
                             ["-l:libz.so.1"])


def _data():
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 200_000)]
    return bases.tobytes() + rng.integers(0, 256, 5000, np.uint8).tobytes()


def test_compat_abi_against_zlib(compat_path):
    lib = ctypes.CDLL(compat_path)
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    lib.libdeflate_alloc_compressor.restype = vp
    lib.libdeflate_alloc_compressor.argtypes = [ctypes.c_int]
    lib.libdeflate_alloc_decompressor.restype = vp
    lib.libdeflate_free_compressor.argtypes = [vp]
    lib.libdeflate_free_decompressor.argtypes = [vp]
    lib.libdeflate_deflate_compress.restype = sz
    lib.libdeflate_deflate_compress.argtypes = [vp, ctypes.c_char_p, sz,
                                                ctypes.c_char_p, sz]
    lib.libdeflate_deflate_decompress.restype = ctypes.c_int
    lib.libdeflate_deflate_decompress.argtypes = [
        vp, ctypes.c_char_p, sz, ctypes.c_char_p, sz, ctypes.POINTER(sz)]
    lib.libdeflate_crc32.restype = ctypes.c_uint32
    lib.libdeflate_crc32.argtypes = [ctypes.c_uint32, ctypes.c_char_p, sz]
    data = _data()

    comp = lib.libdeflate_alloc_compressor(12)
    out = ctypes.create_string_buffer(len(data) + 1024)
    n = lib.libdeflate_deflate_compress(comp, data, len(data), out, len(out))
    assert n > 0 and zlib.decompress(out.raw[:n], -15) == data
    assert lib.libdeflate_deflate_compress(comp, data, len(data), out, 16) \
        == 0
    lib.libdeflate_free_compressor(comp)
    assert lib.libdeflate_alloc_compressor(13) is None

    z = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = z.compress(data) + z.flush()
    dec = lib.libdeflate_alloc_decompressor()
    buf = ctypes.create_string_buffer(len(data) + 8)
    got = sz()
    assert lib.libdeflate_deflate_decompress(
        dec, raw, len(raw), buf, len(buf), ctypes.byref(got)) == 0
    assert buf.raw[:got.value] == data
    # exact-size contract without an out-length pointer: short output
    assert lib.libdeflate_deflate_decompress(
        dec, raw, len(raw), buf, len(buf), None) == 2
    assert lib.libdeflate_deflate_decompress(
        dec, raw, len(raw), buf, len(data) - 1, ctypes.byref(got)) == 3
    assert lib.libdeflate_deflate_decompress(
        dec, b"\xff" * 64, 64, buf, len(buf), ctypes.byref(got)) == 1
    lib.libdeflate_free_decompressor(dec)
    assert lib.libdeflate_crc32(0, data, len(data)) == zlib.crc32(data)
    assert lib.libdeflate_crc32(7, data, 100) == zlib.crc32(data[:100], 7)


_CHILD = r"""
import ctypes, gzip, json, sys, zlib
import numpy as np
repo, compat = sys.argv[1:3]
sys.path.insert(0, repo)
ctypes.CDLL(compat, mode=ctypes.RTLD_GLOBAL)
from manta_tpu_torch import _native
from manta_tpu_torch._native import i32p, i64p, u8p
lib = _native.get_lib()
with open("/proc/self/maps") as f:
    libs = sorted({ln.split()[-1] for ln in f if "libdeflate" in ln})
data = np.frombuffer(sys.stdin.buffer.read(), np.uint8)
P = 0xFF00
nb = -(-len(data) // P)
off = np.minimum(np.arange(nb + 1, dtype=np.int64) * P, len(data))
stride = P + 1024
out = np.empty(nb * stride, np.uint8)
sizes = np.zeros(nb, np.int32)
rc_d = lib.mt_bgzf_deflate_batch(
    nb, data.ctypes.data_as(u8p), off.ctypes.data_as(i64p), 6,
    out.ctypes.data_as(u8p), stride, sizes.ctypes.data_as(i32p), 2)
blocks = b"".join(out[k * stride:k * stride + sizes[k]].tobytes()
                  for k in range(nb))
comp = []
for k in range(nb):
    z = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp.append(z.compress(data[off[k]:off[k + 1]].tobytes()) + z.flush())
blob = np.frombuffer(b"".join(comp), np.uint8).copy()
comp_len = np.array([len(c) for c in comp], np.int32)
comp_off = np.zeros(nb, np.int64)
comp_off[1:] = np.cumsum(comp_len)[:-1]
inflated = np.empty(len(data), np.uint8)
rc_i = lib.mt_bgzf_inflate_batch(
    nb, blob.ctypes.data_as(u8p), comp_off.ctypes.data_as(i64p),
    comp_len.ctypes.data_as(i32p), inflated.ctypes.data_as(u8p),
    off.ctypes.data_as(i64p), 2)
print(json.dumps({"libs": libs, "rc_deflate": rc_d, "rc_inflate": rc_i,
                  "deflate_ok": gzip.decompress(blocks) == data.tobytes(),
                  "inflate_ok": inflated.tobytes() == data.tobytes()}))
"""


def test_native_core_bgzf_over_compat(compat_path):
    """The core's threaded BGZF deflate and inflate batches, with its
    libdeflate.so.0 resolved to the compat library."""
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, REPO, compat_path], input=_data(),
        capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    out = json.loads(proc.stdout.decode().strip().splitlines()[-1])
    assert out["libs"] == [compat_path]
    assert out["rc_deflate"] == 0 and out["rc_inflate"] == 0
    assert out["deflate_ok"] and out["inflate_ok"]


def test_load_uses_the_host_libdeflate_when_present():
    """With libdeflate.so.0 on the host nothing is built or redirected."""
    try:
        ctypes.CDLL(native_core.SONAME)
    except OSError:
        pytest.skip("this host has no libdeflate.so.0")
    assert native_core.ensure_libdeflate() is None
    assert native_core.load().mt_bgzf_inflate_batch is not None


_LOADER = r"""
import json, os, sys
repo, build_dir = sys.argv[1:3]
sys.path.insert(0, repo)
from manta_tpu_torch import _build
_build.BUILD_DIR = build_dir
from manta_tpu_torch import _native
sys.stdin.read()                  # start line: every process at once
lib = _native.get_lib()
g = lib.mt_graph_new(2, 3, 0.0, 1)
lib.mt_graph_free(g)
path = _native._core_path()
with open(path, "rb") as f:
    size = len(f.read())
print(json.dumps({"compiled": "libmanta_core" in _build.BUILD_SECONDS,
                  "path": path, "size": size}))
"""


def _native_tree():
    """Every file under native/: (size, mtime in ns, bytes)."""
    root = os.path.join(REPO, "native")
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = (
                    os.stat(path).st_mtime_ns, f.read())
    return out


def test_concurrent_loads_build_the_core_once(tmp_path):
    """More processes than cores load the port's native core at once
    from an empty build directory: exactly one compiles it, every one
    loads and calls a complete library, no temporary file is left, and
    nothing under native/ changes."""
    build_dir = str(tmp_path / "build")
    before = _native_tree()
    procs = [subprocess.Popen([sys.executable, "-c", _LOADER, REPO,
                               build_dir], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for _ in range((os.cpu_count() or 4) + 2)]
    outs = []
    for p in procs:
        p.stdin.close()
    for p in procs:
        out, err = p.stdout.read(), p.stderr.read()
        assert p.wait(timeout=300) == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert sum(o["compiled"] for o in outs) == 1
    assert len({o["path"] for o in outs}) == 1
    path = outs[0]["path"]
    assert os.path.dirname(path) == build_dir
    assert {o["size"] for o in outs} == {os.path.getsize(path)}
    assert not [n for n in os.listdir(build_dir) if n.endswith(".tmp")]
    assert _native_tree() == before


def test_core_is_keyed_by_the_source_content(tmp_path, monkeypatch):
    """The library's name carries a digest of native/manta_core.cpp, so
    a stale mtime cannot pass an old build for a new source."""
    import hashlib

    from manta_tpu_torch import _build, _native
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with open(os.path.join(REPO, "native", "manta_core.cpp"), "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    stale = tmp_path / f"libmanta_core.{'0' * 16}.so"
    stale.write_bytes(b"")
    path = _native._core_path()
    assert path == os.path.join(str(tmp_path), f"libmanta_core.{key}.so")
    assert os.path.getsize(path) > 0 and stale.read_bytes() == b""
