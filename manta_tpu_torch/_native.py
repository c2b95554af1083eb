"""Native core loader: compiles/loads libmanta_core.so and declares the
C ABI for all native entry points (aligners, BAM parsing, batch scans).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import time

from . import _build

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB = None

i32p = ctypes.POINTER(ctypes.c_int32)
i64p = ctypes.POINTER(ctypes.c_int64)
u8p = ctypes.POINTER(ctypes.c_uint8)
u16p = ctypes.POINTER(ctypes.c_uint16)
u32p = ctypes.POINTER(ctypes.c_uint32)


class MtAsmResult(ctypes.Structure):
    """Mirror of the native assembler result struct (manta_core.cpp)."""
    _fields_ = [
        ("n_contigs", ctypes.c_int32),
        ("seq_off", i64p),
        ("seq_blob", u8p),
        ("cons_beg", i32p),
        ("cons_end", i32p),
        ("sup_off", i64p),
        ("sup_idx", i32p),
        ("final_read_count", ctypes.c_int32),
        ("pseudo_start", ctypes.c_int32),
    ]


def _core_path(is_asan: bool = False) -> str:
    """The port's own build of the native core: ``build/`` holds one
    library per content of ``native/manta_core.cpp`` (a hash of it names
    the file), so neither a checkout's mtimes nor a rebuild by the JAX
    package can make it stale. One process compiles under an exclusive
    lock on ``build/<name>.lock`` while the others wait, into a
    temporary name that ``os.replace`` puts in place: no process can
    load a half-written library. Nothing under ``native/`` is written."""
    src = os.path.abspath(os.path.join(_NATIVE_DIR, "manta_core.cpp"))
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    name = "libmanta_core_asan" if is_asan else "libmanta_core"
    so = os.path.join(_build.BUILD_DIR, f"{name}.{key}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(os.path.join(_build.BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):      # no other process built it
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src,
                   "-ldeflate", "-lpthread"]
            if is_asan:
                cmd[1:1] = ["-g", "-fsanitize=address",
                            "-fno-omit-frame-pointer"]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"building {src} failed:\n{res.stderr}")
            os.replace(tmp, so)
            _build.BUILD_SECONDS[name] = time.perf_counter() - t0
    return so


def get_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    # sanitizer build mode (reference: --build-type=ASan,
    # docs/developerGuide/README.md:115-122): MANTA_TPU_ASAN=1 builds a
    # separate instrumented library; run tests with it preloaded, e.g.
    #   LD_PRELOAD=$(g++ -print-file-name=libasan.so) MANTA_TPU_ASAN=1
    lib = ctypes.CDLL(_core_path(os.environ.get("MANTA_TPU_ASAN") == "1"))

    lib.mt_bam_size.restype = ctypes.c_int
    lib.mt_bam_size.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p, i64p, i64p]
    lib.mt_bam_fill.restype = ctypes.c_int
    lib.mt_bam_fill.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i32p, i32p, u8p, u16p, i32p, i32p, i32p,
        i64p, u32p, i64p, u8p, i64p, u8p, i64p, u8p, i64p, u8p]
    ppu8 = ctypes.POINTER(ctypes.c_void_p)
    lib.mt_bam_size_multi.restype = ctypes.c_int
    lib.mt_bam_size_multi.argtypes = [
        ctypes.c_int64, ppu8, i64p, i64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p, i64p, i64p]
    lib.mt_bam_fill_multi.restype = ctypes.c_int
    lib.mt_bam_fill_multi.argtypes = [
        ctypes.c_int64, ppu8, i64p, i64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64,
        i32p, i32p, u8p, u16p, i32p, i32p, i32p,
        i64p, u32p, i64p, u8p, i64p, u8p, i64p, u8p, i64p, u8p]
    lib.mt_bgzf_deflate_batch.restype = ctypes.c_int
    lib.mt_bgzf_deflate_batch.argtypes = [
        ctypes.c_int64, u8p, i64p, ctypes.c_int32,
        u8p, ctypes.c_int64, i32p, ctypes.c_int32]
    lib.mt_bam_depth_cols.restype = ctypes.c_int64
    lib.mt_bam_depth_cols.argtypes = [
        ctypes.c_int64, ppu8, i64p,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        i32p, u16p, i32p]
    lib.mt_split_read_scan.restype = ctypes.c_int
    lib.mt_split_read_scan.argtypes = [
        u8p, ctypes.c_int32, u8p,
        u8p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), i32p]
    fp = ctypes.POINTER(ctypes.c_float)
    lib.mt_split_read_scan_multi.restype = ctypes.c_int
    lib.mt_split_read_scan_multi.argtypes = [
        ctypes.c_int64, i64p, i64p, u8p, i64p, u8p,
        ctypes.c_int32, u8p, i64p, i32p, i32p,
        ctypes.c_int32, fp, fp, ctypes.c_float, fp, i32p]
    lib.mt_semi_aligned_batch.restype = ctypes.c_int
    lib.mt_semi_aligned_batch.argtypes = [
        ctypes.c_int64, i32p, i64p, u32p, i64p, u8p,
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i32p, i32p, i32p, i32p]
    lib.mt_has_tag.restype = ctypes.c_int
    lib.mt_has_tag.argtypes = [
        ctypes.c_int64, i64p, ctypes.c_char_p,
        ctypes.c_char, ctypes.c_char, u8p]
    lib.mt_mate_ref_len.restype = ctypes.c_int
    lib.mt_mate_ref_len.argtypes = [
        ctypes.c_int64, i64p, ctypes.c_char_p, i64p, i32p]
    lib.mt_mate_align_stats.restype = ctypes.c_int
    lib.mt_mate_align_stats.argtypes = [
        ctypes.c_int64, i64p, ctypes.c_char_p, i64p,
        i32p, i32p, i32p, i32p]
    lib.mt_matchify_ranges.restype = ctypes.c_int
    lib.mt_matchify_ranges.argtypes = [
        ctypes.c_int64, i32p, i64p, u32p, i32p, i32p]
    lib.mt_depth_pileup.restype = ctypes.c_int
    lib.mt_depth_pileup.argtypes = [
        ctypes.c_int64, i64p, i32p, i64p, u32p,
        ctypes.c_int64, ctypes.c_int64, i32p]
    lib.mt_assemble.restype = ctypes.c_int
    lib.mt_assemble.argtypes = [
        ctypes.c_int64, i64p, u8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(MtAsmResult))]
    lib.mt_assemble_free.restype = None
    lib.mt_assemble_free.argtypes = [ctypes.POINTER(MtAsmResult)]
    lib.mt_split_finalize_multi.restype = ctypes.c_int
    lib.mt_split_finalize_multi.argtypes = [
        ctypes.c_int64, i64p, i64p, u8p,
        ctypes.c_int32, u8p, i64p, i32p, i32p, i32p, i32p]
    lib.mt_rans_uncompress.restype = ctypes.c_int
    lib.mt_rans_uncompress.argtypes = [
        u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    lib.mt_align_jump_score_batch.restype = ctypes.c_int
    lib.mt_align_jump_score_batch.argtypes = [
        ctypes.c_int64, u8p, i64p, u8p, i64p, u8p, i64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, i32p]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.mt_frag_lhood.restype = ctypes.c_int
    lib.mt_frag_lhood.argtypes = [
        ctypes.c_int64, i64p,
        u8p, u8p, u8p,
        u8p, f64p,
        u8p, u8p, u8p, f64p,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32, f64p, f64p]
    lib.mt_frag_support.restype = ctypes.c_int
    lib.mt_frag_support.argtypes = [
        ctypes.c_int64, u8p, u8p, u8p, f64p, u8p, f64p, i64p]
    lib.mt_frag_pair_split_conflicts.restype = ctypes.c_int
    lib.mt_frag_pair_split_conflicts.argtypes = [
        ctypes.c_int64, u8p, f64p, u8p, f64p, ctypes.c_int32]
    lib.mt_bam_encode.restype = ctypes.c_int
    lib.mt_bam_encode.argtypes = [
        ctypes.c_int64, i64p,
        i32p, i32p, u8p, u16p, i32p, i32p, i32p,
        i64p, u8p, i64p, u32p, i64p, u8p, i64p, u8p, i64p, u8p,
        i64p, u8p, i64p, u8p, i32p]
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.mt_graph_new.restype = ctypes.c_void_p
    lib.mt_graph_new.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_int32]
    lib.mt_graph_free.restype = None
    lib.mt_graph_free.argtypes = [ctypes.c_void_p]
    lib.mt_graph_insert_read.restype = ctypes.c_int
    lib.mt_graph_insert_read.argtypes = [ctypes.c_void_p] + \
        [ctypes.c_int32] * 11
    lib.mt_graph_clean_region.restype = ctypes.c_int
    lib.mt_graph_clean_region.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.mt_bgzf_inflate_batch.restype = ctypes.c_int
    lib.mt_bgzf_inflate_batch.argtypes = [
        ctypes.c_int64, u8p, i64p, i32p, u8p, i64p, ctypes.c_int32]
    lib.mt_bgzf_index_range.restype = ctypes.c_int64
    lib.mt_bgzf_index_range.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i64p, i64p, i32p, i32p]
    lib.mt_graph_clean_stride.restype = ctypes.c_int
    lib.mt_graph_clean_stride.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64]
    lib.mt_graph_merge_graph.restype = ctypes.c_int
    lib.mt_graph_merge_graph.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.mt_graph_finalize.restype = ctypes.c_int64
    lib.mt_graph_finalize.argtypes = [ctypes.c_void_p]
    lib.mt_graph_load.restype = ctypes.c_int
    lib.mt_graph_load.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, i64p, i64p, i64p]
    lib.mt_graph_set_stats.restype = None
    lib.mt_graph_set_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32]
    lib.mt_graph_counts.restype = None
    lib.mt_graph_counts.argtypes = [ctypes.c_void_p, i64p, i64p, i64p]
    lib.mt_graph_export.restype = ctypes.c_int
    lib.mt_graph_export.argtypes = [
        ctypes.c_void_p, i64p, i64p, i64p, i64p, i64p,
        ctypes.POINTER(ctypes.c_double), i32p, i32p]
    lib.mt_frag_new.restype = ctypes.c_void_p
    lib.mt_frag_new.argtypes = []
    lib.mt_frag_free.restype = None
    lib.mt_frag_free.argtypes = [ctypes.c_void_p]
    lib.mt_frag_scan.restype = ctypes.c_int
    lib.mt_frag_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        i32p, i32p, i32p, i32p, u8p, u8p, i8p, i32p, i64p, u8p,
        ctypes.c_int32, ctypes.c_int64,
        i8p, i32p, i64p, i64p]
    lib.mt_tag_zmatch.restype = ctypes.c_int
    lib.mt_tag_zmatch.argtypes = [
        ctypes.c_int64, i64p, u8p, ctypes.c_char, ctypes.c_char,
        u8p, ctypes.c_int32, u8p]
    lib.mt_gather_ragged.restype = ctypes.c_int
    lib.mt_gather_ragged.argtypes = [
        ctypes.c_int64, i64p, i64p, u8p, ctypes.c_int32, i64p, u8p]
    lib.mt_semi_aligned_batch_idx.restype = ctypes.c_int
    lib.mt_semi_aligned_batch_idx.argtypes = [
        ctypes.c_int64, i64p, i32p, i64p, u32p, i64p, u8p,
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i64p, u8p, ctypes.c_int32,
        i32p, i32p, i32p, i32p, i32p, i32p]
    _LIB = lib
    return lib
