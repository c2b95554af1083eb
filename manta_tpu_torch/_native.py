"""Native core loader: compiles/loads libmanta_core.so and declares the
C ABI for all native entry points (aligners, BAM parsing, batch scans).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

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


def get_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    src = os.path.abspath(os.path.join(_NATIVE_DIR, "manta_core.cpp"))
    # sanitizer build mode (reference: --build-type=ASan,
    # docs/developerGuide/README.md:115-122): MANTA_TPU_ASAN=1 builds a
    # separate instrumented library; run tests with it preloaded, e.g.
    #   LD_PRELOAD=$(g++ -print-file-name=libasan.so) MANTA_TPU_ASAN=1
    is_asan = os.environ.get("MANTA_TPU_ASAN") == "1"
    name = "libmanta_core_asan.so" if is_asan else "libmanta_core.so"
    so = os.path.abspath(os.path.join(_NATIVE_DIR, name))
    if (not os.path.exists(so)) or \
            os.path.getmtime(so) < os.path.getmtime(src):
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", so, src,
               "-ldeflate", "-lpthread"]
        if is_asan:
            cmd[1:1] = ["-g", "-fsanitize=address",
                        "-fno-omit-frame-pointer"]
        subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(so)

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
