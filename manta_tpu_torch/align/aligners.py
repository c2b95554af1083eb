"""Affine-gap SWG aligners: global, two-reference jump, large-indel.

Thin ctypes bindings over the native DP core (native/manta_core.cpp),
which provides exact integer DP with the reference's recurrences and
tie-breaking (reference: src/c++/lib/alignment/GlobalAlignerImpl.hpp,
GlobalJumpAlignerImpl.hpp, GlobalLargeIndelAlignerImpl.hpp). The
native library is compiled on demand with g++ and cached.

Paths are returned as (ops, lens) numpy arrays in BAM cigar codes with
match segments post-converted to seq-match/mismatch (=/X) runs, as the
reference does for the jump aligner output.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np

from ..io.bam import C_EQ, C_M, C_X

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB = None


def _get_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    from .._native import get_lib
    lib = get_lib()
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mt_align_global.restype = ctypes.c_int
    lib.mt_align_global.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, u8p, i32p, i32p, ctypes.c_int32]
    lib.mt_align_jump.restype = ctypes.c_int
    lib.mt_align_jump.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        i32p,
        i32p, u8p, i32p, i32p,
        i32p, u8p, i32p, i32p,
        i32p, i32p, ctypes.c_int32]
    lib.mt_align_jump_intron.restype = ctypes.c_int
    lib.mt_align_jump_intron.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p,
        i32p, u8p, i32p, i32p,
        i32p, u8p, i32p, i32p,
        i32p, i32p, ctypes.c_int32]
    lib.mt_align_large_indel.restype = ctypes.c_int
    lib.mt_align_large_indel.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, u8p, i32p, i32p, ctypes.c_int32]
    _LIB = lib
    return lib


@dataclass(frozen=True)
class AlignmentScores:
    """(reference: alignment/AlignmentScores.hpp:23)."""
    match: int
    mismatch: int
    open: int
    extend: int
    off_edge: int
    allow_edge_insertion: bool = False


@dataclass
class Alignment:
    begin_pos: int = 0
    ops: np.ndarray = None
    lens: np.ndarray = None

    @property
    def is_aligned(self) -> bool:
        return self.ops is not None and len(self.ops) > 0


@dataclass
class AlignmentResult:
    score: int = 0
    align: Alignment = None
    is_jumped: bool = False


@dataclass
class JumpAlignmentResult:
    score: int = 0
    align1: Alignment = None
    align2: Alignment = None
    jump_insert_size: int = 0
    jump_range: int = 0


def add_seqmatch(query: bytes, ref: bytes, begin_pos: int,
                 ops: np.ndarray, lens: np.ndarray, query_offset: int = 0):
    """Expand M segments into =/X runs (reference:
    apath_add_seqmatch)."""
    out_ops: list[int] = []
    out_lens: list[int] = []
    qi = query_offset
    ri = begin_pos

    def push(o, l):
        if l == 0:
            return
        if out_ops and out_ops[-1] == o:
            out_lens[-1] += l
        else:
            out_ops.append(o)
            out_lens.append(l)

    for o, l in zip(ops.tolist(), lens.tolist()):
        if o == C_M:
            run_op = None
            run_len = 0
            for k in range(l):
                same = (qi + k < len(query) and ri + k < len(ref)
                        and query[qi + k] == ref[ri + k])
                op = C_EQ if same else C_X
                if op == run_op:
                    run_len += 1
                else:
                    push(run_op, run_len) if run_op is not None else None
                    run_op, run_len = op, 1
            if run_op is not None:
                push(run_op, run_len)
            qi += l
            ri += l
        else:
            push(o, l)
            from ..core import cigar as cg
            if o in cg.READ_LEN_OPS:
                qi += l
            if o in cg.REF_LEN_OPS:
                ri += l
    return np.array(out_ops, np.int32), np.array(out_lens, np.int32)


class GlobalAligner:
    def __init__(self, scores: AlignmentScores):
        self.scores = scores

    def align(self, query: bytes, ref: bytes) -> AlignmentResult:
        lib = _get_lib()
        nq, nr = len(query), len(ref)
        cap = 2 * (nq + nr) + 4
        ops = np.zeros(cap, np.uint8)
        lens = np.zeros(cap, np.int32)
        score = ctypes.c_int32()
        begin = ctypes.c_int32()
        n = ctypes.c_int32()
        s = self.scores
        rc = lib.mt_align_global(
            query, nq, ref, nr, s.match, s.mismatch, s.open, s.extend,
            s.off_edge, int(s.allow_edge_insertion),
            ctypes.byref(score), ctypes.byref(begin),
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(n), cap)
        assert rc == 0, f"mt_align_global failed: {rc}"
        k = n.value
        al = Alignment(begin.value, ops[:k].astype(np.int32), lens[:k])
        if al.is_aligned:
            al.ops, al.lens = add_seqmatch(query, ref, al.begin_pos,
                                           al.ops, al.lens)
        return AlignmentResult(score=score.value, align=al)


class GlobalJumpAligner:
    def __init__(self, scores: AlignmentScores, jump_score: int):
        self.scores = scores
        self.jump_score = jump_score

    def align(self, query: bytes, ref1: bytes, ref2: bytes,
              seqmatch: bool = True) -> JumpAlignmentResult:
        lib = _get_lib()
        nq, nr1, nr2 = len(query), len(ref1), len(ref2)
        cap = 2 * (nq + nr1 + nr2) + 4
        ops1 = np.zeros(cap, np.uint8); lens1 = np.zeros(cap, np.int32)
        ops2 = np.zeros(cap, np.uint8); lens2 = np.zeros(cap, np.int32)
        score = ctypes.c_int32(); b1 = ctypes.c_int32(); b2 = ctypes.c_int32()
        n1 = ctypes.c_int32(); n2 = ctypes.c_int32()
        jins = ctypes.c_int32(); jrange = ctypes.c_int32()
        s = self.scores
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        rc = lib.mt_align_jump(
            query, nq, ref1, nr1, ref2, nr2,
            s.match, s.mismatch, s.open, s.extend, s.off_edge, self.jump_score,
            ctypes.byref(score),
            ctypes.byref(b1), ops1.ctypes.data_as(u8p),
            lens1.ctypes.data_as(i32p), ctypes.byref(n1),
            ctypes.byref(b2), ops2.ctypes.data_as(u8p),
            lens2.ctypes.data_as(i32p), ctypes.byref(n2),
            ctypes.byref(jins), ctypes.byref(jrange), cap)
        assert rc == 0, f"mt_align_jump failed: {rc}"
        a1 = Alignment(b1.value, ops1[:n1.value].astype(np.int32), lens1[:n1.value])
        a2 = Alignment(b2.value, ops2[:n2.value].astype(np.int32), lens2[:n2.value])
        res = JumpAlignmentResult(
            score=score.value, align1=a1, align2=a2,
            jump_insert_size=jins.value, jump_range=jrange.value)
        if seqmatch:
            if a1.is_aligned:
                a1.ops, a1.lens = add_seqmatch(query, ref1, a1.begin_pos,
                                               a1.ops, a1.lens)
            if a2.is_aligned:
                from ..core import cigar as cg
                qoff = (cg.read_length(a1.ops, a1.lens) if a1.is_aligned else 0) \
                    + res.jump_insert_size
                a2.ops, a2.lens = add_seqmatch(query, ref2, a2.begin_pos,
                                               a2.ops, a2.lens, qoff)
        return res


class GlobalJumpIntronAligner:
    """Two-reference jump aligner with an RNA intron (splice) state
    (reference: alignment/GlobalJumpIntronAligner.hpp:33; intron open
    -15, intron off-edge -1 from SVRefinerOptions.hpp:48-49)."""

    def __init__(self, scores: AlignmentScores, jump_score: int,
                 intron_open_score: int, intron_off_edge_score: int):
        self.scores = scores
        self.jump_score = jump_score
        self.intron_open_score = intron_open_score
        self.intron_off_edge_score = intron_off_edge_score

    def align(self, query: bytes, ref1: bytes, ref2: bytes,
              ref1_fw: bool, ref2_fw: bool, is_stranded: bool,
              seqmatch: bool = True) -> JumpAlignmentResult:
        lib = _get_lib()
        nq, nr1, nr2 = len(query), len(ref1), len(ref2)
        cap = 2 * (nq + nr1 + nr2) + 4
        ops1 = np.zeros(cap, np.uint8); lens1 = np.zeros(cap, np.int32)
        ops2 = np.zeros(cap, np.uint8); lens2 = np.zeros(cap, np.int32)
        score = ctypes.c_int32(); b1 = ctypes.c_int32(); b2 = ctypes.c_int32()
        n1 = ctypes.c_int32(); n2 = ctypes.c_int32()
        jins = ctypes.c_int32(); jrange = ctypes.c_int32()
        s = self.scores
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        rc = lib.mt_align_jump_intron(
            query, nq, ref1, nr1, ref2, nr2,
            s.match, s.mismatch, s.open, s.extend, s.off_edge, self.jump_score,
            self.intron_open_score, self.intron_off_edge_score,
            int(ref1_fw), int(ref2_fw), int(is_stranded),
            ctypes.byref(score),
            ctypes.byref(b1), ops1.ctypes.data_as(u8p),
            lens1.ctypes.data_as(i32p), ctypes.byref(n1),
            ctypes.byref(b2), ops2.ctypes.data_as(u8p),
            lens2.ctypes.data_as(i32p), ctypes.byref(n2),
            ctypes.byref(jins), ctypes.byref(jrange), cap)
        assert rc == 0, f"mt_align_jump_intron failed: {rc}"
        a1 = Alignment(b1.value, ops1[:n1.value].astype(np.int32), lens1[:n1.value])
        a2 = Alignment(b2.value, ops2[:n2.value].astype(np.int32), lens2[:n2.value])
        res = JumpAlignmentResult(
            score=score.value, align1=a1, align2=a2,
            jump_insert_size=jins.value, jump_range=jrange.value)
        if seqmatch:
            if a1.is_aligned:
                a1.ops, a1.lens = add_seqmatch(query, ref1, a1.begin_pos,
                                               a1.ops, a1.lens)
            if a2.is_aligned:
                from ..core import cigar as cg
                qoff = (cg.read_length(a1.ops, a1.lens) if a1.is_aligned else 0) \
                    + res.jump_insert_size
                a2.ops, a2.lens = add_seqmatch(query, ref2, a2.begin_pos,
                                               a2.ops, a2.lens, qoff)
        return res


class GlobalLargeIndelAligner:
    def __init__(self, scores: AlignmentScores, large_indel_score: int):
        self.scores = scores
        self.large_indel_score = large_indel_score

    def align(self, query: bytes, ref: bytes) -> AlignmentResult:
        lib = _get_lib()
        nq, nr = len(query), len(ref)
        cap = 2 * (nq + nr) + 4
        ops = np.zeros(cap, np.uint8)
        lens = np.zeros(cap, np.int32)
        score = ctypes.c_int32(); begin = ctypes.c_int32()
        n = ctypes.c_int32(); isj = ctypes.c_int32()
        s = self.scores
        rc = lib.mt_align_large_indel(
            query, nq, ref, nr, s.match, s.mismatch, s.open, s.extend,
            s.off_edge, int(s.allow_edge_insertion), self.large_indel_score,
            ctypes.byref(score), ctypes.byref(begin), ctypes.byref(isj),
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(n), cap)
        assert rc == 0, f"mt_align_large_indel failed: {rc}"
        k = n.value
        al = Alignment(begin.value, ops[:k].astype(np.int32), lens[:k])
        if al.is_aligned:
            al.ops, al.lens = add_seqmatch(query, ref, al.begin_pos,
                                           al.ops, al.lens)
        return AlignmentResult(score=score.value, align=al,
                               is_jumped=bool(isj.value))


def jump_score_batch(jobs, scores: AlignmentScores,
                     jump_score: int) -> np.ndarray:
    """Score-only batched jump alignment over (query, ref1, ref2) byte
    triples (native mt_align_jump_score_batch). Max scores are identical
    to GlobalJumpAligner.align().score, so winner selection on these
    scores is bit-identical to aligning every job — only the winners
    need the full traceback aligner."""
    from .._native import get_lib, i32p, i64p, u8p
    lib = _get_lib()
    n = len(jobs)
    out = np.zeros(n, np.int32)
    if n == 0:
        return out

    def blob_of(seqs):
        off = np.zeros(n + 1, np.int64)
        for i, s in enumerate(seqs):
            off[i + 1] = off[i] + len(s)
        return np.frombuffer(b"".join(seqs), np.uint8), off

    qb, qo = blob_of([j[0] for j in jobs])
    r1b, r1o = blob_of([j[1] for j in jobs])
    r2b, r2o = blob_of([j[2] for j in jobs])
    rc = lib.mt_align_jump_score_batch(
        n, qb.ctypes.data_as(u8p), qo.ctypes.data_as(i64p),
        r1b.ctypes.data_as(u8p), r1o.ctypes.data_as(i64p),
        r2b.ctypes.data_as(u8p), r2o.ctypes.data_as(i64p),
        scores.match, scores.mismatch, scores.open, scores.extend,
        scores.off_edge, jump_score, out.ctypes.data_as(i32p))
    assert rc == 0, f"mt_align_jump_score_batch failed: {rc}"
    return out
