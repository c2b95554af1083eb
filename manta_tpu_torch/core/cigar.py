"""CIGAR / alignment-path algebra over (ops, lens) numpy arrays.

Behavioral parity with the reference's align_path utilities
(reference: src/c++/lib/blt_util/align_path.{hpp,cpp}): read/ref span
lengths, clip sizes, match-edge segments, swap (combined indel)
detection, soft-clip matchification.
"""

from __future__ import annotations

import numpy as np

from ..io.bam import C_D, C_EQ, C_H, C_I, C_M, C_N, C_S, C_X

# segment-type predicates as sets over op codes
READ_LEN_OPS = frozenset((C_M, C_I, C_S, C_EQ, C_X))
REF_LEN_OPS = frozenset((C_M, C_D, C_N, C_EQ, C_X))
MATCH_OPS = frozenset((C_M, C_EQ, C_X))
INDEL_OPS = frozenset((C_I, C_D))
UNALIGNED_EDGE_OPS = frozenset((C_I, C_H, C_S))

OP_CHARS = "MIDNSHP=X"


def cigar_to_arrays(cigar: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (cigar & 0xF).astype(np.int32), (cigar >> 4).astype(np.int32)


def arrays_to_string(ops: np.ndarray, lens: np.ndarray) -> str:
    return "".join(f"{l}{OP_CHARS[o]}" for o, l in zip(ops, lens))


def string_to_arrays(s: str) -> tuple[np.ndarray, np.ndarray]:
    ops, lens = [], []
    num = 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            ops.append(OP_CHARS.index(ch))
            lens.append(num)
            num = 0
    return np.array(ops, np.int32), np.array(lens, np.int32)


def first_indel_size_batch(cigar: np.ndarray,
                           cigar_off: np.ndarray) -> np.ndarray:
    """Length of the FIRST I/D op of each read's cigar (0 when none),
    vectorized over a batch's flat cigar blob. Matches the assembler's
    indel-keeper scan, which only inspects the first indel segment
    (reference: SVCandidateAssembler.cpp getBreakendReads indel check)."""
    ops = cigar & 0xF
    lens = (cigar >> 4).astype(np.int64)
    out = np.zeros(len(cigar_off) - 1, np.int64)
    idx = np.flatnonzero((ops == C_I) | (ops == C_D))
    if idx.size:
        seg = np.searchsorted(cigar_off, idx, side="right") - 1
        seg_first, first_pos = np.unique(seg, return_index=True)
        out[seg_first] = lens[idx[first_pos]]
    return out


def _sum_where(ops, lens, opset) -> int:
    # cigars are tiny (1-10 segments): a scalar loop beats np.isin ~20x
    return sum(int(l) for o, l in zip(ops.tolist(), lens.tolist())
               if o in opset)


def read_length(ops, lens) -> int:
    return _sum_where(ops, lens, READ_LEN_OPS)


def ref_length(ops, lens) -> int:
    return _sum_where(ops, lens, REF_LEN_OPS)


def matched_length(ops, lens) -> int:
    """(reference: apath_matched_length) — M/=/X segment total."""
    return _sum_where(ops, lens, (C_M, C_EQ, C_X))


def clip_lead_size(ops, lens) -> int:
    v = 0
    for o, l in zip(ops, lens):
        if o in (C_H, C_S):
            v += int(l)
        else:
            break
    return v


def clip_trail_size(ops, lens) -> int:
    v = 0
    for o, l in zip(ops[::-1], lens[::-1]):
        if o in (C_H, C_S):
            v += int(l)
        else:
            break
    return v


def soft_clip_lead_size(ops, lens) -> int:
    for o, l in zip(ops, lens):
        if o == C_S:
            return int(l)
        if o != C_H:
            break
    return 0


def soft_clip_trail_size(ops, lens) -> int:
    for o, l in zip(ops[::-1], lens[::-1]):
        if o == C_S:
            return int(l)
        if o != C_H:
            break
    return 0


def unaligned_prefix_size(ops, lens) -> int:
    """Unaligned read length (S/I; H consumes nothing) before first aligned base."""
    v = 0
    for o, l in zip(ops, lens):
        if o not in UNALIGNED_EDGE_OPS:
            return v
        if o in READ_LEN_OPS:
            v += int(l)
    return v


def unaligned_suffix_size(ops, lens) -> int:
    v = 0
    for o, l in zip(ops[::-1], lens[::-1]):
        if o not in UNALIGNED_EDGE_OPS:
            return v
        if o in READ_LEN_OPS:
            v += int(l)
    return v


def match_edge_segments(ops) -> tuple[int, int]:
    """(first, last) indices of align-match segments; (n, n) if none."""
    n = len(ops)
    first = last = n
    found = False
    for i, o in enumerate(ops):
        if o in MATCH_OPS:
            if not found:
                first = i
            found = True
            last = i
    return first, last


def is_swap_start(ops, i: int) -> bool:
    """True if segment i begins an adjacent I/D combination."""
    has_i = has_d = False
    n = len(ops)
    while i < n and ops[i] in INDEL_OPS:
        if ops[i] == C_I:
            has_i = True
        else:
            has_d = True
        i += 1
    return has_i and has_d


def swap_info(ops, lens, i: int) -> tuple[int, int, int]:
    """(n_segments, insert_len, delete_len) of the I/D run starting at i."""
    ins = dele = 0
    j = i
    n = len(ops)
    while j < n and ops[j] in INDEL_OPS:
        if ops[j] == C_I:
            ins += int(lens[j])
        else:
            dele += int(lens[j])
        j += 1
    return j - i, ins, dele


def matchify_edge_soft_clip(pos: int, ops: np.ndarray, lens: np.ndarray):
    """Convert edge soft-clip segments into match state, extending pos
    left by the leading clip (reference: SimpleAlignment.cpp
    matchifyEdgeSegmentType with SOFT_CLIP)."""
    first, last = match_edge_segments(ops)
    new_pos = pos
    out_ops: list[int] = []
    out_lens: list[int] = []
    for i, (o, l) in enumerate(zip(ops.tolist(), lens.tolist())):
        is_edge = (i < first) or (i > last)
        target = is_edge and o == C_S
        if target and i < first:
            new_pos -= l
        if target or o == C_M:
            if out_ops and out_ops[-1] == C_M:
                out_lens[-1] += l
            else:
                out_ops.append(C_M)
                out_lens.append(l)
        else:
            out_ops.append(o)
            out_lens.append(l)
    return new_pos, np.array(out_ops, np.int32), np.array(out_lens, np.int32)
