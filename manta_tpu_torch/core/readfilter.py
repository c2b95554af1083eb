"""Vectorized read filters and pair-orientation classification.

Behavioral parity with the reference's core filters
(reference: src/c++/lib/manta/ReadFilter.cpp:32-55,
htsapi/bam_record_util.cpp:25-60, common/ReadPairOrient.hpp get_index),
expressed as boolean masks over a ReadBatch.
"""

from __future__ import annotations

import numpy as np

from ..io.bam import (
    FLAG_DUP, FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED, FLAG_PAIRED, FLAG_QCFAIL,
    FLAG_READ1, FLAG_REVERSE, FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED,
    ReadBatch, _find_tag,
)

# pair orientation codes (reference: PAIR_ORIENT enum)
ORIENT_UNKNOWN, ORIENT_FM, ORIENT_FP, ORIENT_RM, ORIENT_RP = range(5)


def has_sa_tag(batch: ReadBatch) -> np.ndarray:
    """Mask of reads carrying an SA (split alignment) tag.

    Fast path scans the raw tag blob for the b'SAZ' marker and maps hits
    to read indices; candidates are confirmed with a proper tag walk so
    'SAZ' inside another tag's string value cannot cause false positives.
    """
    cached = getattr(batch, "_sa_mask", None)
    if cached is not None:
        return cached
    out = np.zeros(batch.n, dtype=bool)
    if not batch.tags:
        batch._sa_mask = out
        return out
    blob = batch.tags
    start = 0
    cand = set()
    while True:
        i = blob.find(b"SAZ", start)
        if i < 0:
            break
        ridx = int(np.searchsorted(batch.tag_off, i, side="right")) - 1
        if 0 <= ridx < batch.n:
            cand.add(ridx)
        start = i + 1
    for ridx in cand:
        if _find_tag(blob[batch.tag_off[ridx]:batch.tag_off[ridx + 1]], b"SA") is not None:
            out[ridx] = True
    batch._sa_mask = out
    return out


def is_read_filtered_core(batch: ReadBatch, sa: np.ndarray | None = None) -> np.ndarray:
    """QC-fail/dup, and secondary/supplementary without an SA tag."""
    if sa is None:
        sa = has_sa_tag(batch)
    f = batch.flag
    bad = (f & (FLAG_QCFAIL | FLAG_DUP)) != 0
    bad |= ((f & FLAG_SUPPLEMENTARY) != 0) & ~sa
    bad |= ((f & FLAG_SECONDARY) != 0) & ~sa
    return bad


def is_read_unmapped_or_filtered_core(batch: ReadBatch, sa: np.ndarray | None = None) -> np.ndarray:
    return is_read_filtered_core(batch, sa) | ((batch.flag & FLAG_UNMAPPED) != 0)


def is_mate_insertion_evidence_candidate(batch: ReadBatch, i: int,
                                         min_mapq: int) -> bool:
    """Anomalous pair whose mate could support insertion assembly
    (reference: manta/RemoteMateReadUtil.cpp:29-45)."""
    flag = int(batch.flag[i])
    if not (flag & FLAG_PAIRED):
        return False
    if flag & FLAG_SUPPLEMENTARY:
        return False
    if (flag & FLAG_SECONDARY) and \
            batch.get_tag(i, b"SA") is not None:
        return False
    if flag & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED):
        return False
    if batch.mapq[i] < min_mapq:
        return False
    if batch.refid[i] < 0 or batch.next_refid[i] < 0:
        return False
    if batch.refid[i] != batch.next_refid[i]:
        return True
    return abs(int(batch.pos[i]) - int(batch.next_pos[i])) >= 10000


def mate_insertion_candidates_mask(batch: ReadBatch, sa: np.ndarray,
                                   min_mapq: int) -> np.ndarray:
    """Vectorized is_mate_insertion_evidence_candidate over a batch
    (sa = has_sa_tag(batch))."""
    f = batch.flag.astype(np.int64)
    return (
        ((f & FLAG_PAIRED) != 0)
        & ((f & FLAG_SUPPLEMENTARY) == 0)
        & ~(((f & FLAG_SECONDARY) != 0) & sa)
        & ((f & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED)) == 0)
        & (batch.mapq >= min_mapq)
        & (batch.refid >= 0) & (batch.next_refid >= 0)
        & ((batch.refid != batch.next_refid)
           | (np.abs(batch.pos.astype(np.int64)
                     - batch.next_pos) >= 10000))
    )


def is_mapped_pair(batch: ReadBatch) -> np.ndarray:
    f = batch.flag
    return (
        ((f & FLAG_PAIRED) != 0)
        & ((f & FLAG_UNMAPPED) == 0)
        & ((f & FLAG_MATE_UNMAPPED) == 0)
    )


def is_mapped_chrom_pair(batch: ReadBatch) -> np.ndarray:
    return is_mapped_pair(batch) & (batch.refid == batch.next_refid)


def is_innie_pair(batch: ReadBatch) -> np.ndarray:
    """FR pair on one chromosome: leftmost read forward, rightmost reverse.

    Same-position pairs count as innie when strands differ.
    """
    ok = is_mapped_chrom_pair(batch)
    fwd = (batch.flag & FLAG_REVERSE) == 0
    mate_fwd = (batch.flag & FLAG_MATE_REVERSE) == 0
    ok &= fwd != mate_fwd
    left = batch.pos < batch.next_pos
    right = batch.pos > batch.next_pos
    ok &= ~(left & ~fwd)
    ok &= ~(right & fwd)
    return ok


def is_non_strict_supplement(batch: ReadBatch, sa: np.ndarray | None = None) -> np.ndarray:
    if sa is None:
        sa = has_sa_tag(batch)
    f = batch.flag
    return ((f & FLAG_SUPPLEMENTARY) != 0) | (((f & FLAG_SECONDARY) != 0) & sa)


def pair_orientation(batch: ReadBatch) -> np.ndarray:
    """Orientation code per read, ordered by read1/read2 as in the
    reference getRelOrient (ReadGroupStatsUtil.cpp:66-79). Only
    meaningful for same-chromosome mapped pairs."""
    is_first = (batch.flag & FLAG_READ1) != 0
    fwd = (batch.flag & FLAG_REVERSE) == 0
    mate_fwd = (batch.flag & FLAG_MATE_REVERSE) == 0
    pos1 = np.where(is_first, batch.pos, batch.next_pos)
    pos2 = np.where(is_first, batch.next_pos, batch.pos)
    fwd1 = np.where(is_first, fwd, mate_fwd)
    fwd2 = np.where(is_first, mate_fwd, fwd)

    read1_left = pos1 < pos2
    diff_strand = fwd1 != fwd2
    near = np.abs(pos1 - pos2) <= 2
    left_strand = np.where(read1_left, fwd1, fwd2)

    out = np.where(
        diff_strand,
        np.where(near, ORIENT_RP, np.where(left_strand, ORIENT_RP, ORIENT_RM)),
        np.where(read1_left == fwd1, ORIENT_FP, ORIENT_FM),
    )
    return out.astype(np.int8)
