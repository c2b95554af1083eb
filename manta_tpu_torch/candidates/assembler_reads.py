"""Breakend read gathering for local assembly.

Behavioral parity with the reference SVCandidateAssembler
(reference: src/c++/lib/manta/SVCandidateAssembler.cpp): search-range
expansion to >=400b, indel/semi-aligned/shadow read selection with
low-quality base N-masking and strand normalization, remote MAPQ0 mate
retrieval for large-insertion assembly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..assembly.assembler import AssemblerOptions, run_iterative_assembler
from ..core import cigar as cg
from ..core.depthsweep import DepthSweep
from ..core.readfilter import is_read_filtered_core, has_sa_tag
from ..core.svmodel import BND_LEFT_OPEN, BND_RIGHT_OPEN, SVBreakend
from ..io.bam import (
    FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED, FLAG_PAIRED,
    FLAG_READ2, FLAG_REVERSE, FLAG_UNMAPPED,
)
from ..scan.scanner import SVScanner, get_alignment

_COMP = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def revcomp(s: str) -> str:
    return s.encode().translate(_COMP)[::-1].decode()


@dataclass
class RemoteReadInfo:
    """(reference: RemoteMateReadUtil.hpp RemoteReadInfo)."""
    qname: str
    read_no: int   # the MATE's read number (to search for)
    tid: int
    pos: int
    local_pos: int
    read_size: int
    is_local_fwd: bool
    is_found: bool = False
    is_used: bool = False


class BreakendReadAssembler:
    """Gathers reads around breakends and runs the iterative assembler."""

    MAX_NUM_READS = 1000

    def __init__(self, scanner: SVScanner, readers, is_tumor: list[bool],
                 assemble_opt: AssemblerOptions,
                 chrom_depths: dict | None = None,
                 max_depth_factor: float = 12.0,
                 max_remote_depth_factor: float = 7.0):
        self.scanner = scanner
        self.readers = readers
        self.is_tumor = is_tumor
        self.opt = assemble_opt
        self.chrom_depths = chrom_depths
        self.max_depth_factor = max_depth_factor
        self.max_remote_depth_factor = max_remote_depth_factor

    def _insert_read(self, read_key: str, seq: str, qual: np.ndarray,
                     is_reversed: bool, read_index: dict, reads: list) -> bool:
        """(reference: insertAssemblyRead:75-106)."""
        if read_key in read_index:
            return False
        read_index[read_key] = len(reads)
        arr = np.frombuffer(seq.encode(), np.uint8)
        masked = np.where(qual[:len(arr)] < self.opt.min_qval,
                          np.uint8(ord("N")), arr).tobytes().decode()
        if is_reversed:
            masked = revcomp(masked)
        reads.append(masked)
        return True

    def get_breakend_reads(self, bp: SVBreakend, is_locus_reversed: bool,
                           refseq: np.ndarray, ref_offset: int,
                           search_remote_insertion: bool,
                           remote_read_cache: dict,
                           read_index: dict, reads: list):
        """(reference: getBreakendReads:230-585)."""
        beg, end = bp.interval.beg, bp.interval.end
        if end - beg < 400:
            missing = 400 - (end - beg)
            wobble = missing // 2
            sbeg = max(beg - wobble, 0)
            send = end + wobble
        else:
            sbeg, send = beg, end
        left_flank = (sbeg, beg)
        right_flank = (end, send)

        min_assemble_indel = self.scanner.opt.min_candidate_variant_size // 2
        search_right_open = bp.state != BND_LEFT_OPEN
        search_left_open = bp.state != BND_RIGHT_OPEN

        tid = bp.interval.tid
        chrom = self.scanner.chrom_names[tid]
        max_depth = None
        max_remote_depth = None
        if self.chrom_depths is not None and chrom in self.chrom_depths:
            max_depth = self.chrom_depths[chrom] * self.max_depth_factor
            max_remote_depth = self.chrom_depths[chrom] * \
                self.max_remote_depth_factor
        sweep = DepthSweep() if max_depth is not None else None
        remote_depth_triggered = False

        remote_reads: list[list[RemoteReadInfo]] = [[] for _ in self.readers]

        for bam_index, reader in enumerate(self.readers):
            is_tumor = self.is_tumor[bam_index]
            batch = reader.fetch(tid, sbeg, send)
            if batch.n == 0:
                continue
            sa = has_sa_tag(batch)
            core_bad = is_read_filtered_core(batch, sa)
            order = np.argsort(batch.pos, kind="stable")
            pos_s = batch.pos[order].astype(np.int64)
            flag_s = batch.flag[order].astype(np.int64)
            mapq_s = batch.mapq[order]
            unmapped_s = (flag_s & FLAG_UNMAPPED) != 0
            fwd_s = (flag_s & FLAG_REVERSE) == 0
            # vectorized equivalents of the scalar in-order gates: window,
            # core filter, non-strict supplement, pileup max-depth gate
            # (checked after the read's own increment; nss reads still
            # contribute depth before being skipped)
            processed = ~core_bad[order] & (pos_s < send)
            nss_s = ((flag_s & 0x800) != 0) | \
                (((flag_s & 0x100) != 0) & sa[order])
            if sweep is not None:
                lens_s = (batch.seq_off[1:] - batch.seq_off[:-1])[order]
                contrib = processed & ~unmapped_s if not is_tumor \
                    else np.zeros(batch.n, bool)
                depths = sweep.start_depth(pos_s, lens_s, contrib)
                gated = processed & ~nss_s & (pos_s >= sbeg)
                remote_trigger_s = gated & (depths > max_remote_depth)
                survivors = processed & ~nss_s & \
                    (~gated | (depths <= max_depth))
            else:
                remote_trigger_s = np.zeros(batch.n, bool)
                survivors = processed & ~nss_s

            # indel keepers: first I/D cigar op >= min_assemble_indel
            first_indel = cg.first_indel_size_batch(
                batch.cigar, batch.cigar_off)[order]
            indel_keeper_s = survivors & ~unmapped_s & \
                (first_indel >= min_assemble_indel)

            # semi-aligned keepers (batched when overlap-pair evidence is
            # off; otherwise evaluated per candidate row below)
            semi_maybe_s = np.zeros(batch.n, bool)
            if not self.scanner.opt.use_overlap_pair_evidence:
                mapped = ~core_bad & ((batch.flag & FLAG_UNMAPPED) == 0)
                batch_lead, batch_trail = \
                    self.scanner.semi_aligned_values_batch(
                        batch, mapped, refseq, ref_offset)
                lead_s = batch_lead[order]
                trail_s = batch_trail[order]
                semi_keeper_s = np.zeros(batch.n, bool)
                if search_right_open:
                    semi_keeper_s |= trail_s >= 4
                if search_left_open:
                    semi_keeper_s |= lead_s >= 4
                semi_keeper_s &= survivors & ~unmapped_s
            else:
                semi_keeper_s = None
                semi_maybe_s = survivors & ~unmapped_s

            # shadow pairing: an anchor arms the finder and the NEXT
            # surviving read consumes it, valid shadow or not (reference:
            # ShadowReadFinder::check) -- so shadows pair with their
            # immediately preceding survivor
            anchor_s = ((flag_s & FLAG_PAIRED) != 0) & ~unmapped_s & \
                ((flag_s & FLAG_MATE_UNMAPPED) != 0) & \
                (mapq_s >= self.scanner.opt.min_singleton_mapq_candidates)
            if not search_left_open:
                anchor_s &= fwd_s
            if not search_right_open:
                anchor_s &= ~fwd_s
            surv_rows = np.flatnonzero(survivors)
            prev_surv = np.full(batch.n, -1, np.int64)
            shadow_maybe_s = np.zeros(batch.n, bool)
            if surv_rows.size > 1:
                prev_surv[surv_rows[1:]] = surv_rows[:-1]
                shadow_maybe_s[surv_rows[1:]] = anchor_s[surv_rows[:-1]]
            shadow_maybe_s &= unmapped_s & \
                ((flag_s & FLAG_MATE_UNMAPPED) == 0)

            # remote-mate insertion candidates (cross-chrom / >=10kb pairs)
            if search_remote_insertion:
                mate_cand_s = survivors & \
                    ((flag_s & FLAG_PAIRED) != 0) & \
                    ((flag_s & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED)) == 0) & \
                    (mapq_s >= self.scanner.opt.min_mapq) & \
                    (batch.refid[order] >= 0) & \
                    (batch.next_refid[order] >= 0) & \
                    ((batch.refid[order] != batch.next_refid[order]) |
                     (np.abs(pos_s - batch.next_pos[order].astype(np.int64))
                      >= 10000))
            else:
                mate_cand_s = np.zeros(batch.n, bool)

            interesting = indel_keeper_s | shadow_maybe_s | mate_cand_s | \
                (semi_keeper_s if semi_keeper_s is not None else semi_maybe_s)
            capped_at = -1 if len(reads) >= self.MAX_NUM_READS else None
            cand_rows = [] if capped_at is not None else \
                np.flatnonzero(interesting).tolist()
            for k in cand_rows:
                i = int(order[k])
                flag = int(flag_s[k])
                if mate_cand_s[k]:
                    al = get_alignment(batch, i)
                    bam_range = self._matchify_ref_range(al)
                    s_left = search_left_open and not (
                        bam_range[1] > left_flank[0]
                        and bam_range[0] < left_flank[1])
                    s_right = search_right_open and not (
                        bam_range[1] > right_flank[0]
                        and bam_range[0] < right_flank[1])
                    fwd = bool(fwd_s[k])
                    ok = not ((not s_left and not fwd)
                              or (not s_right and fwd))
                    if ok:
                        remote_reads[bam_index].append(RemoteReadInfo(
                            qname=batch.name_str(i),
                            read_no=2 if not (flag & FLAG_READ2) else 1,
                            tid=int(batch.next_refid[i]),
                            pos=int(batch.next_pos[i]),
                            local_pos=int(pos_s[k]),
                            read_size=batch.read_len(i),
                            is_local_fwd=fwd))

                is_shadow_keeper = False
                if shadow_maybe_s[k]:
                    qual = batch.qual_arr(i)
                    avg_q = int(qual.sum()) // max(1, len(qual))
                    prev_i = int(order[prev_surv[k]])
                    if avg_q >= 25 and \
                            batch.name_str(i) == batch.name_str(prev_i):
                        is_shadow_keeper = True

                if semi_keeper_s is not None:
                    is_semi_keeper = bool(semi_keeper_s[k])
                else:
                    is_semi_keeper = False
                    if semi_maybe_s[k]:
                        lead, _, trail, _ = \
                            self.scanner.semi_aligned_lengths(
                                batch, i, refseq, ref_offset)
                        if search_right_open and trail >= 4:
                            is_semi_keeper = True
                        if search_left_open and lead >= 4:
                            is_semi_keeper = True

                if not (indel_keeper_s[k] or is_semi_keeper
                        or is_shadow_keeper):
                    continue

                is_reversed = is_locus_reversed
                if is_shadow_keeper and ((flag & FLAG_MATE_REVERSE) == 0):
                    is_reversed = not is_reversed
                read_no = "2" if (flag & FLAG_READ2) else "1"
                key = f"{batch.name_str(i)}_{read_no}_{bam_index}"
                self._insert_read(key, batch.seq_str(i), batch.qual_arr(i),
                                  is_reversed, read_index, reads)
                if len(reads) >= self.MAX_NUM_READS:
                    capped_at = k
                    break
            # the scalar loop stops scanning (and flagging remote-depth
            # triggers) right after the read-cap is reached
            if capped_at is None:
                remote_depth_triggered |= bool(remote_trigger_s.any())
            else:
                remote_depth_triggered |= \
                    bool(remote_trigger_s[:capped_at + 1].any())

        # remote MAPQ0 mate retrieval
        if search_remote_insertion and not remote_depth_triggered:
            for bam_index, reader in enumerate(self.readers):
                remotes = sorted(remote_reads[bam_index],
                                 key=lambda r: (r.tid, r.pos))
                for remote in remotes:
                    if len(reads) >= self.MAX_NUM_READS:
                        break
                    if remote.tid < 0:
                        continue
                    rb = reader.fetch(remote.tid, remote.pos,
                                      remote.pos + 2)
                    for j in range(rb.n):
                        fl = int(rb.flag[j])
                        jnss = bool(fl & 0x800) or (
                            bool(fl & 0x100)
                            and rb.get_tag(j, b"SA") is not None)
                        if jnss:
                            continue
                        jread_no = 2 if (fl & FLAG_READ2) else 1
                        if jread_no != remote.read_no:
                            continue
                        if rb.name_str(j) != remote.qname:
                            continue
                        remote.is_found = True
                        if rb.mapq[j] != 0:
                            break
                        is_reversed = is_locus_reversed
                        if bool(fl & FLAG_REVERSE) == bool(fl & FLAG_MATE_REVERSE):
                            is_reversed = not is_reversed
                        key = f"{remote.qname}_{jread_no}_{bam_index}"
                        if self._insert_read(key, rb.seq_str(j),
                                             rb.qual_arr(j), is_reversed,
                                             read_index, reads):
                            remote_read_cache[remote.qname] = (
                                jread_no, reads[-1])
                            remote.is_used = True
                        break
        return

    def _is_mate_insertion_candidate(self, batch, i) -> bool:
        """(reference: RemoteMateReadUtil.cpp:29-45)."""
        flag = int(batch.flag[i])
        if not (flag & FLAG_PAIRED):
            return False
        sa = batch.get_tag(i, b"SA") is not None
        if bool(flag & 0x800) or (bool(flag & 0x100) and sa):
            return False
        if flag & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED):
            return False
        if batch.mapq[i] < self.scanner.opt.min_mapq:
            return False
        if batch.refid[i] < 0 or batch.next_refid[i] < 0:
            return False
        if batch.refid[i] != batch.next_refid[i]:
            return True
        return abs(int(batch.pos[i]) - int(batch.next_pos[i])) >= 10000

    @staticmethod
    def _matchify_ref_range(al) -> tuple[int, int]:
        """(reference: matchifyEdgeSoftClipRefRange)."""
        beg = al.pos
        end = beg
        first, last = cg.match_edge_segments(al.ops)
        for k, (o, l) in enumerate(zip(al.ops.tolist(), al.lens.tolist())):
            is_edge = k < first or k > last
            if is_edge:
                if o in cg.READ_LEN_OPS:
                    if k < first:
                        beg -= l
                    else:
                        end += l
            if o in cg.REF_LEN_OPS:
                end += l
        return (beg, end)

    # ------------------------------------------------------------------

    def assemble_complex(self, bp: SVBreakend, refseq: np.ndarray,
                         ref_offset: int, search_remote_insertion: bool,
                         remote_read_cache: dict):
        """(reference: assembleComplexSVCandidate:587-601)."""
        read_index: dict = {}
        reads: list[str] = []
        self.get_breakend_reads(bp, False, refseq, ref_offset,
                                search_remote_insertion, remote_read_cache,
                                read_index, reads)
        contigs, read_info = run_iterative_assembler(self.opt, reads)
        return contigs

    def assemble_spanning(self, bp1: SVBreakend, bp2: SVBreakend,
                          is_bp1_reversed: bool, is_bp2_reversed: bool,
                          ref1: np.ndarray, off1: int,
                          ref2: np.ndarray, off2: int):
        """(reference: assembleSpanningSVCandidate:603-625)."""
        read_index: dict = {}
        reads: list[str] = []
        cache: dict = {}
        self.get_breakend_reads(bp1, is_bp1_reversed, ref1, off1, False,
                                cache, read_index, reads)
        self.get_breakend_reads(bp2, is_bp2_reversed, ref2, off2, False,
                                cache, read_index, reads)
        contigs, read_info = run_iterative_assembler(self.opt, reads)
        return contigs
