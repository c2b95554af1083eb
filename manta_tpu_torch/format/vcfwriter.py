"""VCF 4.1 output writers for candidate/diploid/somatic/tumor calls.

Behavioral parity with the reference format layer
(reference: src/c++/lib/format/VcfWriterSV.cpp + subclasses,
manta/JunctionIdGenerator): symbolic vs sequence alleles, BND mate
pairs, CIPOS/CIEND/HOMLEN/HOMSEQ, SVINSLEN/SVINSSEQ, EVENT ids, and the
model-specific QUAL/FILTER/FORMAT columns.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field

from ..candidates.assembler_reads import revcomp
from ..core import cigar as cg
from ..core.svmodel import (
    BND_LEFT_OPEN,
    BND_RIGHT_OPEN,
    EXT_DELETE,
    EXT_INSERT,
    EXT_INTERTRANSLOC,
    EXT_INTRATRANSLOC,
    EXT_INVERSION,
    EXT_LABELS,
    SVCandidate,
    get_extended_sv_type,
)

MAX_NON_SYMBOLIC_RECORD_SIZE = 1000


@dataclass
class SVId:
    sv_type: int = 0
    local_id: str = ""
    mate_id: str = ""

    @property
    def label(self) -> str:
        return EXT_LABELS[self.sv_type]


def make_sv_id(edge, sv: SVCandidate, is_rna: bool) -> SVId:
    """(reference: JunctionIdGenerator.cpp:26-42)."""
    sv_id = SVId()
    sv_id.sv_type = get_extended_sv_type(sv, is_rna)
    locus_index, n1, n2 = edge
    base = (f"Manta{sv_id.label}:{locus_index}:{n1}:{n2}:"
            f"{sv.candidate_index}:{sv.assembly_align_index}:"
            f"{sv.assembly_segment_index}")
    if sv_id.sv_type in (EXT_INTERTRANSLOC, EXT_INTRATRANSLOC, EXT_INVERSION):
        sv_id.mate_id = base + ":1"
        sv_id.local_id = base + ":0"
    else:
        sv_id.local_id = base
        sv_id.mate_id = ""
    return sv_id


@dataclass
class EventInfo:
    label: str = ""
    junction_count: int = 1

    @property
    def is_event(self) -> bool:
        return self.junction_count > 1


def _filters_str(filters: set) -> str:
    if not filters:
        return "PASS"
    return ";".join(sorted(filters))


class VcfFile:
    def __init__(self, path: str):
        self._f = open(path, "w")

    def write(self, s: str):
        self._f.write(s)

    def close(self):
        self._f.close()


class VcfWriterSV:
    """Base writer (reference: VcfWriterSV)."""

    def __init__(self, reference_path: str, chrom_names, chrom_lengths,
                 fasta, path: str, is_output_contig: bool = False):
        self.reference_path = reference_path
        self.chrom_names = chrom_names
        self.chrom_lengths = chrom_lengths
        self.fasta = fasta
        self.stream = VcfFile(path)
        self.is_output_contig = is_output_contig

    # -- header
    def write_header(self, prog_name, prog_version, sample_names):
        out = []
        out.append("##fileformat=VCFv4.1")
        out.append("##fileDate=" + datetime.date.today().strftime("%Y%m%d"))
        out.append(f"##source={prog_name} {prog_version}")
        out.append(f"##reference=file://{self.reference_path}")
        for name, length in zip(self.chrom_names, self.chrom_lengths):
            out.append(f"##contig=<ID={name},length={length}>")
        out.append('##INFO=<ID=IMPRECISE,Number=0,Type=Flag,Description="Imprecise structural variation">')
        out.append('##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">')
        out.append('##INFO=<ID=SVLEN,Number=.,Type=Integer,Description="Difference in length between REF and ALT alleles">')
        out.append('##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the variant described in this record">')
        out.append('##INFO=<ID=CIPOS,Number=2,Type=Integer,Description="Confidence interval around POS">')
        out.append('##INFO=<ID=CIEND,Number=2,Type=Integer,Description="Confidence interval around END">')
        out.append('##INFO=<ID=CIGAR,Number=A,Type=String,Description="CIGAR alignment for each alternate indel allele">')
        out.append('##INFO=<ID=MATEID,Number=.,Type=String,Description="ID of mate breakend">')
        out.append('##INFO=<ID=EVENT,Number=1,Type=String,Description="ID of event associated to breakend">')
        out.append('##INFO=<ID=HOMLEN,Number=.,Type=Integer,Description="Length of base pair identical homology at event breakpoints">')
        out.append('##INFO=<ID=HOMSEQ,Number=.,Type=String,Description="Sequence of base pair identical homology at event breakpoints">')
        out.append('##INFO=<ID=SVINSLEN,Number=.,Type=Integer,Description="Length of insertion">')
        out.append('##INFO=<ID=SVINSSEQ,Number=.,Type=String,Description="Sequence of insertion">')
        out.append('##INFO=<ID=LEFT_SVINSSEQ,Number=.,Type=String,Description="Known left side of insertion for an insertion of unknown length">')
        out.append('##INFO=<ID=RIGHT_SVINSSEQ,Number=.,Type=String,Description="Known right side of insertion for an insertion of unknown length">')
        if self.is_output_contig:
            out.append('##INFO=<ID=CONTIG,Number=1,Type=String,Description="Assembled contig sequence">')
        out.extend(self.add_header_info())
        out.extend(self.add_header_format())
        out.extend(self.add_header_filters())
        out.append('##ALT=<ID=DEL,Description="Deletion">')
        out.append('##ALT=<ID=INS,Description="Insertion">')
        out.append('##ALT=<ID=DUP:TANDEM,Description="Tandem Duplication">')
        key = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
        if sample_names:
            key += "\tFORMAT"
            for s in sample_names:
                key += "\t" + s
        out.append(key)
        self.stream.write("\n".join(out) + "\n")

    def add_header_info(self):
        return []

    def add_header_format(self):
        return []

    def add_header_filters(self):
        return []

    # -- per-model hooks
    def modify_info(self, event, score, info):
        pass

    def modify_transloc_info(self, sv, base_info, is_first, adata, info):
        pass

    def modify_invdel_info(self, sv, is_bp1_first, info):
        pass

    def modify_sample(self, sv, base_info, score, sample_tags):
        pass

    def write_qual(self, score) -> str:
        return "."

    def write_filter(self, score) -> str:
        return "."

    # -- record writing
    def _ref_base(self, tid, pos0, end0=None):
        chrom = self.chrom_names[tid]
        if end0 is None:
            end0 = pos0
        seq = self.fasta.fetch(chrom, pos0, end0 + 1).decode()
        return seq if seq else "N" * (end0 - pos0 + 1)

    def _hom_info(self, tid, bp_range, bp_pos_adjust, info):
        beg, end = bp_range
        if end - beg > 1:
            info.append(f"HOMLEN={end - beg - 1}")
            hom_beg = beg + bp_pos_adjust + 1
            hom_end = end + bp_pos_adjust - 1
            chrom = self.chrom_names[tid]
            seq = self.fasta.fetch(chrom, hom_beg, hom_end + 1).decode()
            info.append(f"HOMSEQ={seq}")

    def write_sv_core(self, adata, sv, sv_id, base_info, score, event,
                      force_intra_chrom_bnd=False):
        t = get_extended_sv_type(sv, force_intra_chrom_bnd)
        if t in (EXT_INTERTRANSLOC, EXT_INTRATRANSLOC, EXT_INVERSION):
            self._write_transloc(sv, sv_id, base_info, score, True, adata, event)
            self._write_transloc(sv, sv_id, base_info, score, False, adata, event)
        else:
            self._write_indel(sv, sv_id, base_info, score,
                              t in (EXT_INSERT, EXT_DELETE), event)

    def _write_transloc(self, sv, sv_id, base_info, score, is_first, adata,
                        event):
        """(reference: writeTransloc:240-370)."""
        imprecise = sv.is_imprecise
        same_shift = sv.bp1.state != sv.bp2.state
        bpa = sv.bp1 if is_first else sv.bp2
        bpb = sv.bp2 if is_first else sv.bp1
        info = []
        sample_tags = []
        chrom = self.chrom_names[bpa.interval.tid]
        mate_chrom = self.chrom_names[bpb.interval.tid]
        a_rng = (bpa.interval.beg, bpa.interval.end)
        b_rng = (bpb.interval.beg, bpb.interval.end)
        if not imprecise:
            assert (a_rng[1] - a_rng[0]) == (b_rng[1] - b_rng[0])
        pos = bpa.interval.center_pos() + 1
        mate_pos = bpb.interval.center_pos() + 1
        if not imprecise:
            pos = a_rng[0] + 1
            mate_pos = b_rng[0] + 1 if same_shift else b_rng[1]
        if pos < 1 or mate_pos < 1:
            return
        local_id = sv_id.local_id if is_first else sv_id.mate_id
        mate_id = sv_id.mate_id if is_first else sv_id.local_id
        ref = self._ref_base(bpa.interval.tid, pos - 1)
        assert len(ref) == 1
        insert_seq = sv.insert_seq
        if not (is_first or (bpa.state != bpb.state)):
            insert_seq = revcomp(insert_seq)
        if bpa.state == BND_RIGHT_OPEN:
            alt_prefix, alt_suffix = ref + insert_seq, ""
        else:
            alt_prefix, alt_suffix = "", insert_seq + ref
        alt_sep = "]" if bpb.state == BND_RIGHT_OPEN else "["
        alt = (f"{alt_prefix}{alt_sep}{mate_chrom}:{mate_pos}{alt_sep}"
               f"{alt_suffix}")
        info.append("SVTYPE=BND")
        info.append("MATEID=" + mate_id)
        if imprecise:
            info.append("IMPRECISE")
        elif self.is_output_contig:
            info.append("CONTIG=" + sv.contig_seq)
        if a_rng[1] - a_rng[0] > 1:
            info.append(f"CIPOS={a_rng[0] + 1 - pos},{a_rng[1] - pos}")
        if not imprecise:
            self._hom_info(bpa.interval.tid, a_rng, 0, info)
        if insert_seq:
            info.append(f"SVINSLEN={len(insert_seq)}")
            info.append(f"SVINSSEQ={insert_seq}")
        if event.is_event:
            info.append(f"EVENT={event.label}")
        self.modify_info(event, score, info)
        self.modify_transloc_info(sv, base_info, is_first, adata, info)
        self.modify_sample(sv, base_info, score, sample_tags)
        self._emit(chrom, pos, local_id, ref, alt, score, info, sample_tags)

    def _write_indel(self, sv, sv_id, base_info, score, is_indel, event):
        """(reference: writeIndel:390-570)."""
        imprecise = sv.is_imprecise
        same_shift = sv.bp1.state != sv.bp2.state
        bp1_first = sv.bp1.interval.beg <= sv.bp2.interval.beg
        bpa = sv.bp1 if bp1_first else sv.bp2
        bpb = sv.bp2 if bp1_first else sv.bp1
        info = []
        sample_tags = []
        chrom = self.chrom_names[sv.bp1.interval.tid]
        a_rng = (bpa.interval.beg, bpa.interval.end)
        b_rng = (bpb.interval.beg, bpb.interval.end)
        if not imprecise:
            assert (a_rng[1] - a_rng[0]) == (b_rng[1] - b_rng[0])
        small_variant = False
        if (not imprecise) and is_indel and not sv.is_unknown_size_insertion:
            delete_size = b_rng[0] - a_rng[0]
            insert_size = len(sv.insert_seq)
            small_variant = (delete_size <= MAX_NON_SYMBOLIC_RECORD_SIZE and
                             insert_size <= MAX_NON_SYMBOLIC_RECORD_SIZE)
        internal_pos = bpa.interval.center_pos()
        internal_end = bpb.interval.center_pos()
        if not imprecise:
            internal_pos = a_rng[0]
            internal_end = b_rng[0] if same_shift else b_rng[1] - 1
        pos = internal_pos + 1
        end_pos = internal_end + 1
        a_adj = -1 if bpa.state == BND_LEFT_OPEN else 0
        b_adj = -1 if bpb.state == BND_LEFT_OPEN else 0
        pos += a_adj
        end_pos += b_adj
        if pos < 1:
            return
        if small_variant:
            ref = self._ref_base(sv.bp1.interval.tid, pos - 1, end_pos - 1)
        else:
            ref = self._ref_base(sv.bp1.interval.tid, pos - 1)
        if small_variant:
            alt = ref[0] + sv.insert_seq
        else:
            alt = f"<{sv_id.label}>"
        info.append(f"END={end_pos}")
        info.append(f"SVTYPE={sv_id.label.split(':')[0]}")
        ref_len = end_pos - pos
        if not sv.is_unknown_size_insertion:
            sv_len = ref_len
            if is_indel:
                insert_len = len(sv.insert_seq)
                sv_len = insert_len if insert_len > ref_len else -ref_len
            info.append(f"SVLEN={sv_len}")
        if small_variant and sv.insert_alignment is not None:
            ops, lens = sv.insert_alignment
            cig = cg.arrays_to_string(ops, lens)
            if cig:
                info.append(f"CIGAR=1M{cig}")
        if imprecise:
            info.append("IMPRECISE")
        elif self.is_output_contig:
            info.append("CONTIG=" + sv.contig_seq)
        if a_rng[1] - a_rng[0] > 1:
            info.append(f"CIPOS={a_rng[0] - internal_pos},"
                        f"{a_rng[1] - 1 - internal_pos}")
        if not small_variant:
            if b_rng[1] - b_rng[0] > 1:
                info.append(f"CIEND={b_rng[0] - internal_end},"
                            f"{b_rng[1] - 1 - internal_end}")
        if not imprecise:
            self._hom_info(sv.bp1.interval.tid, a_rng, a_adj, info)
        if not small_variant:
            if sv.insert_seq and not sv.is_unknown_size_insertion:
                info.append(f"SVINSLEN={len(sv.insert_seq)}")
                if bp1_first or (bpa.state != bpb.state):
                    info.append(f"SVINSSEQ={sv.insert_seq}")
                else:
                    info.append(f"SVINSSEQ={revcomp(sv.insert_seq)}")
        if sv.is_unknown_size_insertion:
            if sv.unknown_size_insertion_left_seq:
                info.append(
                    f"LEFT_SVINSSEQ={sv.unknown_size_insertion_left_seq}")
            if sv.unknown_size_insertion_right_seq:
                info.append(
                    f"RIGHT_SVINSSEQ={sv.unknown_size_insertion_right_seq}")
        if event.is_event:
            info.append(f"EVENT={event.label}")
        self.modify_info(event, score, info)
        self.modify_invdel_info(sv, bp1_first, info)
        self.modify_sample(sv, base_info, score, sample_tags)
        self._emit(chrom, pos, sv_id.local_id, ref, alt, score, info,
                   sample_tags)

    def _emit(self, chrom, pos, vid, ref, alt, score, info, sample_tags):
        fields = [chrom, str(pos), vid, ref, alt, self.write_qual(score),
                  self.write_filter(score), ";".join(info)]
        if sample_tags:
            keys = [k for (k, v) in sample_tags]
            fields.append(":".join(keys))
            n_samples = max(len(v) for (k, v) in sample_tags)
            for si in range(n_samples):
                vals = []
                for (k, v) in sample_tags:
                    vals.append(v[si] if si < len(v) and v[si] else ".")
                fields.append(":".join(vals))
        self.stream.write("\t".join(fields) + "\n")


class VcfWriterCandidateSV(VcfWriterSV):
    def add_header_info(self):
        return [
            '##INFO=<ID=BND_PAIR_COUNT,Number=1,Type=Integer,Description="Confident spanning read pair count for this variant at this breakend">',
            '##INFO=<ID=PAIR_COUNT,Number=1,Type=Integer,Description="Read pairs supporting this variant where both reads are confidently mapped">',
            '##INFO=<ID=UPSTREAM_PAIR_COUNT,Number=1,Type=Integer,Description="Confident spanning pair count upstream of this variant">',
            '##INFO=<ID=DOWNSTREAM_PAIR_COUNT,Number=1,Type=Integer,Description="Confident spanning pair count downstream of this variant">',
        ]

    def modify_transloc_info(self, sv, base_info, is_first, adata, info):
        bpa = sv.bp1 if is_first else sv.bp2
        info.append(f"BND_PAIR_COUNT={bpa.get_local_pair_count()}")
        info.append(f"PAIR_COUNT={bpa.get_pair_count()}")

    def modify_invdel_info(self, sv, is_bp1_first, info):
        bpa = sv.bp1 if is_bp1_first else sv.bp2
        bpb = sv.bp2 if is_bp1_first else sv.bp1
        info.append(f"UPSTREAM_PAIR_COUNT={bpa.get_local_pair_count()}")
        info.append(f"DOWNSTREAM_PAIR_COUNT={bpb.get_local_pair_count()}")
        info.append(f"PAIR_COUNT={bpa.get_pair_count()}")

    def write_sv(self, adata, sv, sv_id):
        self.write_sv_core(adata, sv, sv_id, None, None, EventInfo())


class VcfWriterDiploidSV(VcfWriterSV):
    def __init__(self, diploid_opt, is_max_depth_filter, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.opt = diploid_opt
        self.is_max_depth_filter = is_max_depth_filter

    def add_header_info(self):
        return [
            '##INFO=<ID=JUNCTION_QUAL,Number=1,Type=Integer,Description="If the SV junction is part of an EVENT (ie. a multi-adjacency variant), this field provides the QUAL value for the adjacency in question only">',
        ]

    def add_header_format(self):
        return [
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
            '##FORMAT=<ID=FT,Number=1,Type=String,Description="Sample filter, \'PASS\' indicates that all filters have passed for this sample">',
            '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">',
            '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Normalized, Phred-scaled likelihoods for genotypes as defined in the VCF specification">',
            '##FORMAT=<ID=PR,Number=.,Type=Integer,Description="Spanning paired-read support for the ref and alt alleles in the order listed">',
            '##FORMAT=<ID=SR,Number=.,Type=Integer,Description="Split reads for the ref and alt alleles in the order listed, for reads where P(allele|read)>0.999">',
        ]

    def add_header_filters(self):
        o = self.opt
        out = []
        if self.is_max_depth_filter:
            out.append(f'##FILTER=<ID=MaxDepth,Description="Depth is greater than {o.max_depth_factor:g}x the median chromosome depth near one or both variant breakends">')
        out.append(f'##FILTER=<ID=MaxMQ0Frac,Description="For a small variant (<1000 bases), the fraction of reads in all samples with MAPQ0 around either breakend exceeds {o.max_mq0_frac:g}">')
        out.append('##FILTER=<ID=NoPairSupport,Description="For variants significantly larger than the paired read fragment size, no paired reads support the alternate allele in any sample.">')
        out.append(f'##FILTER=<ID=MinQUAL,Description="QUAL score is less than {o.min_pass_alt_score}">')
        out.append('##FILTER=<ID=SampleFT,Description="No sample passes all the sample-level filters (at the field FORMAT/FT)">')
        out.append(f'##FILTER=<ID=MinGQ,Description="GQ score is less than {o.min_pass_gt_score} (filter applied at sample level)">')
        out.append('##FILTER=<ID=HomRef,Description="homozygous reference call (filter applied at sample level)">')
        return out

    def modify_info(self, event, score, info):
        diploid, single = score
        if event.is_event:
            info.append(f"JUNCTION_QUAL={single.alt_score}")

    def modify_transloc_info(self, sv, base_info, is_first, adata, info):
        info.append(f"BND_DEPTH="
                    f"{base_info.bp1_max_depth if is_first else base_info.bp2_max_depth}")
        info.append(f"MATE_BND_DEPTH="
                    f"{base_info.bp2_max_depth if is_first else base_info.bp1_max_depth}")

    def write_qual(self, score):
        return str(score[0].alt_score)

    def write_filter(self, score):
        return _filters_str(score[0].filters)

    def modify_sample(self, sv, base_info, score, sample_tags):
        diploid = score[0]
        n = len(diploid.samples)
        gt_labels = ["0/0", "0/1", "1/1"]
        sample_tags.append(("GT", [gt_labels[s.gt] for s in diploid.samples]))
        sample_tags.append(("FT", [_filters_str(s.filters)
                                   for s in diploid.samples]))
        sample_tags.append(("GQ", [str(s.gt_score) for s in diploid.samples]))
        sample_tags.append(("PL", [",".join(str(p) for p in s.phred_loghood)
                                   for s in diploid.samples]))
        sample_tags.append(("PR", [
            f"{base_info.samples[i].ref.confident_spanning_pair_count},"
            f"{base_info.samples[i].alt.confident_spanning_pair_count}"
            for i in range(n)]))
        if sv.is_imprecise:
            return
        sample_tags.append(("SR", [
            f"{base_info.samples[i].ref.confident_split_read_count},"
            f"{base_info.samples[i].alt.confident_split_read_count}"
            for i in range(n)]))

    def write_sv(self, adata, sv, sv_id, base_info, diploid_info, event,
                 single_info):
        self.write_sv_core(adata, sv, sv_id, base_info,
                           (diploid_info, single_info), event)


class VcfWriterSomaticSV(VcfWriterSV):
    def __init__(self, somatic_opt, is_max_depth_filter, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.opt = somatic_opt
        self.is_max_depth_filter = is_max_depth_filter

    def add_header_info(self):
        return [
            '##INFO=<ID=BND_DEPTH,Number=1,Type=Integer,Description="Read depth at local translocation breakend">',
            '##INFO=<ID=MATE_BND_DEPTH,Number=1,Type=Integer,Description="Read depth at remote translocation mate breakend">',
            '##INFO=<ID=SOMATIC,Number=0,Type=Flag,Description="Somatic mutation">',
            '##INFO=<ID=SOMATICSCORE,Number=1,Type=Integer,Description="Somatic variant quality score">',
            '##INFO=<ID=JUNCTION_SOMATICSCORE,Number=1,Type=Integer,Description="If the SV junctino is part of an EVENT (ie. a multi-adjacency variant), this field provides the SOMATICSCORE value for the adjacency in question only">',
        ]

    def add_header_format(self):
        return [
            '##FORMAT=<ID=PR,Number=.,Type=Integer,Description="Spanning paired-read support for the ref and alt alleles in the order listed">',
            '##FORMAT=<ID=SR,Number=.,Type=Integer,Description="Split reads for the ref and alt alleles in the order listed, for reads where P(allele|read)>0.999">',
        ]

    def add_header_filters(self):
        o = self.opt
        out = []
        if self.is_max_depth_filter:
            out.append(f'##FILTER=<ID=MaxDepth,Description="Normal sample site depth is greater than {o.max_depth_factor:g}x the median chromosome depth near one or both variant breakends">')
        out.append(f'##FILTER=<ID=MinSomaticScore,Description="Somatic score is less than {o.min_pass_somatic_score}">')
        out.append(f'##FILTER=<ID=MaxMQ0Frac,Description="For a small variant (<1000 bases) in the normal sample, the fraction of reads with MAPQ0 around either breakend exceeds {o.max_mq0_frac:g}">')
        return out

    def modify_info(self, event, score, info):
        somatic, single = score
        info.append("SOMATIC")
        info.append(f"SOMATICSCORE={somatic.somatic_score}")
        if event.is_event:
            info.append(f"JUNCTION_SOMATICSCORE={single.somatic_score}")

    def modify_transloc_info(self, sv, base_info, is_first, adata, info):
        info.append(f"BND_DEPTH="
                    f"{base_info.bp1_max_depth if is_first else base_info.bp2_max_depth}")
        info.append(f"MATE_BND_DEPTH="
                    f"{base_info.bp2_max_depth if is_first else base_info.bp1_max_depth}")

    def write_filter(self, score):
        return _filters_str(score[0].filters)

    def modify_sample(self, sv, base_info, score, sample_tags):
        n = len(base_info.samples)
        sample_tags.append(("PR", [
            f"{base_info.samples[i].ref.confident_spanning_pair_count},"
            f"{base_info.samples[i].alt.confident_spanning_pair_count}"
            for i in range(n)]))
        if sv.is_imprecise:
            return
        sample_tags.append(("SR", [
            f"{base_info.samples[i].ref.confident_split_read_count},"
            f"{base_info.samples[i].alt.confident_split_read_count}"
            for i in range(n)]))

    def write_sv(self, adata, sv, sv_id, base_info, somatic_info, event,
                 single_info):
        self.write_sv_core(adata, sv, sv_id, base_info,
                           (somatic_info, single_info), event)


class VcfWriterTumorSV(VcfWriterSV):
    def __init__(self, tumor_opt, is_max_depth_filter, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.opt = tumor_opt
        self.is_max_depth_filter = is_max_depth_filter

    def add_header_info(self):
        return [
            '##INFO=<ID=BND_DEPTH,Number=1,Type=Integer,Description="Read depth at local translocation breakend">',
            '##INFO=<ID=MATE_BND_DEPTH,Number=1,Type=Integer,Description="Read depth at remote translocation mate breakend">',
        ]

    def add_header_format(self):
        return [
            '##FORMAT=<ID=PR,Number=.,Type=Integer,Description="Spanning paired-read support for the ref and alt alleles in the order listed">',
            '##FORMAT=<ID=SR,Number=.,Type=Integer,Description="Split reads for the ref and alt alleles in the order listed, for reads where P(allele|read)>0.999">',
        ]

    def add_header_filters(self):
        o = self.opt
        out = []
        if self.is_max_depth_filter:
            out.append(f'##FILTER=<ID=MaxDepth,Description="Tumor sample site depth is greater than {o.max_depth_factor:g}x the median chromosome depth near one or both variant breakends">')
        out.append(f'##FILTER=<ID=MaxMQ0Frac,Description="For a small variant (<1000 bases) in the tumor sample, the fraction of reads with MAPQ0 around either breakend exceeds {o.max_mq0_frac:g}">')
        return out

    def modify_transloc_info(self, sv, base_info, is_first, adata, info):
        info.append(f"BND_DEPTH="
                    f"{base_info.bp1_max_depth if is_first else base_info.bp2_max_depth}")
        info.append(f"MATE_BND_DEPTH="
                    f"{base_info.bp2_max_depth if is_first else base_info.bp1_max_depth}")

    def write_filter(self, score):
        return _filters_str(score.filters)

    def modify_sample(self, sv, base_info, score, sample_tags):
        n = len(base_info.samples)
        sample_tags.append(("PR", [
            f"{base_info.samples[i].ref.confident_spanning_pair_count},"
            f"{base_info.samples[i].alt.confident_spanning_pair_count}"
            for i in range(n)]))
        if sv.is_imprecise:
            return
        sample_tags.append(("SR", [
            f"{base_info.samples[i].ref.confident_split_read_count},"
            f"{base_info.samples[i].alt.confident_split_read_count}"
            for i in range(n)]))

    def write_sv(self, adata, sv, sv_id, base_info, tumor_info, event):
        self.write_sv_core(adata, sv, sv_id, base_info, tumor_info, event)


class VcfWriterRnaSV(VcfWriterSV):
    """(reference: format/VcfWriterRnaSV.cpp) — RNA fusion output with
    RNA_* annotation; QUAL stays '.' (placeholder scoring model)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)

    def add_header_info(self):
        return [
            '##INFO=<ID=BND_DEPTH,Number=1,Type=Integer,Description="Read depth at local translocation breakend">',
            '##INFO=<ID=MATE_BND_DEPTH,Number=1,Type=Integer,Description="Read depth at remote translocation mate breakend">',
            '##INFO=<ID=REF_COUNT,Number=1,Type=Integer,Description="The number of reads supporting the reference allele at this breakend">',
            '##INFO=<ID=MATE_REF_COUNT,Number=1,Type=Integer,Description="The number of reads supporting the reference allele at the other breakend">',
            '##INFO=<ID=RNA_FIRST,Number=0,Type=Flag,Description="For RNA fusions, this break-end is 5\' in the fusion transcript">',
            '##INFO=<ID=RNA_STRANDED,Number=0,Type=Flag,Description="For RNA fusions, the direction of transcription is known">',
            '##INFO=<ID=RNA_FwRvReads,Number=2,Type=Integer,Description="For RNA fusions, number of stranded reads supporting forward or reverse direction of transcription">',
            '##INFO=<ID=RNA_Reads,Number=1,Type=Integer,Description="The number of reads and pairs that potentially support this candidate before refinement and scoring">',
            '##INFO=<ID=RNA_CONTIG,Number=1,Type=String,Description="The sequence of the breakend spanning contig">',
            '##INFO=<ID=RNA_CONTIG_ALN,Number=2,Type=Integer,Description="Length of the spanning contig alignment on each breakend">',
        ]

    def add_header_format(self):
        return [
            '##FORMAT=<ID=PR,Number=.,Type=Integer,Description="Spanning paired-read support for the ref and alt alleles in the order listed">',
            '##FORMAT=<ID=SR,Number=.,Type=Integer,Description="Split reads for the ref and alt alleles in the order listed">',
        ]

    def add_header_filters(self):
        return [
            '##FILTER=<ID=LowEvidence,Description="RNA fusion calls without both split read and spanning pair support">',
            '##FILTER=<ID=Imprecise,Description="RNA fusion candidates for which no spanning contig was found">',
            '##FILTER=<ID=Local,Description="RNA call covering short genomic distance">',
        ]

    def modify_transloc_info(self, sv, base_info, is_first, adata, info):
        info.append(f"BND_DEPTH="
                    f"{base_info.bp1_max_depth if is_first else base_info.bp2_max_depth}")
        info.append(f"MATE_BND_DEPTH="
                    f"{base_info.bp2_max_depth if is_first else base_info.bp1_max_depth}")
        refinfo = base_info.samples[0].ref
        rc1 = refinfo.confident_split_read_and_pair_count_ref_bp1
        rc2 = refinfo.confident_split_read_and_pair_count_ref_bp2
        info.append(f"REF_COUNT={rc1 if is_first else rc2}")
        info.append(f"MATE_REF_COUNT={rc2 if is_first else rc1}")
        is_first_bnd = (adata.bporient.is_bp1_first == is_first)
        if is_first_bnd:
            info.append("RNA_FIRST")
        if adata.bporient.is_transcript_strand_known:
            info.append("RNA_STRANDED")
        if not is_first:
            return
        info.append(f"RNA_FwRvReads={sv.forward_transcript_strand_read_count},"
                    f"{sv.reverse_transcript_strand_read_count}")
        info.append(f"RNA_Reads={int(sv.bp2.evidence.sum())}")
        if adata.contigs:
            best = adata.best_alignment_index
            info.append(f"RNA_CONTIG={adata.contigs[best].seq}")
            res = adata.spanning_alignments[best]
            from ..core import cigar as cg
            m1 = cg.matched_length(res.align1.ops, res.align1.lens)
            m2 = cg.matched_length(res.align2.ops, res.align2.lens)
            info.append(f"RNA_CONTIG_ALN={m1},{m2}")

    def write_filter(self, score):
        return _filters_str(score.filters)

    def modify_sample(self, sv, base_info, score, sample_tags):
        n = len(base_info.samples)
        sample_tags.append(("PR", [
            f"{base_info.samples[i].ref.spanning_pair_count},"
            f"{base_info.samples[i].alt.spanning_pair_count}"
            for i in range(n)]))
        if sv.is_imprecise:
            return
        sample_tags.append(("SR", [
            f"{base_info.samples[i].ref.split_read_count},"
            f"{base_info.samples[i].alt.split_read_count}"
            for i in range(n)]))

    def write_sv(self, adata, sv, sv_id, base_info, rna_info, event):
        self.write_sv_core(adata, sv, sv_id, base_info, rna_info, event)
