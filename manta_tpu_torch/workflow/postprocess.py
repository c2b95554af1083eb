"""Final VCF post-processing: sort/dedup, ploidy filter, small indels.

Behavioral ports of the reference workflow's output-stage scripts:
- sort_vcf_lines: libexec/sortVcf.py — contig-order sort plus (unless
  print_all) duplicate-record resolution keeping the best of each
  equal-record run (PASS > qual > assembled) with BND mate consistency
- ploidy_filter_lines: libexec/ploidyFilter.py — stacked same-size
  DEL/DUP records whose genotype ploidy sums exceed diploid expectation
  get FILTER=Ploidy
- extract_small_indel_lines: libexec/extractSmallIndelCandidates.py —
  non-symbolic candidate indels up to minScoredVariantSize-1
"""

from __future__ import annotations

import re


def _get_key_val(s: str, key: str):
    m = re.search(f"{key}=([^;\t]*);?", s)
    return None if m is None else m.group(1)


def _is_info_key(s: str, key: str) -> bool:
    return re.search(f"(^|;){key}(;|$|=)", s) is not None


class _SortRec:
    __slots__ = ("line", "chrom", "pos", "id", "ref", "alt", "qual",
                 "is_pass", "inv_state", "end_pos", "mate_id")

    def __init__(self, line: str):
        self.line = line
        w = line.rstrip("\n").split("\t")
        self.chrom = w[0]
        self.pos = int(w[1])
        self.id = w[2]
        self.ref = w[3]
        self.alt = w[4]
        self.qual = w[5]
        self.is_pass = (w[6] == "PASS")
        inv3 = _is_info_key(w[7], "INV3")
        inv5 = _is_info_key(w[7], "INV5")
        self.inv_state = "INV3" if inv3 else ("INV5" if inv5 else None)
        self.end_pos = self.pos + len(w[3]) - 1
        val = _get_key_val(w[7], "END")
        if val is not None:
            self.end_pos = int(val)
        self.mate_id = _get_key_val(w[7], "MATEID")


_CONTIG_PAT = re.compile(r"^##contig=<ID=([^,>]*)[,>]")


def _is_equal_rec(r1, r2) -> bool:
    """(reference: sortVcf.py isEqualRec) — r = (chrom, pos, ref, alt,
    endPos, invState)."""
    if r1 is None or r2 is None:
        return False
    if r1[0] != r2[0] or r1[1] != r2[1] or r1[2] != r2[2]:
        return False
    if r1[4] != r2[4] or r1[5] != r2[5]:
        return False
    if r1[3] != r2[3]:
        if r1[3] != "<INS>" and r2[3] != "<INS>":
            return False

        def match_test(alt):
            return alt[0] != "<" and len(alt) >= 80

        if r1[3] == "<INS>":
            return match_test(r2[3])
        if r2[3] == "<INS>":
            return match_test(r1[3])
    return True


def _resolve_rec(rec_equal_set, rec_list, removed_mate_ids):
    """(reference: sortVcf.py resolveRec) — keep the best of an
    equal-record set; queue mates of dropped BNDs for removal."""
    if not rec_equal_set:
        return
    best_index = 0
    best_qual = 0.0
    best_is_pass = False
    best_is_assembled = False
    for index, rec in enumerate(rec_equal_set):
        try:
            qual = float(rec.qual)
        except ValueError:
            qual = 0.0
        is_new_pass = (not best_is_pass) and rec.is_pass
        is_high_qual = (best_is_pass == rec.is_pass) and (qual > best_qual)
        is_new_assembled = (not best_is_assembled) and rec.alt[0] != "<"
        if is_new_pass or is_high_qual or is_new_assembled:
            best_index = index
            best_qual = qual
            best_is_pass = rec.is_pass
            best_is_assembled = (rec.alt[0] != "<")
    rec_list.append(rec_equal_set[best_index])
    for index, rec in enumerate(rec_equal_set):
        if index != best_index and rec.mate_id is not None:
            removed_mate_ids.add(rec.mate_id)


def sort_vcf_lines(lines: list[str], print_all: bool = False) -> list[str]:
    """(reference: sortVcf.py main) — returns header + sorted records."""
    header = []
    chrom_order = []
    recs = []
    for line in lines:
        if line.startswith("#"):
            header.append(line)
            m = _CONTIG_PAT.match(line)
            if m is not None:
                chrom_order.append(m.group(1))
        else:
            recs.append(_SortRec(line))

    def sort_key(x):
        try:
            ho = chrom_order.index(x.chrom)
        except ValueError:
            ho = len(chrom_order)
        return (ho, x.chrom, x.pos, x.end_pos, x.ref, x.alt, x.id)

    recs.sort(key=sort_key)

    ids_to_remove: set[str] = set()
    if not print_all:
        out_recs = []
        equal_set = []
        last = None
        for r in recs:
            if r.id in ids_to_remove:
                continue
            key = (r.chrom, r.pos, r.ref, r.alt, r.end_pos, r.inv_state)
            if not _is_equal_rec(key, last):
                _resolve_rec(equal_set, out_recs, ids_to_remove)
                equal_set = []
            equal_set.append(r)
            last = key
        _resolve_rec(equal_set, out_recs, ids_to_remove)
        recs = out_recs

    out = list(header)
    for r in recs:
        if r.id in ids_to_remove:
            continue
        out.append(r.line)
    return out


class _PloidyRec:
    __slots__ = ("chrom", "pos", "is_pass", "end", "sv_len", "sv_type",
                 "gt_type")

    def __init__(self, line: str):
        w = line.rstrip("\n").split("\t")
        self.chrom = w[0]
        self.pos = int(w[1])
        self.is_pass = (w[6] == "PASS")
        self.end = self.pos + len(w[3]) - 1
        val = _get_key_val(w[7], "END")
        if val is not None:
            self.end = int(val)
        self.sv_len = None
        val = _get_key_val(w[7], "SVLEN")
        if val is not None:
            self.sv_len = int(val)
        self.sv_type = _get_key_val(w[7], "SVTYPE")
        gt_ix = w[8].split(":").index("GT")
        self.gt_type = []
        for sample in w[9:]:
            gt = sample.split(":")[gt_ix]
            t = gt.split("/")
            self.gt_type.append(int(t[0]) + int(t[1]))


def _process_block(block, next_pos, filtered_sites):
    """(reference: ploidyFilter.py process_block)."""
    while block:
        target = block[0]
        target_end = target.end
        if target_end > next_pos:
            break
        target_len = -1
        if target.sv_len is not None:
            target_len = abs(target.sv_len)
        ploidy_sum = list(target.gt_type)
        overlap_ids = [0]
        for ix in range(1, len(block)):
            rec = block[ix]
            sv_len = -1
            if rec.sv_len is not None:
                sv_len = abs(rec.sv_len)
            if rec.pos < target_end:
                if sv_len < 2 * target_len and sv_len > 0.5 * target_len:
                    for si, gp in enumerate(rec.gt_type):
                        ploidy_sum[si] += gp
                    overlap_ids.append(ix)
            else:
                break
        overlap_ids.reverse()
        if any(psum > 2 for psum in ploidy_sum):
            for i in overlap_ids:
                site = block.pop(i)
                filtered_sites.setdefault(site.chrom, {})[
                    (site.pos, site.end)] = True
        else:
            for i in overlap_ids:
                block.pop(i)


def _find_stacked_variants(lines) -> dict:
    """(reference: ploidyFilter.py find_stacked_variants)."""
    filtered_sites: dict = {}
    block: list[_PloidyRec] = []
    max_end = -1
    for line in lines:
        if line.startswith("#"):
            continue
        rec = _PloidyRec(line)
        if not rec.is_pass:
            continue
        if rec.sv_type != "DEL" and rec.sv_type != "DUP":
            continue
        if not block:
            target_chrom = rec.chrom
            target_end = rec.end
        else:
            target_chrom = block[0].chrom
            target_end = block[0].end
        if rec.chrom == target_chrom and rec.pos < target_end:
            block.append(rec)
            max_end = max(max_end, rec.end)
        else:
            next_pos = rec.pos
            if rec.chrom != target_chrom:
                next_pos = max_end + 1
                max_end = -1
            _process_block(block, next_pos, filtered_sites)
            block.append(rec)
            max_end = max(max_end, rec.end)
    _process_block(block, max_end + 1, filtered_sites)
    return filtered_sites


_PLOIDY_HEADER = (
    '##FILTER=<ID=Ploidy,Description="For DEL & DUP variants, the '
    "genotypes of overlapping variants (with similar size) are "
    'inconsistent with diploid expectation">\n')


def ploidy_filter_lines(lines: list[str]) -> list[str]:
    """(reference: ploidyFilter.py main)."""
    filtered_sites = _find_stacked_variants(lines)
    out = []
    header_added = False
    for line in lines:
        if not line.startswith("#"):
            site = _PloidyRec(line)
            if site.is_pass and site.sv_type in ("DEL", "DUP"):
                hit = site.chrom in filtered_sites and \
                    (site.pos, site.end) in filtered_sites[site.chrom]
                if hit:
                    w = line.rstrip("\n").split("\t")
                    w[6] = "Ploidy"
                    line = "\t".join(w) + "\n"
        elif not header_added and line.startswith("##FILTER"):
            out.append(_PLOIDY_HEADER)
            header_added = True
        out.append(line)
    return out


def extract_small_indel_lines(lines: list[str], max_size: int) -> list[str]:
    """(reference: extractSmallIndelCandidates.py main)."""
    out = []
    for line in lines:
        if line.startswith("#"):
            out.append(line)
            continue
        w = line.rstrip("\n").split("\t")
        alt = w[4]
        if "<" in alt or "[" in alt or "]" in alt or ":" in alt:
            continue
        if len(w[3]) > max_size + 1 or len(alt) > max_size + 1:
            continue
        out.append(line)
    return out


def swap_cmdline_lines(lines: list[str], cmdline: str) -> list[str]:
    """Replace or add the ##cmdline header field
    (reference: libexec/vcfCmdlineSwapper.py)."""
    prefix = "##cmdline="
    out = []
    written = False
    for line in lines:
        if line.startswith("##"):
            if line.startswith(prefix):
                out.append(prefix + cmdline + "\n")
                written = True
                continue
        else:
            if not written:
                out.append(prefix + cmdline + "\n")
                written = True
        out.append(line)
    return out


_SAMPLE_FT_LABEL = "SampleFT"
_SAMPLE_FT_HEADER = (
    f'##FILTER=<ID={_SAMPLE_FT_LABEL},Description="No sample passes all '
    'the sample-level filters (at the field FORMAT/FT)">\n')


def update_sample_ft_filter_lines(lines: list[str]) -> list[str]:
    """Recompute the record-level SampleFT filter from FORMAT/FT
    (reference: libexec/updateSampleFTFilter.py)."""
    out = []
    header_found = False
    for line in lines:
        if line.startswith("##"):
            if line.startswith("##FILTER") and \
                    _SAMPLE_FT_LABEL in line:
                header_found = True
            out.append(line)
            continue
        if line.startswith("#"):
            if not header_found:
                out.append(_SAMPLE_FT_HEADER)
            out.append(line)
            continue
        w = line.rstrip("\n").split("\t")
        filters = w[6].split(";")
        if filters[0] in (".", "PASS"):
            filters = []
        fmt = w[8].split(":")
        if fmt[0] == ".":
            fmt = []

        def emit(fs):
            w[6] = ";".join(fs) if fs else "PASS"
            out.append("\t".join(w) + "\n")

        if "FT" not in fmt:
            if _SAMPLE_FT_LABEL in filters:
                out.append(line)
            else:
                filters.append(_SAMPLE_FT_LABEL)
                emit(filters)
            continue
        ft_ix = fmt.index("FT")
        passed = any(col.split(":")[ft_ix] == "PASS" for col in w[9:])
        if passed:
            if _SAMPLE_FT_LABEL not in filters:
                out.append(line)
            else:
                filters.remove(_SAMPLE_FT_LABEL)
                emit(filters)
        else:
            if _SAMPLE_FT_LABEL in filters:
                out.append(line)
            else:
                filters.append(_SAMPLE_FT_LABEL)
                emit(filters)
    return out
