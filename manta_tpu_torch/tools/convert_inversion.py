"""Convert same-chromosome inversion BND pairs to <INV> records.

Behavioral port of the reference user utility
(reference: libexec/convertInversion.py; documented at
docs/userGuide/README.md:339-351): INV3 (alt ends with ']') / INV5
(alt starts with '[') breakend pairs on one chromosome become single
symbolic <INV> records with END/SVLEN/CIEND/INV3|INV5 annotation; the
mate record is dropped. Reference base lookups use the native fasta
reader instead of `samtools faidx`.
"""

from __future__ import annotations

import gzip
import sys

from ..io.fasta import FastaReader


class _Rec:
    def __init__(self, line: str):
        tokens = line.rstrip("\n").split("\t")
        self.chrom = tokens[0]
        self.pos = int(tokens[1])
        self.vid = tokens[2]
        self.ref = tokens[3]
        self.alt = tokens[4]
        self.qual = tokens[5]
        self.filter = tokens[6]
        self.info = tokens[7].split(";")
        self.others = "\t".join(tokens[8:])
        self.info_dict = {}
        for item in self.info:
            parts = item.split("=")
            if len(parts) == 1:
                self.info_dict[parts[0]] = True
            else:
                self.info_dict[parts[0]] = parts[1]
        self.is_inv3 = False
        self.is_inv5 = False
        self.mate_chrom = ""
        self.mate_pos = -1

    def check_inversion(self):
        def get_mate(split_char):
            items = self.alt.split(split_char)
            self.mate_chrom, mate_pos = items[1].split(":")
            self.mate_pos = int(mate_pos)

        if self.alt.startswith("["):
            get_mate("[")
            if self.mate_chrom == self.chrom:
                self.is_inv5 = True
        elif self.alt.endswith("]"):
            get_mate("]")
            if self.mate_chrom == self.chrom:
                self.is_inv3 = True

    def make_line(self) -> str:
        return "\t".join((self.chrom, str(self.pos), self.vid, self.ref,
                          self.alt, self.qual, self.filter,
                          ";".join(self.info), self.others)) + "\n"


def _open_lines(vcf_path: str):
    if vcf_path.endswith("gz"):
        return gzip.open(vcf_path, "rt")
    return open(vcf_path)


def _scan_inv_mates(vcf_path: str) -> dict:
    """(reference: convertInversion.py scanVcf)."""
    inv_mates: dict = {}
    with _open_lines(vcf_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            rec = _Rec(line)
            rec.check_inversion()
            if rec.is_inv3 or rec.is_inv5:
                if rec.vid in inv_mates:
                    inv_mates[rec.vid] = rec.info_dict
                else:
                    inv_mates[rec.info_dict["MATEID"]] = ""
    return inv_mates


def convert_inversions(ref_fasta: str, vcf_path: str, out=None) -> None:
    """(reference: convertInversion.py convertInversions)."""
    out = out or sys.stdout
    fasta = FastaReader(ref_fasta)

    def ref_base(chrom, start, end):
        # samtools faidx region semantics: 1-based inclusive
        return fasta.fetch(chrom, start - 1, end).decode().upper()

    inv_mates = _scan_inv_mates(vcf_path)
    header_info_added = False
    header_alt_added = False
    line_buffer: list[str] = []
    buffered_chrom = ""
    buffered_pos = -1

    with _open_lines(vcf_path) as f:
        for line in f:
            if line.startswith("#"):
                if not header_info_added and line.startswith("##FORMAT="):
                    out.write(
                        '##INFO=<ID=INV3,Number=0,Type=Flag,Description='
                        '"Inversion breakends open 3\' of reported '
                        'location">\n'
                        '##INFO=<ID=INV5,Number=0,Type=Flag,Description='
                        '"Inversion breakends open 5\' of reported '
                        'location">\n')
                    header_info_added = True
                if not header_alt_added and line.startswith("##ALT="):
                    out.write('##ALT=<ID=INV,Description="Inversion">\n')
                    header_alt_added = True
                out.write(line)
                continue

            rec = _Rec(line)
            if rec.vid in inv_mates:
                continue
            rec.check_inversion()
            if rec.is_inv3 or rec.is_inv5:
                if rec.is_inv5:
                    rec.pos -= 1
                    rec.mate_pos -= 1
                    rec.ref = ref_base(rec.chrom, rec.pos, rec.pos)
                vid_suffix = rec.vid.split("MantaBND")[1]
                idx = vid_suffix.rfind(":")
                rec.vid = f"MantaINV{vid_suffix[:idx]}"
                rec.alt = "<INV>"
                new_info = [f"END={rec.mate_pos}"]
                for item in rec.info:
                    if item.startswith("SVTYPE"):
                        new_info.append("SVTYPE=INV")
                        new_info.append(f"SVLEN={rec.mate_pos - rec.pos}")
                    elif item.startswith("CIPOS"):
                        new_info.append(item)
                        if "IMPRECISE" in rec.info_dict:
                            mate_info = inv_mates[rec.info_dict["MATEID"]]
                            new_info.append(f"CIEND={mate_info['CIPOS']}")
                        elif "HOMLEN" in rec.info_dict:
                            new_info.append(
                                f"CIEND=-{rec.info_dict['HOMLEN']},0")
                    elif item.startswith("HOMSEQ"):
                        if rec.is_inv5:
                            cipos = rec.info_dict["CIPOS"].split(",")
                            beg = rec.pos + int(cipos[0]) + 1
                            end = rec.pos + int(cipos[1])
                            new_info.append(
                                f"HOMSEQ={ref_base(rec.chrom, beg, end)}")
                        else:
                            new_info.append(item)
                    elif item.startswith(("MATEID", "BND_DEPTH",
                                          "MATE_BND_DEPTH")):
                        continue
                    elif item.startswith("EVENT"):
                        eid_suffix = \
                            rec.info_dict["EVENT"].split("MantaBND")[1]
                        # quirk preserved from the reference: the cut
                        # index comes from the record ID, not the event ID
                        new_info.append(
                            f"EVENT=MantaINV{eid_suffix[:idx]}")
                    else:
                        new_info.append(item)
                if rec.is_inv3:
                    new_info.append("INV3")
                elif rec.is_inv5:
                    new_info.append("INV5")
                rec.info = new_info

            new_line = rec.make_line()
            # local re-sort buffer for the INV5 pos-1 adjustment
            if rec.chrom != buffered_chrom or rec.pos > buffered_pos:
                out.writelines(line_buffer)
                line_buffer = [new_line]
                buffered_chrom = rec.chrom
                buffered_pos = rec.pos
            elif rec.pos < buffered_pos:
                line_buffer.insert(0, new_line)
            else:
                line_buffer.append(new_line)
    out.writelines(line_buffer)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        sys.stderr.write(
            "usage: python -m manta_tpu_torch.tools.convert_inversion "
            "<reference fasta> <vcf file>\n")
        return 1
    convert_inversions(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
