"""Trio de-novo annotation: DQ scores for inheritance-conflict calls.

Behavioral port of the reference user utility
(reference: libexec/denovo_scoring.py; documented at
docs/userGuide/README.md:790-804): for each record, the proband GT is
checked against all father x mother allele combinations; inconsistent
genotypes get FORMAT/DQ=60 on the proband (0 otherwise, '.' for the
parents). Writes <prefix>.de_novo.vcf and <prefix>.de_novo.stats.txt
next to the input.
"""

from __future__ import annotations

import os
import sys


def check_genotype(proband_gt: str, father_gt: str, mother_gt: str) -> bool:
    """(reference: denovo_scoring.py check_genotype)."""
    for it1 in father_gt.split("/"):
        for it2 in mother_gt.split("/"):
            pair = sorted([it1, it2])
            if f"{pair[0]}/{pair[1]}" == proband_gt:
                return True
    return False


def process_vcf(vcf_path: str, proband_id: str, father_id: str,
                mother_id: str) -> tuple[str, str]:
    vcf_path = os.path.abspath(vcf_path)
    data_dir = os.path.dirname(vcf_path)
    prefix = os.path.splitext(os.path.basename(vcf_path))[0]
    out_path = os.path.join(data_dir, prefix + ".de_novo.vcf")
    stats_path = os.path.join(data_dir, prefix + ".de_novo.stats.txt")

    count_passed = 0
    count_filtered = 0
    consistency: dict[str, int] = {}

    with open(vcf_path) as fin, open(out_path, "w") as fout:
        format_added = False
        ix_found = False
        col_name_line = ""
        proband_ix = father_ix = mother_ix = -1
        for line in fin:
            if line.startswith("#"):
                if not format_added and line.startswith("##FORMAT"):
                    fout.write(
                        '##FORMAT=<ID=DQ,Number=1,Type=Integer,'
                        'Description="De novo quality score">\n')
                    format_added = True
                fout.write(line)
                col_name_line = line
                continue
            if not ix_found:
                tokens = col_name_line.split()
                for ix, tok in enumerate(tokens):
                    if tok == proband_id:
                        proband_ix = ix
                    elif tok == father_id:
                        father_ix = ix
                    elif tok == mother_id:
                        mother_ix = ix
                missing = [sid for sid, six in
                           ((proband_id, proband_ix), (father_id, father_ix),
                            (mother_id, mother_ix)) if six == -1]
                if missing:
                    raise ValueError(
                        f"sample ID(s) {','.join(missing)} not in the vcf")
                ix_found = True

            tokens = line.split()
            fmt = tokens[8]
            gt_ix = fmt.split(":").index("GT")
            proband_gt = tokens[proband_ix].split(":")[gt_ix]
            father_gt = tokens[father_ix].split(":")[gt_ix]
            mother_gt = tokens[mother_ix].split(":")[gt_ix]

            fmt += ":DQ"
            if not check_genotype(proband_gt, father_gt, mother_gt):
                dq = "60"
                if tokens[6].upper() == "PASS":
                    count_passed += 1
                else:
                    count_filtered += 1
                key = f"{proband_gt}-{father_gt}-{mother_gt}"
                consistency[key] = consistency.get(key, 0) + 1
            else:
                dq = "0"
            for ix in range(9, len(tokens)):
                tokens[ix] += f":{dq}" if ix == proband_ix else ":."

            fout.write("\t".join(tokens[:8]) + "\t" + fmt)
            for ix in range(9, len(tokens)):
                fout.write("\t" + tokens[ix])
            fout.write("\n")

    with open(stats_path, "w") as f:
        f.write(f"# of passed SVs: {count_passed}\n")
        f.write(f"# of filtered SVs: {count_filtered}\n")
        f.write("probandGT-fatherGT-motherGT\tcounts\n")
        for gt in sorted(consistency):
            f.write(f"{gt}\t{consistency[gt]}\n")
    return out_path, stats_path


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 4:
        sys.stderr.write(
            "usage: python -m manta_tpu_torch.tools.denovo_scoring "
            "<vcf file> <proband ID> <father ID> <mother ID>\n")
        return 1
    process_vcf(*argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
