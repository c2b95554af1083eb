"""Configuration step: validate inputs, emit a run script.

Equivalent of the reference's two-step user flow
(reference: bin/configManta.py + lib/makeRunScript.py): validates
BAM/fasta inputs and chromosome compatibility
(reference: lib/checkChromSet.py), records all options into
<runDir>/runWorkflow.config.json, and writes an executable
<runDir>/runWorkflow.py that drives workflow/run.py.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import stat
import sys

from ..io.bam import open_alignment_reader
from ..io.fasta import FastaReader


# ini key -> (advanced-dict key, parser); mirrors the reference's
# advanced-option tier (reference: configManta.py.ini, configureUtil.py)
_INI_BOOL = lambda v: v.strip() not in ("0", "", "false", "False")
_INI_KEYS = {
    "rnaMinCandidateVariantSize": ("rna_min_candidate_variant_size", int),
    "graphNodeMaxEdgeCount": ("graph_node_max_edge_count", int),
    "minCandidateSpanningCount": ("min_candidate_spanning_count", int),
    "minScoredVariantSize": ("min_scored_variant_size", int),
    "minDiploidVariantScore": ("min_diploid_variant_score", int),
    "minPassDiploidVariantScore": ("min_pass_diploid_variant_score", int),
    "minPassDiploidGTScore": ("min_pass_diploid_gt_score", int),
    "minSomaticScore": ("min_somatic_score", int),
    "minPassSomaticScore": ("min_pass_somatic_score", int),
    "enableRemoteReadRetrievalForInsertionsInGermlineCallingModes":
        ("enable_remote_read_retrieval_germline", _INI_BOOL),
    "enableRemoteReadRetrievalForInsertionsInCancerCallingModes":
        ("enable_remote_read_retrieval_cancer", _INI_BOOL),
    "useOverlapPairEvidence": ("use_overlap_pair_evidence", _INI_BOOL),
    "enableEvidenceSignalFilter": ("enable_evidence_signal_filter",
                                   _INI_BOOL),
    "dupGenotypeModel": ("dup_genotype_model", str),
}


def load_ini(path: str | None):
    """Parse the [manta] section of an advanced-options ini. Returns
    (advanced_dict, top_level_dict) where top_level carries the two
    keys that are also first-class CLI flags."""
    import configparser
    cp = configparser.ConfigParser()
    defaults = os.path.join(os.path.dirname(__file__),
                            "config_defaults.ini")
    read = cp.read([defaults] + ([path] if path else []))
    if path and os.path.abspath(path) not in [os.path.abspath(p)
                                              for p in read]:
        raise ValueError(f"can't read config file: {path}")
    section = cp["manta"]
    advanced = {}
    top = {}
    for key, raw in section.items():
        # ConfigParser lower-cases keys
        match = next((k for k in _INI_KEYS if k.lower() == key), None)
        if match is not None:
            name, conv = _INI_KEYS[match]
            advanced[name] = conv(raw)
        elif key == "mincandidatevariantsize":
            top["min_candidate_variant_size"] = int(raw)
        elif key == "minedgeobservations":
            top["min_edge_observations"] = int(raw)
        elif key == "referencefasta":
            pass  # informational in the reference ini
        else:
            raise ValueError(f"unknown advanced option in ini: {key}")
    return advanced, top


def check_chrom_set(fasta_path: str, bam_paths: list[str]):
    """(reference: lib/checkChromSet.py) — every BAM's chromosome
    names/lengths must match the fasta index entries in order."""
    fasta = FastaReader(fasta_path)
    fa_chroms = [(name, fasta.chrom_length(name))
                 for name in fasta._index]
    for path in bam_paths:
        header = open_alignment_reader(path, fasta_path).header
        bam_chroms = list(zip(header.ref_names, header.ref_lengths))
        ncmp = min(len(fa_chroms), len(bam_chroms))
        if ncmp == 0:
            raise ValueError(f"no chromosomes in {path}")
        for i in range(ncmp):
            if fa_chroms[i] != bam_chroms[i]:
                raise ValueError(
                    f"chromosome mismatch between '{fasta_path}' and "
                    f"'{path}' at index {i}: "
                    f"{fa_chroms[i]} vs {bam_chroms[i]}")


def read_call_regions(path: str) -> dict[str, list[tuple[int, int]]]:
    """Parse a (bgzipped) BED of callable regions
    (reference: --callRegions handling, mantaOptions.py)."""
    opener = gzip.open if path.endswith(".gz") else open
    regions: dict[str, list[tuple[int, int]]] = {}
    with opener(path, "rt") as f:
        for line in f:
            if not line.strip() or line.startswith(("#", "track", "browser")):
                continue
            w = line.split("\t")
            regions.setdefault(w[0], []).append((int(w[1]), int(w[2])))
    # merge overlaps
    for chrom in regions:
        ivs = sorted(regions[chrom])
        merged = [list(ivs[0])]
        for b, e in ivs[1:]:
            if b <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([b, e])
        regions[chrom] = [(b, e) for b, e in merged]
    return regions


_RUN_SCRIPT = """#!/usr/bin/env python3
# auto-generated run script -- edit runWorkflow.config.json to change
# options, then re-run this script
import argparse
import json
import os
import sys

sys.path.insert(0, {repo_root!r})

from manta_tpu_torch.workflow.run import run_workflow

ap = argparse.ArgumentParser()
ap.add_argument("-j", "--jobs", type=int, default=1,
                help="number of worker processes")
ap.add_argument("--rescore", action="store_true",
                help="reuse phase-0/1 artifacts, re-run scoring only")
args = ap.parse_args()

config_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "runWorkflow.config.json")
with open(config_path) as f:
    config = json.load(f)
config["n_jobs"] = args.jobs
config["is_rescore"] = args.rescore
run_workflow(**config)
"""


def configure(args) -> str:
    normal_bams = args.normal_bams or []
    tumor_bams = args.tumor_bams or []
    if not normal_bams and not tumor_bams:
        raise ValueError("at least one --bam or --tumorBam is required")
    if len(tumor_bams) > 1:
        raise ValueError("at most one tumor BAM is supported")
    if tumor_bams and len(normal_bams) > 1:
        raise ValueError(
            "Can't accept multiple normal samples for tumor subtraction")
    for p in normal_bams + tumor_bams + [args.reference]:
        if not os.path.exists(p):
            raise ValueError(f"input not found: {p}")
    if args.call_regions and not os.path.exists(args.call_regions):
        raise ValueError(f"call regions not found: {args.call_regions}")
    if args.exome and args.rna:
        raise ValueError("--exome and --rna are mutually exclusive")
    advanced, ini_top = load_ini(getattr(args, "config", None))
    if args.rna and (tumor_bams or len(normal_bams) != 1):
        raise ValueError(
            "RNA mode requires exactly one normal sample (--bam)")
    if args.unstranded_rna and not args.rna:
        raise ValueError("--unstrandedRNA requires --rna")
    check_chrom_set(args.reference, normal_bams + tumor_bams)

    run_dir = os.path.abspath(args.run_dir)
    os.makedirs(run_dir, exist_ok=True)
    config = {
        "normal_bams": [os.path.abspath(p) for p in normal_bams],
        "tumor_bams": [os.path.abspath(p) for p in tumor_bams],
        "reference": os.path.abspath(args.reference),
        "run_dir": run_dir,
        "regions": args.regions or None,
        "is_exome": bool(args.exome),
        "is_rna": bool(args.rna),
        "min_candidate_variant_size": (
            args.min_candidate_variant_size
            if args.min_candidate_variant_size is not None
            else ini_top.get("min_candidate_variant_size", 8)),
        "min_edge_observations": (
            args.min_edge_observations
            if args.min_edge_observations is not None
            else ini_top.get("min_edge_observations", 3)),
        "advanced": advanced,
        "generate_evidence_bam": bool(args.generate_evidence_bam),
        "call_regions": (os.path.abspath(args.call_regions)
                         if args.call_regions else None),
        "scan_size_mb": args.scan_size_mb,
        "is_output_contig": bool(args.output_contig),
        "is_unstranded_rna": bool(args.unstranded_rna),
        "existing_align_stats": (os.path.abspath(args.existing_align_stats)
                                 if args.existing_align_stats else None),
        "use_existing_chrom_depths": bool(args.use_existing_chrom_depths),
        "cmdline": " ".join(sys.argv),
    }
    with open(os.path.join(run_dir, "runWorkflow.config.json"), "w") as f:
        json.dump(config, f, indent=1)
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    script_path = os.path.join(run_dir, "runWorkflow.py")
    with open(script_path, "w") as f:
        f.write(_RUN_SCRIPT.format(repo_root=repo_root))
    os.chmod(script_path, os.stat(script_path).st_mode | stat.S_IXUSR |
             stat.S_IXGRP | stat.S_IXOTH)
    return script_path


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Configure a structural variant calling run "
                    "(reference: configManta.py)")
    ap.add_argument("--bam", "--normalBam", dest="normal_bams",
                    action="append", default=[])
    ap.add_argument("--tumorBam", "--tumor-bam", dest="tumor_bams",
                    action="append", default=[])
    ap.add_argument("--referenceFasta", "--reference", dest="reference",
                    required=True)
    ap.add_argument("--runDir", "--run-dir", dest="run_dir",
                    default="MantaWorkflow")
    ap.add_argument("--region", dest="regions", action="append", default=[])
    ap.add_argument("--exome", action="store_true")
    ap.add_argument("--rna", action="store_true")
    ap.add_argument("--unstrandedRNA", action="store_true",
                    dest="unstranded_rna")
    ap.add_argument("--callRegions", dest="call_regions")
    ap.add_argument("--scanSizeMb", dest="scan_size_mb", type=int,
                    default=12)
    ap.add_argument("--generateEvidenceBam", dest="generate_evidence_bam",
                    action="store_true")
    ap.add_argument("--outputContig", dest="output_contig",
                    action="store_true")
    ap.add_argument("--existingAlignStatsFile", "--defaultAlignStatsFile",
                    dest="existing_align_stats", default=None,
                    help="default alignment statistics to use when "
                         "direct estimation from the sample fails")
    ap.add_argument("--useExistingChromDepths",
                    dest="use_existing_chrom_depths", action="store_true",
                    help="use pre-calculated chromosome depths")
    ap.add_argument("--retainTempFiles", dest="retain_temp_files",
                    action="store_true")
    ap.add_argument("--minCandidateVariantSize",
                    dest="min_candidate_variant_size", type=int,
                    default=None)
    ap.add_argument("--minEdgeObservations", dest="min_edge_observations",
                    type=int, default=None)
    ap.add_argument("--config", dest="config", default=None,
                    help="advanced-options ini overriding "
                         "config_defaults.ini (reference: "
                         "configManta.py.ini)")
    args = ap.parse_args(argv)
    try:
        script = configure(args)
    except ValueError as e:
        sys.stderr.write(f"ERROR: {e}\n")
        return 2
    print(f"Successfully created workflow run script.\n"
          f"To execute the workflow, run the following script:\n\n{script}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
