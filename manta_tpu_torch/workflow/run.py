"""End-to-end workflow: stats -> graph -> candidates -> VCFs.

Single-process equivalent of the reference workflow
(reference: src/python/lib/mantaWorkflow.py task DAG driving
GetAlignmentStats -> EstimateSVLoci -> MergeSVLoci ->
GenerateSVCandidates): runs all phases in order, writes the standard
results tree (variants VCFs + stats).

The port's counterpart of manta_tpu/workflow/run.py, on the port's own
host layers (nothing of ``manta_tpu`` is imported). Run it as
``python -m manta_tpu_torch.workflow.run``. It differs from that module,
by the module's own line numbers, only in:

- :17-31 and every lazy import: the port's own modules;
- :104-142 ``resolve_device_scoring``: 'auto' probes CUDA through
  ``cuda_present`` (new); ``resolve_device`` (new) picks the torch
  device of every device mode and raises for CUDA without a CUDA
  device;
- :170 ``run_workflow`` takes ``device`` and ``jump_scorer`` (a contig
  scorer of the caller's own, e.g. the mesh-sharded one); :203 resolves
  them; :208 loads the native core through
  ``manta_tpu_torch.native_core`` first;
- :223 the log prefix is ``[manta-tpu-torch]``;
- :464-484 phase 2 hands ``device`` to the refiner and the scorer;
- :1254 and :1274-1285 the CLI description and --device-scoring help;
- every phase, fan-out worker and phase-2 stage records its span of the
  run's trace (``parallel.worker_trace``: ``traced_workflow``,
  ``enter_worker``, ``span``), a no-op unless the trace is armed;
- :1 and :75 docstring wording.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..core.fragstats import ReadGroupStatsSet, extract_read_group_stats_set
from ..graph.finder import estimate_sv_loci
from ..graph.locusgraph import SVLocusSetOptions
from ..io.bam import BamReader, open_alignment_reader
from ..io.fasta import FastaReader
from ..scan.scanner import ScannerOptions, SVScanner
from ..candidates.svfinder import SVFinder, iterate_edges
from ..candidates.multijunction import find_multi_junction_candidates
from ..candidates.processor import (
    ProcessorOptions, SVCandidateProcessor, SVWriter,
)
from ..format.vcfwriter import (
    VcfWriterCandidateSV, VcfWriterDiploidSV, VcfWriterSomaticSV,
    VcfWriterTumorSV,
)

from ..candidates.refiner import SVCandidateAssemblyRefiner
from ..parallel import worker_trace
from ..parallel.forkpool import drain_fork_result
from ..scoring.scorer import SVScorer

PROG_NAME = "GenerateSVCandidates"
PROG_VERSION = "manta-tpu-0.1.0"

# advanced-option defaults (reference: configManta.py.ini:1-62)
ADVANCED_DEFAULTS = {
    "rna_min_candidate_variant_size": 1000,
    "graph_node_max_edge_count": 10,
    "min_candidate_spanning_count": 3,
    "min_scored_variant_size": 50,
    "min_diploid_variant_score": 10,
    "min_pass_diploid_variant_score": 20,
    "min_pass_diploid_gt_score": 15,
    "min_somatic_score": 10,
    "min_pass_somatic_score": 30,
    "enable_remote_read_retrieval_germline": True,
    "enable_remote_read_retrieval_cancer": False,
    "use_overlap_pair_evidence": False,
    "enable_evidence_signal_filter": True,
    # "tandem-aware" | "reference": DUP genotype model (scorer.py
    # _DGT_ALT_FRACTION_TANDUP derivation; "reference" = exact parity
    # with SVScoreInfoDiploid.hpp:40 fractions and no depth term)
    "dup_genotype_model": "tandem-aware",
}


def parse_region(r: str, name_to_tid):
    chrom, _, span = r.partition(":")
    tid = name_to_tid[chrom]
    if span:
        beg, _, end = span.partition("-")
        return (tid, int(beg) - 1, int(end))
    return (tid, 0, None)


def plan_scan_segments(header, regions, call_regions, scan_size_mb: int):
    """The deterministic phase-1 scan plan: user regions and/or
    callable-region BED restriction, then segmentation into
    <= scanSizeMb pieces (reference: workflowUtil.py getChromIntervals,
    mantaOptions.py scanSizeMb=12). Shared by the single-host workflow
    and the multi-host path so both derive the identical plan."""
    if regions:
        region_list = [parse_region(r, header.name_to_tid)
                       for r in regions]
        region_list = [
            (tid, beg, end if end is not None else header.ref_lengths[tid])
            for (tid, beg, end) in region_list]
    else:
        region_list = [(tid, 0, length)
                       for tid, length in enumerate(header.ref_lengths)]
    if call_regions is not None:
        from ..workflow.config import read_call_regions
        bed = read_call_regions(call_regions)
        restricted = []
        for (tid, beg, end) in region_list:
            for (b, e) in bed.get(header.ref_names[tid], []):
                ib, ie = max(beg, b), min(end, e)
                if ib < ie:
                    restricted.append((tid, ib, ie))
        region_list = restricted
    return segment_regions(region_list, scan_size_mb * 1_000_000)


def get_sample_name(reader: BamReader, default: str) -> str:
    names = reader.header.sample_names()
    name = names[0] if names else default
    return name.replace(" ", "_")


def resolve_device_scoring(mode):
    """Resolve the device-scoring request to None|'jump'|'exact'|'mxu'.

    'auto' (the default) resolves to 'jump' -- contig jump scoring on
    the CUDA device, split-read scans on the host -- when a CUDA device
    is present, and to off without one (the reference's semantics for a
    missing accelerator).
    'jump'/'exact'/'mxu' force the respective routing regardless
    ('exact' adds the bit-identical device split scan; 'mxu' the
    fastest approximate one)."""
    if mode in (None, False, "off"):
        return None
    if mode in ("jump", "exact", "mxu"):
        return mode
    if mode is True:
        return "exact"
    if mode != "auto":
        raise ValueError(f"unknown device-scoring mode {mode!r}")
    return "jump" if cuda_present() else None


def cuda_present() -> bool:
    """Whether a CUDA device is present, without initialising CUDA in
    this process: torch.cuda.device_count() asks NVML, where
    torch.cuda.is_available() calls cuInit, after which a worker forked
    for -j N could not use CUDA."""
    import torch
    return torch.cuda.device_count() > 0


def resolve_device(device_scoring, device):
    """The torch device that device scoring (contig jump scoring, and
    the split scan for 'exact' and 'mxu') runs on, or None when it stays
    on the host. ``device=None`` means CUDA: without a CUDA device that
    raises rather than running on the CPU unasked."""
    if device_scoring is None:
        return None
    import torch
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not cuda_present():
        raise RuntimeError(
            f"device scoring ({device_scoring}) on CUDA was requested but "
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch forms on the host")
    return device


def build_kernels(device_scoring) -> None:
    """Build the CUDA libraries that ``device_scoring`` launches, in
    this process. nvcc touches no CUDA state, so the workers a -j N run
    forks then load them; without this each worker compiled its own
    copy at its first dispatch, all at once (6.0-7.2 s each at -j 8 on a
    fresh checkout, PERF.md section 5)."""
    from .._build import build
    build("jump_score")
    if device_scoring in ("exact", "mxu"):
        build("split_score")


@worker_trace.traced_workflow
def run_workflow(normal_bams: list[str], tumor_bams: list[str],
                 reference: str, run_dir: str,
                 regions: list[str] | None = None,
                 is_exome: bool = False, is_rna: bool = False,
                 min_candidate_variant_size: int = 8,
                 min_edge_observations: int = 3,
                 generate_evidence_bam: bool = False,
                 call_regions: str | None = None,
                 scan_size_mb: int = 12,
                 is_output_contig: bool = False,
                 is_unstranded_rna: bool = False,
                 n_jobs: int = 1,
                 cmdline: str | None = None,
                 is_rescore: bool = False,
                 locus_index: int | None = None,
                 use_device_scoring: bool | str = "auto",
                 edge_bin_strategy: str = "contiguous",
                 existing_align_stats: str | None = None,
                 use_existing_chrom_depths: bool = False,
                 per_read_group_stats: bool = False,
                 hygen_bin_count: int | None = None,
                 hygen_bin_range: tuple | None = None,
                 tracker_tag: str = "",
                 stop_after: str | None = None,
                 advanced: dict | None = None,
                 verbose: bool = True,
                 device=None,
                 jump_scorer=None):
    """Run phases 0-2 and write the results tree under ``run_dir``.

    ``device``: the torch device of contig jump scoring and, for
    'exact' and 'mxu', of the split scan when device scoring is on
    (None means CUDA; ``"cpu"`` runs the plain PyTorch forms). Every
    other argument is that of the JAX package's ``workflow.run``.
    ``jump_scorer``: with device scoring on, a contig scorer of the
    caller's own in place of the bucketed scorer on ``device`` (a
    callable from jobs to int32 scores, e.g. the mesh-sharded one of
    ``parallel.mesh_scoring``)."""
    # advanced defaults tier (reference: configManta.py.ini values
    # parsed by configureUtil.py; see workflow/config_defaults.ini)
    adv = dict(ADVANCED_DEFAULTS)
    if advanced:
        unknown = set(advanced) - set(adv)
        if unknown:
            raise ValueError(f"unknown advanced options: {sorted(unknown)}")
        adv.update(advanced)
    if is_rna:
        # (reference: mantaWorkflow.py:761 — RNA mode replaces the
        # candidate size floor with the RNA-specific value)
        min_candidate_variant_size = adv["rna_min_candidate_variant_size"]
    if n_jobs <= 0:
        # memory/core-aware auto sizing (reference: estimateHardware.py
        # core + getNodeMemMb detection feeding pyflow's memMb-
        # constrained scheduler; per-worker guidance is < 2 GB/core,
        # docs/userGuide/README.md:481-484)
        n_jobs = os.cpu_count() or 1
        try:
            mem_gb = (os.sysconf("SC_PAGE_SIZE")
                      * os.sysconf("SC_PHYS_PAGES")) / 1e9
            n_jobs = max(1, min(n_jobs, int(mem_gb // 2)))
        except (ValueError, OSError):
            pass
    os.makedirs(os.path.join(run_dir, "results", "variants"), exist_ok=True)
    os.makedirs(os.path.join(run_dir, "results", "stats"), exist_ok=True)
    os.makedirs(os.path.join(run_dir, "workspace"), exist_ok=True)

    bams = list(normal_bams) + list(tumor_bams)
    is_tumor = [False] * len(normal_bams) + [True] * len(tumor_bams)
    is_somatic = bool(tumor_bams) and bool(normal_bams)
    is_tumor_only = bool(tumor_bams) and not normal_bams
    device_scoring = resolve_device_scoring(use_device_scoring)
    scoring_device = resolve_device(device_scoring, device)
    if scoring_device is not None and scoring_device.type == "cuda":
        build_kernels(device_scoring)
    # contig jump scoring rides the same device decision; the native
    # score-only batch is the host fallback (both are bit-exact vs the
    # traceback aligner, so this is purely a performance choice)
    jump_backend = "device" if device_scoring else "native"
    if jump_scorer is not None:
        if not device_scoring:
            raise ValueError("jump_scorer needs device scoring on")
        jump_backend = jump_scorer

    from ..native_core import load as load_native_core
    load_native_core()
    fasta = FastaReader(reference)
    readers = [open_alignment_reader(p, reference) for p in bams]
    header = readers[0].header

    workspace_dir = os.path.join(run_dir, "workspace")
    log_path = os.path.join(workspace_dir, "workflow_log.txt")
    log_fp = open(log_path, "a")

    def log(msg):
        import datetime
        stamp = datetime.datetime.now().isoformat(timespec="milliseconds")
        log_fp.write(f"[{stamp}] {msg}\n")
        log_fp.flush()
        if verbose:
            print(f"[manta-tpu-torch] {msg}", file=sys.stderr, flush=True)

    # persistent task state: re-running on the same run directory
    # resumes at the last completed task (reference: pyflow completed-
    # task records + runWorkflow.py re-execution semantics,
    # docs/userGuide/README.md:631-633)
    from ..workflow.tasks import TaskTracker, content_digest
    tracker_sig = {
        "bams": bams, "is_tumor": is_tumor, "reference": reference,
        "regions": regions, "is_exome": is_exome, "is_rna": is_rna,
        "min_candidate_variant_size": min_candidate_variant_size,
        "min_edge_observations": min_edge_observations,
        "generate_evidence_bam": generate_evidence_bam,
        "call_regions": call_regions, "scan_size_mb": scan_size_mb,
        "is_output_contig": is_output_contig,
        "is_unstranded_rna": is_unstranded_rna,
        "locus_index": locus_index, "advanced": adv,
        "per_read_group_stats": per_read_group_stats,
        "existing_align_stats": existing_align_stats,
        "use_existing_chrom_depths": use_existing_chrom_depths,
    }
    tasks = TaskTracker(
        workspace_dir, tracker_sig,
        state_name=f"taskState{tracker_tag}.json" if tracker_tag else None)

    # phase 0: alignment stats (reusable checkpoint; reference:
    # pyflow task resume + --rescore, mantaWorkflow.py)
    stats_path = os.path.join(run_dir, "workspace", "alignmentStats.json")
    with worker_trace.span("phase0.fragstats"):
        if tasks.is_done("alignmentStats") or \
                (is_rescore and os.path.exists(stats_path)):
            log("resume: reusing fragment-size statistics")
            stats_set = ReadGroupStatsSet.load(stats_path)
            stats_list = [stats_set.get_stats(p) for p in bams]
        else:
            log("estimating fragment-size statistics")
            stats_set = ReadGroupStatsSet()
            if n_jobs > 1 and len(bams) > 1:
                # per-BAM estimates are independent; fan out like the
                # reference's per-BAM GetAlignmentStats tasks
                # (mantaWorkflow.py:190-202)
                import multiprocessing as mp
                from ..core.fragstats import ReadGroupStats
                ctx = mp.get_context("fork")
                queue = ctx.SimpleQueue()

                def stats_worker(i, p):
                    from ..io.bam import BamReader
                    from ..io.bgzf import set_worker_io_threads
                    worker_trace.enter_worker("phase0")
                    fanout = min(n_jobs, len(bams))
                    set_worker_io_threads(fanout)
                    BamReader.set_worker_cache_budget(fanout)
                    with worker_trace.span("phase0.bam", bam=p):
                        per_rg = extract_read_group_stats_set(
                            p, reference=reference,
                            default_stats=existing_align_stats,
                            per_read_group=per_read_group_stats)
                    queue.put((i, {rg: s.to_dict()
                                   for rg, s in per_rg.items()}))

                # in-flight scheduling — see
                # parallel.forkpool.drain_fork_result for why is_alive()
                # gating deadlocks
                results: dict[int, dict] = {}
                procs: list = []
                nxt = 0
                in_flight = 0
                while len(results) < len(bams):
                    while nxt < len(bams) and in_flight < n_jobs:
                        pr = ctx.Process(target=stats_worker,
                                         args=(nxt, bams[nxt]))
                        pr.start()
                        procs.append(pr)
                        in_flight += 1
                        nxt += 1
                    i, d = drain_fork_result(queue, procs)
                    in_flight -= 1
                    results[i] = d
                for pr in procs:
                    pr.join()
                for i, p in enumerate(bams):
                    stats_set.set_file_stats(
                        p, {rg: ReadGroupStats.from_dict(d)
                            for rg, d in results[i].items()})
            else:
                for p in bams:
                    stats_set.set_file_stats(p, extract_read_group_stats_set(
                        p, reference=reference,
                        default_stats=existing_align_stats,
                        per_read_group=per_read_group_stats))
            stats_list = [stats_set.get_stats(p) for p in bams]
            stats_set.save(stats_path)
            tasks.mark_done("alignmentStats", [stats_path])
        from ..workflow.stats import (
            CpuTimes, EdgeStatsTracker, TimeBlock,
            write_alignment_stats_summary, write_graph_stats,
        )
        stats_dir = os.path.join(run_dir, "results", "stats")
        write_alignment_stats_summary(
            stats_set, os.path.join(stats_dir, "alignmentStatsSummary.txt"))

    scan_opt = ScannerOptions(
        min_candidate_variant_size=min_candidate_variant_size,
        is_ignore_anom_proper_pair=is_rna,
        use_overlap_pair_evidence=adv["use_overlap_pair_evidence"])
    scanner = SVScanner(
        scan_opt, [s.frag_stats for s in stats_list],
        header.ref_lengths, header.ref_names, is_rna=is_rna,
        is_transcript_strand_known=(is_rna and not is_unstranded_rna))
    scanner.rg_frag_dists = [
        ({rg: s.frag_stats for rg, s in stats_set.file_groups(p)}
         if len(stats_set.file_groups(p)) > 1 else None)
        for p in bams]

    # chrom depth (WGS only; reference: mantaGetDepthFromAlignments uses
    # normal BAMs when present, else tumor BAMs)
    chrom_depths = None
    if not (is_exome or is_rna):
        from ..core.chromdepth import (
            estimate_chrom_depths, parse_chrom_depth, write_chrom_depth,
        )
        with worker_trace.span("phase0.depth"):
            depth_path = os.path.join(run_dir, "workspace", "chromDepth.txt")
            if use_existing_chrom_depths:
                # (reference: --useExistingChromDepths, mantaWorkflow.py:843
                # — skip estimation; the user pre-places chromDepth.txt in
                # the run workspace)
                if not os.path.exists(depth_path):
                    raise FileNotFoundError(
                        f"--useExistingChromDepths set but {depth_path} "
                        "not found")
                log("using pre-calculated chromosome depth")
                chrom_depths = parse_chrom_depth(depth_path)
            elif tasks.is_done("chromDepth") or \
                    (is_rescore and os.path.exists(depth_path)):
                log("resume: reusing chromosome depth")
                chrom_depths = parse_chrom_depth(depth_path)
            else:
                log("estimating chromosome depth")
                depth_bams = normal_bams if normal_bams else tumor_bams
                chrom_depths = estimate_chrom_depths(
                    depth_bams, reference=reference, n_jobs=n_jobs)
                write_chrom_depth(depth_path, chrom_depths)
                tasks.mark_done("chromDepth", [depth_path])

    region_list = plan_scan_segments(header, regions, call_regions,
                                     scan_size_mb)

    # phase 1: locus graph
    graph_path = os.path.join(run_dir, "workspace", "svLocusGraph.npz")
    graph_opt = SVLocusSetOptions(
        observation_weight=3,
        min_merge_edge_observations=min_edge_observations)
    graph_stats_path = os.path.join(stats_dir, "svLocusGraphStats.tsv")
    built = False
    build_tb = TimeBlock()
    merge_tb = TimeBlock()
    if tasks.is_done("graph") or \
            (is_rescore and os.path.exists(graph_path)):
        log("resume: reusing breakend graph")
    else:
        log("building breakend graph")
        built = True
        if n_jobs > 1 and len(region_list) > 1:
            # parallel path: parts merge, finalize, and save entirely in
            # the native engine — no Python graph objects exist until
            # the single load below (the old objectify/finalize/save/
            # re-objectify chain cost O(nodes) Python work 3x over at
            # the WGS phase boundary)
            with build_tb:
                _estimate_sv_loci_parallel(
                    bams, is_tumor, scanner, graph_opt, region_list,
                    reference, chrom_depths, n_jobs,
                    out_path=graph_path, merge_tb=merge_tb,
                    tasks=tasks, workspace_dir=workspace_dir, log=log)
            log(f"graph phase complete in {build_tb.times.wall:.1f}s "
                "(native merge/finalize/save)")
        else:
            # every segment scanned in this process
            with build_tb, worker_trace.span("phase1.segments"), \
                    worker_trace.span("phase1.segment",
                                      regions=[list(r) for r in region_list]):
                locus_set = estimate_sv_loci(
                    bams, is_tumor, scanner, graph_opt, region_list, fasta,
                    chrom_depths=chrom_depths)
            with merge_tb, worker_trace.span("phase1.finalize"):
                locus_set.finalize()
            save_t0 = time.perf_counter()
            with worker_trace.span("phase1.save"):
                locus_set.save(graph_path)
            log(f"graph built in {build_tb.times.wall:.1f}s, finalized "
                f"in {merge_tb.times.wall:.1f}s, saved in "
                f"{time.perf_counter() - save_t0:.1f}s")
    # load for phase 2: the serialization round-trip compacts empty
    # locus slots, matching the reference's save/load locus renumbering
    from ..graph.locusgraph import SVLocusSet
    load_t0 = time.perf_counter()
    with worker_trace.span("phase1.load"):
        locus_set = SVLocusSet.load(graph_path)
    log(f"graph loaded for phase 2 in {time.perf_counter() - load_t0:.1f}s")
    if built:
        write_graph_stats(
            locus_set, graph_stats_path,
            build_time=build_tb.times, merge_time=merge_tb.times)
        tasks.clear("graph.part.")
        tasks.mark_done("graph", [graph_path, graph_stats_path])
    log(f"graph complete: {locus_set.non_empty_size()} loci, "
        f"{locus_set.total_node_count()} nodes")
    if stop_after == "graph":
        log("stopping after graph phase (multi-host bootstrap)")
        log_fp.close()
        return run_dir

    # phase 2: candidate generation and scoring
    with worker_trace.span("phase2"):
        log("generating and scoring SV candidates")
        variants_dir = os.path.join(run_dir, "results", "variants")
        unsorted_dir = os.path.join(run_dir, "workspace")
        sample_names = [get_sample_name(r, f"SAMPLE{i + 1}")
                        for i, r in enumerate(readers)]
        proc_opt = ProcessorOptions(
            min_candidate_variant_size=min_candidate_variant_size,
            is_rna=is_rna,
            min_candidate_spanning_count=adv["min_candidate_spanning_count"],
            min_scored_variant_size=adv["min_scored_variant_size"])
        # remote-read retrieval defaults differ by calling mode
        # (reference: mantaWorkflow.py:535-543, configManta.py.ini:44-52)
        is_cancer_mode = is_somatic or is_tumor_only
        enable_remote_retrieval = (
            adv["enable_remote_read_retrieval_cancer"] if is_cancer_mode
            else adv["enable_remote_read_retrieval_germline"])

        vcf_names = ["candidateSV.vcf"]
        if is_rna:
            vcf_names.append("rnaSV.vcf")
        elif is_tumor_only:
            vcf_names.append("tumorSV.vcf")
        else:
            vcf_names.append("diploidSV.vcf")
            if is_somatic:
                vcf_names.append("somaticSV.vcf")

        def build_components(bin_suffix: str = ""):
            """Construct per-process phase-2 pipeline components
            (readers/writers re-opened per process)."""
            from ..format.vcfwriter import VcfWriterRnaSV
            comp_fasta = FastaReader(reference)
            finder = SVFinder(scanner, bams, is_tumor, locus_set.sample_counts,
                              comp_fasta, chrom_depths=chrom_depths,
                              is_rna=is_rna,
                              skip_evidence_signal_filter=(
                                  not adv["enable_evidence_signal_filter"]))
            refiner = SVCandidateAssemblyRefiner(
                scanner, finder.readers, is_tumor, comp_fasta,
                chrom_depths=chrom_depths,
                min_candidate_variant_size=min_candidate_variant_size,
                is_output_contig=is_output_contig, is_rna=is_rna,
                is_unstranded_rna=is_unstranded_rna,
                enable_remote_read_retrieval=enable_remote_retrieval,
                jump_score_backend=jump_backend, device=scoring_device)
            from ..scoring.scorer import CallOptionsDiploid, CallOptionsSomatic
            scorer = SVScorer(
                scanner, finder.readers, is_tumor, comp_fasta,
                chrom_depths=chrom_depths, is_rna=is_rna,
                use_device_scoring=device_scoring, device=scoring_device,
                diploid_opt=CallOptionsDiploid(
                    min_output_alt_score=adv["min_diploid_variant_score"],
                    min_pass_alt_score=adv["min_pass_diploid_variant_score"],
                    min_pass_gt_score=adv["min_pass_diploid_gt_score"],
                    dup_gt_model=adv["dup_genotype_model"]),
                somatic_opt=CallOptionsSomatic(
                    min_output_somatic_score=adv["min_somatic_score"],
                    min_pass_somatic_score=adv["min_pass_somatic_score"]))

            def vpath(name):
                return os.path.join(unsorted_dir, name + bin_suffix)

            cand_writer = VcfWriterCandidateSV(
                reference, header.ref_names, header.ref_lengths, comp_fasta,
                vpath("candidateSV.vcf"), is_output_contig=is_output_contig)
            cand_writer.write_header(PROG_NAME, PROG_VERSION, [])
            diploid_writer = somatic_writer = tumor_writer = rna_writer = None
            if is_rna:
                rna_writer = VcfWriterRnaSV(
                    reference, header.ref_names, header.ref_lengths,
                    comp_fasta,
                    vpath("rnaSV.vcf"), is_output_contig=is_output_contig)
                rna_writer.write_header(PROG_NAME, PROG_VERSION, sample_names)
            elif is_tumor_only:
                tumor_writer = VcfWriterTumorSV(
                    scorer.tumor_opt, chrom_depths is not None,
                    reference, header.ref_names, header.ref_lengths,
                    comp_fasta,
                    vpath("tumorSV.vcf"), is_output_contig=is_output_contig)
                tumor_writer.write_header(PROG_NAME, PROG_VERSION,
                                          sample_names)
            else:
                diploid_sample_names = [
                    n for n, t in zip(sample_names, is_tumor) if not t]
                diploid_writer = VcfWriterDiploidSV(
                    scorer.diploid_opt, chrom_depths is not None,
                    reference, header.ref_names, header.ref_lengths,
                    comp_fasta,
                    vpath("diploidSV.vcf"), is_output_contig=is_output_contig)
                diploid_writer.write_header(PROG_NAME, PROG_VERSION,
                                            diploid_sample_names)
                if is_somatic:
                    somatic_writer = VcfWriterSomaticSV(
                        scorer.somatic_opt, chrom_depths is not None,
                        reference, header.ref_names, header.ref_lengths,
                        comp_fasta, vpath("somaticSV.vcf"),
                        is_output_contig=is_output_contig)
                    somatic_writer.write_header(PROG_NAME, PROG_VERSION,
                                                sample_names)

            writer = SVWriter(
                cand_writer, diploid_writer, somatic_writer, tumor_writer,
                rna_writer=rna_writer,
                diploid_sample_count=sum(1 for t in is_tumor if not t),
                min_output_alt_score=scorer.diploid_opt.min_output_alt_score,
                min_output_somatic_score=(
                    scorer.somatic_opt.min_output_somatic_score))

            tracker = EdgeStatsTracker()
            evidence_writer = None
            if generate_evidence_bam:
                from ..scoring.evidence_bam import SVEvidenceWriter
                evidence_dir = os.path.join(run_dir, "results", "evidence")
                os.makedirs(evidence_dir, exist_ok=True)
                out_paths = []
                for bi, bam_path in enumerate(bams):
                    prefix = os.path.splitext(os.path.basename(bam_path))[0]
                    out_paths.append(os.path.join(
                        evidence_dir,
                        f"evidence_{bi}.{prefix}{bin_suffix}.bam"))
                evidence_writer = SVEvidenceWriter(
                    bams, out_paths, reference=reference)
            processor = SVCandidateProcessor(
                proc_opt, refiner, scorer, writer, locus_set, is_somatic,
                is_tumor_only, edge_tracker=tracker,
                evidence_enabled=generate_evidence_bam)
            all_writers = [w for w in (cand_writer, diploid_writer,
                                       somatic_writer, tumor_writer,
                                       rna_writer)
                           if w is not None]
            return {
                "finder": finder, "processor": processor, "tracker": tracker,
                "evidence_writer": evidence_writer, "writers": all_writers,
            }

        def run_edges(comps, edges):
            """Staged candidate generation/scoring over edge chunks:
            per-edge candidate finding + assembly (stage 1), one batched
            contig-alignment dispatch per chunk across every edge's
            junctions (stage 2: many edges a kernel launch, SURVEY §2.4
            P3), then in-order selection/scoring/output (stage 3).
            Returns the edge runtime log lines."""
            from ..core.svmodel import is_complex_sv
            from copy import copy as _copy
            finder = comps["finder"]
            processor = comps["processor"]
            tracker = comps["tracker"]
            evidence_writer = comps["evidence_writer"]
            edge_runtime_log = []
            # cross-edge batching pays off when contig scoring dispatches to
            # the device (one launch per chunk); on the host-native backend
            # a chunk of 1 keeps the per-edge fetch windows cache-hot.
            # MANTA_TPU_EDGE_CHUNK overrides. The device default of 24 is
            # the JAX package's, kept as it is until a benchmark decides it
            # (ROADMAP.md Queue 1 item 1). On the card a dispatch of the
            # high-span shape (a 24-edge chunk, 16 rows) took 1.7 ms of the
            # dispatcher's wall, 0.27 ms of it K1's device time
            # (tools.device_timing --kernel workflow; NVIDIA H100 80GB HBM3,
            # 700.00 W; PERF.md section 6)
            CHUNK = int(os.environ.get("MANTA_TPU_EDGE_CHUNK",
                                       "24" if device_scoring else "1"))
            for c0 in range(0, len(edges), CHUNK):
                chunk = edges[c0:c0 + CHUNK]
                prepared = []
                for edge in chunk:
                    li, n1, n2 = edge
                    is_self = (n1 == n2)
                    with worker_trace.span("chunk.find"):
                        finder_before = _copy(finder.stats)
                        cand_tb = TimeBlock()
                        with cand_tb:
                            svs, groups = finder.find_candidate_sv(
                                locus_set, li, n1, n2)
                        delta = _copy(finder.stats)
                        for k in vars(delta):
                            setattr(delta, k, getattr(delta, k)
                                    - getattr(finder_before, k))
                        tracker.update_edge_candidates(is_self, len(svs),
                                                       delta)
                        mj_groups = find_multi_junction_candidates(
                            svs, proc_opt.min_candidate_spanning_count,
                            is_rna)
                        mj_total = sum(len(g) for g in mj_groups)
                        tracker.update_mj_filter(
                            is_self,
                            sum(1 for sv in svs if is_complex_sv(sv)),
                            max(0, len(svs) - mj_total))
                    prep_tb = TimeBlock()
                    with worker_trace.span("chunk.assemble"), prep_tb:
                        st = processor.prepare_candidates(edge, mj_groups,
                                                          groups)
                    prepared.append((edge, svs, cand_tb, prep_tb, st))
                with worker_trace.span("chunk.contig_align"):
                    processor.flush_pending([st for *_r, st in prepared])
                for (edge, svs, cand_tb, prep_tb, st) in prepared:
                    li, n1, n2 = edge
                    fin_tb = TimeBlock()
                    with worker_trace.span("chunk.score",
                                           samples=len(bams)), fin_tb:
                        processor.finish_candidates(st)
                        if evidence_writer is not None and \
                                st.edge_support is not None:
                            evidence_writer.write(st.edge_support)
                    total = CpuTimes()
                    for t in (cand_tb.times, prep_tb.times, fin_tb.times):
                        total.merge(t)
                    total.wall += getattr(st, "flush_wall", 0.0)
                    tracker.add_times(st.is_self_edge, total, cand_tb.times,
                                      st.assembly_time, st.scoring_time)
                    if total.wall >= 0.5:
                        # (reference: EdgeRuntimeTracker.cpp stop(),
                        # minLogTime=0.5)
                        edge_runtime_log.append(
                            f"{li}:{n1}:{n2}\t{total.wall:.4g}"
                            f"\t{len(svs)}"
                            f"\t{sum(1 for sv in svs if is_complex_sv(sv))}"
                            f"\t{st.assembled_count}"
                            f"\t{st.assembled_complex_count}"
                            f"\t{cand_tb.times.wall:.4g}"
                            f"\t{st.assembly_time.wall:.4g}"
                            f"\t0\t{st.scoring_time.wall:.4g}\n")
            return edge_runtime_log

        all_edges = list(iterate_edges(
            locus_set,
            graph_node_max_edge_count=adv["graph_node_max_edge_count"]))
        if locus_index is not None:
            # single-locus debug mode (reference: EdgeRetrieverLocus,
            # GSC --locus-index)
            all_edges = [e for e in all_edges if e[0] == locus_index]
        if is_rescore:
            # --rescore always re-runs candidate generation and scoring
            # (reference: mantaWorkflow.py rescore path)
            tasks.clear("hygen")
        hygen_artifacts = [os.path.join(unsorted_dir, n) for n in vcf_names]
        hygen_artifacts += [
            os.path.join(run_dir, "workspace", "edgeRuntimeLog.txt"),
            os.path.join(stats_dir, "svCandidateGenerationStats.tsv"),
            os.path.join(stats_dir, "svCandidateGenerationStats.xml")]
        if tasks.is_done("hygen"):
            log("resume: reusing candidate generation and scoring results")
        else:
            if (n_jobs > 1 or hygen_bin_count is not None) \
                    and len(all_edges) > 1:
                tracker, edge_runtime_log = _run_edges_parallel(
                    all_edges, locus_set, build_components, run_edges,
                    vcf_names, unsorted_dir, n_jobs, generate_evidence_bam,
                    os.path.join(run_dir, "results", "evidence"), bams,
                    edge_bin_strategy=edge_bin_strategy,
                    tasks=tasks, log=log,
                    n_bins=hygen_bin_count, bin_range=hygen_bin_range,
                    do_merge=(hygen_bin_range is None))
                if hygen_bin_range is not None:
                    # (per-host edge count logged by _run_edges_parallel's
                    # do_merge=False path)
                    log(f"host bins {hygen_bin_range[0]}.."
                        f"{hygen_bin_range[1] - 1} complete "
                        "(multi-host phase 2)")
                    log_fp.close()
                    return run_dir
            else:
                comps = build_components()
                edge_runtime_log = run_edges(comps, all_edges)
                tracker = comps["tracker"]
                for w in comps["writers"]:
                    w.stream.close()
                if comps["evidence_writer"] is not None:
                    comps["evidence_writer"].close()
            edge_count = len(all_edges)
            log(f"processed {edge_count} graph edges")
            # (reference: libexec/sortEdgeLogs.py — slowest edges first)
            edge_runtime_log.sort(
                key=lambda l: float(l.split("\t", 2)[1]), reverse=True)
            with open(os.path.join(run_dir, "workspace", "edgeRuntimeLog.txt"),
                      "w") as f:
                f.writelines(edge_runtime_log)
            with open(os.path.join(stats_dir,
                                   "svCandidateGenerationStats.tsv"),
                      "w") as f:
                f.writelines(tracker.report())
            tracker.save_xml(
                os.path.join(stats_dir, "svCandidateGenerationStats.xml"))
            tasks.clear("hygen.bin.")
            tasks.mark_done("hygen", hygen_artifacts)

    # final output stage (reference: mantaWorkflow.py sortAllVcfs):
    # sort + dedup, ploidy-filter diploid, extract small indels, then
    # bgzip + tabix into results/variants
    from ..workflow.postprocess import (
        extract_small_indel_lines, ploidy_filter_lines, sort_vcf_lines,
        swap_cmdline_lines,
    )
    final_cmdline = cmdline if cmdline is not None else \
        " ".join(sys.argv)
    from ..format.tabix import write_vcf_gz

    def read_lines(name):
        path = os.path.join(unsorted_dir, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.readlines()

    with worker_trace.span("final.sort_index"):
        sort_t0 = time.perf_counter()
        cand_lines = read_lines("candidateSV.vcf")
        if cand_lines is not None:
            cand_lines = swap_cmdline_lines(cand_lines, final_cmdline)
            sorted_cand = sort_vcf_lines(cand_lines, print_all=True)
            write_vcf_gz(sorted_cand,
                         os.path.join(variants_dir, "candidateSV.vcf.gz"))
            max_small = proc_opt.min_scored_variant_size - 1
            if max_small >= 1:
                write_vcf_gz(
                    extract_small_indel_lines(sorted_cand, max_small),
                    os.path.join(variants_dir, "candidateSmallIndels.vcf.gz"))
        for name, out_name, is_diploid in (
                ("diploidSV.vcf", "diploidSV.vcf.gz", True),
                ("somaticSV.vcf", "somaticSV.vcf.gz", False),
                ("tumorSV.vcf", "tumorSV.vcf.gz", False),
                ("rnaSV.vcf", "rnaSV.vcf.gz", False)):
            lines = read_lines(name)
            if lines is None:
                continue
            lines = swap_cmdline_lines(lines, final_cmdline)
            lines = sort_vcf_lines(lines)
            if is_diploid:
                lines = ploidy_filter_lines(lines)
            write_vcf_gz(lines, os.path.join(variants_dir, out_name))
        log(f"sorted and indexed final VCFs in "
            f"{time.perf_counter() - sort_t0:.1f}s")
    log("workflow complete")
    log_fp.close()
    return run_dir


def _partition_edges(locus_set, edges, n_bins: int):
    """Observation-weighted contiguous edge binning
    (reference: EdgeRetrieverBin.cpp:38-61 equal-work bins)."""
    weights = []
    for (li, n1, n2) in edges:
        locus = locus_set.loci[li]
        w = locus.nodes[n1].edges.get(n2, 0)
        if n1 != n2:
            w += locus.nodes[n2].edges.get(n1, 0)
        weights.append(max(w, 1))
    total = sum(weights)
    target = total / n_bins
    bins = []
    cur = []
    acc = 0.0
    for e, w in zip(edges, weights):
        cur.append(e)
        acc += w
        if acc >= target * (len(bins) + 1) and len(bins) < n_bins - 1:
            bins.append(cur)
            cur = []
    bins.append(cur)
    return [b for b in bins if b]


def _partition_edges_jump(locus_set, edges, n_bins: int):
    """Interleaved observation-balanced edge binning
    (reference: EdgeRetrieverJumpBin.cpp:35-124): edges round-robin over
    bins by edge index, jumping past bins already at the average
    observation load. The reference variant is flagged with an edge
    repetition/dropout bug because each parallel process only accounts
    its OWN bin's load (EdgeRetrieverJumpBin.cpp:105-114), so per-process
    views of bin fullness diverge; computing every bin in one pass here
    keeps one consistent load table, which removes the bug while
    preserving the intended assignment rule."""
    avg = 1 + locus_set.total_observation_count() // n_bins
    bin_total = [0] * n_bins
    bins = [[] for _ in range(n_bins)]
    for edge_index, (li, n1, n2) in enumerate(edges):
        first = edge_index % n_bins
        target = first
        while bin_total[target] >= avg:
            target = (target + 1) % n_bins
            if target == first:
                break
        locus = locus_set.loci[li]
        w = locus.nodes[n1].edges.get(n2, 0)
        if n1 != n2:
            w += locus.nodes[n2].edges.get(n1, 0)
        bin_total[target] += w
        bins[target].append((li, n1, n2))
    return [b for b in bins if b]


def _run_edges_parallel(all_edges, locus_set, build_components, run_edges,
                        vcf_names, unsorted_dir, n_jobs,
                        generate_evidence_bam, evidence_dir, bams,
                        edge_bin_strategy: str = "contiguous",
                        tasks=None, log=None,
                        n_bins: int | None = None,
                        bin_range: tuple | None = None,
                        do_merge: bool = True):
    """Fork-based phase-2 scale-out: observation-weighted edge bins per
    worker, per-bin VCF shards merged in bin order afterwards
    (reference: GenerateSVCandidates thread pool + legacy
    --bin-index/--bin-count multi-process mode). With a task tracker,
    each completed bin's shards + runtime stats persist in the workspace
    and are reused on resume (reference: pyflow per-task records).

    Multi-host mode (parallel/distributed.run_host_phase2): n_bins is
    the GLOBAL bin count over all hosts, bin_range selects this host's
    slice, and do_merge=False defers the shard merge to the host-0
    finalize pass. Each bin's pickle carries its edge-content digest, so
    the finalize pass (a different process with its own task state)
    recognizes completed bins and never reuses a stale work plan."""
    import multiprocessing as mp
    import pickle
    from ..workflow.stats import EdgeStatsTracker
    from ..workflow.tasks import content_digest
    # the merged SVGenTotalHours is the SUM of bin-worker lifetimes
    # plus this parent's span (reference: GSCEdgeStatsData::merge sums
    # lifeTime across per-process stats, GSCEdgeStats.hpp:139-144)
    tracker = EdgeStatsTracker()
    if n_bins is None:
        n_bins = n_jobs
    if edge_bin_strategy == "jump":
        bins = _partition_edges_jump(locus_set, all_edges, n_bins)
    else:
        bins = _partition_edges(locus_set, all_edges, n_bins)
    ctx = mp.get_context("fork")
    queue = ctx.SimpleQueue()

    def bin_artifacts(bi):
        paths = [os.path.join(unsorted_dir, f"{name}.{bi:04d}")
                 for name in vcf_names]
        if generate_evidence_bam:
            for smp, bam_path in enumerate(bams):
                prefix = os.path.splitext(os.path.basename(bam_path))[0]
                paths.append(os.path.join(
                    evidence_dir,
                    f"evidence_{smp}.{prefix}.{bi:04d}.bam"))
        paths.append(os.path.join(unsorted_dir, f"hygenBin.{bi:04d}.pkl"))
        return paths

    bin_digests = [content_digest(edges) for edges in bins]

    def pkl_path(bi):
        return os.path.join(unsorted_dir, f"hygenBin.{bi:04d}.pkl")

    def pkl_done(bi):
        """Bin complete per its persisted pickle (cross-host/cross-
        process completion marker; the digest guards stale plans)."""
        try:
            with open(pkl_path(bi), "rb") as f:
                digest, _lines, _tr = pickle.load(f)
            return digest == bin_digests[bi]
        except (OSError, ValueError, EOFError, pickle.UnpicklingError):
            return False

    def worker(bi, edges):
        # a no-op unless the run's trace is armed
        worker_trace.enter_phase2_worker(bi)
        from ..io.bam import BamReader
        from ..io.bgzf import set_worker_io_threads
        with worker_trace.span("worker.setup"):
            fanout = min(max(1, n_jobs), len(bins))
            set_worker_io_threads(fanout)
            BamReader.set_worker_cache_budget(fanout)
            comps = build_components(f".{bi:04d}")
        log_lines = run_edges(comps, edges)
        with worker_trace.span("worker.write"):
            for w in comps["writers"]:
                w.stream.close()
            if comps["evidence_writer"] is not None:
                comps["evidence_writer"].close()
            # persist the bin's runtime log + edge stats so a resumed run
            # can reuse this bin without recomputing it; close the
            # lifetime clock here so it records the worker's own process
            # time
            comps["tracker"].life_times()
            pkl = pkl_path(bi)
            with open(pkl + ".tmp", "wb") as f:
                pickle.dump((bin_digests[bi], log_lines, comps["tracker"]),
                            f)
            os.replace(pkl + ".tmp", pkl)
        worker_trace.bin_finished()
        queue.put(bi)

    task_names = [f"hygen.bin.{bi:04d}.{bin_digests[bi]}"
                  for bi in range(len(bins))]
    lo, hi = bin_range if bin_range is not None else (0, len(bins))
    pending = []
    n_reused = 0
    for bi in range(lo, hi):
        if (tasks is not None and tasks.is_done(task_names[bi])) or \
                pkl_done(bi):
            n_reused += 1
        else:
            pending.append((bi, bins[bi]))
    if n_reused and log is not None:
        log(f"resume: reusing {n_reused}/{hi - lo} candidate-"
            "generation bins")
    # bounded in-flight forks (a host may own more bins than cores),
    # with one per-bin retry on worker death (reference: pyflow task
    # retry, redist/pyflow README "Task restart/retry")
    attempts = {bi: 0 for bi, _ in pending}
    comp: set = set()
    work = list(pending)
    pi = 0
    in_flight = 0
    procs = []
    while len(comp) < len(attempts):
        while pi < len(work) and in_flight < max(1, n_jobs):
            bi, edges = work[pi]
            pr = ctx.Process(target=worker, args=(bi, edges))
            pr.start()
            procs.append(pr)
            in_flight += 1
            pi += 1
        try:
            bi = drain_fork_result(queue, procs)
        except RuntimeError as e:
            # a worker died without reporting; the drain terminated all
            # live workers, so requeue every unreported launched bin
            retry = []
            for item in work[:pi]:
                if item[0] in comp:
                    continue
                attempts[item[0]] += 1
                if attempts[item[0]] > 1:
                    raise
                retry.append(item)
            if log is not None:
                log(f"retrying {len(retry)} failed candidate-"
                    f"generation bin(s): {e}")
            work = retry + work[pi:]
            pi = 0
            in_flight = 0
            procs = []
            queue = ctx.SimpleQueue()
            continue
        comp.add(bi)
        in_flight -= 1
        if tasks is not None:
            tasks.mark_done(task_names[bi], bin_artifacts(bi))
    for pr in procs:
        pr.join()
    if not do_merge:
        if log is not None:
            host_edges = sum(len(bins[bi]) for bi in range(lo, hi))
            log(f"host processed {host_edges} graph edges "
                f"(bins {lo}..{hi - 1})")
        return None, None
    with worker_trace.span("phase2.merge_shards"):
        results = []
        for bi in range(len(bins)):
            if not pkl_done(bi):
                raise FileNotFoundError(
                    f"phase-2 bin {bi} incomplete (missing/stale "
                    f"{pkl_path(bi)}); run every host's phase-2 pass "
                    "before finalizing")
            with open(pkl_path(bi), "rb") as f:
                _digest, log_lines, bin_tracker = pickle.load(f)
            results.append((bi, log_lines, bin_tracker))

        # merge per-bin vcf shards in bin order (header from shard 0);
        # shards are cleaned up only after every merge step succeeds so a
        # crash mid-merge resumes from the per-bin artifacts
        shard_t0 = time.perf_counter()
        cleanup = []
        for name in vcf_names:
            out_lines = []
            for bi in range(len(bins)):
                shard = os.path.join(unsorted_dir, f"{name}.{bi:04d}")
                if not os.path.exists(shard):
                    continue
                with open(shard) as f:
                    for line in f:
                        if line.startswith("#"):
                            if bi == 0:
                                out_lines.append(line)
                        else:
                            out_lines.append(line)
                cleanup.append(shard)
            with open(os.path.join(unsorted_dir, name), "w") as f:
                f.writelines(out_lines)

        # merge per-bin evidence bams
        if generate_evidence_bam:
            from ..io.bam import BamReader
            from ..io.bamwriter import BamWriter
            for smp, bam_path in enumerate(bams):
                prefix = os.path.splitext(os.path.basename(bam_path))[0]
                final = os.path.join(evidence_dir,
                                     f"evidence_{smp}.{prefix}.bam")
                merged = None
                for bi in range(len(bins)):
                    shard = os.path.join(
                        evidence_dir, f"evidence_{smp}.{prefix}.{bi:04d}.bam")
                    if not os.path.exists(shard):
                        continue
                    rd = BamReader(shard)
                    if merged is None:
                        h = rd.header
                        merged = BamWriter(final, h.text, h.ref_names,
                                           h.ref_lengths)
                    batch = rd.read_all()
                    for i in range(batch.n):
                        merged.add_record(batch, i)
                    cleanup.append(shard)
                    if os.path.exists(shard + ".bai"):
                        cleanup.append(shard + ".bai")
                if merged is not None:
                    merged.close()

        log_lines = []
        for (_bi, lines, tr) in results:
            log_lines.extend(lines)
            tracker.merge_stats_from(tr)
        if log is not None:
            log(f"merged {len(bins)} phase-2 bin shards in "
                f"{time.perf_counter() - shard_t0:.1f}s")
        for bi in range(len(bins)):
            cleanup.append(pkl_path(bi))
        for path in cleanup:
            if os.path.exists(path):
                os.remove(path)
    return tracker, log_lines


def _estimate_sv_loci_parallel(bams, is_tumor, scanner, graph_opt,
                               region_list, reference, chrom_depths,
                               n_jobs, out_path=None, merge_tb=None,
                               tasks=None, workspace_dir=None,
                               log=None):
    """Fork-based phase-1 scale-out: one independent graph PER segment
    group (the reference's 200 kb clumping rule), merged in submission
    order with the first group's graph adopted as the merge base
    (reference: per-group EstimateSVLoci tasks + sequential
    MergeSVLoci over the per-group graph files, mantaWorkflow.py:252-299,
    MergeSVLoci.cpp:48-62). Saving per GROUP — never pre-merging a
    worker's groups — keeps the merge sequence identical to the serial
    path and the reference. When a task tracker is supplied, each
    group's partial graph persists in the run workspace and completed
    groups are skipped on resume (reference: pyflow per-task completion
    records)."""
    import multiprocessing as mp
    import tempfile
    from ..workflow.tasks import content_digest
    from ..graph.locusgraph import SVLocusSet
    from ..graph.finder import group_segments
    groups = group_segments(region_list)
    ctx = mp.get_context("fork")
    queue = ctx.SimpleQueue()
    if workspace_dir is not None:
        tmpdir = os.path.join(workspace_dir, "graphParts")
        os.makedirs(tmpdir, exist_ok=True)
    else:
        tmpdir = tempfile.mkdtemp(prefix="svgraph_")
    # key each group task by its region content so a changed work plan
    # (different -j / segmentation) never reuses a stale part file
    task_names = [f"graph.part.{gi:04d}.{content_digest(regions)}"
                  for gi, regions in enumerate(groups)]
    part_paths = [os.path.join(tmpdir, f"part_{gi:04d}.npz")
                  for gi in range(len(groups))]

    def worker(chunk):
        # one fork serves a CHUNK of groups, but each group still gets
        # its own independent graph + file (per-group merge semantics);
        # results stream back as each group finishes
        from ..io.bam import BamReader
        from ..io.bgzf import set_worker_io_threads
        worker_trace.enter_worker("phase1")
        fanout = min(n_jobs, len(groups))
        set_worker_io_threads(fanout)
        BamReader.set_worker_cache_budget(fanout)
        fasta = FastaReader(reference)
        for gi, regions in chunk:
            with worker_trace.span("phase1.segment",
                                   regions=[list(r) for r in regions]):
                nat, names, lengths, sc = estimate_sv_loci(
                    bams, is_tumor, scanner, graph_opt, regions, fasta,
                    chrom_depths=chrom_depths, as_native=True)
                nat.save_npz(part_paths[gi], names, lengths, len(bams), sc,
                             is_finalized=False)
                nat.free()
            queue.put((gi, part_paths[gi]))

    procs = []
    results = {}
    jobs = []
    for gi, regions in enumerate(groups):
        if tasks is not None and tasks.is_done(task_names[gi]):
            results[gi] = part_paths[gi]
        else:
            jobs.append((gi, regions))
    if results and log is not None:
        log(f"resume: reusing {len(results)}/{len(groups)} graph segments")
    # amortize fork + BAM-open cost: ~4 chunks per worker keeps cores
    # busy under skewed group sizes without one fork per 12 Mb group
    # (jobs may be empty on a resume where every part already finished
    # but the merge didn't)
    if jobs:
        n_chunks = min(n_jobs * 4, len(jobs))
        per = (len(jobs) + n_chunks - 1) // n_chunks
        chunks = [jobs[i:i + per] for i in range(0, len(jobs), per)]
    else:
        chunks = []
    # schedule on an in-flight (spawned - received) count — see
    # parallel.forkpool.drain_fork_result for why is_alive() gating deadlocks
    ci = 0
    live_chunks = 0
    n_total = len(results) + len(jobs)
    with worker_trace.span("phase1.segments"):
        while len(results) < n_total:
            while ci < len(chunks) and live_chunks < n_jobs:
                pr = ctx.Process(target=worker, args=(chunks[ci],))
                pr.start()
                procs.append(pr)
                live_chunks += 1
                ci += 1
            gi, path = drain_fork_result(queue, procs)
            results[gi] = path
            if tasks is not None:
                tasks.mark_done(task_names[gi], [path])
            # a chunk frees its worker slot when its last group reports
            done_chunks = sum(
                1 for k in range(ci)
                if all(g in results for g, _ in chunks[k]))
            live_chunks = ci - done_chunks
        for pr in procs:
            pr.join()

    merge_t0 = time.perf_counter()
    with worker_trace.span("phase1.merge"):
        nat, meta = merge_saved_graphs_native(
            [results[gi] for gi in sorted(results)])
    if log is not None:
        log(f"merged {len(results)} graph parts in "
            f"{time.perf_counter() - merge_t0:.1f}s")
    fin_t0 = time.perf_counter()
    with worker_trace.span("phase1.finalize"):
        if merge_tb is not None:
            with merge_tb:
                nat.finalize_native()
        else:
            nat.finalize_native()
    fin_s = time.perf_counter() - fin_t0
    save_t0 = time.perf_counter()
    with worker_trace.span("phase1.save"):
        nat.save_npz(out_path, meta["chrom_names"], meta["chrom_lengths"],
                     meta["sample_count"], meta["sample_counts"],
                     is_finalized=True)
        nat.free()
    if log is not None:
        log(f"graph finalized in {fin_s:.1f}s, saved in "
            f"{time.perf_counter() - save_t0:.1f}s")
    # parts are removed only after the whole merge + finalized save
    # succeeds so an interrupted merge can resume from the persisted
    # segments
    for gi in sorted(results):
        os.remove(results[gi])
    os.rmdir(tmpdir)


def merge_saved_graphs_native(paths):
    """Sequential merge of saved partial graphs through the native
    engine (reference: MergeSVLoci.cpp); byte-identical to loading each
    part and running SVLocusSet.merge_set in order.

    Returns (NativeLocusSet, meta) where meta carries part 0's header
    fields plus element-wise-summed sample_counts. Every part — the
    first included — loads through the flat native path; no Python
    graph objects are built at the phase boundary (the previous
    objectify-first-part + re-objectify-merged flow cost O(nodes) in
    Python twice at WGS scale)."""
    import json as _json

    import numpy as np

    from ..graph.locusgraph import SVLocusSetOptions
    from ..graph.native_set import NativeLocusSet

    nat = None
    meta0 = None
    for path in paths:
        data = np.load(path)
        meta = _json.loads(data["meta"].tobytes().decode())
        if nat is None:
            # the first part's graph is ADOPTED as the merge base
            # (MergeSVLoci.cpp:48-62)
            meta0 = meta
            nat = NativeLocusSet(SVLocusSetOptions(**meta["opt"]),
                                 len(meta["chrom_names"]))
            nat.load_flat(
                data["locus_sizes"], data["nodes"], data["edges"],
                meta["total_cleaned"], meta["highest_search_count"],
                meta["highest_search_density"],
                meta["is_max_search_count"], meta["is_max_search_density"])
            continue
        assert meta["opt"]["observation_weight"] * \
            meta["opt"]["min_merge_edge_observations"] == \
            nat.opt.min_merge_edge_count
        src = NativeLocusSet(nat.opt, nat.n_tids)
        src.load_flat(
            data["locus_sizes"], data["nodes"], data["edges"],
            meta["total_cleaned"], meta["highest_search_count"],
            meta["highest_search_density"], meta["is_max_search_count"],
            meta["is_max_search_density"])
        nat.merge_native(src)
        src.free()
        for si, counts in enumerate(meta["sample_counts"]):
            tgt = meta0["sample_counts"][si]
            for k, v in counts.items():
                if isinstance(v, list):
                    prev = tgt.get(k, [0] * len(v))
                    tgt[k] = [a + b for a, b in zip(prev, v)]
                elif isinstance(v, str):
                    tgt[k] = v or tgt.get(k, "")
                else:
                    tgt[k] = tgt.get(k, 0) + v
    if nat is None:
        return None, None
    return nat, meta0


def merge_saved_graphs(paths):
    """Python-object variant of merge_saved_graphs_native for callers
    that consume an SVLocusSet directly (workers CLI, distributed
    bootstrap)."""
    nat, meta = merge_saved_graphs_native(paths)
    if nat is None:
        return None
    out = nat.to_locus_set(meta["chrom_names"], meta["chrom_lengths"],
                           meta["sample_count"])
    nat.free()
    out.sample_counts = meta["sample_counts"]
    out.is_finalized = meta["is_finalized"]
    return out


def segment_regions(region_list, segment_size: int):
    """Split regions into near-equal segments no larger than
    segment_size (reference: workflowUtil.py getChromIntervals)."""
    out = []
    for (tid, beg, end) in region_list:
        size = end - beg
        if size <= 0:
            continue
        n_seg = 1 + (size - 1) // segment_size
        base = size // n_seg
        n_plus_one = size % n_seg
        start = beg
        for i in range(n_seg):
            seg = base + (1 if i < n_plus_one else 0)
            out.append((tid, start, min(start + seg, end)))
            start += seg
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Structural variant caller (PyTorch/CUDA port of "
                    "manta_tpu)")
    ap.add_argument("--normal-bam", "--bam", dest="normal_bams",
                    action="append", default=[])
    ap.add_argument("--tumor-bam", dest="tumor_bams", action="append",
                    default=[])
    ap.add_argument("--reference", required=True)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--region", dest="regions", action="append", default=[])
    ap.add_argument("--exome", action="store_true")
    ap.add_argument("--rna", action="store_true")
    ap.add_argument("--min-candidate-sv-size", type=int, default=8)
    ap.add_argument("--min-edge-observations", type=int, default=3)
    ap.add_argument("--generate-evidence-bam", action="store_true")
    ap.add_argument("-j", "--jobs", type=int, default=1,
                    help="worker processes; 0 = all cores")
    ap.add_argument("--locus-index", type=int, default=None,
                    help="debug: process only edges of one graph locus")
    ap.add_argument("--device-scoring", nargs="?", const="exact",
                    default="auto",
                    choices=("auto", "jump", "exact", "mxu", "off"),
                    help="CUDA routing for phase-2 scoring kernels: "
                         "'auto' (default; resolves to 'jump' when a "
                         "CUDA device is present), 'jump' (contig "
                         "jump scoring through the CUDA jump kernel, "
                         "split scans on the host-native path), "
                         "'exact' (adds the split-read scan through "
                         "the CUDA split-scan kernel, bit-identical), "
                         "'mxu' (the matmul split scan, ~1e-6 relative "
                         "score error), or 'off'")
    ap.add_argument("--existing-align-stats", default=None,
                    help="fallback alignment stats JSON used when "
                         "direct estimation from a sample fails "
                         "(reference: --existingAlignStatsFile)")
    ap.add_argument("--per-read-group-stats", action="store_true",
                    help="estimate fragment-size statistics per "
                         "(file, RG) and route pair-support "
                         "likelihoods through each fragment's own "
                         "group (default pools one group per file, "
                         "the reference's shipped READ_GROUPS-off "
                         "behavior)")
    ap.add_argument("--use-existing-chrom-depths", action="store_true",
                    help="use pre-calculated workspace/chromDepth.txt "
                         "(reference: --useExistingChromDepths)")
    ap.add_argument("--rescore", action="store_true",
                    help="reuse phase-0/1 artifacts, re-run candidate "
                         "generation and scoring only")
    ap.add_argument("--edge-bin-strategy", default="contiguous",
                    choices=("contiguous", "jump"),
                    help="phase-2 edge binning: contiguous "
                         "observation-weighted spans (default, "
                         "output-order preserving) or interleaved jump "
                         "bins (EdgeRetrieverJumpBin semantics)")
    args = ap.parse_args(argv)
    run_workflow(args.normal_bams, args.tumor_bams, args.reference,
                 args.run_dir, regions=args.regions or None,
                 is_exome=args.exome, is_rna=args.rna,
                 min_candidate_variant_size=args.min_candidate_sv_size,
                 min_edge_observations=args.min_edge_observations,
                 generate_evidence_bam=args.generate_evidence_bam,
                 n_jobs=args.jobs, is_rescore=args.rescore,
                 locus_index=args.locus_index,
                 use_device_scoring=args.device_scoring,
                 edge_bin_strategy=args.edge_bin_strategy,
                 existing_align_stats=args.existing_align_stats,
                 use_existing_chrom_depths=args.use_existing_chrom_depths,
                 per_read_group_stats=args.per_read_group_stats)


if __name__ == "__main__":
    main()
