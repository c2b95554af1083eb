"""Entry points: a single-device forward step and the multi-device dry
run.

Counterpart of the repository's ``__graft_entry__.py``. The flagship
device kernel is the batched split-read scorer
(``align/device_splitscore.py``), the phase-2 scoring hot loop, batched
over candidates. ``entry`` hands out one forward step on it;
``dryrun_multichip`` drives seven stages of the pipeline over a mesh of
devices (``parallel/mesh.py``) and checks each against the host path.

Both run on the card unless told ``device="cpu"``: the hand-written
kernels on CUDA devices, the plain PyTorch forms on CPU shards.

    python -c "from manta_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(1)"
"""

from __future__ import annotations

import json
import os as _os

import numpy as np

# Demo data: vendored in-tree (tests/data/demo); the fasta is extracted
# into .testdata on first use.
_REPO_DIR = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
_DEMO_DIR = _os.path.join(_REPO_DIR, "tests", "data", "demo")
_TUMOR_BAM = "G15512.HCC1954.1.COST16011_region.bam"
_NORMAL_BAM = "HCC1954.NORMAL.30x.compare.COST16011_region.bam"
_REGIONS = ["8:107652000-107655000", "11:94974000-94989000"]
# the jump scores of the demo jobs: match, mismatch, open, extend, offEdge
_JUMP_SCORES = (2, -8, -18, -1, -1)
_JUMP = -100


def _demo_fasta_path():
    """Path to the extracted demo fasta, extracting it if needed."""
    fa = _os.path.join(_REPO_DIR, ".testdata",
                       "Homo_sapiens_assembly19.COST16011_region.fa")
    if not _os.path.exists(fa):
        tarball = _os.path.join(_DEMO_DIR, _os.path.basename(fa) + ".tar.bz2")
        if _os.path.exists(tarball):
            import tarfile
            _os.makedirs(_os.path.dirname(fa), exist_ok=True)
            with tarfile.open(tarball) as tf:
                tf.extractall(_os.path.dirname(fa), filter="data")
            if not _os.path.exists(fa):
                import pathlib
                for p in pathlib.Path(_os.path.dirname(fa)).rglob(
                        _os.path.basename(fa)):
                    p.rename(fa)
                    break
            fai_src = _os.path.join(_DEMO_DIR, _os.path.basename(fa) + ".fai")
            if _os.path.exists(fai_src) and not _os.path.exists(fa + ".fai"):
                with open(fai_src, "rb") as s, open(fa + ".fai", "wb") as d:
                    d.write(s.read())
    return fa


def _example_batch(B=64, L=100, T=400, seed=0):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    targets = bases[rng.integers(0, 4, (B, T))].copy()
    reads = np.empty((B, L), np.uint8)
    for b in range(B):
        pos = rng.integers(0, T - L)
        reads[b] = targets[b, pos:pos + L]
    quals = rng.integers(10, 40, (B, L)).astype(np.uint8)
    margin = min(50, T // 4)
    bp_beg = rng.integers(margin, T - margin, B).astype(np.int32)
    bp_end = (bp_beg + rng.integers(0, 5, B)).astype(np.int32)
    read_len = np.full(B, L, np.int32)
    target_len = np.full(B, T, np.int32)
    return reads, quals, targets, bp_beg, bp_end, read_len, target_len


def _device(device):
    """The torch device ``device`` names; None means the card."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.device_count() == 0:
        raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                           "plain PyTorch forms on the host")
    return dev


def entry(device=None):
    """(fn, example_args): one forward step on the flagship kernel, the
    exact split scan at B=64, L=100, T=400. The arguments are tensors on
    ``device``; ``fn`` launches the CUDA kernel there, or runs the plain
    form on the CPU."""
    import torch

    from .align.device_splitscore import make_luts, split_score

    dev = _device(device)
    lut_m, lut_x = (torch.from_numpy(a).to(dev) for a in make_luts(0.0))
    args = tuple(torch.from_numpy(a).to(dev) for a in _example_batch())
    T = args[2].shape[1]

    def fn(reads, quals, targets, bp_beg, bp_end, read_len, target_len):
        return split_score(reads, quals, targets, bp_beg, bp_end, read_len,
                           target_len, 50, lut_m, lut_x, T)

    return fn, args


def _launches():
    """Every kernel wrapper's launch count, by kernel."""
    from .align import cuda_jumpscore, cuda_splitscore
    return {**cuda_jumpscore.KERNEL_LAUNCHES,
            **cuda_splitscore.KERNEL_LAUNCHES}


class _StageCounts:
    """Kernel launches of each stage: the wrappers' own counts read
    before and after."""

    def __init__(self):
        self.stages = {}
        self._at = _launches()

    def close(self, stage: str) -> None:
        now = _launches()
        self.stages[stage] = {k: now[k] - self._at[k] for k in now}
        self._at = now


def _sharded(mesh, arrays, fn):
    """Cut the numpy ``arrays`` along dim 0 over the mesh's devices, run
    ``fn(*pieces)`` on each device's slice (all enqueued before any
    result is fetched) and return the results' components concatenated
    on the host as numpy arrays."""
    import torch

    from .parallel.mesh import shard_batch_spec
    batch_sharded, _ = shard_batch_spec(mesh, mesh.axis_names[0])
    devices = list(mesh.devices.flat)
    pieces = [batch_sharded(torch.from_numpy(np.ascontiguousarray(a)))
              for a in arrays]
    outs = []
    for dev, t in zip(devices, zip(*pieces)):
        out = fn(dev, *t)
        outs.append(out if isinstance(out, tuple) else (out,))
    return tuple(np.concatenate([o[k].cpu().numpy() for o in outs])
                 for k in range(len(outs[0])))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the scoring steps and the pipeline stages over an n-device
    mesh on tiny shapes and real demo reads, each checked against the
    host path. ``device=None`` takes the first ``n_devices`` CUDA
    devices; ``device="cpu"`` makes ``n_devices`` CPU shards. Prints
    the ``dryrun_multichip ok: ...`` line; returns the kernel launches
    of each stage."""
    import torch

    from .align.device_jumpscore import _score
    from .align.device_splitscore import (
        batched_split_score, make_luts, split_score,
    )
    from .align.aligners import AlignmentScores
    from .parallel.mesh import make_mesh, make_mesh_2d
    from .native_core import load as load_native_core

    load_native_core()
    mesh = make_mesh(n_devices, device=device)
    counts = _StageCounts()

    # stage 1: the exact split scan, batch-sharded, with its summary
    # reductions over the gathered result
    B, L, T = 2 * n_devices, 16, 48
    batch = _example_batch(B=B, L=L, T=T, seed=1)
    luts = make_luts(0.0)

    def split_step(flank, n_scan, lut_m, lut_x):
        def step(dev, *pieces):
            return split_score(*pieces, flank, torch.from_numpy(lut_m).to(dev),
                               torch.from_numpy(lut_x).to(dev), n_scan)
        return step

    best, best_pos = _sharded(mesh, batch, split_step(8, T, *luts))
    total = float(best.sum())
    assert best.shape == (B,) and best_pos.shape == (B,)
    assert np.isfinite(total) and int(best_pos.max()) >= 0
    want = batched_split_score(*(torch.from_numpy(a) for a in batch), 8,
                               *(torch.from_numpy(a) for a in luts), T)
    assert best.tolist() == want[0].tolist() and \
        best_pos.tolist() == want[1].tolist(), \
        "mesh split scan diverged from the plain form"
    counts.close("1 split scan")

    # stage 2: batched jump scoring + global best. REAL demo reads as
    # queries against the two COST16011 breakend reference windows (the
    # production contig-scoring shape), equal row by row to the native
    # host aligner
    *jump_arrays, host_scores, _jobs = _demo_jump_jobs(B)
    scores = AlignmentScores(*_JUMP_SCORES)
    (jump_out,) = _sharded(
        mesh, jump_arrays, lambda dev, *t: _score(*t, scores, _JUMP))
    from .align.cuda_jumpscore import raise_on_kernel_error
    raise_on_kernel_error()
    best_score = int(jump_out.max())
    assert jump_out.shape == (B,)
    assert jump_out[:len(host_scores)].tolist() == host_scores.tolist(), \
        "mesh jump scores diverged from the native host aligner"
    counts.close("2 jump scoring")

    # stage 3: 2-D (edge x scan) mesh: junctions data-parallel, scan
    # positions sequence-parallel with an argmax combine over the shards
    from .align.device_splitscore_mxu import junction_split_score
    from .parallel.scan_parallel import junction_split_score_scan_parallel

    edge_n = 2 if n_devices % 2 == 0 else 1
    scan_n = n_devices // edge_n
    mesh2 = make_mesh_2d((edge_n, scan_n), ("edge", "scan"), device=device)
    G, R, L2, T2 = 2 * edge_n, 4, 8, 16 * scan_n  # L2 < T2 for any scan_n
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    tg = bases[rng.integers(0, 4, (G, T2))].copy()
    rd = np.empty((G, R, L2), np.uint8)
    for g in range(G):
        for r in range(R):
            pos = rng.integers(0, T2 - L2)
            rd[g, r] = tg[g, pos:pos + L2]
    qs = rng.integers(10, 40, (G, R, L2)).astype(np.uint8)
    bb = np.full(G, T2 // 2, np.int32)
    be = bb + 2
    rl2 = np.full((G, R), L2, np.int32)
    tl2 = np.full(G, T2, np.int32)
    s0 = np.zeros(G, np.int32)
    ops2 = tuple(torch.from_numpy(a) for a in (rd, qs, tg, s0, bb, be, rl2,
                                               tl2))
    t_luts = tuple(torch.from_numpy(a) for a in luts)
    sp_best, sp_pos = junction_split_score_scan_parallel(
        mesh2, *ops2, 8, *t_luts, n_scan=T2, batch_axis="edge")
    sp_best, sp_pos = sp_best.cpu(), sp_pos.cpu()
    assert sp_best.shape == (G, R) and sp_pos.shape == (G, R)
    one_best, one_pos = junction_split_score(*ops2, 8, *t_luts, n_scan=T2)
    # tolerance: the matmul form's float32 sums, ~1e-6 relative
    assert torch.allclose(sp_best, one_best, rtol=1e-6, atol=1e-5)
    assert sp_pos.tolist() == one_pos.tolist(), \
        "scan-parallel winners diverged from the single-device scan"
    sp_total = float(torch.where(torch.isfinite(sp_best), sp_best,
                                 torch.zeros(())).sum())
    counts.close("3 scan-parallel")

    # stage 4: a REAL pipeline stage over the mesh: the production
    # split-read scoring pass on actual sequencing reads around the demo
    # COST16011 junction, sharded read-parallel and checked bit for bit
    # against the native host scan the single-device path uses
    reads4, quals4, rlen4, tgt4, bpb4, bpe4, host_lnl, host_pos = \
        _demo_edge_batch()
    B4, L4 = reads4.shape
    pad = (-B4) % n_devices
    if pad:
        reads4 = np.concatenate([reads4, np.full((pad, L4), 0xFF, np.uint8)])
        quals4 = np.concatenate([quals4, np.zeros((pad, L4), np.uint8)])
        rlen4 = np.concatenate([rlen4, np.full(pad, L4, np.int32)])
    Bp4, T4 = reads4.shape[0], tgt4.shape[1]
    ops4 = (reads4, quals4, np.broadcast_to(tgt4, (Bp4, T4)).copy(),
            np.full(Bp4, bpb4, np.int32), np.full(Bp4, bpe4, np.int32),
            rlen4, np.full(Bp4, T4, np.int32))
    from .scoring.evidence import QscoreSnp
    qm, qx = QscoreSnp(0.0).lut256()
    d_lnl, d_pos = _sharded(mesh, ops4, split_step(
        50, T4, np.ascontiguousarray(qm[:71]), np.ascontiguousarray(qx[:71])))
    assert d_pos[:B4].tolist() == host_pos.tolist(), \
        "mesh split-scan winners diverged from the host scan"
    assert d_lnl[:B4].astype(np.float32).tolist() == host_lnl.tolist(), \
        "mesh split-scan lnlhoods diverged from the host scan"
    real_note = (f", real-read stage {B4} demo reads bit-identical "
                 "to host scan")
    counts.close("4 real split reads")

    # stage 5: a REAL phase-2 pipeline end to end over the mesh: the
    # bundled COST16011 demo workflow (read gather, host assembly,
    # MESH-SHARDED contig jump scoring, candidate records, somatic VCF)
    # run twice, host-scored and mesh-scored, and the variant bodies
    # diffed byte for byte. Stage 6, the graph reduce through its fork
    # part-merge path, reuses the host-scored run's saved graph.
    e2e_note = _mesh_e2e_demo(mesh, counts)

    # stage 7: PHASE 1 under the mesh: the per-read gate chain as
    # tensors (parallel/phase1_mesh.py) over REAL demo reads cut along
    # the genome-bin data axis, with the summed evidence count and the
    # full candidate mask equal to the host scanner's numpy building
    # blocks
    p1_note = _mesh_phase1_gates(mesh)
    counts.close("7 phase-1 gates")

    print("dryrun_multichip launches: " + json.dumps(counts.stages))
    print(f"dryrun_multichip ok: {n_devices} devices, batch {B}, "
          f"total lnlhood {total:.3f}, "
          f"best jump score {best_score}, "
          f"2-D mesh {edge_n}x{scan_n} seq-parallel total "
          f"{sp_total:.3f}{real_note}{e2e_note}{p1_note}", flush=True)
    return counts.stages


def _mesh_phase1_gates(mesh):
    import torch

    from .core.readfilter import (
        has_sa_tag, is_innie_pair, is_read_unmapped_or_filtered_core,
    )
    from .io.bam import BamReader
    from .parallel.phase1_mesh import read_gate_masks, shard_evidence_counts

    n_devices = mesh.size
    min_mapq, min_tlen, max_tlen = 15, 100, 700
    batch = BamReader(_os.path.join(_DEMO_DIR, _TUMOR_BAM)).read_all()
    sa = has_sa_tag(batch)
    core_bad = is_read_unmapped_or_filtered_core(batch, sa)
    innie = is_innie_pair(batch)
    atl = np.abs(batch.tlen)
    proper = innie & (atl >= min_tlen) & (atl <= max_tlen)
    mapped_pair = ((batch.flag & 0x1) != 0) & \
        ((batch.flag & (0x4 | 0x8)) == 0)
    host_cand = ~core_bad & (batch.mapq >= min_mapq) & \
        (mapped_pair & ~proper)

    cols = (batch.flag.astype(np.int32), batch.mapq.astype(np.int32),
            batch.pos.astype(np.int32), batch.next_pos.astype(np.int32),
            batch.refid.astype(np.int32),
            batch.next_refid.astype(np.int32),
            batch.tlen.astype(np.int32), sa)
    # padding rows: unmapped flag, so core_bad and never candidates
    fills = (0x4, 0, 0, 0, -1, -1, 0, False)
    n = len(cols[0])
    pad = (-n) % n_devices
    padded = [np.concatenate([c, np.full(pad, fill, c.dtype)])
              for c, fill in zip(cols, fills)]

    def p1_step(_dev, *a):
        masks = read_gate_masks(*a, min_mapq, min_tlen, max_tlen)
        return masks[3], shard_evidence_counts(masks[3])[None]

    cand, shard_counts = _sharded(mesh, padded, p1_step)
    count = int(shard_counts.sum())
    assert shard_counts.shape == (n_devices,)
    assert count == int(host_cand.sum()), \
        "mesh phase-1 evidence count diverged from host"
    assert cand[:n].tolist() == host_cand.tolist(), \
        "mesh phase-1 candidate mask diverged from host"
    return (f"; phase-1 gate stage: {n} demo reads sharded over "
            f"{n_devices} devices, {count} evidence candidates "
            "bit-identical to host")


def _demo_paths():
    return (_demo_fasta_path(), _os.path.join(_DEMO_DIR, _TUMOR_BAM),
            _os.path.join(_DEMO_DIR, _NORMAL_BAM))


def _somatic_body(run_dir):
    import gzip
    with gzip.open(_os.path.join(run_dir, "results", "variants",
                                 "somaticSV.vcf.gz"), "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


def _mesh_e2e_demo(mesh, counts):
    """Stage 5: full demo workflow with mesh-sharded contig scoring,
    somatic VCF diffed against the host-scored run; then stage 6 on the
    host-scored run's graph."""
    import shutil
    import tempfile

    from .candidates.refiner import RefinerOptions
    from .parallel.mesh_scoring import MESH_STATS, make_mesh_bucketed_scorer
    from .workflow.run import run_workflow

    fa, tumor, normal = _demo_paths()
    opt = RefinerOptions()
    mesh_scorer = make_mesh_bucketed_scorer(mesh, opt.spanning_scores,
                                            opt.jump_score)

    def run(run_dir, **kw):
        run_workflow([normal], [tumor], fa, run_dir, regions=_REGIONS,
                     is_exome=True, n_jobs=1, verbose=False, **kw)
        return _somatic_body(run_dir)

    d_host = tempfile.mkdtemp(prefix="mc_host_")
    d_mesh = tempfile.mkdtemp(prefix="mc_mesh_")
    try:
        host_body = run(d_host, use_device_scoring=False)
        calls = MESH_STATS["calls"]
        mesh_body = run(d_mesh, use_device_scoring="jump",
                        device=mesh.devices.flat[0], jump_scorer=mesh_scorer)
        workflow_calls = MESH_STATS["calls"] - calls
        assert host_body == mesh_body, (
            "mesh-scored somatic VCF diverged from host-scored run")
        assert len(host_body) >= 6, host_body
        # The refiner scores contigs ahead of the traceback only where a
        # candidate assembled more than one, and every candidate of the
        # demo assembles one: the workflow above hands the scorer no job
        # (nor does the reference's). So the scorer the workflow was
        # given also takes the demo reads of stage 2, as the jobs the
        # refiner would make of them, against the native score batch.
        from .align.aligners import jump_score_batch
        jobs = _demo_jump_jobs(64)[-1]
        mesh_scores = mesh_scorer(jobs)
        assert mesh_scores.tolist() == jump_score_batch(
            jobs, opt.spanning_scores, opt.jump_score).tolist(), \
            "the mesh scorer diverged from the native score batch"
        counts.close("5 e2e demo")
        host_graph = _os.path.join(d_host, "workspace", "svLocusGraph.npz")
        note6 = _graph_part_merge_demo(host_graph)
        counts.close("6 graph part-merge")
        return (f", e2e demo edge stage: {len(host_body)} somatic "
                f"records bit-identical host vs mesh-scored "
                f"({workflow_calls} scorer calls in the workflow, "
                f"{len(jobs)} demo contig jobs through the same scorer "
                f"== native){note6}")
    finally:
        shutil.rmtree(d_host, ignore_errors=True)
        shutil.rmtree(d_mesh, ignore_errors=True)


def _graph_part_merge_demo(serial_graph_npz):
    """Stage 6: the phase-1 graph reduce through its production part
    path: the demo workflow re-run with fork workers (-j 2: per-group
    part npz files + the native ordered merge,
    workflow/run.py merge_saved_graphs_native) and its saved graph
    asserted array-identical to the serial run's. The reduce stays a
    host file hand-off: the graphs are pointer-rich interval-set
    structures with no dense form for a collective to carry, while
    every dense phase-2 kernel rides the mesh (stages 1-5)."""
    import shutil
    import tempfile

    from .workflow.run import run_workflow

    fa, tumor, normal = _demo_paths()
    d_par = tempfile.mkdtemp(prefix="mc_par_")
    try:
        run_workflow([normal], [tumor], fa, d_par, regions=_REGIONS,
                     is_exome=True, n_jobs=2, verbose=False,
                     use_device_scoring=False)
        par_graph = _os.path.join(d_par, "workspace", "svLocusGraph.npz")
        a = np.load(serial_graph_npz, allow_pickle=True)
        b = np.load(par_graph, allow_pickle=True)
        assert sorted(a.files) == sorted(b.files)
        n_arrays = 0
        for k in a.files:
            va, vb = a[k], b[k]
            if va.dtype == object:
                assert str(va.tolist()) == str(vb.tolist()), k
            else:
                assert np.array_equal(va, vb), (
                    f"graph array {k} differs between serial and "
                    "fork-merged builds")
            n_arrays += 1
        return (f"; graph P2 reduce: fork part-merge == serial graph "
                f"({n_arrays} arrays identical; file hand-off)")
    finally:
        shutil.rmtree(d_par, ignore_errors=True)


def _demo_jump_jobs(B: int):
    """Real production-shaped jump jobs: demo tumor reads as queries
    against the two COST16011 breakend reference windows (chr11 x chr8,
    the demo's somatic translocation partners), plus the native host
    aligner's scores for the parity check. Returns padded (B, ...) int32
    arrays, the scores of the real rows and the jobs themselves."""
    from .align.aligners import AlignmentScores, jump_score_batch
    from .io.bam import BamReader
    from .io.fasta import FastaReader

    reader = BamReader(_os.path.join(_DEMO_DIR, _TUMOR_BAM))
    fa = FastaReader(_demo_fasta_path())
    tid = reader.header.name_to_tid["11"]
    batch = reader.fetch(tid, 94975547, 94975947)
    keep = np.flatnonzero(batch.mapq >= 15)[:B]
    if len(keep) < min(4, B):
        raise RuntimeError(f"only {len(keep)} demo reads for the jump jobs")
    r1b = fa.fetch("11", 94975647, 94975847)
    r2b = fa.fetch("8", 107653411, 107653611)
    jobs = []
    for i in keep:
        s0, s1 = int(batch.seq_off[i]), int(batch.seq_off[i + 1])
        jobs.append((bytes(batch.seq[s0:s1]), r1b, r2b))
    host = jump_score_batch(jobs, AlignmentScores(*_JUMP_SCORES), _JUMP)

    n = len(jobs)
    nq = max(len(j[0]) for j in jobs)
    q = np.full((B, nq), 1, np.int32)
    ql = np.ones(B, np.int32)
    for r, j in enumerate(jobs):
        a = np.frombuffer(j[0], np.uint8).astype(np.int32)
        q[r, :len(a)] = a
        ql[r] = len(a)
    r1 = np.full((B, len(r1b)), 2, np.int32)
    r2 = np.full((B, len(r2b)), 2, np.int32)
    r1[:] = np.frombuffer(r1b, np.uint8).astype(np.int32)
    r2[:] = np.frombuffer(r2b, np.uint8).astype(np.int32)
    r1l = np.full(B, len(r1b), np.int32)
    r2l = np.full(B, len(r2b), np.int32)
    return q, ql, r1, r1l, r2, r2l, host[:n], jobs


def _demo_edge_batch():
    """A canned phase-2 edge batch from the bundled demo data: tumor
    reads overlapping the COST16011 chr11 breakend scored against the
    breakend-window reference target, plus the native host scan's
    (lnl, pos) for the parity check."""
    from .io.bam import BamReader
    from .io.fasta import FastaReader
    from .scoring.evidence import QscoreSnp, split_read_scan_multi

    reader = BamReader(_os.path.join(_DEMO_DIR, _TUMOR_BAM))
    tid = reader.header.name_to_tid["11"]
    center = 94975747
    batch = reader.fetch(tid, center - 200, center + 200)
    keep = np.flatnonzero((batch.mapq >= 15))[:64].astype(np.int64)
    if len(keep) < 8:
        raise RuntimeError(f"only {len(keep)} demo reads at the junction")
    ref = FastaReader(_demo_fasta_path()).fetch("11", center - 350,
                                                center + 350)
    target = np.frombuffer(ref, np.uint8)
    bp_beg, bp_end = 349, 351
    q0 = QscoreSnp(0.0)
    host_lnl, host_pos = split_read_scan_multi(
        50, batch, keep, q0, [target], [(bp_beg, bp_end)])
    L = int((batch.seq_off[keep + 1] - batch.seq_off[keep]).max())
    reads = np.full((len(keep), L), 0xFF, np.uint8)
    quals = np.zeros((len(keep), L), np.uint8)
    for r, i in enumerate(keep):
        s0, s1 = int(batch.seq_off[i]), int(batch.seq_off[i + 1])
        reads[r, :s1 - s0] = batch.seq[s0:s1]
        quals[r, :s1 - s0] = batch.qual[
            int(batch.qual_off[i]):int(batch.qual_off[i + 1])]
    rlen = (batch.seq_off[keep + 1] - batch.seq_off[keep]).astype(np.int32)
    return (reads, quals, rlen, target[None, :], bp_beg, bp_end,
            host_lnl[:, 0], host_pos[:, 0])
