"""The high-spanning-contig shape through the port's workflow on the CPU:
a rehearsal, at 16 tiles, of chip_smoke.py's high-span phase (512).

The demo junction tiled at a fifth of its depth with split-read evidence
stripped (manta_tpu_torch.tools.stress_workload) gives pair-only,
IMPRECISE candidates with about three contigs a junction, so phase 2
sends many jobs through the bucketed contig scorer: more than the
WGS-shaped workloads reach. The tumor VCF body of the port with scoring
off (the native score batch), of the port with jump (the plain form of
the jump kernel on the CPU) and of the JAX package with jump (its
batched_jump_score) must be identical byte for byte, and K1's work
counter over the jump run must equal the cells of the jobs the
dispatcher padded."""

import gzip

import pytest

from manta_tpu.align import device_jumpscore as reference_dj
from manta_tpu.workflow.run import run_workflow as reference_run
from manta_tpu_torch.align import device_jumpscore as dj
from manta_tpu_torch.align.cuda_jumpscore import KERNEL_WORK
from manta_tpu_torch.tools import stress_workload
from manta_tpu_torch.workflow.run import run_workflow

from test_torch_splitscore import one_torch_thread  # noqa: F401  (autouse)

TILES = 16
# the WGS-shaped workload of chip_smoke.py reaches 20 contig jobs
WGS_SHAPED_JOBS = 20


def _body(run_dir):
    with gzip.open(f"{run_dir}/results/variants/tumorSV.vcf.gz", "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, demo_fasta):
    """{run: (tumorSV body, contig jobs dispatched)} for the port's off
    and jump runs and the JAX package's jump run, on one generated BAM."""
    d = tmp_path_factory.mktemp("highspan")
    bam, fasta, reads = stress_workload.generate(
        TILES, str(d / "h"), depth_frac=0.2, strip_sa=True,
        demo_fasta=demo_fasta)
    assert reads == 2260 * TILES
    out = {}
    # the jump run's jobs as the dispatcher pads them, and K1's work
    # counter over the run
    padded, pad_jobs = [], dj.pad_jobs

    def keeping(jobs, rows):
        padded.append(jobs)
        return pad_jobs(jobs, rows)
    work = dict(KERNEL_WORK["jump_score"])
    for name, run, stats, kw in (
            ("off", run_workflow, dj.DISPATCH_STATS,
             dict(use_device_scoring="off", device="cpu")),
            ("jump", run_workflow, dj.DISPATCH_STATS,
             dict(use_device_scoring="jump", device="cpu")),
            ("jax_jump", reference_run, reference_dj.DISPATCH_STATS,
             dict(use_device_scoring="jump"))):
        stats["jobs"] = 0
        if name == "jump":
            dj.pad_jobs = keeping
        try:
            run([], [bam], fasta, str(d / name), is_exome=True, n_jobs=1,
                verbose=False, **kw)
        finally:
            dj.pad_jobs = pad_jobs
        out[name] = _body(d / name), stats["jobs"]
        if name == "jump":
            out["jump_work"] = padded, {
                k: v - work[k] for k, v in KERNEL_WORK["jump_score"].items()}
    return out


def test_jump_scores_more_contig_jobs_than_the_wgs_shape(runs):
    assert runs["off"][1] == 0
    assert runs["jump"][1] > WGS_SHAPED_JOBS
    assert runs["jax_jump"][1] == runs["jump"][1]


def test_off_and_jump_bodies_are_identical(runs):
    assert len(runs["off"][0]) >= 4 * TILES
    assert runs["jump"][0] == runs["off"][0]


def test_jump_body_equals_the_jax_packages(runs):
    assert runs["jump"][0] == runs["jax_jump"][0]


def test_every_tile_is_called_alike(runs):
    """The tiles are copies of one junction: each holds as many records."""
    body = runs["jump"][0]
    assert len(body) % TILES == 0


def test_k1_work_counter_equals_the_jobs_cells(runs):
    """K1's useful-cell counter over the jump run equals the sum over
    the dispatched jobs of len(query) x (len(ref1) + len(ref2)),
    counted here from the jobs themselves; every job is counted once."""
    batches, work = runs["jump_work"]
    jobs = [job for batch in batches for job in batch]
    assert len(jobs) == runs["jump"][1] > 0
    assert work["useful"] == sum(len(q) * (len(r1) + len(r2))
                                 for q, r1, r2 in jobs)
    assert 0 < work["useful"] < work["padded"]
