"""The CUDA kernels on the card, against their plain PyTorch forms (on
the same card): the jump DP (also against the full traceback aligner)
and the split scan. Tolerance: exact (int32 scores; float32 split-scan
sums bit-equal, positions equal).

Needs a CUDA device and nvcc; skips without them. tests/conftest.py
imports JAX, which a GPU host may not have, so on the card run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import gzip
import os
import re
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

from manta_tpu.align.aligners import AlignmentScores, GlobalJumpAligner
from manta_tpu_torch import native_core
from manta_tpu_torch.align import cuda_jumpscore, cuda_splitscore
from manta_tpu_torch.align import device_jumpscore as dj
from manta_tpu_torch.align import device_splitscore as ds

pytestmark = pytest.mark.cuda

SCORES = AlignmentScores(2, -8, -12, -1, -1)
JUMP = -100
ARGS = (SCORES.match, SCORES.mismatch, SCORES.open, SCORES.extend,
        SCORES.off_edge, JUMP)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    native_core.ensure_libdeflate()       # for the native aligner
    return torch.device("cuda")


def _jobs(rng, B, nq_max, nr_max):
    seq = lambda n: bytes(b"ACGT"[i] for i in rng.integers(0, 4, n))
    jobs = []
    for i in range(B):
        r1 = seq(int(rng.integers(max(1, nr_max // 2), nr_max + 1)))
        r2 = seq(int(rng.integers(max(1, nr_max // 2), nr_max + 1)))
        a = int(rng.integers(1, max(2, nq_max // 2)))
        ins = seq(int(rng.integers(0, 60))) if i % 3 == 1 else b""
        q = (r1[-a:] + ins + r2[:max(1, nq_max - a - len(ins))])[:nq_max]
        jobs.append((q, r1, r2))
    return jobs


def _kernel_and_plain(arrays, device):
    t = dj.from_reference_inputs(*arrays, device)
    nq, nr1, nr2 = t[0].shape[1], t[2].shape[1], t[4].shape[1]
    kern = cuda_jumpscore.jump_score_cuda(*t, *ARGS)
    plain = dj.batched_jump_score(*t, *ARGS, nq, nr1, nr2)
    torch.cuda.synchronize()
    return kern.cpu().numpy(), plain.cpu().numpy()


@pytest.mark.parametrize("B,nq_max,nr_max", [
    (1, 20, 40), (7, 128, 256), (64, 400, 800), (3, 1100, 1500),
    (2, 4200, 4400)])
def test_kernel_matches_plain_and_full_aligner(cuda, B, nq_max, nr_max):
    """Contigs that jump from ref1's end into ref2's start, some with a
    junction insertion (where the native score batch scores 3 lower,
    ROADMAP.md Queue 3)."""
    jobs = _jobs(np.random.default_rng(B + nq_max), B, nq_max, nr_max)
    arrays = dj.pad_jobs(jobs, B + 2)
    kern, plain = _kernel_and_plain(arrays, cuda)
    np.testing.assert_array_equal(kern, plain)
    aln = GlobalJumpAligner(SCORES, JUMP)
    assert kern[:B].tolist() == [aln.align(*j, seqmatch=False).score
                                 for j in jobs]


def test_kernel_edge_lengths(cuda):
    """Empty references, a one-base query, and lengths at the padded
    width."""
    q = np.full((4, 128), 1, np.int32)
    q[:, :128] = np.frombuffer(b"ACGT" * 32, np.uint8)
    ql = np.array([128, 1, 0, 64], np.int32)
    r = np.full((4, 128), 2, np.int32)
    r[:, :128] = np.frombuffer(b"ACGT" * 32, np.uint8)
    r1l = np.array([128, 0, 5, 128], np.int32)
    r2l = np.array([0, 128, 5, 128], np.int32)
    kern, plain = _kernel_and_plain((q, ql, r, r1l, r.copy(), r2l), cuda)
    np.testing.assert_array_equal(kern, plain)


def test_bucketed_scorer_launches_kernel(cuda):
    jobs = _jobs(np.random.default_rng(9), 11, 300, 600)
    scorer = dj.make_bucketed_scorer(SCORES, JUMP, cuda)
    launches = cuda_jumpscore.KERNEL_LAUNCHES["jump_score"]
    plain_calls = dj.PLAIN_CALLS["cuda"]
    got = scorer(jobs)
    assert cuda_jumpscore.KERNEL_LAUNCHES["jump_score"] == launches + 1
    assert dj.PLAIN_CALLS["cuda"] == plain_calls
    assert got.tolist() == dj.make_bucketed_scorer(
        SCORES, JUMP, "cpu")(jobs).tolist()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    jobs = _jobs(np.random.default_rng(4), 3, 50, 90)
    t = dj.from_reference_inputs(*dj.pad_jobs(jobs, 3), cuda)
    with pytest.raises(TypeError):
        cuda_jumpscore.jump_score_cuda(t[0].long(), *t[1:], *ARGS)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_jumpscore.jump_score_cuda(t[0].t().contiguous().t(), *t[1:],
                                       *ARGS)
    with pytest.raises(ValueError, match="rows"):
        cuda_jumpscore.jump_score_cuda(t[0], t[1][:2], *t[2:], *ARGS)
    wide = torch.ones((1, cuda_jumpscore.max_query_width() + 1),
                      dtype=torch.int32, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="limit"):
        cuda_jumpscore.jump_score_cuda(wide, one, wide[:, :8], one,
                                       wide[:, :8], one, *ARGS)


# ---- the split scan (csrc/split_score.cu)

def _split_rows(rng, B, L, T, iupac):
    """Reads planted in their targets with mutations, N bases, IUPAC
    bytes on some rows, and rows with no valid scan position."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    codes = np.frombuffer(b"MRWSYKVHDB", np.uint8)
    reads = np.full((B, L), 0xFF, np.uint8)
    quals = np.zeros((B, L), np.uint8)
    targets = np.full((B, T), ord("N"), np.uint8)
    ints = np.zeros((4, B), np.int32)        # bp_beg, bp_end, rl, tl
    for b in range(B):
        t = int(rng.integers(max(1, T // 2), T + 1))
        n = min(t, int(rng.integers(max(1, L // 2), L + 1)))
        tg = bases[rng.integers(0, 4, t)].copy()
        tg[rng.integers(0, t, 3)] = ord("N")
        if iupac and b % 3 == 0:
            tg[rng.integers(0, t, 4)] = codes[rng.integers(0, 10, 4)]
        p = int(rng.integers(0, max(1, t - n)))
        rd = tg[p:p + n].copy()
        rd[rng.integers(0, n, 3)] = bases[rng.integers(0, 4, 3)]
        if b % 4 == 1:
            rd[rng.integers(0, n)] = ord("N")
        reads[b, :n] = rd
        quals[b, :n] = rng.integers(0, 75, n)
        targets[b, :t] = tg
        beg = t + 3 if b % 7 == 6 else int(rng.integers(0, t))
        ints[:, b] = (beg, beg + int(rng.integers(0, 6)), n, t)
    return (reads, quals, targets, *ints)


def _split_kernel_and_plain(arrays, flank, n_scan, device):
    t = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in arrays)
    lm, lx = (torch.from_numpy(a).to(device) for a in ds.make_luts(1e-3))
    kern = cuda_splitscore.split_score_cuda(*t, flank, lm, lx, n_scan)
    plain = ds.batched_split_score(*t, flank, lm, lx, n_scan)
    torch.cuda.synchronize()
    return [x.cpu().numpy() for x in (*kern, *plain)]


@pytest.mark.parametrize("B,L,T,n_scan,iupac", [
    (1, 256, 512, 512, False), (7, 256, 300, 512, True),
    (64, 256, 1000, 1024, True), (5, 512, 2048, 2048, True),
    (3, 100, 400, 50, False), (2, 8192, 8192, 8192, True)])
def test_split_kernel_matches_plain(cuda, B, L, T, n_scan, iupac):
    """Bucketed widths of scan_multi (read tiers 256-8192, scan = the
    target tier), and an n_scan below the scan window."""
    arrays = _split_rows(np.random.default_rng(B + L), B, L, T, iupac)
    kb, kp, pb, pp = _split_kernel_and_plain(arrays, 50, n_scan, cuda)
    np.testing.assert_array_equal(kb, pb)
    np.testing.assert_array_equal(kp, pp)
    assert kb.dtype == np.float32 and kp.dtype == np.int32


def test_split_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    arrays = _split_rows(np.random.default_rng(3), 4, 64, 128, False)
    t = [torch.from_numpy(a).to(cuda) for a in arrays]
    lm, lx = (torch.from_numpy(a).to(cuda) for a in ds.make_luts(0.0))
    launches = cuda_splitscore.KERNEL_LAUNCHES["split_score"]
    with pytest.raises(TypeError, match="uint8"):
        cuda_splitscore.split_score_cuda(t[0].int(), *t[1:], 50, lm, lx, 128)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_splitscore.split_score_cuda(
            t[0].t().contiguous().t(), *t[1:], 50, lm, lx, 128)
    with pytest.raises(ValueError, match="shape"):
        cuda_splitscore.split_score_cuda(*t[:3], t[3][:2], *t[4:], 50, lm,
                                         lx, 128)
    with pytest.raises(ValueError, match="shape"):
        cuda_splitscore.split_score_cuda(*t, 50, lm[:70], lx, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_splitscore.split_score_cuda(*t, 50, lm.cpu(), lx, 128)
    wide = torch.full((1, 40000), 65, dtype=torch.uint8, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_splitscore.split_score_cuda(wide, wide, wide, one, one, one,
                                         one, 50, lm, lx, 8)
    assert cuda_splitscore.KERNEL_LAUNCHES["split_score"] == launches


@pytest.fixture
def demo_fasta():
    """The demo reference, extracted once into the git-ignored
    .testdata/ (as tests/conftest.py does)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    demo = os.path.join(repo, "tests", "data", "demo")
    name = "Homo_sapiens_assembly19.COST16011_region.fa"
    fa = os.path.join(repo, ".testdata", name)
    if not os.path.exists(fa):
        with tarfile.open(os.path.join(demo, name + ".tar.bz2")) as tf:
            tf.extractall(os.path.dirname(fa), filter="data")
    if not os.path.exists(fa + ".fai"):
        with open(os.path.join(demo, name + ".fai"), "rb") as src, \
                open(fa + ".fai", "wb") as dst:
            dst.write(src.read())
    return repo, demo, fa


def test_demo_exact_j2_launches_both_kernels_in_workers(cuda, tmp_path,
                                                        demo_fasta):
    """-j 2 with --device-scoring exact, in a fresh process: phase 2
    forks workers, each initialises CUDA and scans split reads through
    the kernel; the somatic VCF body equals the oracle."""
    repo, demo, fasta = demo_fasta
    run_dir = tmp_path / "run"
    cli = subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.workflow.run",
         "--normal-bam",
         os.path.join(demo, "HCC1954.NORMAL.30x.compare.COST16011_region.bam"),
         "--tumor-bam", os.path.join(demo, "G15512.HCC1954.1.COST16011_region.bam"),
         "--reference", fasta, "--run-dir", str(run_dir), "--exome",
         "-j", "2", "--device-scoring", "exact"],
        capture_output=True, text=True, cwd=repo, timeout=600)
    assert cli.returncode == 0, cli.stderr[-3000:]
    launches = [int(n) for n in re.findall(
        r"split-scan pid=\d+: .* (\d+) kernel launches", cli.stderr)]
    assert len(launches) >= 1 and sum(launches) > 0, cli.stderr[-3000:]
    with gzip.open(run_dir / "results" / "variants" / "somaticSV.vcf.gz",
                   "rt") as f:
        got = [ln for ln in f if not ln.startswith("#")]
    with gzip.open(os.path.join(demo, "expectedResults",
                                "somaticSV.vcf.gz"), "rt") as f:
        want = [ln for ln in f if not ln.startswith("#")]
    assert got == want
