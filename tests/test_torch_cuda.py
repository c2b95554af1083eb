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

from manta_tpu_torch.align.aligners import AlignmentScores, GlobalJumpAligner
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


def _padded(jobs, rows, nq, nr):
    """Jobs padded to widths of the caller's choice (pad_jobs pads to
    the scorer's buckets)."""
    q, ql = dj._pad_to([j[0] for j in jobs] + [b"\x01"] * (rows - len(jobs)),
                       rows, nq, 1)
    r1, r1l = dj._pad_to([j[1] for j in jobs] + [b"\x02"] * (rows - len(jobs)),
                         rows, nr, 2)
    r2, r2l = dj._pad_to([j[2] for j in jobs] + [b"\x02"] * (rows - len(jobs)),
                         rows, nr, 2)
    return q, ql, r1, r1l, r2, r2l


def test_kernel_main_path_bucket(cuda):
    """The bucket the WGS-shaped workflow run gives the kernel: (8, 256,
    1024, 1024), one warp per row."""
    jobs = _jobs(np.random.default_rng(77), 6, 250, 1000)
    arrays = dj.pad_jobs(jobs, 8)
    assert tuple(arrays[i].shape[1] for i in (0, 2, 4)) == (256, 1024, 1024)
    lanes, warps = cuda_jumpscore.kernel_layout(8, 256)
    assert 32 * lanes * warps >= 257 > 32 * lanes * (warps - 1)
    kern, plain = _kernel_and_plain(arrays, cuda)
    np.testing.assert_array_equal(kern, plain)


@pytest.mark.parametrize("lanes", cuda_jumpscore.LANE_CHOICES)
@pytest.mark.parametrize("over", (0, 1), ids=("fits", "one_more"))
def test_kernel_widths_at_a_warps_edge(cuda, lanes, over):
    """nq + 1 = 32 * lanes lanes fill one warp exactly; one lane more
    takes a second warp at that many lanes per thread, and the next
    choice of lanes when the kernel chooses."""
    nq = 32 * lanes - 1 + over
    jobs = _jobs(np.random.default_rng(lanes + over), 5, nq, 2 * nq)
    jobs.append((jobs[0][0][:3], jobs[0][1], jobs[0][2]))  # qlen << nq
    t = dj.from_reference_inputs(*_padded(jobs, 7, nq, 2 * nq), cuda)
    assert cuda_jumpscore.kernel_layout(7, nq, lanes) == (lanes, 1 + over)
    plain = dj.batched_jump_score(*t, *ARGS, nq, 2 * nq, 2 * nq)
    for kw in ({}, {"lanes": lanes}):
        kern = cuda_jumpscore.jump_score_cuda(*t, *ARGS, **kw)
        assert torch.equal(kern, plain), kw
    cuda_jumpscore.raise_on_kernel_error()


@pytest.mark.parametrize("lanes", cuda_jumpscore.LANE_CHOICES)
@pytest.mark.parametrize("nq", (530, 1500))
def test_kernel_every_layout_gives_the_same_scores(cuda, lanes, nq):
    """Two widths through every lanes-per-thread choice, from 1 warp a
    row to 16: a layout changes the time, never the score. Rows of many
    lengths, so some warps of a row lie wholly above its query end."""
    rng = np.random.default_rng(5)
    jobs = _jobs(rng, 20, nq, 900) + _jobs(rng, 6, 60, 900)
    t = dj.from_reference_inputs(*_padded(jobs, 28, nq, 900), cuda)
    plain = dj.batched_jump_score(*t, *ARGS, nq, 900, 900)
    kern = cuda_jumpscore.jump_score_cuda(*t, *ARGS, lanes=lanes)
    assert torch.equal(kern, plain)
    cuda_jumpscore.raise_on_kernel_error()


def test_kernel_layout_by_batch(cuda):
    """Which form a batch takes: the fewest lanes per thread for which
    its warps have a scheduler each (422 warps); the most lanes where
    none does."""
    assert [cuda_jumpscore.kernel_layout(B, nq) for B, nq in
            ((8, 256), (64, 512), (256, 128), (256, 512), (8, 8192),
             (256, 4096))] == [
        (3, 3), (3, 6), (5, 1), (17, 1), (5, 52), (17, 8)]
    t = dj.from_reference_inputs(*_padded(_jobs(
        np.random.default_rng(1), 2, 30, 40), 2, 30, 40), cuda)
    with pytest.raises(ValueError, match="lanes"):
        cuda_jumpscore.jump_score_cuda(*t, *ARGS, lanes=4)
    with pytest.raises(ValueError, match="extend"):
        cuda_jumpscore.jump_score_cuda(*t, *ARGS[:3], 1, *ARGS[4:])


# ---- the bounded jump DP (csrc/jump_score_bounded.cu)

def _bounded_jobs(rng, B, nq_max, nr_max, rounds):
    """_jobs, plus a junction insertion longer than 2^(rounds+1) lanes
    (flags), queries of 2^rounds + 1 and 2^rounds bases (the shortest
    that flags, through the first lane of the detection window alone,
    and the longest that cannot) and one shorter still."""
    seq = lambda n: bytes(b"ACGT"[i] for i in rng.integers(0, 4, n))
    jobs = _jobs(rng, B, nq_max, nr_max)
    half = max(2, min(50, (nq_max - (2 << rounds) - 9) // 2))
    left, right = seq(half), seq(half)
    ins = seq(min((2 << rounds) + 8, max(0, nq_max - 2 * half)))
    jobs.append((left + ins + right, seq(30) + left, right + seq(30)))
    for n in ((1 << rounds) + 1, 1 << rounds, (1 << rounds) - 1):
        jobs.append((seq(n), jobs[0][1], jobs[0][2]))
    return jobs


@pytest.mark.parametrize("rounds", (1, 3, 5, 7))
@pytest.mark.parametrize("B,nq_max,nr_max", [
    (1, 200, 300),          # one job (plus the crafted rows)
    (5, 1100, 900),         # wider than one block's lanes at L = 1
    (9, 400, 800), (2, 8192, 2048)])
def test_bounded_kernel_matches_plain(cuda, B, nq_max, nr_max, rounds):
    """(best, flag) of the kernel == the plain flagged form on every
    row; bounded + rerun == the exact kernel == the plain exact form."""
    jobs = _bounded_jobs(np.random.default_rng(B + nq_max), B, nq_max,
                         nr_max, rounds)
    t = dj.from_reference_inputs(*dj.pad_jobs(jobs, len(jobs) + 2), cuda)
    nq, nr1, nr2 = t[0].shape[1], t[2].shape[1], t[4].shape[1]
    before = dict(cuda_jumpscore.KERNEL_LAUNCHES)
    best, flag = cuda_jumpscore.jump_score_flagged_cuda(*t, *ARGS, rounds)
    assert cuda_jumpscore.KERNEL_LAUNCHES["jump_score_bounded"] == \
        before["jump_score_bounded"] + 1
    fixed, n_flagged = cuda_jumpscore.jump_score_bounded_cuda(*t, *ARGS,
                                                              rounds)
    exact = cuda_jumpscore.jump_score_cuda(*t, *ARGS)
    p_best, p_flag = dj.batched_jump_score_flagged(*t, *ARGS, nq, nr1, nr2,
                                                   rounds)
    p_exact = dj.batched_jump_score(*t, *ARGS, nq, nr1, nr2)
    torch.cuda.synchronize()
    assert best.dtype == torch.int32 and flag.dtype == torch.int32
    assert torch.equal(best, p_best)
    assert torch.equal(flag, p_flag)
    assert torch.equal(fixed, exact) and torch.equal(exact, p_exact)
    assert n_flagged == int((flag != 0).sum())
    assert flag[len(jobs) - 4] == 1 or (2 << rounds) + 8 > nq_max
    # 2^K + 1 bases flag; 2^K, 2^K - 1 and the two pad rows do not
    assert flag[len(jobs) - 3:].tolist() == [1, 0, 0, 0, 0]


@pytest.mark.parametrize("rounds", (3, 5))
def test_bounded_kernel_single_row(cuda, rounds):
    jobs = _jobs(np.random.default_rng(8), 1, 300, 500)
    t = dj.from_reference_inputs(*dj.pad_jobs(jobs, 1), cuda)
    assert t[0].shape[0] == 1
    nq, nr1, nr2 = t[0].shape[1], t[2].shape[1], t[4].shape[1]
    best, flag = cuda_jumpscore.jump_score_flagged_cuda(*t, *ARGS, rounds)
    p_best, p_flag = dj.batched_jump_score_flagged(*t, *ARGS, nq, nr1, nr2,
                                                   rounds)
    assert torch.equal(best, p_best) and torch.equal(flag, p_flag)


def test_bounded_kernel_window_covers_every_lane(cuda):
    """2^K past the query width: the exact chain, no flag."""
    jobs = _jobs(np.random.default_rng(2), 6, 120, 200)
    t = dj.from_reference_inputs(*dj.pad_jobs(jobs, 8), cuda)
    best, flag = cuda_jumpscore.jump_score_flagged_cuda(*t, *ARGS, 8)
    assert torch.equal(best, cuda_jumpscore.jump_score_cuda(*t, *ARGS))
    assert not flag.any()


def test_bounded_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    jobs = _jobs(np.random.default_rng(4), 3, 50, 90)
    t = dj.from_reference_inputs(*dj.pad_jobs(jobs, 3), cuda)
    before = dict(cuda_jumpscore.KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_jumpscore.jump_score_flagged_cuda(t[0].cpu(), *t[1:], *ARGS, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_jumpscore.jump_score_bounded_cuda(
            *(x.cpu() for x in t), *ARGS, 3)
    with pytest.raises(TypeError):
        cuda_jumpscore.jump_score_flagged_cuda(t[0].long(), *t[1:], *ARGS, 3)
    with pytest.raises(ValueError, match="prefix_rounds"):
        cuda_jumpscore.jump_score_flagged_cuda(*t, *ARGS, 0)
    wide = torch.ones((1, 17408), dtype=torch.int32, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="limit"):
        cuda_jumpscore.jump_score_flagged_cuda(wide, one, wide[:, :8], one,
                                               wide[:, :8], one, *ARGS, 3)
    assert cuda_jumpscore.KERNEL_LAUNCHES == before


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


@pytest.mark.parametrize("n,t,L,T,n_scan", [
    (256, 2, 256, 500, 512),        # 512 pairs: the Pallas bench shape
    (47, 2, 256, 400, 512),         # a typical workflow call, ~93 pairs
    (9, 5, 512, 1900, 2048), (1, 1, 256, 300, 512), (3, 130, 256, 300, 512)])
def test_split_factored_kernel_matches_plain_and_replicated(cuda, n, t, L,
                                                            T, n_scan):
    """The factored call == the factored plain form == the replicated
    call on the replicated rows, bit for bit."""
    rng = np.random.default_rng(n + t)
    rows = _split_rows(rng, n, L, T, True)
    tg = _split_rows(rng, t, L, T, True)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    reads, quals, rl = put(rows[0]), put(rows[1]), put(rows[5])
    targets, beg, end, tl = put(tg[2]), put(tg[3]), put(tg[4]), put(tg[6])
    lm, lx = (put(a) for a in ds.make_luts(1e-3))
    launches = cuda_splitscore.KERNEL_LAUNCHES["split_score"]
    out = torch.empty((2, n, t), dtype=torch.int32, device=cuda)
    kb, kp = cuda_splitscore.split_score_factored_cuda(
        reads, quals, rl, targets, beg, end, tl, 50, lm, lx, n_scan, out=out)
    assert cuda_splitscore.KERNEL_LAUNCHES["split_score"] == launches + 1
    pb, pp = ds.batched_split_score_factored(
        reads, quals, rl, targets, beg, end, tl, 50, lm, lx, n_scan)
    rep = lambda a: a.repeat_interleave(t, dim=0).contiguous()
    til = lambda a: a.repeat(n, *([1] * (a.dim() - 1))).contiguous()
    rb, rp = cuda_splitscore.split_score_cuda(
        rep(reads), rep(quals), til(targets), til(beg), til(end), rep(rl),
        til(tl), 50, lm, lx, n_scan)
    torch.cuda.synchronize()
    assert kb.shape == (n, t) and kb.dtype == torch.float32
    assert torch.equal(kb, pb) and torch.equal(kp, pp)
    assert torch.equal(kb.reshape(-1), rb) and torch.equal(kp.reshape(-1), rp)
    assert torch.equal(out[0].view(torch.float32), kb)
    assert torch.isfinite(kb).any()


def test_scan_multi_on_the_card_copies_once_each_way(cuda):
    """DeviceScanContext.scan_multi on CUDA == the native host scan, bit
    for bit, with one host-to-device and one device-to-host copy a call
    (the LUTs went over at the first)."""
    from manta_tpu_torch.io.bam import BamReader
    from manta_tpu_torch.scoring import device_scan
    from manta_tpu_torch.scoring.evidence import (
        QscoreSnp, split_read_scan_multi,
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    batch = BamReader(os.path.join(
        repo, "tests", "data", "demo",
        "G15512.HCC1954.1.COST16011_region.bam")).fetch(
            "8", 107652000, 107655000)
    seq = lambda i: batch.seq[batch.seq_off[i]:batch.seq_off[i + 1]]
    targets = [np.concatenate([seq(0), seq(1)[:40]]),
               np.concatenate([seq(1), seq(0)[:60]])]
    ranges = [(len(seq(0)) - 3, len(seq(0)) + 2),
              (len(seq(1)) - 4, len(seq(1)) + 1)]
    qconv = QscoreSnp(1e-3)
    ctx = device_scan.DeviceScanContext(device=cuda)
    for idx in (np.arange(0, 47, dtype=np.int64),
                np.arange(10, 300, dtype=np.int64)):
        copies = dict(device_scan.EXACT_COPIES)
        launches = cuda_splitscore.KERNEL_LAUNCHES["split_score"]
        got = ctx.scan_multi(50, batch, idx, qconv, targets, ranges)
        want = split_read_scan_multi(50, batch, idx, qconv, targets, ranges)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert device_scan.EXACT_COPIES == {"h2d": copies["h2d"] + 1,
                                            "d2h": copies["d2h"] + 1}
        assert cuda_splitscore.KERNEL_LAUNCHES["split_score"] == launches + 1


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
