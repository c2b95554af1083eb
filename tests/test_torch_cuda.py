"""The CUDA jump-DP kernel on the card, against its plain PyTorch form
(on the same card) and the full traceback aligner. Tolerance: exact.

Needs a CUDA device and nvcc; skips without them. tests/conftest.py
imports JAX, which a GPU host may not have, so on the card run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from manta_tpu.align.aligners import AlignmentScores, GlobalJumpAligner
from manta_tpu_torch import native_core
from manta_tpu_torch.align import cuda_jumpscore
from manta_tpu_torch.align import device_jumpscore as dj

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
