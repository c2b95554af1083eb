"""The port's jump DP (manta_tpu_torch.align) vs manta_tpu's JAX forms
and the native aligners.

Inputs are made from a seed with numpy and handed to both packages as
the same padded int32 arrays (from_reference_inputs). Tolerance: exact
equality everywhere (int32 DP)."""

import numpy as np
import pytest
import torch

from manta_tpu.align.aligners import (
    AlignmentScores, GlobalJumpAligner, jump_score_batch,
)
from manta_tpu.align.device_jumpscore import (
    batched_jump_score as jax_batched_jump_score,
)
from manta_tpu.align.pallas_jumpscore import pallas_jump_score
from manta_tpu_torch.align import cuda_jumpscore
from manta_tpu_torch.align import device_jumpscore as dj

from test_pallas_jumpscore import _pad, _rand_jobs

# (scores, jump): the sets of test_pallas_jumpscore.py and
# test_device_jumpscore.py, the latter with both of its jump scores
SCORE_SETS = {
    "open18_jump100": (AlignmentScores(2, -8, -18, -1, -1), -100),
    "open12_jump100": (AlignmentScores(2, -8, -12, -1, -1), -100),
    "open12_jump10": (AlignmentScores(2, -8, -12, -1, -1), -10),
}
# the three shapes of test_pallas_jumpscore.py:51
SHAPES = ((5, 60, 120), (9, 150, 260), (3, 40, 500))


def _args(scores, jump):
    return (scores.match, scores.mismatch, scores.open, scores.extend,
            scores.off_edge, jump)


def _padded(jobs, nq, nr):
    q, ql = _pad([j[0] for j in jobs], nq, 1)
    r1, r1l = _pad([j[1] for j in jobs], nr, 2)
    r2, r2l = _pad([j[2] for j in jobs], nr, 2)
    return q, ql, r1, r1l, r2, r2l


def _torch_plain(arrays, scores, jump, nq, nr1, nr2):
    t = dj.from_reference_inputs(*arrays, "cpu")
    return dj.batched_jump_score(*t, *_args(scores, jump),
                                 nq, nr1, nr2).numpy()


@pytest.mark.parametrize("score_set", sorted(SCORE_SETS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%d_q%d_r%d" % s)
def test_plain_matches_jax_and_native(shape, score_set):
    scores, jump = SCORE_SETS[score_set]
    B, nq, nr = shape
    rng = np.random.default_rng(17 + nq)
    jobs = _rand_jobs(rng, B, nq, nr)
    arrays = _padded(jobs, nq, nr)
    got = _torch_plain(arrays, scores, jump, nq, nr, nr)
    want = np.asarray(jax_batched_jump_score(
        *arrays, *_args(scores, jump), nq, nr, nr))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jump_score_batch(jobs, scores, jump))


def test_plain_matches_pallas_interpret():
    scores, jump = SCORE_SETS["open18_jump100"]
    B, nq, nr = 4, 48, 96
    jobs = _rand_jobs(np.random.default_rng(5), B, nq, nr)
    arrays = _padded(jobs, nq, nr)
    got = _torch_plain(arrays, scores, jump, nq, nr, nr)
    want = np.asarray(pallas_jump_score(
        *arrays, *_args(scores, jump), nq, nr, nr, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_long_insertions_and_pad_rows():
    """Long untemplated junction insertions (insert chains far longer
    than any short-chain shortcut) and length-1 pad rows, padded to the
    scorer's buckets by pad_jobs."""
    scores, jump = SCORE_SETS["open18_jump100"]
    rng = np.random.default_rng(23)
    bases = b"ACGT"

    def seq(n):
        return bytes(bases[i] for i in rng.integers(0, 4, n))

    def mk(ins_len):
        left, right = seq(50), seq(50)
        return (left + seq(ins_len) + right, seq(30) + left,
                right + seq(30))

    jobs = [mk(0), mk(2), mk(40), mk(5), mk(90), mk(0)]
    arrays = dj.pad_jobs(jobs, 8)
    nq, nr1, nr2 = arrays[0].shape[1], arrays[2].shape[1], \
        arrays[4].shape[1]
    assert (nq, nr1, nr2) == (256, 128, 128)
    assert arrays[1][6:].tolist() == [1, 1]
    got = _torch_plain(arrays, scores, jump, nq, nr1, nr2)
    want = np.asarray(jax_batched_jump_score(
        *arrays, *_args(scores, jump), nq, nr1, nr2))
    np.testing.assert_array_equal(got, want)
    # the full traceback aligner; the native score batch scores a
    # junction insertion between ref1's last and ref2's first base 3
    # lower (ROADMAP.md Queue 3)
    aln = GlobalJumpAligner(scores, jump)
    assert got[:6].tolist() == [aln.align(*j, seqmatch=False).score
                                for j in jobs]


def test_plain_matches_full_aligner_on_queries_longer_than_refs():
    """Queries longer than both references together: the plain form
    and the JAX form agree with the full traceback aligner (the native
    score batch departs from it on some of these)."""
    scores, jump = SCORE_SETS["open12_jump100"]
    rng = np.random.default_rng(1)
    jobs = _rand_jobs(rng, 6, 129, 64)
    arrays = dj.pad_jobs(jobs, 6)
    nq, nr1, nr2 = arrays[0].shape[1], arrays[2].shape[1], \
        arrays[4].shape[1]
    got = _torch_plain(arrays, scores, jump, nq, nr1, nr2)
    aln = GlobalJumpAligner(scores, jump)
    want = [aln.align(*j, seqmatch=False).score for j in jobs]
    assert got.tolist() == want
    np.testing.assert_array_equal(got, np.asarray(jax_batched_jump_score(
        *arrays, *_args(scores, jump), nq, nr1, nr2)))


@pytest.mark.parametrize("jump", (-100, -10))
def test_jump_scores_match_full_aligner(jump):
    """dj.jump_scores on the CPU (test_device_jumpscore.py's cases)."""
    scores = SCORE_SETS["open12_jump100"][0]
    rng = np.random.default_rng(11)
    aln = GlobalJumpAligner(scores, jump)
    queries, ref1s, ref2s, want = [], [], [], []
    for case in range(16):
        r1 = bytes(rng.choice(list(b"ACGT"), int(rng.integers(30, 200))))
        r2 = bytes(rng.choice(list(b"ACGT"), int(rng.integers(30, 200))))
        if case % 2 == 0:
            q = r1[-int(rng.integers(10, 30)):] + r2[:int(rng.integers(10,
                                                                     30))]
        else:
            q = bytes(rng.choice(list(b"ACGT"), int(rng.integers(20, 120))))
        queries.append(q)
        ref1s.append(r1)
        ref2s.append(r2)
        want.append(aln.align(q, r1, r2, seqmatch=False).score)
    got = dj.jump_scores(queries, ref1s, ref2s, scores, jump, "cpu")
    np.testing.assert_array_equal(got, np.array(want, np.int32))


def test_bucketed_scorer_cpu_matches_full_aligner():
    """The production backend on the CPU device (mirrors
    test_device_jumpscore.py:93-110): exact through its padding, and no
    kernel launch and no CUDA plain-form call."""
    scores, jump = SCORE_SETS["open12_jump100"]
    rng = np.random.default_rng(31)
    aln = GlobalJumpAligner(scores, jump)
    scorer = dj.make_bucketed_scorer(scores, jump, "cpu")
    launches = cuda_jumpscore.KERNEL_LAUNCHES["jump_score"]
    jobs, want = [], []
    for case in range(9):
        r1 = bytes(rng.choice(list(b"ACGT"), int(rng.integers(30, 120))))
        r2 = bytes(rng.choice(list(b"ACGT"), int(rng.integers(30, 120))))
        q = (r1[-20:] + r2[:25]) if case % 2 == 0 else \
            bytes(rng.choice(list(b"ACGT"), int(rng.integers(20, 90))))
        jobs.append((q, r1, r2))
        want.append(aln.align(q, r1, r2, seqmatch=False).score)
    got = scorer(jobs)
    assert got.dtype == np.int32
    assert got.tolist() == want
    assert scorer([]).shape == (0,)
    assert cuda_jumpscore.KERNEL_LAUNCHES["jump_score"] == launches


def test_bucket_tiers():
    assert [dj._bucket(n) for n in (1, 128, 129, 4096, 4097, 8193)] == \
        [128, 128, 256, 4096, 8192, 12288]


def test_cuda_wrapper_raises_on_cpu_tensor():
    """The kernel's wrapper never runs the plain form: a CPU tensor
    raises before any build or launch."""
    jobs = _rand_jobs(np.random.default_rng(3), 2, 20, 40)
    t = dj.from_reference_inputs(*dj.pad_jobs(jobs, 2), "cpu")
    args = _args(*SCORE_SETS["open12_jump100"])
    launches = cuda_jumpscore.KERNEL_LAUNCHES["jump_score"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_jumpscore.jump_score_cuda(*t, *args)
    with pytest.raises(TypeError, match="int32"):
        cuda_jumpscore.jump_score_cuda(t[0].long(), *t[1:], *args)
    assert cuda_jumpscore.KERNEL_LAUNCHES["jump_score"] == launches


def test_scorer_rejects_other_devices():
    with pytest.raises(ValueError, match="no jump-score path"):
        dj.make_bucketed_scorer(SCORE_SETS["open12_jump100"][0], -100,
                                "meta")


def test_from_reference_inputs_layout():
    q = np.arange(6, dtype=np.int64).reshape(2, 3)
    t = dj.from_reference_inputs(q, q[:, 0], q, q[:, 0], q, q[:, 0], "cpu")
    assert all(x.dtype == torch.int32 and x.is_contiguous() for x in t)
    assert t[0].tolist() == q.tolist()
