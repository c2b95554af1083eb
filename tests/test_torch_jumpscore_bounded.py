"""The port's bounded-insert-chain jump DP (manta_tpu_torch.align) vs
manta_tpu's Pallas kernel in interpret mode.

Inputs are made from a seed with numpy and handed to both packages as
the same padded int32 arrays (from_reference_inputs). Tolerance: exact
equality everywhere (int32 DP), of the bounded score and of the flag on
every row."""

import numpy as np
import pytest
import torch

from manta_tpu.align.device_jumpscore import (
    batched_jump_score as jax_batched_jump_score,
)
from manta_tpu.align.pallas_jumpscore import (
    pallas_jump_score, pallas_jump_score_bounded, pallas_jump_score_flagged,
)
from manta_tpu_torch.align import cuda_jumpscore
from manta_tpu_torch.align import device_jumpscore as dj
from manta_tpu_torch.align.aligners import AlignmentScores, jump_score_batch

from test_pallas_jumpscore import _pad, _rand_jobs
from test_torch_splitscore import one_torch_thread  # noqa: F401  (autouse)

SCORES = (2, -8, -18, -1, -1)        # match, mismatch, open, extend, offEdge
JUMP = -100
# K = 9 covers every lane of every case here (2^9 > 191 query lanes)
ROUNDS = (1, 3, 5, 9)


def _long_insertion_jobs():
    """The jobs of test_pallas_jumpscore.py:70: the optimum is a jump
    plus an untemplated insertion of 0..90 bases, so short chains (no
    flag needed) and chains longer than 2^(K+1) lanes both occur."""
    rng = np.random.default_rng(23)
    bases = b"ACGT"

    def seq(n):
        return bytes(bases[i] for i in rng.integers(0, 4, n))

    def mk(ins_len):
        left, right, ins = seq(50), seq(50), seq(ins_len)
        return (left + ins + right, seq(30) + left, right + seq(30))

    jobs = [mk(0), mk(2), mk(40), mk(5), mk(90), mk(0)]
    nq = max(len(j[0]) for j in jobs)
    nr = max(max(len(j[1]), len(j[2])) for j in jobs)
    return jobs, nq, nr


def _soundness_jobs():
    """The jobs of test_pallas_jumpscore.py:123."""
    return _rand_jobs(np.random.default_rng(31), 8, 100, 200), 100, 200


def _random_jobs():
    return _rand_jobs(np.random.default_rng(41), 16, 128, 256), 128, 256


CASES = {"long_insertions": _long_insertion_jobs,
         "soundness_sweep": _soundness_jobs,
         "random": _random_jobs}


def _padded(jobs, nq, nr):
    q, ql = _pad([j[0] for j in jobs], nq, 1)
    r1, r1l = _pad([j[1] for j in jobs], nr, 2)
    r2, r2l = _pad([j[2] for j in jobs], nr, 2)
    return q, ql, r1, r1l, r2, r2l


@pytest.mark.parametrize("rounds", ROUNDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_flagged_matches_pallas_interpret(case, rounds):
    jobs, nq, nr = CASES[case]()
    assert nq <= 190 and nr <= 256 and len(jobs) <= 16
    arrays = _padded(jobs, nq, nr)
    tail = (*SCORES, JUMP, nq, nr, nr)
    best, flag = dj.batched_jump_score_flagged(
        *dj.from_reference_inputs(*arrays, "cpu"), *tail, rounds)
    assert best.dtype == torch.int32 and flag.dtype == torch.int32
    if (1 << rounds) > nq:
        # the reference takes its exact path and returns no flag
        want_best = np.asarray(pallas_jump_score(*arrays, *tail,
                                                 interpret=True))
        want_flag = np.zeros(len(jobs), np.int32)
    else:
        want_best, want_flag = (np.asarray(x) for x in
                                pallas_jump_score_flagged(
                                    *arrays, *tail, rounds, interpret=True))
    np.testing.assert_array_equal(best.numpy(), want_best)
    np.testing.assert_array_equal(flag.numpy(), want_flag)


@pytest.mark.parametrize("rounds", (3, 5))
def test_flagged_and_unflagged_rows(rounds):
    """Both kinds of row are present: the 40- and 90-base insertions
    flag (the reference's own assertion at K = 3); a query of 2^K + 1
    bases flags through the first lane of the detection window alone,
    and one of 2^K bases, whose every chain fits the window, cannot. A
    row whose bounded score differs is flagged (soundness), and some
    row does differ."""
    jobs, _, nr = _long_insertion_jobs()
    rng = np.random.default_rng(5)
    for n in ((1 << rounds) + 1, 1 << rounds):
        jobs.append((bytes(b"ACGT"[i] for i in rng.integers(0, 4, n)),
                     jobs[0][1], jobs[0][2]))
    jobs.append((b"\x01", b"\x02", b"\x02"))
    nq = max(len(j[0]) for j in jobs)
    arrays = _padded(jobs, nq, nr)
    t = dj.from_reference_inputs(*arrays, "cpu")
    tail = (*SCORES, JUMP, nq, nr, nr)
    exact = dj.batched_jump_score(*t, *tail)
    best, flag = dj.batched_jump_score_flagged(*t, *tail, rounds)
    want_best, want_flag = pallas_jump_score_flagged(*arrays, *tail, rounds,
                                                     interpret=True)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want_best))
    np.testing.assert_array_equal(flag.numpy(), np.asarray(want_flag))
    assert flag[2] and flag[4]
    assert flag[6:].tolist() == [1, 0, 0]
    assert not ((best != exact) & (flag == 0)).any()
    assert (best != exact).any()


@pytest.mark.parametrize("rounds", (1, 2, 3, 4, 5, 6, 9))
@pytest.mark.parametrize("case", sorted(CASES))
def test_bounded_matches_every_exact_form(case, rounds):
    """bounded + rerun == the port's exact form == JAX's exact form ==
    the Pallas bounded form; and the native score batch where that is
    exact (not on the long-insertion jobs, whose junction insertion it
    scores 3 lower, see ROADMAP.md Queue 3)."""
    jobs, nq, nr = CASES[case]()
    arrays = _padded(jobs, nq, nr)
    tail = (*SCORES, JUMP, nq, nr, nr)
    t = dj.from_reference_inputs(*arrays, "cpu")
    got, n_flagged = dj.batched_jump_score_bounded(*t, *tail, rounds)
    _, flag = dj.batched_jump_score_flagged(*t, *tail, rounds)
    assert n_flagged == int((flag != 0).sum())
    np.testing.assert_array_equal(
        got.numpy(), dj.batched_jump_score(*t, *tail).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_batched_jump_score(*arrays, *tail)))
    if case != "long_insertions":
        np.testing.assert_array_equal(
            got.numpy(),
            jump_score_batch(jobs, AlignmentScores(*SCORES), JUMP))
    if rounds in (3, 5):
        ref, ref_n = pallas_jump_score_bounded(*arrays, *tail, rounds,
                                               interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert n_flagged == ref_n


def test_flagged_on_bucket_padded_jobs():
    """Through pad_jobs (pad rows of length 1, query bucket 256): pad
    rows never flag, and K = 8 covers the bucket's 257 lanes only with
    the 9th round, so it is still the bounded chain."""
    jobs, _, _ = _long_insertion_jobs()
    arrays = dj.pad_jobs(jobs, 8)
    nq, nr1, nr2 = (arrays[i].shape[1] for i in (0, 2, 4))
    tail = (*SCORES, JUMP, nq, nr1, nr2)
    t = dj.from_reference_inputs(*arrays, "cpu")
    for rounds in (3, 8):
        best, flag = dj.batched_jump_score_flagged(*t, *tail, rounds)
        want_best, want_flag = pallas_jump_score_flagged(
            *arrays, *tail, rounds, interpret=True)
        np.testing.assert_array_equal(best.numpy(), np.asarray(want_best))
        np.testing.assert_array_equal(flag.numpy(), np.asarray(want_flag))
        assert flag[6:].tolist() == [0, 0]


@pytest.mark.parametrize("rounds", (1, 2, 3, 5, 7))
def test_bounded_prefix_is_the_windowed_maximum(rounds):
    """The chain of one column against its definition, on sources that
    no DP made (so that the two windows really differ): out over the
    last 2^K lanes, the raised mask from the last 2^(K+1)."""
    rng = np.random.default_rng(rounds)
    B, width, extend = 5, 70, -1
    f = rng.integers(-400, 400, (B, width)).astype(np.int32)
    f[rng.random((B, width)) < 0.4] = dj.BAD
    f[:, 0] = dj.BAD - 7                 # below BAD is no source either
    k = np.arange(width, dtype=np.int64)
    g = np.where(f <= dj.BAD, dj.NEG, f - extend * k)

    def window(w):
        out = np.empty((B, width), np.int64)
        for q in range(width):
            out[:, q] = g[:, max(0, q - w + 1):q + 1].max(axis=1)
        return np.maximum(out + extend * (k + 1), dj.BAD)

    want, want2 = window(1 << rounds), window(2 << rounds)
    got, raised = dj._maxplus_prefix(
        torch.from_numpy(f), extend,
        torch.arange(width, dtype=torch.int32)[None, :], rounds)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(raised.numpy(), want2 > want)
    if (1 << rounds) < width:
        assert raised.any()
    exact, none = dj._maxplus_prefix(
        torch.from_numpy(f), extend,
        torch.arange(width, dtype=torch.int32)[None, :])
    assert none is None
    np.testing.assert_array_equal(exact.numpy(), window(width))


def test_prefix_rounds_must_be_positive():
    jobs, nq, nr = _soundness_jobs()
    t = dj.from_reference_inputs(*_padded(jobs, nq, nr), "cpu")
    with pytest.raises(ValueError, match="prefix_rounds"):
        dj.batched_jump_score_flagged(*t, *SCORES, JUMP, nq, nr, nr, 0)


def test_cuda_wrappers_raise_on_cpu_tensor():
    """The bounded kernel's wrappers never run the plain form: a CPU
    tensor raises before any build or launch."""
    jobs, nq, nr = _soundness_jobs()
    t = dj.from_reference_inputs(*_padded(jobs, nq, nr), "cpu")
    before = dict(cuda_jumpscore.KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_jumpscore.jump_score_flagged_cuda(*t, *SCORES, JUMP, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_jumpscore.jump_score_bounded_cuda(*t, *SCORES, JUMP, 3)
    with pytest.raises(TypeError, match="int32"):
        cuda_jumpscore.jump_score_flagged_cuda(t[0].long(), *t[1:],
                                               *SCORES, JUMP, 3)
    with pytest.raises(ValueError, match="prefix_rounds"):
        cuda_jumpscore.jump_score_flagged_cuda(*t, *SCORES, JUMP, 0)
    assert cuda_jumpscore.KERNEL_LAUNCHES == before


# ---- the plain model of the CUDA kernel's exchange
# (batched_jump_score_flagged_strips): the chain cut at thread and strip
# boundaries as csrc/jump_systolic.cuh cuts it

def _exchange_jobs():
    """Rows that flag (junction insertions longer than 2 x 32 lanes and
    2 x 8 lanes), rows that cannot (queries shorter than the shortest
    window), random rows and a pad row."""
    rng = np.random.default_rng(77)

    def seq(n):
        return bytes(b"ACGT"[i] for i in rng.integers(0, 4, n))

    def mk(ins_len):
        left, right = seq(25), seq(25)
        return (left + seq(ins_len) + right, seq(12) + left, right + seq(12))

    jobs = [mk(0), mk(70), mk(20), mk(3), (seq(2), seq(30), seq(30)),
            (seq(1), seq(30), seq(30)), (seq(33), seq(37), seq(9)),
            (b"\x01", b"\x02", b"\x02")]
    nq = max(len(j[0]) for j in jobs)
    return _padded(jobs, nq, 37), nq, 37


_EXCHANGE_WANT = {}


def _exchange_want(rounds):
    """(arrays, tail, best, flag) of the port's plain flagged form, held
    here against Pallas in interpret mode once per K."""
    if rounds not in _EXCHANGE_WANT:
        arrays, nq, nr = _exchange_jobs()
        tail = (*SCORES, JUMP, nq, nr, nr)
        best, flag = dj.batched_jump_score_flagged(
            *dj.from_reference_inputs(*arrays, "cpu"), *tail, rounds)
        ref_best, ref_flag = pallas_jump_score_flagged(
            *arrays, *tail, rounds, interpret=True)
        np.testing.assert_array_equal(best.numpy(), np.asarray(ref_best))
        np.testing.assert_array_equal(flag.numpy(), np.asarray(ref_flag))
        _EXCHANGE_WANT[rounds] = (arrays, tail, best, flag)
    return _EXCHANGE_WANT[rounds]


@pytest.mark.parametrize("threads", (1, 32, 33, "row", "row+1"), ids=str)
@pytest.mark.parametrize("rounds", (1, 3, 5))
@pytest.mark.parametrize("lanes", (3, 5, 9, 17))
def test_exchange_model_matches_plain_and_pallas(lanes, rounds, threads):
    """Thread widths 3, 5, 9, 17, windows W = 2, 8, 32, strips of 1, 32
    and 33 threads, of the whole row and of one lane more: score and
    flag equal the plain flagged form and Pallas in interpret mode
    exactly. Sources at or under BAD stay un-floored in the model, as in
    the kernel, and raise neither window."""
    arrays, tail, want_best, want_flag = _exchange_want(rounds)
    nq = tail[6]
    if threads == "row":
        threads = -(-(nq + 1) // lanes)
    elif threads == "row+1":
        threads = -(-(nq + 2) // lanes)
    t = dj.from_reference_inputs(*arrays, "cpu")
    best, flag = dj.batched_jump_score_flagged_strips(*t, *tail, rounds,
                                                      lanes, threads)
    assert best.dtype == torch.int32 and flag.dtype == torch.int32
    np.testing.assert_array_equal(best.numpy(), want_best.numpy())
    np.testing.assert_array_equal(flag.numpy(), want_flag.numpy())
    # rows that flag and rows that cannot are both present
    assert want_flag[1] == 1 and want_flag[-1] == 0
    assert not want_flag[4:6].any() or rounds == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_exchange_model_on_the_flagged_cases(case):
    """The cases of the flagged form above through one uneven cut (5
    lanes a thread, 7 threads a strip) at K = 3."""
    jobs, nq, nr = CASES[case]()
    arrays = _padded(jobs, nq, nr)
    tail = (*SCORES, JUMP, nq, nr, nr)
    t = dj.from_reference_inputs(*arrays, "cpu")
    best, flag = dj.batched_jump_score_flagged_strips(*t, *tail, 3, 5, 7)
    want_best, want_flag = dj.batched_jump_score_flagged(*t, *tail, 3)
    np.testing.assert_array_equal(best.numpy(), want_best.numpy())
    np.testing.assert_array_equal(flag.numpy(), want_flag.numpy())


def test_exchange_model_sentinel_sources_raise_no_window():
    """A source at or under BAD is NEG in the plain form and f -
    extend*k in the kernel and its model: on sources no DP made, with
    many at and under BAD, both windows floored at BAD are the same
    numbers, so neither the insert value nor the flag can differ."""
    rng = np.random.default_rng(11)
    B, width, extend, w = 6, 90, -1, 8
    f = rng.integers(-300, 300, (B, width)).astype(np.int64)
    f[rng.random((B, width)) < 0.5] = dj.BAD - rng.integers(0, 50)
    k = np.arange(width, dtype=np.int64)
    for floor in (True, False):
        g = f - extend * k
        if floor:
            g = np.where(f <= dj.BAD, dj.NEG, g)
        out = []
        for win in (w, 2 * w):
            m = np.stack([g[:, max(0, q - win + 1):q + 1].max(axis=1)
                          for q in range(width)], axis=1)
            out.append(np.maximum(m + extend * (k + 1), dj.BAD))
        if floor:
            want = out
        else:
            np.testing.assert_array_equal(out[0], want[0])
            np.testing.assert_array_equal(out[1], want[1])


def test_exchange_model_rejects_bad_cuts():
    arrays, tail, _b, _f = _exchange_want(3)
    t = dj.from_reference_inputs(*arrays, "cpu")
    with pytest.raises(ValueError, match="lanes"):
        dj.batched_jump_score_flagged_strips(*t, *tail, 3, 0, 4)
    with pytest.raises(ValueError, match="prefix_rounds"):
        dj.batched_jump_score_flagged_strips(*t, *tail, 0, 3, 4)
