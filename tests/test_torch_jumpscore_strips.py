"""The strip form of the port's jump DP, the plain model of the CUDA
kernel's decomposition (query lanes cut into strips that hand two
boundary values per column upwards), vs the port's plain form and
manta_tpu's JAX forms.

Inputs are made from a seed with numpy and handed to every form as the
same padded int32 arrays. Tolerance: 0 (int32 DP)."""

import numpy as np
import pytest

from manta_tpu.align.device_jumpscore import (
    batched_jump_score as jax_batched_jump_score,
)
from manta_tpu.align.pallas_jumpscore import pallas_jump_score
from manta_tpu_torch.align import device_jumpscore as dj

from test_pallas_jumpscore import _rand_jobs
from test_torch_jumpscore import SCORE_SETS, _args, _padded


def _seq(rng, n):
    return bytes(b"ACGT"[i] for i in rng.integers(0, 4, n))


def _case_random(rng):
    return _padded(_rand_jobs(rng, 5, 60, 120), 60, 120)


def _case_long_insertions_and_pad_rows(rng):
    def mk(ins_len):
        left, right = _seq(rng, 50), _seq(rng, 50)
        return (left + _seq(rng, ins_len) + right, _seq(rng, 30) + left,
                right + _seq(rng, 30))
    return dj.pad_jobs([mk(0), mk(2), mk(40), mk(90)], 6)


def _case_short_queries(rng):
    """A 7-base query, a 1-base query and a wide one in one batch: most
    strips of the short rows lie above their query end."""
    r1, r2 = _seq(rng, 70), _seq(rng, 64)
    jobs = [(r1[-4:] + r2[:3], r1, r2), (b"A", r1, r2),
            (r1[-30:] + r2[:34], r1, r2)]
    return _padded(jobs, 64, 70)


def _case_empty_ref2(rng):
    arrays = list(_padded(_rand_jobs(rng, 4, 40, 50), 40, 50))
    arrays[5] = np.array([0, 0, 7, 50], np.int32)       # ref2_len
    arrays[3] = np.array([50, 0, 0, 33], np.int32)      # ref1_len
    return tuple(arrays)


def _case_queries_longer_than_refs(rng):
    return dj.pad_jobs(_rand_jobs(rng, 3, 129, 64), 4)


CASES = {
    "random": _case_random,
    "long_insertions_pad_rows": _case_long_insertions_and_pad_rows,
    "short_queries": _case_short_queries,
    "empty_refs": _case_empty_ref2,
    "query_longer_than_refs": _case_queries_longer_than_refs,
}
# strip widths in lanes: one lane, a warp's and one more, then (below)
# the whole row and one above it
STRIPS = (1, 32, 33, "row", "row+1")


@pytest.mark.parametrize("strip", STRIPS, ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_strip_form_matches_plain_and_jax(case, strip):
    scores, jump = SCORE_SETS["open18_jump100"]
    arrays = CASES[case](np.random.default_rng(len(case) * 7 + 1))
    nq, nr1, nr2 = (arrays[i].shape[1] for i in (0, 2, 4))
    width = {"row": nq + 1, "row+1": nq + 2}.get(strip, strip)
    t = dj.from_reference_inputs(*arrays, "cpu")
    args = _args(scores, jump)
    got = dj.batched_jump_score_strips(*t, *args, nq, nr1, nr2,
                                       width).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, dj.batched_jump_score(*t, *args, nq, nr1, nr2).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax_batched_jump_score(
        *arrays, *args, nq, nr1, nr2)))


@pytest.mark.parametrize("score_set", sorted(SCORE_SETS))
def test_strip_form_score_sets(score_set):
    """The other score sets (a jump cheap enough to be taken often), at
    a strip width that cuts the row unevenly."""
    scores, jump = SCORE_SETS[score_set]
    arrays = _padded(_rand_jobs(np.random.default_rng(41), 6, 75, 90),
                     75, 90)
    t = dj.from_reference_inputs(*arrays, "cpu")
    args = _args(scores, jump)
    got = dj.batched_jump_score_strips(*t, *args, 75, 90, 90, 20).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_batched_jump_score(
        *arrays, *args, 75, 90, 90)))


def test_strip_form_matches_pallas_interpret():
    scores, jump = SCORE_SETS["open18_jump100"]
    B, nq, nr = 4, 48, 96
    arrays = _padded(_rand_jobs(np.random.default_rng(5), B, nq, nr),
                     nq, nr)
    t = dj.from_reference_inputs(*arrays, "cpu")
    got = dj.batched_jump_score_strips(*t, *_args(scores, jump), nq, nr,
                                       nr, 17).numpy()
    want = np.asarray(pallas_jump_score(
        *arrays, *_args(scores, jump), nq, nr, nr, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_strip_width_must_be_positive():
    arrays = _padded(_rand_jobs(np.random.default_rng(2), 2, 10, 20), 10, 20)
    t = dj.from_reference_inputs(*arrays, "cpu")
    with pytest.raises(ValueError, match="strip"):
        dj.batched_jump_score_strips(
            *t, *_args(*SCORE_SETS["open12_jump100"]), 10, 20, 20, 0)
