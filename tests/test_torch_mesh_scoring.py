"""The port's mesh-sharded contig scorer (manta_tpu_torch.parallel.
mesh_scoring) on 1, 3 and 8 CPU shards vs the port's single-device
bucketed scorer, manta_tpu's mesh scorer and the native score batch.

Jobs are made from a seed with numpy; references are at least as long as
queries, as around a real contig (the native score batch departs from
the full aligner on some queries longer than both references together,
ROADMAP.md Queue 3). Tolerance: exact (int32 scores)."""

import numpy as np
import pytest

from manta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from manta_tpu.parallel.mesh_scoring import (
    make_mesh_bucketed_scorer as jax_make_mesh_bucketed_scorer,
)
from manta_tpu_torch.align import device_jumpscore as dj
from manta_tpu_torch.align.aligners import AlignmentScores, jump_score_batch
from manta_tpu_torch.parallel import mesh_scoring
from manta_tpu_torch.parallel.mesh import make_mesh, shard_batch_spec

from test_torch_splitscore import one_torch_thread  # noqa: F401  (autouse)

SCORES = AlignmentScores(2, -8, -12, -1, -1)
JUMP = -100


def _jobs(seed, B, nq_max, nr_max):
    rng = np.random.default_rng(seed)
    seq = lambda n: bytes(b"ACGT"[i] for i in rng.integers(0, 4, n))
    jobs = []
    for _ in range(B):
        r1 = seq(int(rng.integers(nq_max, nr_max + 1)))
        r2 = seq(int(rng.integers(nq_max, nr_max + 1)))
        a = int(rng.integers(1, nq_max - 1))
        jobs.append((r1[-a:] + r2[:int(rng.integers(1, nq_max - a + 1))],
                     r1, r2))
    return jobs


@pytest.mark.parametrize("n_dev", (1, 3, 8))
@pytest.mark.parametrize("B", (1, 5, 11))
def test_mesh_scorer_matches_every_other_scorer(n_dev, B):
    jobs = _jobs(B * 10 + n_dev, B, 40, 60)
    before = dict(mesh_scoring.MESH_STATS)
    got = mesh_scoring.make_mesh_bucketed_scorer(
        make_mesh(n_dev, device="cpu"), SCORES, JUMP)(jobs)
    assert got.dtype == np.int32 and got.shape == (B,)
    stats = mesh_scoring.MESH_STATS
    assert stats["calls"] == before["calls"] + 1
    assert stats["jobs"] == before["jobs"] + B
    assert stats["slices"] == before["slices"] + n_dev
    # Bp: the batch tier, rounded up to a multiple of the device count
    assert (stats["rows"] - before["rows"]) % n_dev == 0
    assert stats["rows"] - before["rows"] >= 8
    np.testing.assert_array_equal(
        got, dj.make_bucketed_scorer(SCORES, JUMP, "cpu")(jobs))
    np.testing.assert_array_equal(got, jump_score_batch(jobs, SCORES, JUMP))
    np.testing.assert_array_equal(got, jax_make_mesh_bucketed_scorer(
        jax_make_mesh(n_dev), SCORES, JUMP)(jobs))


def test_mesh_scorer_empty_batch_and_pad_rows():
    scorer = mesh_scoring.make_mesh_bucketed_scorer(
        make_mesh(3, device="cpu"), SCORES, JUMP)
    assert scorer([]).shape == (0,)
    # 9 jobs: tier 16, 18 rows over 3 devices; the pad rows are cut off
    jobs = _jobs(4, 9, 30, 50)
    before = mesh_scoring.MESH_STATS["rows"]
    got = scorer(jobs)
    assert mesh_scoring.MESH_STATS["rows"] - before == 18
    np.testing.assert_array_equal(got, jump_score_batch(jobs, SCORES, JUMP))


def test_shard_batch_spec_cuts_and_replicates():
    import torch
    mesh = make_mesh(4, device="cpu")
    sharded, replicated = shard_batch_spec(mesh)
    x = torch.arange(24).reshape(8, 3)
    pieces = sharded(x)
    assert [p.shape for p in pieces] == [(2, 3)] * 4
    assert torch.equal(torch.cat(pieces), x)
    assert all(torch.equal(p, x) for p in replicated(x))
    with pytest.raises(ValueError, match="divide"):
        sharded(x[:7])
