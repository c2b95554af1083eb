"""The plain references against the port's plain forms (the tests may
import the port; the references may not), and the controls against the
references: the bounded insertion chain moves K1's scores."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from svbench import reference

SCORES = dict(match=2, mismatch=-8, open_=-12, extend=-1, off_edge=-1,
              jump_score=-100)


def _jobs(rng, n, ins=0):
    """Contigs drawn from two reference windows with a junction between
    them, with ``ins`` novel bases inserted at the junction and a few
    substitutions."""
    jobs = []
    for _ in range(n):
        r1 = rng.choice(list(b"ACGT"), int(rng.integers(200, 500)))
        r2 = rng.choice(list(b"ACGT"), int(rng.integers(200, 500)))
        a, b = int(rng.integers(20, 150)), int(rng.integers(20, 150))
        q = np.concatenate([r1[-a:], rng.choice(list(b"ACGT"), ins),
                            r2[:b]]).astype(np.uint8)
        q[rng.integers(0, len(q), 2)] = ord("A")
        jobs.append((q.tobytes(), r1.astype(np.uint8).tobytes(),
                     r2.astype(np.uint8).tobytes()))
    return jobs


def test_k1_reference_equals_the_ports_plain_form():
    from manta_tpu_torch.align import device_jumpscore as dj
    from manta_tpu_torch.align.aligners import AlignmentScores
    rng = np.random.default_rng(3)
    jobs = _jobs(rng, 10, ins=5)
    want = dj.make_bucketed_scorer(AlignmentScores(2, -8, -12, -1, -1), -100,
                                   "cpu")(jobs)
    got = reference.jump_scores(jobs, **SCORES)
    np.testing.assert_array_equal(got, want)


def test_k1_control_moves_scores_with_long_insertions():
    rng = np.random.default_rng(4)
    jobs = _jobs(rng, 6, ins=30)
    exact = reference.jump_scores(jobs, **SCORES)
    bounded = reference.jump_scores(jobs, **SCORES, rounds=3)
    assert (bounded != exact).any()
    assert (bounded <= exact).all()


def _scan_inputs(rng, n=12, t=2, L=100):
    reads = rng.choice(list(b"ACGT"), (n, L)).astype(np.uint8)
    reads[0, 7] = ord("N")
    quals = rng.integers(2, 41, (n, L)).astype(np.uint8)
    read_len = np.full(n, L, np.int32)
    read_len[1] = 80
    reads[1, 80:] = 0xFF
    targets, ranges = [], []
    for _ in range(t):
        T = int(rng.integers(300, 600))
        tg = rng.choice(list(b"ACGT"), T).astype(np.uint8)
        tg[T // 3] = ord("N")
        # plant read 2 across the junction so the best position is real
        beg = int(rng.integers(120, T - 150))
        targets.append(tg)
        ranges.append((beg, beg + int(rng.integers(0, 5))))
    targets[0][ranges[0][0] - 50:ranges[0][0] + 50] = reads[2]
    return reads, quals, read_len, targets, ranges


@pytest.mark.parametrize("snp", [0.0, 1e-3])
def test_k3_reference_equals_the_ports_plain_form_bit_for_bit(snp):
    from manta_tpu_torch.align import device_splitscore as ds
    rng = np.random.default_rng(5)
    reads, quals, read_len, targets, ranges = _scan_inputs(rng)
    n, L = reads.shape
    Tp = 1024
    tg = np.full((len(targets), Tp), ord("N"), np.uint8)
    for k, t in enumerate(targets):
        tg[k, :len(t)] = t
    m, x = ds.make_luts(snp)
    best, pos = ds.batched_split_score_factored(
        torch.from_numpy(reads), torch.from_numpy(quals),
        torch.from_numpy(read_len), torch.from_numpy(tg),
        torch.tensor([r[0] for r in ranges], dtype=torch.int32),
        torch.tensor([r[1] for r in ranges], dtype=torch.int32),
        torch.tensor([len(t) for t in targets], dtype=torch.int32), 50,
        torch.from_numpy(m), torch.from_numpy(x), Tp)
    rb, rp = reference.split_scan(reads, quals, read_len, targets, ranges,
                                  50, snp)
    np.testing.assert_array_equal(rb.view(np.int32),
                                  best.numpy().view(np.int32))
    np.testing.assert_array_equal(rp, pos.numpy())


def test_luts_match_the_ports():
    from manta_tpu_torch.scoring.evidence import QscoreSnp
    from svbench.capture import snp_prior
    for snp in (0.0, 1e-3):
        q = QscoreSnp(snp)
        assert snp_prior(q) == pytest.approx(snp, abs=1e-15)
        m, x = q.lut256()
        rm, rx = reference.split_luts(snp_prior(q))
        np.testing.assert_array_equal(m[2:71], rm[2:71])
        np.testing.assert_array_equal(x[2:71], rx[2:71])
