"""The port's split-read scan (manta_tpu_torch.align, .scoring) vs
manta_tpu's JAX forms and the native host scan.

Inputs are made from a seed with numpy and handed to both packages as
the same arrays. Tolerances: the exact forms are bit-identical (float32
terms added in base order everywhere); the Pallas kernel sums with a
tree, so its scores get atol 2e-3 (tests/test_pallas_splitscore.py);
the matmul form gets rtol 1e-4 / atol 1e-4 against the exact form, and
its positions may differ only on near-ties under 1e-3
(tests/test_mxu_splitscore.py)."""

import numpy as np
import pytest
import torch

from manta_tpu.align.device_splitscore import (
    batched_split_score as jax_batched_split_score, make_luts as jax_make_luts,
)
from manta_tpu.align.device_splitscore_mxu import (
    junction_split_score as jax_junction_split_score,
)
from manta_tpu.align.pallas_splitscore import pallas_split_score
from manta_tpu_torch.io.bam import BamReader
from manta_tpu_torch.scoring.evidence import (
    QscoreSnp, split_read_scan_multi,
)
from manta_tpu_torch.align import cuda_splitscore
from manta_tpu_torch.align import device_splitscore as ds
from manta_tpu_torch.align.device_splitscore_mxu import junction_split_score
from manta_tpu_torch.scoring.device_scan import SCAN_STATS, DeviceScanContext

BASES = np.frombuffer(b"ACGT", np.uint8)
IUPAC = np.frombuffer(b"MRWSYKN", np.uint8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for the tests of the port's plain split scan
    (this module's, and test_torch_workflow.py's, which imports it).

    Its (B, n_scan) float32 planes are large enough for torch to split
    each operation over its intra-op threads. Under pytest-xdist every
    worker does so on the same cores, the threads oversubscribe them and
    spin, and a test that takes 5 s alone takes 110 s. Results do not
    depend on the thread count (elementwise operations; the base-order
    sum is a loop). Subprocesses get OMP_NUM_THREADS=1 for the same
    reason (test_torch_nojax.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _luts(snp_prob):
    m, x = ds.make_luts(snp_prob)
    jm, jx = jax_make_luts(snp_prob)
    np.testing.assert_array_equal(m, np.asarray(jm))
    np.testing.assert_array_equal(x, np.asarray(jx))
    return m, x


def _rows(rng, B, L, T, iupac=False):
    """(reads, quals, targets, bp_beg, bp_end, read_len, target_len):
    reads of varied length planted in their targets with mutations, N
    bases, optional IUPAC bytes, and some rows whose breakend range
    leaves no valid scan position."""
    reads = np.full((B, L), 0xFF, np.uint8)
    quals = np.zeros((B, L), np.uint8)
    targets = np.full((B, T), ord("N"), np.uint8)
    bp_beg = np.zeros(B, np.int32)
    bp_end = np.zeros(B, np.int32)
    rl = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(max(1, L // 2), L + 1))
        t = int(rng.integers(max(n + 20, T // 2), T + 1)) if T > n + 20 \
            else T
        tg = BASES[rng.integers(0, 4, t)].copy()
        tg[rng.integers(0, t, 3)] = ord("N")
        if iupac and b % 3 == 0:
            tg[rng.integers(0, t, 4)] = IUPAC[rng.integers(0, len(IUPAC), 4)]
        p = int(rng.integers(0, max(1, t - n)))
        rd = tg[p:p + n].copy()
        for _ in range(int(rng.integers(0, 6))):
            rd[rng.integers(0, n)] = BASES[rng.integers(0, 4)]
        if b % 4 == 1:
            rd[rng.integers(0, n)] = ord("N")
        if iupac and b % 5 == 2:
            rd[rng.integers(0, n)] = IUPAC[rng.integers(0, len(IUPAC))]
        reads[b, :n] = rd
        quals[b, :n] = rng.integers(0, 75, n)       # clamped to [2, 70]
        targets[b, :t] = tg
        rl[b] = n
        tl[b] = t
        if b % 7 == 6:
            # bp beyond what any scan can reach: scan_start > scan_end
            bp_beg[b] = t + 5
        else:
            bp_beg[b] = int(rng.integers(min(40, t - 1), max(41, t - 40)))
        bp_end[b] = bp_beg[b] + int(rng.integers(0, 6))
    return reads, quals, targets, bp_beg, bp_end, rl, tl


def _plain(arrays, flank, luts, n_scan):
    m, x = luts
    best, pos = ds.batched_split_score(*_t(*arrays), flank,
                                       *_t(m, x), n_scan=n_scan)
    return best.numpy(), pos.numpy()


# (B, L, T, n_scan, flank, snp_prob, iupac)
SHAPES = (
    (16, 100, 400, 400, 50, 0.0, False),     # test_device_splitscore.py
    (24, 150, 260, 512, 50, 1e-3, True),     # read tier 256, scan 512
    (9, 257, 700, 1024, 20, 0.0, True),      # read past the 256 tier
    (5, 40, 60, 20, 0, 1e-3, False),         # n_scan below the window
)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%d_L%d_T%d_S%d" % s[:4])
def test_plain_matches_jax_exact(shape):
    B, L, T, n_scan, flank, snp, iupac = shape
    rng = np.random.default_rng(B * 1000 + L)
    arrays = _rows(rng, B, L, T, iupac=iupac)
    luts = _luts(snp)
    best, pos = _plain(arrays, flank, luts, n_scan)
    jb, jp = jax_batched_split_score(*arrays, flank, *luts, n_scan=n_scan)
    assert best.dtype == np.float32 and pos.dtype == np.int32
    np.testing.assert_array_equal(best, np.asarray(jb))
    np.testing.assert_array_equal(pos, np.asarray(jp))
    assert np.isneginf(best).any() and np.isfinite(best).any()


@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: "B%d_L%d_T%d" % s[:3])
def test_plain_matches_pallas_interpret(shape):
    B, L, T, n_scan, flank, snp, iupac = shape
    rng = np.random.default_rng(B * 1000 + L + 1)
    arrays = _rows(rng, B, L, T, iupac=iupac)
    luts = _luts(snp)
    best, pos = _plain(arrays, flank, luts, n_scan)
    pb, pp = pallas_split_score(*arrays, flank, *luts, n_scan=n_scan,
                                interpret=True)
    np.testing.assert_array_equal(pos, np.asarray(pp))
    np.testing.assert_allclose(best, np.asarray(pb), atol=2e-3)


def test_dispatch_and_kernel_wrapper_refuse_cpu_only_in_the_wrapper():
    """On CPU tensors split_score takes the plain form; the kernel's
    wrapper raises on them (it never falls back)."""
    rng = np.random.default_rng(5)
    arrays = _rows(rng, 6, 50, 120)
    luts = _luts(0.0)
    t = _t(*arrays)
    lt = _t(*luts)
    plain_calls = ds.PLAIN_CALLS["cuda"]
    best, pos = ds.split_score(*t, 10, *lt, n_scan=128)
    want = _plain(arrays, 10, luts, 128)
    np.testing.assert_array_equal(best.numpy(), want[0])
    np.testing.assert_array_equal(pos.numpy(), want[1])
    assert ds.PLAIN_CALLS["cuda"] == plain_calls
    launches = cuda_splitscore.KERNEL_LAUNCHES["split_score"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_splitscore.split_score_cuda(*t, 10, *lt, n_scan=128)
    with pytest.raises(TypeError, match="uint8"):
        cuda_splitscore.split_score_cuda(t[0].int(), *t[1:], 10, *lt,
                                         n_scan=128)
    assert cuda_splitscore.KERNEL_LAUNCHES["split_score"] == launches


# ---- the matmul form: the 4 cases of tests/test_mxu_splitscore.py

def _junction(rng, R, L, T, with_n=False):
    target = BASES[rng.integers(0, 4, T)].copy()
    if with_n:
        target[rng.integers(0, T, 5)] = ord("N")
    reads = np.full((R, L), 0xFF, np.uint8)
    quals = np.zeros((R, L), np.uint8)
    read_len = np.zeros(R, np.int32)
    for r in range(R):
        n = int(rng.integers(L // 2, L + 1))
        pos = int(rng.integers(0, T - n))
        seq = target[pos:pos + n].copy()
        for _ in range(int(rng.integers(0, 6))):
            seq[rng.integers(0, n)] = BASES[rng.integers(0, 4)]
        if with_n and rng.integers(0, 2):
            seq[rng.integers(0, n)] = ord("N")
        reads[r, :n] = seq
        quals[r, :n] = rng.integers(5, 41, n)
        read_len[r] = n
    bp_beg = int(rng.integers(60, T - 60))
    bp_end = bp_beg + int(rng.integers(0, 8))
    return reads, quals, read_len, target, bp_beg, bp_end


def _mxu_case(seed, with_n, G=3, R=8, L=80, T=300, s0_mode="zero"):
    rng = np.random.default_rng(seed)
    reads = np.zeros((G, R, L), np.uint8)
    quals = np.zeros((G, R, L), np.uint8)
    read_len = np.zeros((G, R), np.int32)
    targets = np.zeros((G, T), np.uint8)
    bp_beg = np.zeros(G, np.int32)
    bp_end = np.zeros(G, np.int32)
    for g in range(G):
        reads[g], quals[g], read_len[g], targets[g], bp_beg[g], bp_end[g] = \
            _junction(rng, R, L, T, with_n)
    target_len = np.full(G, T, np.int32)
    luts = _luts(0.0)
    if s0_mode == "tight":
        s0 = np.maximum(0, bp_beg - L + 2).astype(np.int32)
        n_scan = int((np.maximum(0, np.minimum(bp_end, T - read_len.min()))
                      - s0).max()) + 1
    else:
        s0 = np.zeros(G, np.int32)
        n_scan = T
    args = (reads, quals, targets, s0, bp_beg, bp_end, read_len, target_len)
    best_m, pos_m = junction_split_score(*_t(*args), 50, *_t(*luts),
                                         n_scan=n_scan)
    best_m, pos_m = best_m.numpy(), pos_m.numpy()
    jb, jp = jax_junction_split_score(*args, 50, *luts, n_scan=n_scan)
    jb, jp = np.asarray(jb), np.asarray(jp)

    B = G * R
    flat = (reads.reshape(B, L), quals.reshape(B, L),
            np.repeat(targets, R, axis=0), np.repeat(bp_beg, R),
            np.repeat(bp_end, R), read_len.reshape(B),
            np.repeat(target_len, R))
    best_e, pos_e = _plain(flat, 50, luts, T)
    best_e, pos_e = best_e.reshape(G, R), pos_e.reshape(G, R)

    for other_b, other_p in ((jb, jp), (best_e, pos_e)):
        np.testing.assert_allclose(best_m, other_b, rtol=1e-4, atol=1e-4)
        mism = pos_m != other_p
        assert (np.abs(best_m - other_b)[mism] < 1e-3).all()
        assert (pos_m == other_p).mean() > 0.9


def test_mxu_matches_jax_and_exact():
    _mxu_case(seed=11, with_n=False)


def test_mxu_matches_jax_and_exact_with_n_bases():
    _mxu_case(seed=12, with_n=True)


def test_mxu_offset_grid():
    _mxu_case(seed=13, with_n=False, s0_mode="tight")


def test_mxu_no_valid_scan_position():
    # bp range beyond what any read can scan -> all -inf, pos=scan_start
    luts = _luts(0.0)
    G, R, L, T = 1, 2, 40, 60
    rng = np.random.default_rng(3)
    reads = BASES[rng.integers(0, 4, (G, R, L))].copy()
    quals = np.full((G, R, L), 30, np.uint8)
    read_len = np.full((G, R), L, np.int32)
    targets = BASES[rng.integers(0, 4, (G, T))].copy()
    bp_beg = np.array([55], np.int32)   # scan_end = min(55, 60-40)=20
    bp_end = np.array([56], np.int32)
    target_len = np.full(G, T, np.int32)
    s0 = np.array([40], np.int32)       # grid [40, 60): beyond scan_end
    args = (reads, quals, targets, s0, bp_beg, bp_end, read_len, target_len)
    best, pos = junction_split_score(*_t(*args), 50, *_t(*luts), n_scan=20)
    assert np.isneginf(best.numpy()).all()
    assert (pos.numpy() == 17).all()  # scan_start = 55 - 40 + 2
    jb, jp = jax_junction_split_score(*args, 50, *luts, n_scan=20)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp))


# ---- DeviceScanContext on the CPU vs the native host scan: the 4
# tests of tests/test_device_scan.py

@pytest.fixture(scope="module")
def batch(tumor_bam):
    return BamReader(tumor_bam).fetch("8", 107652000, 107655000)


def _targets_from(batch, idx):
    # junction targets: real read sequences spliced at a fake junction
    s = [batch.seq[batch.seq_off[i]:batch.seq_off[i + 1]]
         for i in idx[:2]]
    t1 = np.concatenate([s[0], s[1][:40]])
    t2 = np.concatenate([s[1], s[0][:60]])
    return [t1, t2], [(len(s[0]) - 3, len(s[0]) + 2),
                      (len(s[1]) - 4, len(s[1]) + 1)]


def test_device_scan_exact_matches_host(batch):
    qconv = QscoreSnp(1e-3)
    read_idx = np.arange(0, 96, dtype=np.int64)
    targets, bp_ranges = _targets_from(batch, read_idx)
    h_lnl, h_pos = split_read_scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    exact = SCAN_STATS["exact"]
    d_lnl, d_pos = DeviceScanContext(device="cpu").scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    assert SCAN_STATS["exact"] == exact + 1
    assert d_lnl.shape == h_lnl.shape == (96, 2)
    assert d_lnl.dtype == np.float32 and d_pos.dtype == np.int32
    assert np.array_equal(h_lnl, d_lnl)
    assert np.array_equal(h_pos, d_pos)


def test_device_scan_mxu_matches_host(batch):
    qconv = QscoreSnp(1e-3)
    read_idx = np.arange(0, 96, dtype=np.int64)
    targets, bp_ranges = _targets_from(batch, read_idx)
    h_lnl, h_pos = split_read_scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    mxu = SCAN_STATS["mxu"]
    d_lnl, d_pos = DeviceScanContext(mxu=True, device="cpu").scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    assert SCAN_STATS["mxu"] == mxu + 1
    assert d_lnl.shape == h_lnl.shape == (96, 2)
    assert np.allclose(h_lnl, d_lnl, atol=1e-3, rtol=1e-4)
    mism = h_pos != d_pos
    assert np.abs(h_lnl - d_lnl)[mism].max(initial=0.0) < 1e-2
    assert (h_pos == d_pos).mean() > 0.9


def test_device_scan_mxu_iupac_fallback(batch):
    """Targets with non-ACGTN IUPAC codes route to the exact scan."""
    qconv = QscoreSnp(1e-3)
    read_idx = np.arange(0, 8, dtype=np.int64)
    targets, bp_ranges = _targets_from(batch, read_idx)
    targets[0] = targets[0].copy()
    targets[0][5] = ord("M")  # amino IUPAC code
    h_lnl, h_pos = split_read_scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    ctx = DeviceScanContext(mxu=True, device="cpu")
    assert not ctx._mxu_eligible(np.zeros((1, 1), np.uint8) + 65, targets)
    fallback = SCAN_STATS["fallback"]
    d_lnl, d_pos = ctx.scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    assert SCAN_STATS["fallback"] == fallback + 1
    assert np.array_equal(h_lnl, d_lnl)
    assert np.array_equal(h_pos, d_pos)


def test_device_scan_tier_boundary(batch):
    """Batches whose padded shapes straddle a bucket tier still agree."""
    qconv = QscoreSnp(1e-3)
    read_idx = np.arange(0, 8, dtype=np.int64)
    s = [batch.seq[batch.seq_off[i]:batch.seq_off[i + 1]]
         for i in read_idx[:4]]
    long_target = np.concatenate(s * 2)   # > 256-tier scan length
    targets = [long_target]
    bp_ranges = [(100, 110)]
    h_lnl, h_pos = split_read_scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    d_lnl, d_pos = DeviceScanContext(device="cpu").scan_multi(
        50, batch, read_idx, qconv, targets, bp_ranges)
    assert np.array_equal(h_lnl, d_lnl)
    assert np.array_equal(h_pos, d_pos)


# ---- the factored layout (n reads x t targets, each stored once)

def _factored_case(rng, n, t, L, T):
    """n reads and t targets as the replicated read-major arrays of the
    JAX layout (row r * t + k: read r against target k). Reads are
    planted in a target with mutations; there are IUPAC codes on both
    sides, runs of N, a periodic target and reads cut from it (equal
    sums at several positions: ties), a one-base read, and a target
    whose breakend range leaves no scan position (n_k <= 0)."""
    tgts = np.full((t, T), ord("N"), np.uint8)
    tl = np.zeros(t, np.int32)
    beg = np.zeros(t, np.int32)
    end = np.zeros(t, np.int32)
    for k in range(t):
        m = int(rng.integers(T * 2 // 3, T + 1))
        tg = BASES[rng.integers(0, 4, m)].copy()
        if k == 1:
            tg = np.resize(np.frombuffer(b"ACGGT", np.uint8), m).copy()
        if k != 1:
            run = int(rng.integers(0, m - 12))
            tg[run:run + int(rng.integers(2, 12))] = ord("N")
        if k % 2 == 0:
            tg[rng.integers(0, m, 3)] = IUPAC[rng.integers(0, len(IUPAC), 3)]
        tgts[k, :m] = tg
        tl[k] = m
        beg[k] = m + 7 if k == t - 1 and t > 2 else int(
            rng.integers(min(40, m - 1), max(41, m - 40)))
        end[k] = beg[k] + int(rng.integers(0, 6))
    reads = np.full((n, L), 0xFF, np.uint8)
    quals = np.zeros((n, L), np.uint8)
    rl = np.zeros(n, np.int32)
    for r in range(n):
        k = r % t
        m = 1 if r == 3 else int(rng.integers(max(2, L // 2), L + 1))
        if t > 1 and k == 1:
            m = 20          # short and unmutated: fits the score range
        m = min(m, int(tl[k]) - 1)
        p = int(rng.integers(0, int(tl[k]) - m))
        rd = tgts[k, p:p + m].copy()
        if r % 3 == 0 and k != 1:
            rd[rng.integers(0, m, 2)] = BASES[rng.integers(0, 4, 2)]
        if r % 5 == 1 and k != 1:
            rd[rng.integers(0, m)] = IUPAC[rng.integers(0, len(IUPAC))]
        reads[r, :m] = rd
        # one quality on the periodic target's reads: exact ties
        quals[r, :m] = 30 if k == 1 else rng.integers(0, 75, m)
        rl[r] = m
    rep = lambda a: np.repeat(a, t, axis=0)
    til = lambda a: np.concatenate([a] * n)
    return (rep(reads), rep(quals), til(tgts), til(beg), til(end), rep(rl),
            til(tl))


FACTORED = ((12, 2, 100, 400, 400, 50, 1e-3), (7, 3, 150, 300, 512, 50, 0.0),
            (5, 1, 60, 260, 256, 20, 1e-3), (9, 4, 257, 600, 1024, 0, 0.0))


@pytest.mark.parametrize("shape", FACTORED,
                         ids=lambda s: "n%d_t%d_L%d_T%d" % s[:4])
def test_factored_matches_replicated_jax_and_pallas(shape):
    """The factored plain form == the replicated plain form == JAX's
    exact form, float32 bit for bit and positions equal; Pallas in
    interpret mode sums with a tree: positions equal, scores atol 2e-3
    (tests/test_pallas_splitscore.py)."""
    n, t, L, T, n_scan, flank, snp = shape
    arrays = _factored_case(np.random.default_rng(n * 100 + t), n, t, L, T)
    luts = _luts(snp)
    f = ds.factored_from_replicated(*arrays, t, "cpu")
    assert f[0].shape == (n, L) and f[3].shape == (t, T)
    fb, fp = ds.batched_split_score_factored(*f, flank, *_t(*luts),
                                             n_scan=n_scan)
    assert fb.shape == (n, t) and fb.dtype == torch.float32
    assert fp.dtype == torch.int32
    fb, fp = fb.numpy().ravel(), fp.numpy().ravel()
    rb, rp = _plain(arrays, flank, luts, n_scan)
    np.testing.assert_array_equal(fb, rb)
    np.testing.assert_array_equal(fp, rp)
    jb, jp = jax_batched_split_score(*arrays, flank, *luts, n_scan=n_scan)
    np.testing.assert_array_equal(fb, np.asarray(jb))
    np.testing.assert_array_equal(fp, np.asarray(jp))
    pb, pp = pallas_split_score(*arrays, flank, *luts, n_scan=n_scan,
                                interpret=True)
    finite = np.isfinite(fb)
    np.testing.assert_array_equal(finite, np.isfinite(np.asarray(pb)))
    np.testing.assert_allclose(fb[finite], np.asarray(pb)[finite], atol=2e-3)
    # Pallas' tree sum can break an exact tie the other way
    differ = (fp != np.asarray(pp)) & finite
    assert np.abs(fb[differ] - np.asarray(pb)[differ]).max(initial=0) < 2e-3
    if t > 2:
        assert np.isneginf(fb.reshape(n, t)[:, -1]).all()
    if t > 1:
        # the periodic target really ties: a read cut from it reaches its
        # best sum again one period on, and the first position is kept
        tied = 0
        for row in range(t + 1, n * t, t * t):      # read k = 1, target 1
            sums = _position_sums(*(a[row] for a in arrays), flank, luts)
            at_best = np.flatnonzero(sums == sums.max())
            tied += len(at_best) > 1
            scan_start = max(0, int(arrays[3][row] - arrays[5][row]) + 2)
            assert fb[row] == sums.max()
            assert fp[row] == scan_start + at_best[0]
        assert tied


def _position_sums(read, qual, target, beg, end, rl, tl, flank, luts):
    """Every valid scan position's float32 sum of one row, terms added
    in base order: a brute-force form of the scan's definition."""
    lnm, lnx = luts
    ln_random = np.float32(-np.log(4.0))
    scan_start = max(0, int(beg) - int(rl) + 2)
    scan_end = max(0, min(int(end), int(tl) - int(rl)))
    sums = []
    for p0 in range(scan_start, scan_end + 1):
        acc = np.float32(0.0)
        for j in range(int(rl)):
            p = p0 + j
            if not (beg - flank < p <= end + flank):
                continue
            q, tb = read[j], target[min(p, len(target) - 1)]
            qi = min(max(int(qual[j]), 2), 70)
            if q == ord("N") or tb == ord("N"):
                term = ln_random
            else:
                term = lnx[qi] if q != tb else lnm[qi]
            acc = np.float32(acc + np.float32(term))
        sums.append(acc)
    return np.array(sums, np.float32)


def test_factored_dispatch_fills_out_on_cpu():
    arrays = _factored_case(np.random.default_rng(2), 6, 2, 80, 300)
    luts = _t(*_luts(1e-3))
    f = ds.factored_from_replicated(*arrays, 2, "cpu")
    want = ds.batched_split_score_factored(*f, 50, *luts, n_scan=300)
    out = torch.empty((2, 6, 2), dtype=torch.int32)
    plain_calls = ds.PLAIN_CALLS["cuda"]
    best, pos = ds.split_score_factored(*f, 50, *luts, n_scan=300, out=out)
    assert torch.equal(best, want[0]) and torch.equal(pos, want[1])
    assert torch.equal(out[0].view(torch.float32), want[0])
    assert torch.equal(out[1], want[1])
    assert ds.PLAIN_CALLS["cuda"] == plain_calls
    launches = cuda_splitscore.KERNEL_LAUNCHES["split_score"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_splitscore.split_score_factored_cuda(*f, 50, *luts, n_scan=300)
    assert cuda_splitscore.KERNEL_LAUNCHES["split_score"] == launches


def test_factored_from_replicated_refuses_other_rows():
    arrays = list(_factored_case(np.random.default_rng(4), 4, 2, 40, 120))
    with pytest.raises(ValueError, match="not n reads"):
        ds.factored_from_replicated(*arrays, 3, "cpu")
    bad = [a.copy() for a in arrays]
    bad[0][1, 0] ^= 1                       # second row of read 0
    with pytest.raises(ValueError, match="one read differ"):
        ds.factored_from_replicated(*bad, 2, "cpu")
    bad = [a.copy() for a in arrays]
    bad[3][2] += 1                          # bp_beg of target 0, read 1
    with pytest.raises(ValueError, match="do not repeat"):
        ds.factored_from_replicated(*bad, 2, "cpu")


def _stage_reads_loop(batch, read_idx):
    """The per-read staging loop the vectorised stage_reads replaced."""
    from manta_tpu_torch.scoring.device_scan import _bucket
    n = len(read_idx)
    read_lens = (batch.seq_off[read_idx + 1]
                 - batch.seq_off[read_idx]).astype(np.int32)
    Lp = _bucket(int(read_lens.max()))
    reads = np.full((n, Lp), 0xFF, np.uint8)
    quals = np.zeros((n, Lp), np.uint8)
    for r in range(n):
        i = int(read_idx[r])
        s0, s1 = int(batch.seq_off[i]), int(batch.seq_off[i + 1])
        q0, q1 = int(batch.qual_off[i]), int(batch.qual_off[i + 1])
        reads[r, :s1 - s0] = batch.seq[s0:s1]
        quals[r, :q1 - q0] = batch.qual[q0:q1]
    return reads, quals, read_lens


def test_stage_reads_matches_the_loop_on_a_ragged_batch():
    from types import SimpleNamespace

    from manta_tpu_torch.scoring.device_scan import stage_reads
    rng = np.random.default_rng(9)
    lens = np.array([1, 300, 17, 101, 256, 2, 257, 64], np.int64)
    off = np.zeros(len(lens) + 1, np.int64)
    off[1:] = np.cumsum(lens)
    ragged = SimpleNamespace(
        seq=BASES[rng.integers(0, 4, off[-1])],
        qual=rng.integers(0, 60, off[-1]).astype(np.uint8),
        seq_off=off, qual_off=off.copy(), n=len(lens))
    for idx in (np.arange(8), np.array([6, 0, 3, 3, 5]), np.array([0, 5])):
        idx = idx.astype(np.int64)
        got = stage_reads(ragged, idx)
        want = _stage_reads_loop(ragged, idx)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_stage_reads_matches_the_loop_on_demo_reads(batch):
    from manta_tpu_torch.scoring.device_scan import stage_reads
    idx = np.arange(5, 200, 3, dtype=np.int64)
    for g, w in zip(stage_reads(batch, idx), _stage_reads_loop(batch, idx)):
        np.testing.assert_array_equal(g, w)


def test_exact_staging_is_one_buffer_in_the_factored_layout(batch):
    """What one scan call hands the split scan: views of one buffer,
    each read and each target once."""
    from manta_tpu_torch.scoring.device_scan import ExactStaging, stage_reads
    read_idx = np.arange(0, 40, dtype=np.int64)
    targets, bp_ranges = _targets_from(batch, read_idx)
    staged = ExactStaging(torch.device("cpu")).stage(
        batch, read_idx, targets, bp_ranges, 256)
    reads, quals, rl, tgts, beg, end, tl = staged
    want = stage_reads(batch, read_idx)
    np.testing.assert_array_equal(reads.numpy(), want[0])
    np.testing.assert_array_equal(quals.numpy(), want[1])
    np.testing.assert_array_equal(rl.numpy(), want[2])
    assert tgts.shape == (2, 256)
    assert beg.tolist() == [b for b, _e in bp_ranges]
    assert end.tolist() == [e for _b, e in bp_ranges]
    assert tl.tolist() == [len(t) for t in targets]
    for k, tg in enumerate(targets):
        np.testing.assert_array_equal(tgts[k, :len(tg)].numpy(), tg)
        assert (tgts[k, len(tg):] == ord("N")).all()
    base = reads.untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base for x in staged)
