"""Struct-of-arrays fragment-evidence bank for SV scoring.

Replaces the per-fragment object graph (reference:
GenerateSVCandidates/SVEvidence.hpp SVFragmentEvidence keyed by qname in
a std::map evidence track) with columnar numpy arrays so the scoring
hot loops — split-score bookkeeping, support summaries, pair/split
conflict resolution, and the genotype-likelihood accumulations — run as
single vectorized/native passes over all fragments of an edge instead
of millions of Python attribute accesses.

Axis conventions (fixed across the native consumers in
native/manta_core.cpp mt_frag_*):
    allele: 0 = alt, 1 = ref
    bp:     0 = bp1, 1 = bp2
    read:   0 = read1, 1 = read2
"""

from __future__ import annotations

import numpy as np

AL_ALT, AL_REF = 0, 1

_INIT_CAP = 64


class FragmentBank:
    """One evidence track: fragments keyed by qname, fields columnar."""

    __slots__ = (
        "rows", "qnames", "n", "_cap",
        "r_scanned", "r_shadow", "r_mapq", "r_size", "r_anch", "r_t2anch",
        "pair_sup", "pair_prob",
        "sp_eval", "sp_sup", "sp_t2", "sp_ev", "sp_lnl",
        "_order", "_order_n",
    )

    def __init__(self):
        self.rows: dict[bytes, int] = {}
        self.qnames: list[bytes] = []
        self.n = 0
        self._cap = 0
        self._order = None
        self._order_n = -1
        self._alloc(_INIT_CAP)

    def _alloc(self, cap: int):
        def grow(old, shape, dtype):
            arr = np.zeros(shape, dtype)
            if old is not None and self.n:
                arr[:self.n] = old[:self.n]
            return arr

        old = self if self._cap else None

        def prev(name):
            return getattr(old, name) if old is not None else None

        self.r_scanned = grow(prev("r_scanned"), (cap, 2), bool)
        self.r_shadow = grow(prev("r_shadow"), (cap, 2), bool)
        self.r_mapq = grow(prev("r_mapq"), (cap, 2), np.int32)
        self.r_size = grow(prev("r_size"), (cap, 2), np.int32)
        self.r_anch = grow(prev("r_anch"), (cap, 2), bool)
        self.r_t2anch = grow(prev("r_t2anch"), (cap, 2), bool)
        self.pair_sup = grow(prev("pair_sup"), (cap, 2, 2), bool)
        self.pair_prob = grow(prev("pair_prob"), (cap, 2, 2), np.float64)
        self.sp_eval = grow(prev("sp_eval"), (cap, 2, 2, 2), bool)
        self.sp_sup = grow(prev("sp_sup"), (cap, 2, 2, 2), bool)
        self.sp_t2 = grow(prev("sp_t2"), (cap, 2, 2, 2), bool)
        self.sp_ev = grow(prev("sp_ev"), (cap, 2, 2, 2), np.float64)
        self.sp_lnl = grow(prev("sp_lnl"), (cap, 2, 2, 2), np.float64)
        self._cap = cap

    def __len__(self):
        return self.n

    def row(self, qname: bytes) -> int:
        """Get-or-create the fragment row for a qname."""
        r = self.rows.get(qname)
        if r is not None:
            return r
        r = self.n
        if r >= self._cap:
            self._alloc(self._cap * 2)
        self.rows[qname] = r
        self.qnames.append(qname)
        self.n = r + 1
        return r

    def rows_for(self, qnames: list[bytes]) -> np.ndarray:
        """Vectorized-ish get-or-create for a list of qnames."""
        out = np.empty(len(qnames), np.int64)
        row = self.row
        for i, q in enumerate(qnames):
            out[i] = row(q)
        return out

    def qname_order(self) -> np.ndarray:
        """Rows sorted by qname (the reference's std::map iteration
        order; the likelihood sums are float-order-sensitive)."""
        if self._order_n != self.n:
            order = sorted(range(self.n), key=self.qnames.__getitem__)
            self._order = np.array(order, np.int64)
            self._order_n = self.n
        return self._order

    # ------------------------------------------------------------------
    # scalar accessors for the low-frequency writers

    def set_read_evidence(self, r: int, rd: int, min_mapq: int,
                          min_tier2: int, mapq: int, size: int,
                          is_shadow: bool):
        """(reference: SVScorerShared.cpp setReadEvidence; first write
        wins per read)."""
        if self.r_scanned[r, rd]:
            return
        self.r_scanned[r, rd] = True
        self.r_mapq[r, rd] = mapq
        self.r_shadow[r, rd] = is_shadow
        self.r_anch[r, rd] = mapq >= min_mapq
        self.r_t2anch[r, rd] = mapq >= min_tier2
        self.r_size[r, rd] = size

    def set_pair_support(self, r: int, allele: int, bp: int, prob: float):
        self.pair_sup[r, allele, bp] = True
        self.pair_prob[r, allele, bp] = prob

    # ------------------------------------------------------------------
    # native views (contiguous prefixes as flat arrays)

    def _u8(self, arr) -> np.ndarray:
        return arr[:self.n].view(np.uint8)

    def native_args(self):
        from .._native import get_lib, u8p
        import ctypes
        f64p = ctypes.POINTER(ctypes.c_double)

        def u8(a):
            return a[:self.n].view(np.uint8).ctypes.data_as(u8p)

        def f64(a):
            return a[:self.n].ctypes.data_as(f64p)

        return u8, f64


def accumulate_lhood(bank: FragmentBank, spanning_weight: float,
                     semi_mapped_power: float, ref_chim_prob: float,
                     alt_chim_prob: float, ref_map_prob: float,
                     alt_map_prob: float, is_permissive: bool,
                     alt_fractions, loglhood: list):
    """Native getRefAltFromFrag + genotype mixing over the whole bank in
    qname order; accumulates into loglhood in place (reference:
    SVScorer.cpp addDiploidLoglhood:767 /
    computeSomaticSampleLoghood:1143)."""
    if bank.n == 0:
        return
    import ctypes
    from .._native import get_lib, i64p
    lib = get_lib()
    f64p = ctypes.POINTER(ctypes.c_double)
    u8, f64 = bank.native_args()
    order = bank.qname_order()
    fr = np.ascontiguousarray(alt_fractions, np.float64)
    acc = np.asarray(loglhood, np.float64)
    rc = lib.mt_frag_lhood(
        bank.n, order.ctypes.data_as(i64p),
        u8(bank.r_scanned), u8(bank.r_anch), u8(bank.r_t2anch),
        u8(bank.pair_sup), f64(bank.pair_prob),
        u8(bank.sp_eval), u8(bank.sp_sup), u8(bank.sp_t2), f64(bank.sp_lnl),
        spanning_weight, semi_mapped_power,
        ref_chim_prob, alt_chim_prob, ref_map_prob, alt_map_prob,
        1 if is_permissive else 0,
        len(fr), fr.ctypes.data_as(f64p), acc.ctypes.data_as(f64p))
    assert rc == 0, f"mt_frag_lhood failed: {rc}"
    loglhood[:] = acc.tolist()


def support_counts(bank: FragmentBank) -> np.ndarray:
    """Per-sample support summaries over the bank; returns the (2, 6)
    int64 counter block documented at mt_frag_support (reference:
    SVScorer.cpp addConservativeSplitReadSupport / addSpanningPair*)."""
    out = np.zeros((2, 6), np.int64)
    if bank.n == 0:
        return out
    from .._native import get_lib, i64p
    lib = get_lib()
    u8, f64 = bank.native_args()
    rc = lib.mt_frag_support(
        bank.n, u8(bank.r_scanned), u8(bank.r_anch),
        u8(bank.pair_sup), f64(bank.pair_prob),
        u8(bank.sp_sup), f64(bank.sp_lnl),
        out.ctypes.data_as(i64p))
    if rc == -1:
        raise RuntimeError("Spanning likelihood is zero for all alleles")
    assert rc == 0, f"mt_frag_support failed: {rc}"
    return out


def resolve_pair_split_conflicts(bank: FragmentBank,
                                 find_alt_pair_conflict: bool):
    """(reference: SVScorer.cpp resolvePairSplitConflicts:476)."""
    if bank.n == 0:
        return
    from .._native import get_lib
    lib = get_lib()
    u8, f64 = bank.native_args()
    rc = lib.mt_frag_pair_split_conflicts(
        bank.n, u8(bank.pair_sup), f64(bank.pair_prob),
        u8(bank.sp_sup), f64(bank.sp_lnl),
        1 if find_alt_pair_conflict else 0)
    assert rc == 0, f"mt_frag_pair_split_conflicts failed: {rc}"
