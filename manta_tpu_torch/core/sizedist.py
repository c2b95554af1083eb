"""Fragment-size distribution with cdf/quantile/smoothed-pdf.

Behavioral parity with the reference SizeDistribution
(reference: src/c++/lib/blt_util/SizeDistribution.{hpp,cpp}): a sparse
integer histogram with a 1000-point quantile cache, cdf defined over
ascending sizes, a 5-nearest-bin smoothed pdf, and high-quantile outlier
filtering. Float math is done in float32 to reproduce the reference's
single-precision cdf values exactly.
"""

from __future__ import annotations

import numpy as np

_QUANTILE_NUM = 1000


class SizeDistribution:
    def __init__(self):
        self._counts: dict[int, int] = {}
        self._total = 0
        self._stale = True
        self._sizes: np.ndarray | None = None      # ascending
        self._cprob: np.ndarray | None = None      # float32 P(X <= size)
        self._quantiles: np.ndarray | None = None

    def add_observation(self, size: int, count: int = 1) -> None:
        self._counts[size] = self._counts.get(size, 0) + count
        self._total += count
        self._stale = True

    def add_observations(self, sizes: np.ndarray) -> None:
        vals, cnts = np.unique(np.asarray(sizes, dtype=np.int64), return_counts=True)
        for v, c in zip(vals.tolist(), cnts.tolist()):
            self.add_observation(v, c)

    @property
    def total_observations(self) -> int:
        return self._total

    def _calc(self) -> None:
        if not self._stale:
            return
        self._stale = False
        self._quantiles = np.zeros(_QUANTILE_NUM, dtype=np.int64)
        if not self._counts:
            self._sizes = np.zeros(0, np.int64)
            self._cprob = np.zeros(0, np.float32)
            return
        sizes = np.array(sorted(self._counts), dtype=np.int64)
        counts = np.array([self._counts[s] for s in sizes], dtype=np.int64)
        cum = np.cumsum(counts)
        pfactor = np.float32(1) / np.float32(self._total)
        cprob = (cum.astype(np.float32) * pfactor).astype(np.float32)
        self._sizes = sizes
        self._counts_arr = counts
        self._cprob = cprob
        # quantile cache: for each size (ascending), fill slots up to
        # rint(cprob * N) with that size
        fill_base = 0
        for s, cp in zip(sizes.tolist(), cprob.tolist()):
            fill_next = int(np.rint(np.float32(cp) * np.float32(_QUANTILE_NUM)))
            if fill_next > fill_base:
                self._quantiles[fill_base:fill_next] = s
                fill_base = fill_next

    def quantile(self, prob: float) -> int:
        assert 0.0 <= prob <= 1.0
        self._calc()
        b = int(np.ceil(prob * _QUANTILE_NUM) - 1)
        b = min(max(b, 0), _QUANTILE_NUM - 1)
        return int(self._quantiles[b])

    def cdf(self, size: int) -> float:
        """P(X <= size), float32 precision."""
        self._calc()
        if len(self._sizes) == 0:
            return 0.0
        i = np.searchsorted(self._sizes, size, side="right") - 1
        if i < 0:
            return 0.0
        return float(self._cprob[i])

    def cdf_arr(self, sizes: np.ndarray) -> np.ndarray:
        self._calc()
        if len(self._sizes) == 0:
            return np.zeros(len(sizes), np.float32)
        i = np.searchsorted(self._sizes, sizes, side="right") - 1
        out = np.where(i >= 0, self._cprob[np.clip(i, 0, None)], np.float32(0))
        return out.astype(np.float32)

    def pdf(self, size: int) -> float:
        """Smoothed pdf: sum of the 5 closest bins over their span."""
        self._calc()
        n = len(self._sizes)
        if n == 0:
            return 0.0
        sizes = self._sizes
        counts = self._counts_arr
        # low index: largest size <= query; high: next larger
        li = int(np.searchsorted(sizes, size, side="right")) - 1
        hi = li + 1
        min_size = max_size = size
        count = 0
        for _ in range(5):
            low_ok = li >= 0
            high_ok = hi < n
            if not (low_ok or high_ok):
                break
            if low_ok and (not high_ok or abs(int(sizes[li]) - size) <= abs(int(sizes[hi]) - size)):
                min_size = int(sizes[li])
                count += int(counts[li])
                li -= 1
            else:
                max_size = int(sizes[hi])
                count += int(counts[hi])
                hi += 1
        return count / (float(self._total) * float(1 + max_size - min_size))

    def filter_observations_over_quantile(self, prob: float) -> None:
        max_size = self.quantile(prob)
        for s in [s for s in self._counts if s > max_size]:
            self._total -= self._counts.pop(s)
        self._stale = True

    # -- persistence (JSON-friendly) --
    def to_dict(self) -> dict:
        return {
            "totalObservationCount": self._total,
            "histogram": sorted(self._counts.items()),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SizeDistribution":
        sd = cls()
        for s, c in d["histogram"]:
            sd._counts[int(s)] = int(c)
        sd._total = int(d["totalObservationCount"])
        sd._stale = True
        return sd

    def __eq__(self, other) -> bool:
        return isinstance(other, SizeDistribution) and self._counts == other._counts
