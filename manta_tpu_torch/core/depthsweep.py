"""Vectorized position-sweep depth for the per-edge read-gathering loops.

The reference accumulates a per-position pileup while scanning reads in
position order and checks the depth at each read's start position
*after* counting the read itself (reference:
src/c++/lib/applications/GenerateSVCandidates/SVFinder.cpp
addSVNodeData + SVCandidateAssembler.cpp getBreakendReads depth gates).
A scalar translation costs O(reads x read_len) per window; this module
computes the same per-read start-depth values with two sorted sweeps.

For reads sorted by position, the pileup value at read k's start after
increments from reads 0..k is

    #{contributing j <= k} - #{contributing j : end_j <= pos_k}

because a contributing read j <= k covers pos_k iff its end exceeds
pos_k (starts are sorted so pos_j <= pos_k), and any j > k has
end_j = pos_j + len_j > pos_k whenever len_j > 0 (zero-length reads
never contribute). Reads from previously processed files enter as a
static base coverage counted the same way.
"""

from __future__ import annotations

import numpy as np


class DepthSweep:
    """Running start-depth over one search window, across several
    sorted read files sharing one pileup (matching the sequential
    scalar accumulation order)."""

    def __init__(self):
        self._starts: list[np.ndarray] = []
        self._ends: list[np.ndarray] = []
        self._sorted_starts = np.zeros(0, np.int64)
        self._sorted_ends = np.zeros(0, np.int64)

    def start_depth(self, pos: np.ndarray, read_len: np.ndarray,
                    contrib: np.ndarray) -> np.ndarray:
        """Depth at each read's start position, including the read's own
        increment and all increments from earlier reads of this batch
        plus every read of previously swept batches.

        `pos` must be sorted ascending; `contrib` marks reads that
        increment the pileup. Returns int64 per-read depths.
        """
        pos = pos.astype(np.int64, copy=False)
        lens = read_len.astype(np.int64, copy=False)
        contrib = contrib & (lens > 0)
        ends = pos + lens
        base = np.searchsorted(self._sorted_starts, pos, side="right") \
            - np.searchsorted(self._sorted_ends, pos, side="right")
        own = np.cumsum(contrib.astype(np.int64)) \
            - np.searchsorted(np.sort(ends[contrib]), pos, side="right")
        depth = base + own
        if contrib.any():
            self._starts.append(pos[contrib])
            self._ends.append(ends[contrib])
            self._sorted_starts = np.sort(np.concatenate(self._starts))
            self._sorted_ends = np.sort(np.concatenate(self._ends))
        return depth
