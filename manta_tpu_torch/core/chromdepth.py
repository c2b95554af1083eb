"""Per-chromosome median depth estimation (phase-0, WGS mode).

Behavioral port of the reference GetChromDepth application
(reference: applications/GetChromDepth/ReadChromDepthUtil.cpp): each
chromosome is divided into <=20 segments; segments are scanned in
round-robin cycles of ~40k reads each until the running median depth
converges (<0.05 change per 1M-read checkpoint) or data runs out.
Depth is tracked "as if reads align perfectly in place" through a
16x-compressed block buffer (blt_util/depth_buffer.hpp:82-114), and
the median excludes zero-depth positions
(blt_util/MedianDepthTracker.hpp).

The inner per-position flush loop is replaced by a vectorized
block-deficit computation: for flushed position p in 16-base block b,
the buffer value at flush time is
  S_p = (total base overlap of block b from reads starting <= p)
      = T_b - sum_{reads r in block b with start > p} overlap(r, b)
and the recorded observation is (S_p + 8) // 16. This reproduces the
reference's value-at-flush-time semantics exactly without a scalar
scan.

Per-BAM depths are summed across input BAMs
(reference: libexec/mergeChromDepth.py) and written as
"chrom<TAB>depth" lines consumed by the depth-filter logic
(reference: manta/ChromDepthFilterUtil.cpp:29-61).
"""

from __future__ import annotations

import numpy as np

from ..io.bam import open_alignment_reader
from ..io.bam import (
    FLAG_DUP, FLAG_QCFAIL, FLAG_SECONDARY, FLAG_SUPPLEMENTARY,
    FLAG_UNMAPPED,
)

_STATS_CHECK_COUNT = 1_000_000
_TARGET_SEGMENT_READS = 40_000
_MIN_SPAN = 10_000
_MAX_CYCLES = 10
_DEPTH_PRECISION = 0.05
_CSIZE = 16


def _median(counter: dict, total: int) -> float:
    """(reference: MedianDepthTracker::getMedian) — zero-depth excluded,
    integer doubling arithmetic preserved."""
    ztotal = total + 1 - counter.get(0, 0)
    sum2 = 0
    last_before = 0
    first_after = 0
    for val in sorted(counter):
        if val == 0:
            continue
        sum2 += counter[val] * 2
        if sum2 >= ztotal:
            first_after = val
            if (ztotal + counter[val] * 2) != (sum2 + 1):
                last_before = first_after
            break
        last_before = val
    if last_before == first_after:
        return float(last_before)
    return (last_before + first_after) / 2.0


def _chrom_segments(chrom_size: int, segment_size: int) -> list[int]:
    """(reference: getChromSegments:252-271)."""
    n_seg = 1 + (chrom_size - 1) // segment_size
    base = chrom_size // n_seg
    n_plus_one = chrom_size % n_seg
    out = []
    start = 0
    for i in range(n_seg):
        out.append(start)
        start = min(start + base + (1 if i < n_plus_one else 0), chrom_size)
    return out


def _visit_observations(starts: np.ndarray, lengths: np.ndarray):
    """Per-position flushed depth values for one region visit.

    Returns (positions base offset p0, values v[p] for p in
    [p0, plast]) where plast = last read start."""
    p0 = int(starts[0])
    plast = int(starts[-1])
    b0 = p0 // _CSIZE
    b1 = plast // _CSIZE
    nb = b1 - b0 + 1
    span = nb * _CSIZE
    base = b0 * _CSIZE

    idx_s = starts - base
    idx_e = np.minimum(starts + lengths, base + span) - base
    cov = np.zeros(span + 1, np.int64)
    np.add.at(cov, idx_s, 1)
    np.add.at(cov, idx_e, -1)
    cov = np.cumsum(cov[:-1])
    T = cov.reshape(nb, _CSIZE).sum(axis=1)

    # own-block overlap of each read, accumulated at its start position
    block_end = (starts // _CSIZE + 1) * _CSIZE
    c = np.minimum(lengths.astype(np.int64), block_end - starts)
    G = np.zeros(span, np.int64)
    np.add.at(G, idx_s, c)
    cumG = G.reshape(nb, _CSIZE).cumsum(axis=1)
    D = cumG[:, -1][:, None] - cumG
    S = T[:, None] - D
    v = (S + (_CSIZE // 2)) // _CSIZE
    return p0, plast, v.reshape(-1)[p0 - base:plast - base + 1]


class _MedianState:
    def __init__(self):
        self.counter: dict[int, int] = {}
        self.total = 0
        self.old_depth = -1.0
        self.converged = False

    def add(self, values: np.ndarray):
        if len(values) == 0:
            return
        uniq, counts = np.unique(values, return_counts=True)
        for u, ct in zip(uniq.tolist(), counts.tolist()):
            self.counter[u] = self.counter.get(u, 0) + ct
        self.total += len(values)

    def convergence_check(self):
        depth = _median(self.counter, self.total)
        if self.old_depth >= 0:
            self.converged = abs(self.old_depth - depth) < _DEPTH_PRECISION
        self.old_depth = depth

    def median(self) -> float:
        return _median(self.counter, self.total)


def _fetch_depth_cols(reader, tid: int, beg: int, end: int):
    """(pos, flag, l_seq) of reads STARTING in [beg, end); the light
    BAM column path when available (BamReader.fetch_depth_cols), the
    generic batch fetch otherwise (CRAM)."""
    f = getattr(reader, "fetch_depth_cols", None)
    if f is not None:
        return f(tid, beg, end)
    b = reader.fetch(tid, beg, end)
    keep = (b.pos >= beg) & (b.pos < end)
    lseq = (b.seq_off[1:] - b.seq_off[:-1]).astype(np.int32)
    return (b.pos[keep].astype(np.int64), b.flag[keep], lseq[keep])


_CHUNK0_SPAN = 150_000   # first-chunk span guess per segment visit


def _visit_fetch(reader, tid: int, start: int, seg_end: int,
                 span_hint: list):
    """One segment visit's reads, fetched incrementally.

    The reference streams records and stops ~40k reads into the
    segment (ReadChromDepthUtil.cpp:349-375); a monolithic fetch of
    [head, segment_end) parses the segment's whole remainder per visit,
    which made depth estimation quadratic in segment size. This
    fetches chunks sized from a running reads-per-base estimate until
    the cycling-cut condition is decidable, then truncates exactly
    where the monolithic form would have cut.

    Returns (pos, flag, lseq, new_head) with pos >= start, already cut;
    new_head == start means the segment is empty."""
    parts = []
    n_tot = 0
    c0 = start
    chunk = span_hint[0]
    while True:
        c1 = min(seg_end, c0 + chunk)
        cols = _fetch_depth_cols(reader, tid, c0, c1)
        if len(cols[0]):
            parts.append(cols)
            n_tot += len(cols[0])
            # adapt: reads/base over the spans fetched so far
            dens = n_tot / (c1 - start)
            need = _TARGET_SEGMENT_READS + 2 - n_tot
            if need > 0 and dens > 0:
                chunk = max(_MIN_SPAN, int(need / dens * 1.3))
        else:
            chunk = min(chunk * 2, 16 * _CHUNK0_SPAN)
        done = c1 >= seg_end
        if n_tot > _TARGET_SEGMENT_READS or done:
            pos = parts[0][0] if len(parts) == 1 else \
                np.concatenate([p[0] for p in parts]) if parts else \
                np.zeros(0, np.int32)
            n = len(pos)
            if n_tot > _TARGET_SEGMENT_READS:
                posl = pos.astype(np.int64)
                fresh = np.empty(n, bool)
                fresh[0] = True
                fresh[1:] = posl[1:] > posl[:-1]
                cut_mask = fresh & \
                    (np.arange(1, n + 1) > _TARGET_SEGMENT_READS) & \
                    (posl - start >= _MIN_SPAN)
                if cut_mask.any():
                    cut = int(np.argmax(cut_mask))
                    flag = np.concatenate([p[1] for p in parts])[:cut]
                    lseq = np.concatenate([p[2] for p in parts])[:cut]
                    # carry the observed density to the next visit's
                    # first-chunk sizing
                    span_hint[0] = max(_MIN_SPAN, min(
                        int((int(posl[cut]) - start) * 1.15),
                        16 * _CHUNK0_SPAN))
                    return (posl[:cut], flag, lseq, int(posl[cut]))
            if done:
                if n == 0:
                    return (np.zeros(0, np.int64),
                            np.zeros(0, np.uint16),
                            np.zeros(0, np.int32), start)
                flag = parts[0][1] if len(parts) == 1 else \
                    np.concatenate([p[1] for p in parts])
                lseq = parts[0][2] if len(parts) == 1 else \
                    np.concatenate([p[2] for p in parts])
                return (pos.astype(np.int64), flag, lseq,
                        int(pos[-1]) + 1)
        c0 = c1
    # unreachable


def read_chrom_depth(reader: BamReader, tid: int, chrom_size: int) -> float:
    """(reference: readChromDepthFromAlignment:273-410)."""
    segment_size = 2_000_000
    while True:
        seg_starts = _chrom_segments(chrom_size, segment_size)
        if len(seg_starts) <= 20:
            break
        segment_size *= 2
    n_seg = len(seg_starts)
    head = list(seg_starts)
    empty = [False] * n_seg
    span_hint = [_CHUNK0_SPAN]

    state = _MedianState()
    added_count = 0
    pending_flush: np.ndarray | None = None  # plast observation

    finished = False
    for cycle in range(_MAX_CYCLES):
        if cycle > 0 and state.converged and not finished:
            # reference: the convergence break fires per read inside the
            # next segment scan, after that scan's setNewRegion flushed
            # the pending observation
            if pending_flush is not None:
                state.add(pending_flush)
                pending_flush = None
            break
        if finished:
            break
        any_data = False
        for si in range(n_seg):
            if empty[si]:
                continue
            if finished:
                # converged mid-cycle: remaining segment scans only
                # trigger setNewRegion (flushing any pending obs) before
                # their first-read convergence break
                if pending_flush is not None:
                    state.add(pending_flush)
                    pending_flush = None
                break
            start = head[si]
            end = seg_starts[si + 1] if si + 1 < n_seg else chrom_size
            pos, flags, lseq, new_head = _visit_fetch(
                reader, tid, start, end, span_hint)
            n = len(pos)

            # region visit boundary: flush previous visit's pending obs
            if pending_flush is not None:
                state.add(pending_flush)
                pending_flush = None

            if n == 0:
                empty[si] = True
                continue
            any_data = True
            head[si] = new_head

            # core read filters (reference: depth loop filters split/
            # secondary reads entirely to avoid double counting —
            # is_read_unmapped_or_filtered_core | secondary | supp
            # reduces to a pure flag mask here because secondary and
            # supplementary are excluded regardless of SA tags)
            bad = (flags & (FLAG_QCFAIL | FLAG_DUP | FLAG_UNMAPPED
                            | FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) != 0
            lengths = lseq.astype(np.int64)
            ok = ~bad & (lengths > 0)
            starts = pos[ok]
            lengths = lengths[ok]
            m = len(starts)
            if m == 0:
                continue

            p0, plast, values = _visit_observations(starts, lengths)
            obs = values[:-1]  # [p0, plast); plast flushes at next visit
            pending_flush = values[-1:]

            # 1M-added-read convergence checkpoints within this visit
            next_check = ((added_count // _STATS_CHECK_COUNT) + 1) * \
                _STATS_CHECK_COUNT
            consumed = 0
            while added_count + m >= next_check:
                k = next_check - added_count - 1  # index of boundary read
                sk = int(starts[k])
                upto = min(max(sk - p0, 0), len(obs))
                state.add(obs[consumed:upto])
                consumed = upto
                state.convergence_check()
                if cycle > 0 and state.converged:
                    # stop at the next read; the s_k position flushes at
                    # the next setNewRegion, valued over reads [0, k]
                    added_count = next_check
                    finished = True
                    _, _, vals_k = _visit_observations(
                        starts[:k + 1], lengths[:k + 1])
                    pending_flush = vals_k[-1:]
                    break
                next_check += _STATS_CHECK_COUNT
            if finished:
                continue
            state.add(obs[consumed:])
            added_count += m
        if not any_data and not finished:
            break

    return state.median()


def estimate_chrom_depths(bam_paths: list[str],
                          reference: str | None = None,
                          n_jobs: int = 1) -> dict[str, float]:
    """Sum per-chromosome depths across BAMs
    (reference: libexec/mergeChromDepth.py). Per-(BAM, chrom) estimates
    are independent, so n_jobs > 1 fans them out over forked workers
    (reference: per-chrom-chunk GetChromDepth tasks,
    sharedWorkflow.py)."""
    jobs = []
    for path in bam_paths:
        reader = open_alignment_reader(path, reference)
        for tid, (name, size) in enumerate(zip(reader.header.ref_names,
                                               reader.header.ref_lengths)):
            jobs.append((path, tid, name, size))
    totals: dict[str, float] = {}
    if n_jobs > 1 and len(jobs) > 1:
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        queue = ctx.SimpleQueue()
        readers = {p: open_alignment_reader(p, reference)
                   for p in bam_paths}

        def worker(ji, path, tid, size):
            from ..io.bam import BamReader
            from ..io.bgzf import set_worker_io_threads
            from ..parallel import worker_trace
            worker_trace.enter_worker("phase0")
            fanout = min(n_jobs, len(jobs))
            set_worker_io_threads(fanout)
            BamReader.set_worker_cache_budget(fanout)
            with worker_trace.span("phase0.bam", bam=path,
                                   chrom=jobs[ji][2]):
                depth = read_chrom_depth(readers[path], tid, size)
            queue.put((ji, depth))

        # in-flight scheduling — see parallel.forkpool for why
        # is_alive() gating deadlocks
        from ..parallel.forkpool import drain_fork_result
        results: dict[int, float] = {}
        procs: list = []
        nxt = 0
        in_flight = 0
        while len(results) < len(jobs):
            while nxt < len(jobs) and in_flight < n_jobs:
                path, tid, _name, size = jobs[nxt]
                pr = ctx.Process(target=worker,
                                 args=(nxt, path, tid, size))
                pr.start()
                procs.append(pr)
                in_flight += 1
                nxt += 1
            ji, d = drain_fork_result(queue, procs)
            in_flight -= 1
            results[ji] = d
        for pr in procs:
            pr.join()
        for ji, (path, tid, name, size) in enumerate(jobs):
            totals[name] = totals.get(name, 0.0) + results[ji]
        return totals
    readers = {p: open_alignment_reader(p, reference) for p in bam_paths}
    for (path, tid, name, size) in jobs:
        d = read_chrom_depth(readers[path], tid, size)
        totals[name] = totals.get(name, 0.0) + d
    return totals


def write_chrom_depth(path: str, depths: dict[str, float]):
    with open(path, "w") as f:
        for name, d in depths.items():
            f.write(f"{name}\t{d:.3f}\n")


def parse_chrom_depth(path: str) -> dict[str, float]:
    """(reference: htsapi/parse_chrom_depth)."""
    out: dict[str, float] = {}
    with open(path) as f:
        for line in f:
            w = line.rstrip("\n").split("\t")
            if len(w) >= 2:
                out[w[0]] = float(w[1])
    return out
