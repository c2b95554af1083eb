// Batched two-reference jump Smith-Waterman-Gotoh score (int32, score only)
// for Hopper (sm_90a): the insert chain bounded to 2^prefix_rounds lanes,
// with a flag per row where the bound may have changed the score.
//
// Replaces the Pallas TPU kernel manta_tpu/align/pallas_jumpscore.py
// `_kernel` with `prefix_rounds=K` and `flag_ref`, reached through
// `_pallas_jump_score_impl` from `pallas_jump_score_flagged` (and, with
// the rerun of flagged rows, `pallas_jump_score_bounded`). Same contract
// as the plain form
// manta_tpu_torch/align/device_jumpscore.batched_jump_score_flagged: with
// W = 2^K and g[k] = NEG where f[k] <= BAD, else f[k] - extend*k,
//
//     ci[q]  = max(BAD, extend*(q+1) + max(g[k], q - W  < k <= q))
//     ci2[q] = max(BAD, extend*(q+1) + max(g[k], q - 2W < k <= q))
//
// ci feeds the recurrence in both phases, and a row's flag is 1 where
// ci2 > ci at any walked column and any lane q <= qlen. All int32 adds
// and maxes: bit-identical to the plain form in any order. Where W
// covers every lane the chain is the exact one: the exact kernel runs
// and the flags are 0.
//
// What bounds it on the H100: as the exact kernel (jump_score.cu), the
// latency of the nr1 + nr2 dependent columns; the bytes and the
// arithmetic are a hundredth of the time or less.
//
// What the design does about it (jump_systolic.cuh, kBounded): the
// exact kernel's systolic walk, warps that own strips of query lanes
// with their threads one column apart and no block barrier anywhere.
// Only the insert chain's exchange differs. The exact chain hands one
// running maximum up a thread; the bounded one needs the sources of the
// 2W lanes below a thread's first lane, which the threads below made for
// the same column one to several steps earlier. They stay in a ring of
// per-column rows in the warp's own shared memory (one __syncwarp a
// step); a thread takes both windows of its L lanes from the row by a
// sliding maximum of W + 2L reads each. Between a row's strips the top
// 2W sources of a column travel through device memory beside the
// boundary word, as int32 words that say themselves whether they have
// arrived, and are read a chunk of 16 columns at a time. A row's flag is
// one warp vote and one atomicOr a strip.

#include "jump_systolic.cuh"

extern "C" {

// Widest padded query the bounded kernel takes: the exact kernel's.
int mt_cuda_jump_score_flagged_max_nq(void) { return kMaxNq; }

// Most shared memory a warp's ring and stage may take: a block's.
long long mt_cuda_jump_score_flagged_max_shared_bytes(void) {
    return (long long)kMaxSharedBytes;
}

// Whether the window 1 << prefix_rounds covers every lane of a query of
// width nq, so that the exact kernel runs.
static bool covers(int nq, int prefix_rounds) {
    return prefix_rounds >= 30 || (1 << prefix_rounds) >= nq + 1;
}

// Lanes per thread a batch takes when the caller names none; 0 where
// the ring of no layout fits a block's shared memory (a window of
// thousands of lanes on a query too wide for one warp).
int mt_cuda_jump_score_flagged_auto_lanes(int B, int nq, int prefix_rounds) {
    return covers(nq, prefix_rounds) ? auto_lanes(B, nq)
                                     : auto_lanes_bounded(nq, prefix_rounds);
}

// Bytes of shared memory a warp takes at `lanes` lanes per thread.
long long mt_cuda_jump_score_flagged_shared_bytes(int nq, int prefix_rounds,
                                                  int lanes) {
    if (covers(nq, prefix_rounds)) return 0;
    return (long long)bounded_shared_bytes(nq, prefix_rounds, lanes);
}

// Bytes of scratch a launch of these shapes needs (0: none); -1 where no
// layout fits.
long long mt_cuda_jump_score_flagged_scratch_bytes(int B, int nq, int nr1,
                                                   int nr2, int prefix_rounds,
                                                   int lanes) {
    const int rounds = covers(nq, prefix_rounds) ? 0 : prefix_rounds;
    if (lanes == 0)
        lanes = rounds ? auto_lanes_bounded(nq, rounds) : auto_lanes(B, nq);
    if (lanes == 0) return -1;
    return (long long)systolic_scratch_bytes(B, nq, nr1, nr2, lanes, rounds);
}

// Pointers as mt_cuda_jump_score, plus flag (B,) int32. prefix_rounds
// >= 1. scratch: mt_cuda_jump_score_flagged_scratch_bytes bytes,
// 8-aligned. lanes: 0 for the kernel's own choice, else 3, 5, 9 or 17.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t.
int mt_cuda_jump_score_flagged(const void* query, const void* qlen,
                               const void* ref1, const void* r1len,
                               const void* ref2, const void* r2len,
                               void* out, void* flag,
                               int B, int nq, int nr1, int nr2,
                               int match, int mismatch, int open, int extend,
                               int off_edge, int jump, int prefix_rounds,
                               void* scratch, long long scratch_bytes,
                               int lanes, void* stream) {
    if (B <= 0) return cudaSuccess;
    if (nq < 0 || nr1 < 0 || nr2 < 0 || prefix_rounds < 1 ||
        scratch_bytes < 0)
        return cudaErrorInvalidValue;
    const Scores s{match, mismatch, open, extend, off_edge, jump};
    const Batch a = make_batch(query, qlen, ref1, r1len, ref2, r2len, out,
                               B, nq, nr1, nr2);
    auto* fl = static_cast<int*>(flag);
    auto* sc = static_cast<int*>(scratch);
    auto st = static_cast<cudaStream_t>(stream);
    if (covers(nq, prefix_rounds)) {
        // the window covers every lane: the exact chain, no flag
        cudaError_t err = cudaMemsetAsync(fl, 0, (size_t)B * sizeof(int), st);
        if (err != cudaSuccess) return err;
        return launch_systolic_any<false>(a, nullptr, 0, sc,
                                          (size_t)scratch_bytes, lanes, s, st);
    }
    return launch_systolic_any<true>(a, fl, prefix_rounds, sc,
                                     (size_t)scratch_bytes, lanes, s, st);
}

}  // extern "C"
