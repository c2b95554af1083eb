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
// What bounds it on the H100: as the exact kernel, the latency of the
// nr1 + nr2 dependent columns with two block barriers each. The bounded
// chain takes the block-wide scan (11 shuffles and a fold over the warp
// totals) out of a column and puts 2W + 4L shared-memory reads per
// thread in its place, so it is bound by shared-memory reads as W
// grows; the one-time load of B*(nq + nr1 + nr2) int32 codes is nothing
// beside either.
//
// Design (simple first, not yet fast): jump_dp.cuh, with the bounded
// exchange 2 (one shared-memory row of chain sources per column, a
// sliding maximum per thread). The flag is one block-wide OR at the end
// of the row.

#include "jump_dp.cuh"

namespace {

// most lanes per thread here: the query and the source row together
// must fit the 227 KB of shared memory a block can have
constexpr int kMaxBoundedLanes = 17;

// Launch the block-barrier kernel on the exact chain with the fewest
// lanes per thread that fit the query into one block.
inline cudaError_t launch_exact(const Batch& a, const Scores& s,
                                cudaStream_t st) {
    const int need = (a.nq + 1 + kMaxThreads - 1) / kMaxThreads;
    if (need <= 1) return launch<1, false>(a, nullptr, 0, s, st);
    if (need <= 2) return launch<2, false>(a, nullptr, 0, s, st);
    if (need <= 3) return launch<3, false>(a, nullptr, 0, s, st);
    if (need <= 5) return launch<5, false>(a, nullptr, 0, s, st);
    if (need <= 9) return launch<9, false>(a, nullptr, 0, s, st);
    if (need <= 17) return launch<17, false>(a, nullptr, 0, s, st);
    if (need <= kMaxLanes) return launch<kMaxLanes, false>(a, nullptr, 0, s, st);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Widest padded query the bounded kernel takes.
int mt_cuda_jump_score_flagged_max_nq(void) {
    return kMaxBoundedLanes * kMaxThreads - 1;
}

// Pointers as mt_cuda_jump_score, plus flag (B,) int32. prefix_rounds
// >= 1. Launches on `stream` without synchronising; returns the
// launch's cudaError_t.
int mt_cuda_jump_score_flagged(const void* query, const void* qlen,
                               const void* ref1, const void* r1len,
                               const void* ref2, const void* r2len,
                               void* out, void* flag,
                               int B, int nq, int nr1, int nr2,
                               int match, int mismatch, int open, int extend,
                               int off_edge, int jump, int prefix_rounds,
                               void* stream) {
    if (B <= 0) return cudaSuccess;
    if (nq < 0 || nr1 < 0 || nr2 < 0 || prefix_rounds < 1)
        return cudaErrorInvalidValue;
    const Scores s{match, mismatch, open, extend, off_edge, jump};
    const Batch a = make_batch(query, qlen, ref1, r1len, ref2, r2len, out,
                               B, nq, nr1, nr2);
    auto* fl = static_cast<int*>(flag);
    auto st = static_cast<cudaStream_t>(stream);
    if (prefix_rounds >= 30 || (1 << prefix_rounds) >= nq + 1) {
        // the window covers every lane: the exact chain, no flag
        cudaError_t err = cudaMemsetAsync(fl, 0, (size_t)B * sizeof(int), st);
        if (err != cudaSuccess) return err;
        return launch_exact(a, s, st);
    }
    const int w = 1 << prefix_rounds;
    const int need = (nq + 1 + kMaxThreads - 1) / kMaxThreads;
    if (need <= 1) return launch<1, true>(a, fl, w, s, st);
    if (need <= 2) return launch<2, true>(a, fl, w, s, st);
    if (need <= 3) return launch<3, true>(a, fl, w, s, st);
    if (need <= 5) return launch<5, true>(a, fl, w, s, st);
    if (need <= 9) return launch<9, true>(a, fl, w, s, st);
    if (need <= kMaxBoundedLanes)
        return launch<kMaxBoundedLanes, true>(a, fl, w, s, st);
    return cudaErrorInvalidValue;
}

}  // extern "C"
