// Batched two-reference jump Smith-Waterman-Gotoh score (int32, score only)
// for Hopper (sm_90a): the exact insert chain.
//
// Replaces the Pallas TPU kernel manta_tpu/align/pallas_jumpscore.py
// `_kernel`, reached through `_pallas_jump_score_impl` (prefix_rounds=0)
// from `pallas_jump_score`. Same contract as the plain form
// manta_tpu_torch/align/device_jumpscore.batched_jump_score; the in-column
// insert chain is the max-plus prefix
//
//     ci[q] = extend*(q+1) + cummax_{k<=q}(f[k] - extend*k)
//
// and each row's result is the best M at the q == qlen lane plus the
// off-edge terms of both phases. Every operation is an int32 add or max,
// so the result is bit-identical to the plain form and to the native
// score batch (mt_align_jump_score_batch) in any association order.
//
// What bounds it on the H100: per row the work is a sequential walk of
// nr1 + nr2 columns, and inside a column the M update needs lane q-1 of
// the previous column (a one-lane shift) and the insert chain needs a
// prefix over all lower lanes. The bytes are a one-time load of
// B*(nq + nr1 + nr2) int32 codes, so the kernel is bound by the latency
// of the per-column dependency chain and its barriers, not by memory or
// arithmetic throughput.
//
// Design (simple first, not yet fast): jump_dp.cuh, with the exact
// exchange 2 (a block-wide max-scan of the chain totals).

#include "jump_dp.cuh"

extern "C" {

// Widest padded query the kernel takes.
int mt_cuda_jump_score_max_nq(void) {
    return kMaxLanes * kMaxThreads - 1;
}

// All pointers are device pointers to contiguous int32 arrays: query
// (B, nq), ref1 (B, nr1), ref2 (B, nr2), lengths and out (B,). Launches
// on `stream` without synchronising; returns the launch's cudaError_t.
int mt_cuda_jump_score(const void* query, const void* qlen,
                       const void* ref1, const void* r1len,
                       const void* ref2, const void* r2len, void* out,
                       int B, int nq, int nr1, int nr2,
                       int match, int mismatch, int open, int extend,
                       int off_edge, int jump, void* stream) {
    if (B <= 0) return cudaSuccess;
    if (nq < 0 || nr1 < 0 || nr2 < 0) return cudaErrorInvalidValue;
    const Scores s{match, mismatch, open, extend, off_edge, jump};
    return launch_exact(make_batch(query, qlen, ref1, r1len, ref2, r2len,
                                   out, B, nq, nr1, nr2),
                        s, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
