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
// What bounds it on the H100: the dependent chain. A row is a walk of
// r1len + r2len columns, and a column's cells need the column before
// (lane q-1 for M, lane q for D) and, through the insert chain, every
// lower lane of the same column. The bytes are a one-time load of
// B*(nq + nr1 + nr2) int32 codes and the arithmetic some 20 int32
// operations a cell, both a hundredth of the time or less: the time is
// the number of columns times the latency of one step of the walk.
//
// What the design does about it (jump_systolic.cuh): it takes every
// block-wide exchange out of the step and shortens the step itself. A
// warp owns 32*L query lanes, L per thread in registers, and its
// threads run one column apart, so the two values a thread needs from
// below arrive by one warp shuffle each, made a step earlier; a step
// costs what L cells take on one scheduler's pipe and nothing else,
// and a cell is a dozen arithmetic instructions, most of them Hopper's
// DPX ones (max of three, add-then-max). A row is cut into W such
// warps, free to sit on W different schedulers and SMs, each handing
// its last lane's two values to the next through device memory, one
// 64-bit word a column that says itself whether it has arrived (no
// flag, no fence),
// read in chunks of 16 columns; the launch takes the fewest lanes per
// thread for which the batch's warps still have a scheduler each. No
// warp ever waits at a block barrier. The price is the pipeline's
// fill: a step per thread of the row in each phase, and about a chunk
// for every further strip.
//
// The kernel this replaces (one block per row, one query lane per
// thread, two __syncthreads per column; jump_dp.cuh) stays as the body of
// the bounded-chain kernel, jump_score_bounded.cu.

#include "jump_systolic.cuh"

extern "C" {

// Widest padded query the kernel takes.
int mt_cuda_jump_score_max_nq(void) { return kMaxNq; }

// Lanes per thread a batch of B rows of that query width takes when the
// caller names none.
int mt_cuda_jump_score_auto_lanes(int B, int nq) { return auto_lanes(B, nq); }

// Warps (strips) a row of that width takes at `lanes` lanes per thread.
int mt_cuda_jump_score_strips(int nq, int lanes) {
    return lanes > 0 ? strips_for(nq, lanes) : -1;
}

// Bytes of scratch a launch of these shapes needs (0: none).
long long mt_cuda_jump_score_scratch_bytes(int B, int nq, int nr1, int nr2,
                                           int lanes) {
    return (long long)systolic_scratch_bytes(
        B, nq, nr1, nr2, lanes == 0 ? auto_lanes(B, nq) : lanes);
}

// All pointers are device pointers to contiguous int32 arrays: query
// (B, nq), ref1 (B, nr1), ref2 (B, nr2), lengths and out (B,). scratch:
// mt_cuda_jump_score_scratch_bytes bytes, 8-aligned, contents
// arbitrary; may be null where that is 0. lanes: 0 for the kernel's own
// choice, else lanes per thread (3, 5, 9 or 17). extend must not be
// positive. Launches on `stream` without synchronising; returns the
// launch's cudaError_t.
int mt_cuda_jump_score(const void* query, const void* qlen,
                       const void* ref1, const void* r1len,
                       const void* ref2, const void* r2len, void* out,
                       int B, int nq, int nr1, int nr2,
                       int match, int mismatch, int open, int extend,
                       int off_edge, int jump, void* scratch,
                       long long scratch_bytes, int lanes, void* stream) {
    if (B <= 0) return cudaSuccess;
    if (nq < 0 || nr1 < 0 || nr2 < 0 || scratch_bytes < 0)
        return cudaErrorInvalidValue;
    const Scores s{match, mismatch, open, extend, off_edge, jump};
    return launch_systolic_any(
        make_batch(query, qlen, ref1, r1len, ref2, r2len, out, B, nq, nr1,
                   nr2),
        static_cast<int*>(scratch), (size_t)scratch_bytes, lanes, s,
        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
