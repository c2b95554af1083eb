// What the two jump Smith-Waterman-Gotoh kernels for Hopper (sm_90a)
// share: the scores, the sentinels BAD and NEG, and the device pointers
// of a batch. The walk itself is jump_systolic.cuh's, for the exact
// chain (jump_score.cu) and the bounded one (jump_score_bounded.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBad = -10000;
constexpr int kNeg = -(1 << 28);
constexpr unsigned kFull = 0xffffffffu;

struct Scores {
    int match, mismatch, open, extend, off_edge, jump;
};

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// The device pointers of one batch: query (B, nq), ref1 (B, nr1), ref2
// (B, nr2), lengths and out (B,), contiguous int32.
struct Batch {
    const int *query, *qlen, *ref1, *r1len, *ref2, *r2len;
    int* out;
    int B, nq, nr1, nr2;
};

inline Batch make_batch(const void* query, const void* qlen,
                        const void* ref1, const void* r1len,
                        const void* ref2, const void* r2len, void* out,
                        int B, int nq, int nr1, int nr2) {
    return Batch{static_cast<const int*>(query),
                 static_cast<const int*>(qlen),
                 static_cast<const int*>(ref1),
                 static_cast<const int*>(r1len),
                 static_cast<const int*>(ref2),
                 static_cast<const int*>(r2len),
                 static_cast<int*>(out), B, nq, nr1, nr2};
}

}  // namespace
