// The two-reference jump Smith-Waterman-Gotoh recurrence (int32, score
// only) for Hopper (sm_90a) as a block-barrier walk: the body of the
// bounded-insert-chain kernel (jump_score_bounded.cu), and of the exact
// chain that kernel runs where its window covers every lane. The exact
// kernel proper (jump_score.cu, jump_systolic.cuh) shares the cell's
// pieces below (scores, sentinels, insert_source) and walks otherwise.
//
// Four int32 state rows (M, D, I, J) over the query lanes q = 0..nq walk
// the ref1 columns, then the ref2 columns. One thread block per batch
// row; thread t owns the L contiguous lanes [t*L, t*L + L), so the four
// carried state rows live in registers and the one-lane shift of M is
// sequential inside a thread. Columns past a row's reference length are
// not walked: the reference freezes the state there, which is the same
// thing. The query is staged once in shared memory; the reference code
// of a column is one broadcast load. L is a template parameter chosen by
// the host so that ceil((nq+1)/L) <= 1024 threads.
//
// Per column there are two block exchanges:
//   1. the previous column's diagonal max at each thread's last lane
//      (warp shuffle, plus one shared-memory word per warp);
//   2. the in-column insert chain
//          ci[q] = extend*(q+1) + max_k(f[k] - extend*k),
//      which the template parameter kBounded selects:
//      - exact (k <= q): a block-wide inclusive max-scan of the
//        per-thread chain totals (warp shuffle scan, then the warp
//        totals in shared memory);
//      - bounded (q - W < k <= q, W = 2^prefix_rounds): every thread
//        publishes its L chain sources in one shared-memory row, and
//        after the barrier reads only the 2W - 1 lanes below its own:
//        no scan, no cross-warp fold. A second window of W lanes below
//        the first gives the detection value (the chain bounded to 2W
//        lanes); a lane where that is larger raises the row's flag.
// Thread t computes the insert sources of lanes t*L+1 .. t*L+L from its
// own new M lanes, so neither form needs an extra exchange of M.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBad = -10000;
constexpr int kNeg = -(1 << 28);
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// most lanes per thread (the last instantiation below); bounds the query
constexpr int kMaxLanes = 33;

struct Scores {
    int match, mismatch, open, extend, off_edge, jump;
};

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// g[k] at k = qs + 1: the insert-chain source that lane qs's new M (and,
// in the ref2 phase, its J) opens for lane qs + 1, less extend*k; NEG
// where the source is at or below BAD.
template <bool kRef1>
__device__ __forceinline__ int insert_source(int m, int jv, int qs,
                                             const Scores& s) {
    const int f = kRef1 ? (qs == 0 ? kBad : m + s.open)
                        : imax(m + s.open, jv);
    return f <= kBad ? kNeg : f - s.extend * (qs + 1);
}

// out[j] = max(g[k] for base + j - w < k <= base + j, k >= 0), w a power
// of two >= 2, by the block decomposition of a sliding maximum with the
// blocks anchored at the thread's own lanes: a prefix inside each chunk
// of w lanes (ascending pass) and the suffix below the chunk's pivot
// (descending pass, one new lane per step), w + 2L reads in all.
template <int L>
__device__ __forceinline__ void window_max(const int* g, int base, int w,
                                           int (&out)[L]) {
    int u = kNeg;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        if ((j & (w - 1)) == 0) {
            u = kNeg;
        } else {
            const int k = base + j;
            if (k >= 0) u = imax(u, g[k]);
        }
        out[j] = u;
    }
    int sfx = kNeg;
#pragma unroll
    for (int j = L - 1; j >= 0; --j) {
        const int q = base + j;
        if (j == L - 1 || ((j + 1) & (w - 1)) == 0) {
            // top lane of a chunk: the lanes its window shares with
            // every lower lane of the chunk
            const int pivot = base + (j & ~(w - 1));
            sfx = kNeg;
            for (int k = imax(q - w + 2, 0); k <= pivot; ++k)
                sfx = imax(sfx, g[k]);
        }
        const int k = q - w + 1;
        if (k >= 0) sfx = imax(sfx, g[k]);
        out[j] = imax(out[j], sfx);
    }
}

template <int L, bool kRef1, bool kBounded>
__device__ __forceinline__ void walk_phase(
        int (&pm)[L], int (&pd)[L], int (&pi)[L], int (&pj)[L],
        const int* __restrict__ ref, int rlen, const int* s_qsh,
        int* s_diag, int* s_tot, int* s_g, int window, int q0, int qn,
        const Scores& s, int& best, int& flag) {
    const int lane_id = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int c = 0; c < rlen; ++c) {
        const int rc = __ldg(ref + c);
        // exchange 1: diagonal max of the previous column at lane q0-1
        int dl = imax(imax(pm[L - 1], pd[L - 1]), pi[L - 1]);
        if (!kRef1) dl = imax(dl, pj[L - 1]);
        int dprev = __shfl_up_sync(kFull, dl, 1);
        if (lane_id == 31) s_diag[warp] = dl;
        __syncthreads();
        if (lane_id == 0) dprev = warp > 0 ? s_diag[warp - 1] : kBad;

        // M and D, high lane first so lane j-1 still holds the old state
#pragma unroll
        for (int j = L - 1; j >= 0; --j) {
            const int q = q0 + j;
            int d = dprev;
            if (j > 0) {
                d = imax(imax(pm[j - 1], pd[j - 1]), pi[j - 1]);
                if (!kRef1) d = imax(d, pj[j - 1]);
            }
            const int sub = s_qsh[q] == rc ? s.match : s.mismatch;
            const int vm = q == 0 ? 0 : d + sub;
            const bool d_bad = kRef1 ? q <= 1 : q == 0;
            const int vd = d_bad ? kBad
                : imax(imax(pm[j] + s.open, pd[j]), pi[j]) + s.extend;
            pm[j] = vm;
            pd[j] = vd;
        }

        // insert sources of lanes q0+1 .. q0+L from the new M of lanes
        // q0 .. q0+L-1
        int excl = kNeg;
        if constexpr (!kBounded) {
            // pi[j] holds the local inclusive max up to lane q0+j
            int run = kNeg;
#pragma unroll
            for (int j = 0; j < L; ++j) {
                pi[j] = run;
                run = imax(run, insert_source<kRef1>(pm[j], pj[j], q0 + j, s));
            }

            // exchange 2: block-wide exclusive max-scan of the thread
            // totals
            int incl = run;
#pragma unroll
            for (int k = 1; k < 32; k <<= 1) {
                const int v = __shfl_up_sync(kFull, incl, k);
                if (lane_id >= k) incl = imax(incl, v);
            }
            excl = __shfl_up_sync(kFull, incl, 1);
            if (lane_id == 0) excl = kNeg;
            if (lane_id == 31) s_tot[warp] = incl;
            __syncthreads();
            int wv = lane_id < warp ? s_tot[lane_id] : kNeg;
#pragma unroll
            for (int k = 16; k > 0; k >>= 1)
                wv = imax(wv, __shfl_xor_sync(kFull, wv, k));
            excl = imax(excl, wv);
        } else {
            // exchange 2, bounded: publish the sources, then each lane
            // takes the maximum over its own window. The row is reused
            // every column: its reads end before exchange 1's barrier
            // of the next column, its writes come after it.
#pragma unroll
            for (int j = 0; j < L; ++j)
                s_g[q0 + j + 1] =
                    insert_source<kRef1>(pm[j], pj[j], q0 + j, s);
            __syncthreads();
            window_max<L>(s_g, q0, window, pi);
        }
        int below[kBounded ? L : 1];
        if constexpr (kBounded) window_max<L>(s_g, q0 - window, window, below);

        // I, J and the query-end best
#pragma unroll
        for (int j = 0; j < L; ++j) {
            const int q = q0 + j;
            const int e1 = s.extend * (q + 1);
            const int vi = imax(imax(excl, pi[j]) + e1, kBad);
            if constexpr (kBounded) {
                // the chain bounded to twice the window: larger anywhere
                // at or below the query end means the row may differ
                // from the exact chain
                const int vi2 = imax(imax(pi[j], below[j]) + e1, kBad);
                if (vi2 > vi && q <= qn) flag = 1;
            }
            pi[j] = vi;
            if (kRef1)
                pj[j] = q == 0 ? kBad
                    : imax(imax(pm[j] + s.jump, vi + s.jump), pj[j]);
            if (q == qn) best = imax(best, pm[j]);
        }
    }
    // off-edge terms at the phase end
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const int q = q0 + j;
        if (q < qn) best = imax(best, pm[j] + (qn - q) * s.off_edge);
    }
}

// kBounded: `window` = 2^prefix_rounds lanes bound the insert chain and
// flag_out[b] is 1 where the detection window raised a lane, else 0.
// Exact: `window` and `flag_out` are not read.
template <int L, bool kBounded>
__global__ void __launch_bounds__(kMaxThreads)
jump_score_kernel(const int* __restrict__ query, const int* __restrict__ qlen,
                  const int* __restrict__ ref1, const int* __restrict__ r1len,
                  const int* __restrict__ ref2, const int* __restrict__ r2len,
                  int* __restrict__ out, int* __restrict__ flag_out,
                  int nq, int nr1, int nr2, int window, Scores s) {
    // blockDim.x * L query lanes; bounded: then the source row g[0 ..
    // blockDim.x * L]
    extern __shared__ int s_qsh[];
    __shared__ int s_diag[kMaxWarps];
    __shared__ int s_tot[kMaxWarps];
    __shared__ int s_best[kMaxWarps];
    const int b = blockIdx.x;
    const int n_lanes = blockDim.x * L;
    int* s_g = s_qsh + n_lanes;
    if (kBounded && threadIdx.x == 0) s_g[0] = kNeg;
    const int* qrow = query + (size_t)b * nq;
    // s_qsh[q] = query[q-1]; 0 at lane 0 and past the query never
    // equals a base or a pad code
    for (int i = threadIdx.x; i < n_lanes; i += blockDim.x)
        s_qsh[i] = (i >= 1 && i <= nq) ? qrow[i - 1] : 0;
    const int qn = min(qlen[b], nq);
    const int rl1 = min(r1len[b], nr1);
    const int rl2 = min(r2len[b], nr2);
    __syncthreads();

    const int q0 = threadIdx.x * L;
    int pm[L], pd[L], pi[L], pj[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
        pm[j] = (q0 + j) * s.off_edge;
        pd[j] = kBad;
        pi[j] = kBad;
        pj[j] = kBad;
    }
    int best = kNeg;
    int flag = 0;
    walk_phase<L, true, kBounded>(pm, pd, pi, pj, ref1 + (size_t)b * nr1,
                                  rl1, s_qsh, s_diag, s_tot, s_g, window,
                                  q0, qn, s, best, flag);
    // ref2 restarts M, D and I; J carries over
#pragma unroll
    for (int j = 0; j < L; ++j) {
        pm[j] = (q0 + j) * s.off_edge;
        pd[j] = kBad;
        pi[j] = kBad;
    }
    walk_phase<L, false, kBounded>(pm, pd, pi, pj, ref2 + (size_t)b * nr2,
                                   rl2, s_qsh, s_diag, s_tot, s_g, window,
                                   q0, qn, s, best, flag);

    const int lane_id = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
        best = imax(best, __shfl_xor_sync(kFull, best, k));
    if (lane_id == 0) s_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
        int v = lane_id < (int)(blockDim.x >> 5) ? s_best[lane_id] : kNeg;
#pragma unroll
        for (int k = 16; k > 0; k >>= 1)
            v = imax(v, __shfl_xor_sync(kFull, v, k));
        if (lane_id == 0) out[b] = v;
    }
    if constexpr (kBounded) {
        const int any = __syncthreads_or(flag);
        if (threadIdx.x == 0) flag_out[b] = any ? 1 : 0;
    }
}

// The device pointers of one batch: query (B, nq), ref1 (B, nr1), ref2
// (B, nr2), lengths and out (B,), contiguous int32.
struct Batch {
    const int *query, *qlen, *ref1, *r1len, *ref2, *r2len;
    int* out;
    int B, nq, nr1, nr2;
};

template <int L, bool kBounded>
cudaError_t launch(const Batch& a, int* flag_out, int window,
                   const Scores& s, cudaStream_t stream) {
    const int per = (a.nq + 1 + L - 1) / L;
    const int threads = (per + 31) / 32 * 32;
    const size_t lanes = (size_t)threads * L;
    const size_t smem = (kBounded ? 2 * lanes + 1 : lanes) * sizeof(int);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            jump_score_kernel<L, kBounded>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    jump_score_kernel<L, kBounded><<<a.B, threads, smem, stream>>>(
        a.query, a.qlen, a.ref1, a.r1len, a.ref2, a.r2len, a.out, flag_out,
        a.nq, a.nr1, a.nr2, window, s);
    return cudaGetLastError();
}

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
