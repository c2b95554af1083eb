// Batched two-reference jump Smith-Waterman-Gotoh score (int32, score only)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel manta_tpu/align/pallas_jumpscore.py
// `_kernel`, reached through `_pallas_jump_score_impl` (prefix_rounds=0)
// from `pallas_jump_score`. Same contract as the plain form
// manta_tpu_torch/align/device_jumpscore.batched_jump_score: four int32
// state rows (M, D, I, J) over the query lanes q = 0..nq walk the ref1
// columns, then the ref2 columns; the in-column insert chain is the
// max-plus prefix
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
// Design (simple first, not yet fast): one thread block per batch row.
// Thread t owns the L contiguous lanes [t*L, t*L + L), so the four
// carried state rows live in registers and the shift and the prefix are
// sequential inside a thread. Per column there are two block exchanges:
//   1. the previous column's diagonal max at each thread's last lane
//      (warp shuffle, plus one shared-memory word per warp);
//   2. a block-wide inclusive max-scan of the per-thread insert-chain
//      totals (warp shuffle scan, then the warp totals in shared memory).
// Thread t scans the insert sources of lanes t*L+1 .. t*L+L, which it
// computes from its own new M lanes, so the prefix needs no extra
// exchange of M. Columns past a row's reference length are not walked:
// the reference freezes the state there, which is the same thing.
// The query is staged once in shared memory; the reference code of a
// column is one broadcast load. L is a template parameter chosen by the
// host so that ceil((nq+1)/L) <= 1024 threads.

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

template <int L, bool kRef1>
__device__ __forceinline__ void walk_phase(
        int (&pm)[L], int (&pd)[L], int (&pi)[L], int (&pj)[L],
        const int* __restrict__ ref, int rlen, const int* s_qsh,
        int* s_diag, int* s_tot, int q0, int qn, const Scores& s,
        int& best) {
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
        // q0 .. q0+L-1; pi[j] holds the local inclusive max up to lane q0+j
        int run = kNeg;
#pragma unroll
        for (int j = 0; j < L; ++j) {
            const int qs = q0 + j;
            pi[j] = run;
            const int f = kRef1 ? (qs == 0 ? kBad : pm[j] + s.open)
                                : imax(pm[j] + s.open, pj[j]);
            const int g = f <= kBad ? kNeg : f - s.extend * (qs + 1);
            run = imax(run, g);
        }

        // exchange 2: block-wide exclusive max-scan of the thread totals
        int incl = run;
#pragma unroll
        for (int k = 1; k < 32; k <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, k);
            if (lane_id >= k) incl = imax(incl, v);
        }
        int excl = __shfl_up_sync(kFull, incl, 1);
        if (lane_id == 0) excl = kNeg;
        if (lane_id == 31) s_tot[warp] = incl;
        __syncthreads();
        int wv = lane_id < warp ? s_tot[lane_id] : kNeg;
#pragma unroll
        for (int k = 16; k > 0; k >>= 1)
            wv = imax(wv, __shfl_xor_sync(kFull, wv, k));
        excl = imax(excl, wv);

        // I, J and the query-end best
#pragma unroll
        for (int j = 0; j < L; ++j) {
            const int q = q0 + j;
            const int vi = imax(imax(excl, pi[j]) + s.extend * (q + 1), kBad);
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

template <int L>
__global__ void __launch_bounds__(kMaxThreads)
jump_score_kernel(const int* __restrict__ query, const int* __restrict__ qlen,
                  const int* __restrict__ ref1, const int* __restrict__ r1len,
                  const int* __restrict__ ref2, const int* __restrict__ r2len,
                  int* __restrict__ out, int nq, int nr1, int nr2, Scores s) {
    extern __shared__ int s_qsh[];          // blockDim.x * L lanes
    __shared__ int s_diag[kMaxWarps];
    __shared__ int s_tot[kMaxWarps];
    __shared__ int s_best[kMaxWarps];
    const int b = blockIdx.x;
    const int n_lanes = blockDim.x * L;
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
    walk_phase<L, true>(pm, pd, pi, pj, ref1 + (size_t)b * nr1, rl1, s_qsh,
                        s_diag, s_tot, q0, qn, s, best);
    // ref2 restarts M, D and I; J carries over
#pragma unroll
    for (int j = 0; j < L; ++j) {
        pm[j] = (q0 + j) * s.off_edge;
        pd[j] = kBad;
        pi[j] = kBad;
    }
    walk_phase<L, false>(pm, pd, pi, pj, ref2 + (size_t)b * nr2, rl2, s_qsh,
                         s_diag, s_tot, q0, qn, s, best);

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
}

template <int L>
cudaError_t launch(const int* query, const int* qlen, const int* ref1,
                   const int* r1len, const int* ref2, const int* r2len,
                   int* out, int B, int nq, int nr1, int nr2,
                   const Scores& s, cudaStream_t stream) {
    const int per = (nq + 1 + L - 1) / L;
    const int threads = (per + 31) / 32 * 32;
    const size_t smem = (size_t)threads * L * sizeof(int);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            jump_score_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return err;
    }
    jump_score_kernel<L><<<B, threads, smem, stream>>>(
        query, qlen, ref1, r1len, ref2, r2len, out, nq, nr1, nr2, s);
    return cudaGetLastError();
}

}  // namespace

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
    const auto* q = static_cast<const int*>(query);
    const auto* ql = static_cast<const int*>(qlen);
    const auto* r1 = static_cast<const int*>(ref1);
    const auto* r1l = static_cast<const int*>(r1len);
    const auto* r2 = static_cast<const int*>(ref2);
    const auto* r2l = static_cast<const int*>(r2len);
    auto* o = static_cast<int*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    const int need = (nq + 1 + kMaxThreads - 1) / kMaxThreads;
    if (need <= 1) return launch<1>(q, ql, r1, r1l, r2, r2l, o, B, nq, nr1, nr2, s, st);
    if (need <= 2) return launch<2>(q, ql, r1, r1l, r2, r2l, o, B, nq, nr1, nr2, s, st);
    if (need <= 3) return launch<3>(q, ql, r1, r1l, r2, r2l, o, B, nq, nr1, nr2, s, st);
    if (need <= 5) return launch<5>(q, ql, r1, r1l, r2, r2l, o, B, nq, nr1, nr2, s, st);
    if (need <= 9) return launch<9>(q, ql, r1, r1l, r2, r2l, o, B, nq, nr1, nr2, s, st);
    if (need <= 17) return launch<17>(q, ql, r1, r1l, r2, r2l, o, B, nq, nr1, nr2, s, st);
    if (need <= kMaxLanes) return launch<kMaxLanes>(q, ql, r1, r1l, r2, r2l, o, B, nq, nr1, nr2, s, st);
    return cudaErrorInvalidValue;
}

}  // extern "C"
