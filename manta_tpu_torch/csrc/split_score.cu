// Batched split-read junction scan (float32 ln-likelihood, first-index
// argmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel manta_tpu/align/pallas_splitscore.py
// `_kernel`, reached through `pallas_split_score`. Same contract as the
// plain form manta_tpu_torch/align/device_splitscore.batched_split_score:
// each (read, target) row slides its read across the target's scan
// window [scan_start, scan_end]; at scan position k the read's
// ln-likelihood is the sum over read bases j of
//
//     LN_RANDOM          if the read or the target base is N
//     lnx[clamp(q,2,70)] if they differ
//     lnm[clamp(q,2,70)] otherwise
//
// counting only bases whose target position scan_start+k+j lies in the
// score range (score_beg, score_end]. The row's result is the best sum
// and its position, the first one among equal sums.
//
// Exactness: each position's terms are added in base order j = 0, 1, ...
// into one float32 accumulator, as the plain form, the JAX lax.scan and
// the native host scan (native/manta_core.cpp split_scan_pos) do. A
// gated term is skipped, which equals adding +0.0f because the sum never
// holds -0.0f (every real term is negative). There is no multiply, so no
// FMA contraction can change a term; build without --use_fast_math.
//
// What bounds it on the H100: a row does about n_k * read_len terms
// (n_k valid scan positions, ~160 for a 150 bp read), each a compare and
// a float add on bytes and floats already loaded, with no product to
// give the tensor cores. The bytes are a one-time load of the row's read,
// quals and target window (~1 KB). So the kernel is bound by the
// shared-memory loads of its inner loop and their latency, not by device
// memory or arithmetic throughput.
//
// Design (simple first, not yet fast): one thread block per row, one
// thread per scan position k, looping when a row has more positions
// than threads. A row evaluates only its own n_k = min(scan_end -
// scan_start + 1, n_scan) positions, not all n_scan positions of the
// padded target. The block stages in shared memory the row's read bytes,
// the per-base lnm/lnx values (from the two 71-entry LUTs) and the
// target window [scan_start, scan_start + n_k + read_len). At a given j
// every thread of a warp reads the same read byte and LUT values (a
// broadcast) and consecutive target bytes (no bank conflict). The winner
// is a block reduction on (value descending, k ascending): a warp
// shuffle, then one shared word pair per warp. Target reads past the
// row's padded width are clamped to its last column, as the plain form
// and the JAX forms clamp them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxQ = 70;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoPos = 0x7fffffff;
constexpr uint8_t kN = 'N';

// bytes of dynamic shared memory one row needs: lnm and lnx per base
// (float), the read bytes and the target window
size_t smem_bytes(int L, int n_scan) {
    return (size_t)L * (2 * sizeof(float) + 1) + (size_t)n_scan + L;
}

__device__ __forceinline__ bool better(float v, int k, float bv, int bk) {
    return v > bv || (v == bv && k < bk);
}

__global__ void __launch_bounds__(kThreads)
split_score_kernel(const uint8_t* __restrict__ reads,
                   const uint8_t* __restrict__ quals,
                   const uint8_t* __restrict__ targets,
                   const int* __restrict__ bp_beg,
                   const int* __restrict__ bp_end,
                   const int* __restrict__ read_len,
                   const int* __restrict__ target_len,
                   const float* __restrict__ lut_m,
                   const float* __restrict__ lut_x,
                   float* __restrict__ out_best, int* __restrict__ out_pos,
                   int L, int T, int flank, int n_scan, float ln_random) {
    extern __shared__ float4 smem_f4[];
    float* s_lnm = reinterpret_cast<float*>(smem_f4);
    float* s_lnx = s_lnm + L;
    uint8_t* s_read = reinterpret_cast<uint8_t*>(s_lnx + L);
    uint8_t* s_tgt = s_read + L;
    __shared__ float s_best[kWarps];
    __shared__ int s_k[kWarps];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int rl = read_len[b];
    const int beg = bp_beg[b];
    const int end = bp_end[b];
    const int scan_start = max(0, beg - rl + 2);
    const int scan_end = max(0, min(end, target_len[b] - rl));
    const int score_beg = beg - flank;
    const int score_end = end + flank;
    const int n_k = min(scan_end - scan_start + 1, n_scan);
    if (n_k <= 0) {                      // no valid scan position
        if (tid == 0) {
            out_best[b] = -INFINITY;
            out_pos[b] = scan_start;
        }
        return;
    }
    const int nb = min(max(rl, 0), L);   // bases that can add a term

    const uint8_t* g_read = reads + (size_t)b * L;
    const uint8_t* g_qual = quals + (size_t)b * L;
    for (int j = tid; j < nb; j += kThreads) {
        const int q = min(max((int)g_qual[j], 2), kMaxQ);
        s_read[j] = g_read[j];
        s_lnm[j] = __ldg(lut_m + q);
        s_lnx[j] = __ldg(lut_x + q);
    }
    const uint8_t* g_tgt = targets + (size_t)b * T;
    const int win = n_k + nb;
    for (int i = tid; i < win; i += kThreads)
        s_tgt[i] = g_tgt[min(scan_start + i, T - 1)];
    __syncthreads();

    float best = -INFINITY;
    int best_k = kNoPos;
    for (int k = tid; k < n_k; k += kThreads) {
        const int p0 = scan_start + k;
        const int j_lo = max(0, score_beg - p0 + 1);
        const int j_hi = min(nb, score_end - p0 + 1);
        const uint8_t* w = s_tgt + k;
        float acc = 0.0f;
        for (int j = j_lo; j < j_hi; ++j) {
            const uint8_t qb = s_read[j];
            const uint8_t tb = w[j];
            float term;
            if (qb == kN || tb == kN) term = ln_random;
            else if (qb != tb) term = s_lnx[j];
            else term = s_lnm[j];
            acc += term;
        }
        if (acc > best) {                // k ascends: keeps the first
            best = acc;
            best_k = k;
        }
    }

    const int lane = tid & 31;
    const int warp = tid >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float v = __shfl_xor_sync(kFull, best, o);
        const int k = __shfl_xor_sync(kFull, best_k, o);
        if (better(v, k, best, best_k)) {
            best = v;
            best_k = k;
        }
    }
    if (lane == 0) {
        s_best[warp] = best;
        s_k[warp] = best_k;
    }
    __syncthreads();
    if (warp == 0) {
        best = lane < kWarps ? s_best[lane] : -INFINITY;
        best_k = lane < kWarps ? s_k[lane] : kNoPos;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float v = __shfl_xor_sync(kFull, best, o);
            const int k = __shfl_xor_sync(kFull, best_k, o);
            if (better(v, k, best, best_k)) {
                best = v;
                best_k = k;
            }
        }
        if (lane == 0) {
            out_best[b] = best;
            out_pos[b] = scan_start + best_k;   // n_k >= 1: k = 0 is valid
        }
    }
}

int max_smem_optin() {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return -1;
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return -1;
    return bytes - (int)(kWarps * (sizeof(float) + sizeof(int)));
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch at read width L and n_scan positions
// needs, and the most the current device gives a block (-1 if unknown).
long long mt_cuda_split_score_smem(int L, int n_scan) {
    return (long long)smem_bytes(L, n_scan);
}

int mt_cuda_split_score_max_smem(void) { return max_smem_optin(); }

// All pointers are device pointers to contiguous arrays: reads and quals
// uint8 (B, L), targets uint8 (B, T), bp_beg, bp_end, read_len and
// target_len int32 (B,), the LUTs float32 (71,), out_best float32 (B,)
// and out_pos int32 (B,). Launches on `stream` without synchronising;
// returns the launch's cudaError_t.
int mt_cuda_split_score(const void* reads, const void* quals,
                        const void* targets, const void* bp_beg,
                        const void* bp_end, const void* read_len,
                        const void* target_len, const void* lut_m,
                        const void* lut_x, void* out_best, void* out_pos,
                        int B, int L, int T, int flank, int n_scan,
                        float ln_random, void* stream) {
    if (B <= 0) return cudaSuccess;
    if (L < 0 || T <= 0 || n_scan < 0) return cudaErrorInvalidValue;
    const size_t smem = smem_bytes(L, n_scan);
    const int limit = max_smem_optin();
    if (limit < 0 || smem > (size_t)limit) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            split_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return err;
    }
    split_score_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reads), static_cast<const uint8_t*>(quals),
        static_cast<const uint8_t*>(targets), static_cast<const int*>(bp_beg),
        static_cast<const int*>(bp_end), static_cast<const int*>(read_len),
        static_cast<const int*>(target_len), static_cast<const float*>(lut_m),
        static_cast<const float*>(lut_x), static_cast<float*>(out_best),
        static_cast<int*>(out_pos), L, T, flank, n_scan, ln_random);
    return cudaGetLastError();
}

}  // extern "C"
