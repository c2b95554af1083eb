// Batched split-read junction scan (float32 ln-likelihood, first-index
// argmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel manta_tpu/align/pallas_splitscore.py
// `_kernel`, reached through `pallas_split_score`. Same contract as the
// plain forms manta_tpu_torch/align/device_splitscore.batched_split_score
// (a row per (read, target) pair) and batched_split_score_factored (n
// reads against t targets): a read slides across a target's scan window
// [scan_start, scan_end]; at scan position k its ln-likelihood is the
// sum over read bases j of
//
//     LN_RANDOM          if the read or the target base is N
//     lnx[clamp(q,2,70)] if they differ
//     lnm[clamp(q,2,70)] otherwise
//
// counting only bases whose target position scan_start+k+j lies in the
// score range (score_beg, score_end]. The pair's result is the best sum
// and its position, the first one among equal sums.
//
// Exactness: each position's terms are added in base order j = 0, 1, ...
// into one float32 accumulator, as the plain form, the JAX lax.scan and
// the native host scan (native/manta_core.cpp split_scan_pos) do. A
// gated term is skipped, which equals adding +0.0f because the sum never
// holds -0.0f (every real term is negative). There is no multiply, so no
// FMA contraction can change a term; build without --use_fast_math.
//
// What bounds it on the H100: a pair does about n_k * read_len terms
// (n_k valid scan positions, ~160 for a 150 bp read), each a compare and
// a float add, with no product to give the tensor cores. The bytes are a
// one-time load of each read, its quals and each target (~1 KB a pair).
// So the kernel is bound by the loads and the latency of its inner loop,
// not by device memory or arithmetic throughput; around it, a call of
// ~100 pairs is bound by what the caller copies to and from the card.
//
// Design: one block of eight warps takes one read and all of its
// targets. It stages the read once, whatever the number of targets: per
// base its byte and the pair (lnm, lnx) from the two 71-entry LUTs, with
// both set to LN_RANDOM where the read base is N. The work of the read
// is cut into items of 32 consecutive scan positions of one target; the
// warps take the items in turn, a thread one position, so that a
// target's 100-160 positions fill the lanes they are given and several
// targets are in flight. At a given j the lanes of a warp read the same
// read byte and LUT pair (a shared-memory broadcast) and consecutive
// target bytes (through L1; a target's window is read by every read's
// block and stays in L2). A warp folds its item by shuffle on (value
// descending, position ascending) and merges it into the target's slot
// in shared memory with one 64-bit atomicMax on a key that orders the
// same way. Target reads past the padded width are clamped to the last
// column, as the plain form and the JAX forms clamp them.
//
// The replicated layout is the same kernel: every row is a read with one
// target, its own (target row = read row).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxQ = 70;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kN = 'N';

// bytes of dynamic shared memory one read needs: (lnm, lnx) per base,
// one key per target, the read bytes
size_t smem_bytes(int L, int t) {
    return (size_t)L * (sizeof(float2) + 1) + (size_t)t * sizeof(uint64_t);
}

// (value, position) as one key whose unsigned order is value ascending,
// then position descending: the maximum is the best value at its first
// position. The value is never NaN.
__device__ __forceinline__ uint64_t make_key(float v, int k) {
    uint32_t u = __float_as_uint(v);
    u ^= (u >> 31) ? 0xffffffffu : 0x80000000u;
    return ((uint64_t)u << 32) | (uint32_t)(0x7fffffff - k);
}

__device__ __forceinline__ float key_value(uint64_t key) {
    uint32_t u = (uint32_t)(key >> 32);
    u ^= (u >> 31) ? 0x80000000u : 0xffffffffu;
    return __uint_as_float(u);
}

__device__ __forceinline__ int key_pos(uint64_t key) {
    return 0x7fffffff - (int)(uint32_t)key;
}

// Target row of read r's k-th target: r * tgt_stride + k (stride 0: all
// reads share the t targets; stride 1 with t == 1: a target per read).
__global__ void __launch_bounds__(kThreads)
split_score_kernel(const uint8_t* __restrict__ reads,
                   const uint8_t* __restrict__ quals,
                   const int* __restrict__ read_len,
                   const uint8_t* __restrict__ targets,
                   const int* __restrict__ bp_beg,
                   const int* __restrict__ bp_end,
                   const int* __restrict__ target_len,
                   const float* __restrict__ lut_m,
                   const float* __restrict__ lut_x,
                   float* __restrict__ out_best, int* __restrict__ out_pos,
                   int t, int tgt_stride, int L, int T, int flank,
                   int n_scan, float ln_random) {
    extern __shared__ uint64_t smem_u64[];
    uint64_t* s_key = smem_u64;                              // [t]
    float2* s_ln = reinterpret_cast<float2*>(s_key + t);     // [L]
    uint8_t* s_read = reinterpret_cast<uint8_t*>(s_ln + L);  // [L]

    const int r = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int rl = read_len[r];
    const int nb = min(max(rl, 0), L);   // bases that can add a term

    const uint8_t* g_read = reads + (size_t)r * L;
    const uint8_t* g_qual = quals + (size_t)r * L;
    for (int j = tid; j < nb; j += kThreads) {
        const int q = min(max((int)g_qual[j], 2), kMaxQ);
        const uint8_t qb = g_read[j];
        s_read[j] = qb;
        s_ln[j] = qb == kN ? make_float2(ln_random, ln_random)
                           : make_float2(__ldg(lut_m + q), __ldg(lut_x + q));
    }
    for (int k = tid; k < t; k += kThreads) s_key[k] = 0;
    __syncthreads();

    const int chunks = (n_scan + 31) / 32;
    const int n_items = t * chunks;
    for (int item = warp; item < n_items; item += kWarps) {
        const int kt = item / chunks;
        const int k = (item - kt * chunks) * 32 + lane;
        const int row = r * tgt_stride + kt;
        const int beg = bp_beg[row];
        const int end = bp_end[row];
        const int scan_start = max(0, beg - rl + 2);
        const int scan_end = max(0, min(end, target_len[row] - rl));
        const int n_k = min(scan_end - scan_start + 1, n_scan);
        if (k - lane >= n_k) continue;       // the whole item is past it
        uint64_t key = 0;
        if (k < n_k) {
            const int p0 = scan_start + k;
            const int j_lo = max(0, beg - flank - p0 + 1);
            const int j_hi = min(nb, end + flank - p0 + 1);
            // bases whose target position lies inside the padded width
            const int j_in = min(j_hi, T - p0);
            const uint8_t* w = targets + (size_t)row * T + p0;
            float acc = 0.0f;
            int j = j_lo;
            for (; j < j_in; ++j) {
                const uint8_t tb = __ldg(w + j);
                const float2 ln = s_ln[j];
                acc += tb == kN ? ln_random
                                : (s_read[j] != tb ? ln.y : ln.x);
            }
            if (j < j_hi) {
                const uint8_t tb = __ldg(targets + (size_t)row * T + T - 1);
                for (; j < j_hi; ++j) {
                    const float2 ln = s_ln[j];
                    acc += tb == kN ? ln_random
                                    : (s_read[j] != tb ? ln.y : ln.x);
                }
            }
            key = make_key(acc, k);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const uint64_t other = __shfl_xor_sync(kFull, key, o);
            key = other > key ? other : key;
        }
        if (lane == 0)
            atomicMax(reinterpret_cast<unsigned long long*>(s_key + kt),
                      (unsigned long long)key);
    }
    __syncthreads();

    for (int kt = tid; kt < t; kt += kThreads) {
        const int row = r * tgt_stride + kt;
        const int scan_start = max(0, bp_beg[row] - rl + 2);
        const uint64_t key = s_key[kt];
        const size_t o = (size_t)r * t + kt;
        // no valid scan position: the key was never raised
        out_best[o] = key == 0 ? -INFINITY : key_value(key);
        out_pos[o] = scan_start + (key == 0 ? 0 : key_pos(key));
    }
}

int max_smem_optin() {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return -1;
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return -1;
    return bytes;
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch at read width L with t targets per
// read needs, and the most the current device gives a block (-1 if
// unknown).
long long mt_cuda_split_score_smem(int L, int t) {
    return (long long)smem_bytes(L, t);
}

int mt_cuda_split_score_max_smem(void) { return max_smem_optin(); }

// All pointers are device pointers to contiguous arrays: reads and quals
// uint8 (n, L), read_len int32 (n,), targets uint8 (rows, T), bp_beg,
// bp_end and target_len int32 (rows,), the LUTs float32 (71,), out_best
// float32 (n, t) and out_pos int32 (n, t). Read r's k-th target is row
// r * tgt_stride + k: tgt_stride 0 with rows = t (every read against
// the same t targets), or tgt_stride 1 with t = 1 and rows = n (a
// target per read). Launches on `stream` without synchronising; returns
// the launch's cudaError_t.
int mt_cuda_split_score(const void* reads, const void* quals,
                        const void* read_len, const void* targets,
                        const void* bp_beg, const void* bp_end,
                        const void* target_len, const void* lut_m,
                        const void* lut_x, void* out_best, void* out_pos,
                        int n, int t, int tgt_stride, int L, int T,
                        int flank, int n_scan, float ln_random,
                        void* stream) {
    if (n <= 0 || t <= 0) return cudaSuccess;
    if (L < 0 || T <= 0 || n_scan < 0 || tgt_stride < 0 ||
        (tgt_stride != 0 && t != 1))
        return cudaErrorInvalidValue;
    const size_t smem = smem_bytes(L, t);
    const int limit = max_smem_optin();
    if (limit < 0 || smem > (size_t)limit) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            split_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return err;
    }
    split_score_kernel<<<n, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reads), static_cast<const uint8_t*>(quals),
        static_cast<const int*>(read_len),
        static_cast<const uint8_t*>(targets), static_cast<const int*>(bp_beg),
        static_cast<const int*>(bp_end), static_cast<const int*>(target_len),
        static_cast<const float*>(lut_m), static_cast<const float*>(lut_x),
        static_cast<float*>(out_best), static_cast<int*>(out_pos), t,
        tgt_stride, L, T, flank, n_scan, ln_random);
    return cudaGetLastError();
}

}  // extern "C"
