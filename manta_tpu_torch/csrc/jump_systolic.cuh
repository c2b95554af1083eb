// The exact two-reference jump Smith-Waterman-Gotoh recurrence (int32,
// score only) as a systolic walk for Hopper (sm_90a): no block barrier
// anywhere. Used by jump_score.cu; the scores and the sentinels BAD and
// NEG are jump_dp.cuh's.
//
// A warp owns a strip of 32*L consecutive query lanes of one batch row,
// L lanes per thread in registers. Its 32 threads run one reference
// column apart: in step s thread t works on column s - t. What a thread
// needs from the lanes below it for a column, the thread below made one
// step earlier, so both exchanges of a column are one __shfl_up_sync
// each:
//   dl    the diagonal maximum of the lower thread's last lane at the
//         previous column, taken before that thread updates its state;
//   incl  the running maximum of the insert-chain sources up to and
//         including the lower thread's lanes, before the extend*(q+1)
//         offset and the BAD floor (so the maximum is over the same set
//         as the plain form's prefix and the result is bit-identical).
// Inside a thread the chain is a sequential running maximum that starts
// from the incoming value. The reference codes come from 32-column
// register chunks the warp loads together, one shuffle a step. A cell is
// a dozen arithmetic instructions, most of them Hopper's DPX ones (max
// of three, add-then-max), on per-lane constants held in registers.
//
// One warp has one scheduler's integer pipe, so a row is fastest cut
// into several strips of few lanes per thread: W warps, one strip each,
// in any blocks on any SMs. Strip w hands the two values of its last
// lane to strip w + 1 through a row of 64-bit words in device memory,
// one word per column, written with one store. The words start out as
// a pattern no pair of values can have, so a word says itself whether
// it has arrived: there is no flag and no fence. Strip w + 1 reads a
// chunk of 16 columns with one coalesced volatile load, again until
// every word of it is there, and feeds its thread 0 from that register
// chunk (measured: chunks of 4 and 8 are slower, 32 no faster). A strip
// never waits for a strip above it, and
// strips take their place in the row from a ticket drawn at the start,
// so a strip's lower neighbour always started before it: the wait
// cannot deadlock whatever order the blocks are scheduled in. The wait
// is bounded all the same; when the bound is hit the strip sets the
// error word of the scratch header and waits no more.
//
// A row walks only its own width and length: strips and threads wholly
// above the row's query length do not compute (no lane feeds a lower
// lane), and columns past a row's reference lengths are not walked.

#pragma once

#include "jump_dp.cuh"

namespace {

constexpr int kSpinLimit = 1 << 22;     // polls of one wait
// scratch header, in ints: ticket, error word
constexpr int kHeaderInts = 2;
constexpr int kHand = 16;               // columns per hand-over chunk
// a hand-over word that has not arrived: both halves 0x80808080, far
// below BAD and NEG and any sum of scores
constexpr unsigned long long kAbsent = 0x8080808080808080ull;
constexpr int kAbsentByte = 0x80;

typedef unsigned long long Word;

__device__ __forceinline__ Word pack(int dl, int incl) {
    return ((Word)(unsigned)incl << 32) | (unsigned)dl;
}

// What a thread carries: its L lanes' state and per-lane constants.
// D and I are kept as their maximum: the recurrence reads them only
// together (max(pm + open, pd, pi) and the diagonal max(pm, pd, pi)).
template <int L>
struct Lanes {
    int pm[L], pdi[L], pj[L];
    int qc[L];      // query code of the lane: query[q-1], 0 at q = 0
    int e1[L];      // extend * (q + 1)
    int src[L];     // what the lane's new M adds to open a chain: open - e1
    int pjs[L];     // ref2: the lane's (frozen) J as a chain source, pj - e1
    int end[L];     // 0 at the query-end lane, NEG elsewhere
    int best;
};

// One column of one thread's L lanes, in Hopper's DPX instructions
// (__vimax3_s32: max of three; __viaddmax_s32(a, b, c): max(a + b, c)),
// a dozen a cell. dprev, excl: the two values from the lanes below for
// this column. Returns through dl (taken before the update) and incl
// what the lanes above need.
//
// The plain form sets a chain source f <= BAD to NEG before the prefix
// maximum. Here it stays f - extend*k: such a source gives a lane above
// it f + extend*(q+1-k) < BAD, which the BAD floor on the chain's
// result removes, so every I is the same number. Only lane 0 of the
// ref1 phase, whose source is BAD by definition and not by value, takes
// NEG (through src[0]); first: this thread holds lane 0.
template <int L, bool kRef1>
__device__ __forceinline__ void column(Lanes<L>& st, bool first, bool bad_d0,
                                       bool bad_d1, int rc, int dprev,
                                       int excl, const Scores& s, int& dl,
                                       int& incl) {
    const int oe = s.open + s.extend;
    auto diag = [&](int j) {
        return kRef1 ? imax(st.pm[j], st.pdi[j])
                     : __vimax3_s32(st.pm[j], st.pdi[j], st.pj[j]);
    };
    dl = diag(L - 1);
    // M and D, high lane first so lane j-1 still holds the old state
    int vd[L];
#pragma unroll
    for (int j = L - 1; j >= 0; --j) {
        const int d = j > 0 ? diag(j - 1) : dprev;
        int vm = d + (st.qc[j] == rc ? s.match : s.mismatch);
        vd[j] = __viaddmax_s32(st.pdi[j], s.extend, st.pm[j] + oe);
        if (j == 0 && first) vm = 0;
        if (j == 0 && bad_d0) vd[j] = kBad;
        if (j == 1 && bad_d1) vd[j] = kBad;
        st.pm[j] = vm;
    }
    // the insert chain, I, J and the query-end best
    int run = excl;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const int vi = __viaddmax_s32(run, st.e1[j], kBad);
        if (kRef1) {
            run = __viaddmax_s32(st.pm[j], st.src[j], run);
            st.pj[j] = __viaddmax_s32(imax(st.pm[j], vi), s.jump, st.pj[j]);
            if (j == 0 && first) st.pj[j] = kBad;
        } else {
            run = __vimax3_s32(st.pm[j] + st.src[j], st.pjs[j], run);
        }
        st.pdi[j] = imax(vd[j], vi);
        st.best = __viaddmax_s32(st.pm[j], st.end[j], st.best);
    }
    incl = run;
}

// Set a thread's state and constants at the start of a phase.
template <int L, bool kRef1>
__device__ __forceinline__ void start_phase(Lanes<L>& st, int q0,
                                            const Scores& s) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const int q = q0 + j;
        st.pm[j] = q * s.off_edge;
        st.pdi[j] = kBad;
        st.src[j] = s.open - st.e1[j];
        if (kRef1) {
            st.pj[j] = kBad;
            if (q == 0) st.src[j] = kNeg;
        } else {
            // ref2 keeps J, and J opens a chain without paying open
            st.pjs[j] = st.pj[j] - st.e1[j];
        }
    }
}

// One phase of one strip: the columns [0, rlen) of `ref`, thread t one
// column behind thread t - 1. `t_last` is the strip's highest thread
// with a lane at or below the query end. `below`/`above` are the
// hand-over rows of this phase (entry c: column c) shared with the
// strip below and the strip above, null where there is none.
template <int L, bool kRef1>
__device__ __forceinline__ void walk_strip(
        Lanes<L>& st, const int* __restrict__ ref, int rlen, int q0, int qn,
        int t_last, const Word* below, Word* above, int* error,
        const Scores& s) {
    constexpr int hand = kHand;
    const int lane = threadIdx.x & 31;
    const bool computes = lane <= t_last;
    const bool first = q0 == 0;
    const bool bad_d0 = q0 <= (kRef1 ? 1 : 0);
    const bool bad_d1 = q0 + 1 <= (kRef1 ? 1 : 0);
    start_phase<L, kRef1>(st, q0, s);
    // the reference codes of 32 columns, lane l the column = l mod 32:
    // this chunk's, and the one before for the threads still in it
    int r_cur = 0, r_prev = 0;
    Word bchunk = kAbsent;
    int dl = kBad, incl = kNeg;
    bool gave_up = false;
    const int n_steps = rlen > 0 ? rlen + t_last : 0;
    for (int step = 0; step < n_steps; ++step) {
        if ((step & 31) == 0) {
            r_prev = r_cur;
            r_cur = step + lane < rlen ? __ldg(ref + step + lane) : 0;
        }
        if (below != nullptr && (step & (hand - 1)) == 0 && step < rlen) {
            const bool mine = lane < hand && step + lane < rlen;
            const volatile Word* p = below + step + (mine ? lane : 0);
            bchunk = *p;
            for (int spin = 0; !gave_up &&
                 __any_sync(kFull, mine && bchunk == kAbsent); ++spin) {
                if (spin >= kSpinLimit) {
                    gave_up = true;
                    atomicExch(error, 1);
                }
                bchunk = *p;
            }
        }
        // what the thread below made in the step before, for the column
        // this thread works on now
        int dprev = __shfl_up_sync(kFull, dl, 1);
        int excl = __shfl_up_sync(kFull, incl, 1);
        // this thread's column is step - lane; lane l holds it in r_cur
        // if l <= step mod 32, else in r_prev
        const int rc = __shfl_sync(kFull, lane <= (step & 31) ? r_cur : r_prev,
                                   (step - lane) & 31);
        if (below != nullptr) {
            const Word w0 = __shfl_sync(kFull, bchunk, step & (hand - 1));
            if (lane == 0) {
                dprev = (int)(unsigned)w0;
                excl = (int)(unsigned)(w0 >> 32);
            }
        } else if (lane == 0) {
            dprev = kBad;
            excl = kNeg;
        }
        const int c = step - lane;
        if (computes && c >= 0 && c < rlen) {
            column<L, kRef1>(st, first, bad_d0, bad_d1, rc, dprev, excl, s,
                             dl, incl);
            if (above != nullptr && lane == 31) above[c] = pack(dl, incl);
        }
    }
    // off-edge terms at the phase end
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const int q = q0 + j;
        if (q < qn) st.best = imax(st.best, st.pm[j] + (qn - q) * s.off_edge);
    }
}

// One warp, one block, per (row, strip): blocks of several warps
// measured no faster. `strips` = W strips per row. With W == 1 the
// block index is the row, `scratch` is not read and out[b] is written
// directly. With W > 1 the warp draws a ticket, strip-major (all rows'
// strip 0 first), and out[b], preset below every score, takes the
// strips' results by atomicMax.
template <int L>
__global__ void __launch_bounds__(32)
jump_systolic_kernel(const int* __restrict__ query,
                     const int* __restrict__ qlen,
                     const int* __restrict__ ref1,
                     const int* __restrict__ r1len,
                     const int* __restrict__ ref2,
                     const int* __restrict__ r2len, int* __restrict__ out,
                     int* scratch, int B, int nq, int nr1, int nr2,
                     int strips, Scores s) {
    const int lane = threadIdx.x;
    int id = blockIdx.x;
    if (strips > 1) {
        if (lane == 0) id = atomicAdd(scratch, 1);
        id = __shfl_sync(kFull, id, 0);
    }
    if (id >= B * strips) return;
    const int w = id / B;
    const int b = id - w * B;
    const int qn = min(qlen[b], nq);
    const int strip_q0 = w * 32 * L;
    if (strip_q0 > qn) return;            // wholly above the query end
    const int rl1 = min(r1len[b], nr1);
    const int rl2 = min(r2len[b], nr2);
    const int q0 = strip_q0 + lane * L;
    const int t_last = min(31, (qn - strip_q0) / L);

    // hand-over rows: row b's boundary k (between strips k and k + 1)
    // holds nr1 + nr2 entries, ref1's columns then ref2's
    const bool has_below = w > 0;
    const bool has_above = w + 1 < strips && (w + 1) * 32 * L <= qn;
    int* error = scratch + 1;
    Word* rows = reinterpret_cast<Word*>(scratch + kHeaderInts);
    const size_t row_len = (size_t)nr1 + nr2;
    Word* below = has_below
        ? rows + ((size_t)b * (strips - 1) + (w - 1)) * row_len : nullptr;
    Word* above = has_above
        ? rows + ((size_t)b * (strips - 1) + w) * row_len : nullptr;

    Lanes<L> st;
    const int* qrow = query + (size_t)b * nq;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const int q = q0 + j;
        st.qc[j] = (q >= 1 && q <= nq) ? __ldg(qrow + q - 1) : 0;
        st.e1[j] = s.extend * (q + 1);
        st.end[j] = q == qn ? 0 : kNeg;
    }
    st.best = kNeg;
    walk_strip<L, true>(st, ref1 + (size_t)b * nr1, rl1, q0, qn, t_last,
                        below, above, error, s);
    // ref2 restarts M, D and I; J carries over
    walk_strip<L, false>(st, ref2 + (size_t)b * nr2, rl2, q0, qn, t_last,
                         has_below ? below + nr1 : nullptr,
                         has_above ? above + nr1 : nullptr, error, s);

    int best = st.best;
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
        best = imax(best, __shfl_xor_sync(kFull, best, k));
    if (lane == 0) {
        if (strips > 1) atomicMax(out + b, best);
        else out[b] = best;
    }
}

// Lanes per thread the kernel is built for, and the strips (warps) a
// row of nq + 1 lanes takes at each.
constexpr int kLaneChoices[] = {3, 5, 9, 17};
constexpr int kMaxStrips = 64;
constexpr int kWarpsWithAScheduler = 132 * 4 * 4 / 5;
constexpr int kMaxNq = kMaxStrips * 32 * 17 - 1;

inline int strips_for(int nq, int L) { return (nq + 32 * L) / (32 * L); }

// The lanes per thread a batch takes when the caller names none: the
// fewest for which the batch's warps still have a scheduler each, so
// that a row's strips run side by side (132 SMs x 4 schedulers, less a
// fifth because blocks do not spread evenly: measured, a batch of 512
// warps ran faster at the next choice, one of 384 did not); where no
// choice does, the most lanes, the fewest warps.
inline int auto_lanes(int B, int nq) {
    int widest = 0;
    for (int L : kLaneChoices) {
        const int W = strips_for(nq, L);
        if (W > kMaxStrips) continue;
        widest = L;
        if ((long long)B * W <= kWarpsWithAScheduler) return L;
    }
    return widest;
}

// Bytes of scratch a launch needs: the header (ticket, error word) and
// the hand-over rows; 0 for one strip.
inline size_t systolic_scratch_bytes(int B, int nq, int nr1, int nr2,
                                     int L) {
    const int W = strips_for(nq, L);
    if (W <= 1) return 0;
    return kHeaderInts * sizeof(int)
        + (size_t)B * (W - 1) * ((size_t)nr1 + nr2) * sizeof(Word);
}

template <int L>
cudaError_t launch_systolic(const Batch& a, int* scratch,
                            size_t scratch_bytes, const Scores& s,
                            cudaStream_t stream) {
    const int W = strips_for(a.nq, L);
    if (W > kMaxStrips) return cudaErrorInvalidValue;
    cudaError_t err;
    if (W > 1) {
        if (scratch == nullptr ||
            scratch_bytes < systolic_scratch_bytes(a.B, a.nq, a.nr1, a.nr2, L))
            return cudaErrorInvalidValue;
        // ticket and error word to 0, every hand-over word absent; out
        // below any score
        err = cudaMemsetAsync(scratch, 0, kHeaderInts * sizeof(int), stream);
        if (err != cudaSuccess) return err;
        err = cudaMemsetAsync(
            scratch + kHeaderInts, kAbsentByte,
            systolic_scratch_bytes(a.B, a.nq, a.nr1, a.nr2, L)
                - kHeaderInts * sizeof(int), stream);
        if (err != cudaSuccess) return err;
        err = cudaMemsetAsync(a.out, 0x80, (size_t)a.B * sizeof(int), stream);
        if (err != cudaSuccess) return err;
    }
    jump_systolic_kernel<L><<<a.B * W, 32, 0, stream>>>(
        a.query, a.qlen, a.ref1, a.r1len, a.ref2, a.r2len, a.out, scratch,
        a.B, a.nq, a.nr1, a.nr2, W, s);
    return cudaGetLastError();
}

// lanes: 0 for the batch's own choice (auto_lanes), or one of
// kLaneChoices.
inline cudaError_t launch_systolic_any(const Batch& a, int* scratch,
                                       size_t scratch_bytes, int lanes,
                                       const Scores& s, cudaStream_t st) {
    if (lanes == 0) lanes = auto_lanes(a.B, a.nq);
    if (s.extend > 0) return cudaErrorInvalidValue;
    switch (lanes) {
    case 3: return launch_systolic<3>(a, scratch, scratch_bytes, s, st);
    case 5: return launch_systolic<5>(a, scratch, scratch_bytes, s, st);
    case 9: return launch_systolic<9>(a, scratch, scratch_bytes, s, st);
    case 17: return launch_systolic<17>(a, scratch, scratch_bytes, s, st);
    default: return cudaErrorInvalidValue;
    }
}

}  // namespace
