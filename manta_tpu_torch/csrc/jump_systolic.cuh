// The two-reference jump Smith-Waterman-Gotoh recurrence (int32, score
// only) as a systolic walk for Hopper (sm_90a): no block barrier
// anywhere. The exact insert chain is jump_score.cu's kernel, the chain
// bounded to a window of lanes (kBounded, below) jump_score_bounded.cu's;
// the scores and the sentinels BAD and NEG are jump_dp.cuh's.
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
// error word of the scratch header and waits no more. Every wait adds the
// polls it made beyond the first to the header's two counters (one for
// the boundary words, one for the bounded chain's tails), so a run can
// say how long its strips stood waiting.
//
// A row walks only its own width and length: strips and threads wholly
// above the row's query length do not compute (no lane feeds a lower
// lane), and columns past a row's reference lengths are not walked.
//
// The bounded chain (kBounded) changes only what crosses a thread
// boundary for the insert chain. A lane's insert value is the maximum
// of the sources of the w lanes below it, its detection value that of
// the 2w below; where the second is larger the row is flagged. So
// instead of one running maximum a thread needs the sources of the 2w
// lanes below its first lane, which the threads below made for the
// same column one to several steps earlier. They stay in a ring of
// per-column rows in the warp's own shared memory (Tail, walk_strip);
// the order of a row's writes and reads is kept by one __syncwarp a
// step. Between strips the top 2w sources of a column travel beside the
// boundary word, as int32 words that say themselves whether they have
// arrived.

#pragma once

#include "jump_dp.cuh"

namespace {

constexpr int kSpinLimit = 1 << 22;     // polls of one wait
// scratch header, in ints: ticket, error word, polls of the waits for
// boundary words beyond the first of each, the same for the tails
constexpr int kHeaderInts = 4;
constexpr int kHand = 16;               // columns per hand-over chunk
// a hand-over word that has not arrived: both halves 0x80808080, far
// below BAD and NEG and any sum of scores
constexpr unsigned long long kAbsent = 0x8080808080808080ull;
constexpr int kAbsentByte = 0x80;
constexpr int kAbsentInt = (int)0x80808080u;

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

// The diagonal maximum of lane j: what lane j + 1's M takes.
template <int L, bool kRef1>
__device__ __forceinline__ int diag_max(const Lanes<L>& st, int j) {
    return kRef1 ? imax(st.pm[j], st.pdi[j])
                 : __vimax3_s32(st.pm[j], st.pdi[j], st.pj[j]);
}

// M and D of one column, high lane first so lane j-1 still holds the old
// state. Leaves the new M in st.pm and the new D in vd; returns the
// diagonal maximum of the last lane, taken before the update.
template <int L, bool kRef1>
__device__ __forceinline__ int advance_md(Lanes<L>& st, bool first,
                                          bool bad_d0, bool bad_d1, int rc,
                                          int dprev, const Scores& s,
                                          int (&vd)[L]) {
    const int oe = s.open + s.extend;
    const int dl = diag_max<L, kRef1>(st, L - 1);
#pragma unroll
    for (int j = L - 1; j >= 0; --j) {
        const int d = j > 0 ? diag_max<L, kRef1>(st, j - 1) : dprev;
        int vm = d + (st.qc[j] == rc ? s.match : s.mismatch);
        vd[j] = __viaddmax_s32(st.pdi[j], s.extend, st.pm[j] + oe);
        if (j == 0 && first) vm = 0;
        if (j == 0 && bad_d0) vd[j] = kBad;
        if (j == 1 && bad_d1) vd[j] = kBad;
        st.pm[j] = vm;
    }
    return dl;
}

// The chain source lane j's new M (in the ref2 phase also its J) opens
// for the lanes above it, less extend*(q+1).
template <int L, bool kRef1>
__device__ __forceinline__ int chain_source(const Lanes<L>& st, int j) {
    return kRef1 ? st.pm[j] + st.src[j]
                 : imax(st.pm[j] + st.src[j], st.pjs[j]);
}

// I, J and the query-end best of lane j, from the lane's insert value.
template <int L, bool kRef1>
__device__ __forceinline__ void finish_lane(Lanes<L>& st, int j, bool first,
                                            int vi, int vd, const Scores& s) {
    if (kRef1) {
        st.pj[j] = __viaddmax_s32(imax(st.pm[j], vi), s.jump, st.pj[j]);
        if (j == 0 && first) st.pj[j] = kBad;
    }
    st.pdi[j] = imax(vd, vi);
    st.best = __viaddmax_s32(st.pm[j], st.end[j], st.best);
}

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
    int vd[L];
    dl = advance_md<L, kRef1>(st, first, bad_d0, bad_d1, rc, dprev, s, vd);
    // the insert chain: a running maximum that starts from the lanes
    // below
    int run = excl;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const int vi = __viaddmax_s32(run, st.e1[j], kBad);
        if (kRef1) run = __viaddmax_s32(st.pm[j], st.src[j], run);
        else run = __vimax3_s32(st.pm[j] + st.src[j], st.pjs[j], run);
        finish_lane<L, kRef1>(st, j, first, vi, vd[j], s);
    }
    incl = run;
}

// out[j] = max(g[k] for base + j - w < k <= base + j), w a power of two
// >= 2 and every such k >= 0, by the block decomposition of a sliding
// maximum with the blocks anchored at the thread's own lanes: a prefix
// inside each chunk of w lanes (ascending pass) and the suffix below
// the chunk's pivot (descending pass, one new lane per step), w + 2L
// reads in all.
template <int L>
__device__ __forceinline__ void window_max(const int* g, int base, int w,
                                           int (&out)[L]) {
    int u = kNeg;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        if ((j & (w - 1)) == 0) u = kNeg;
        else u = imax(u, g[base + j]);
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
            for (int k = q - w + 2; k <= pivot; ++k) sfx = imax(sfx, g[k]);
        }
        sfx = imax(sfx, g[q - w + 1]);
        out[j] = imax(out[j], sfx);
    }
}

// One column with the chain bounded to w lanes. `row` is the column's
// row of chain sources in the warp's shared-memory ring: entry 2w + i
// is the source lane i of the strip opens (for lane i + 1), entries
// [0, 2w) those of the 2w lanes below the strip. This thread's own
// entries start at `own`. Lane i's insert value takes the maximum of
// the w entries below its own, the detection value that of the 2w
// below. `over` gathers the largest margin of a detection value over
// the insert value; the row flags where it is positive. Lanes above the
// query end cannot raise it: their e1 is so low that both values sit on
// the BAD floor (bounded_e1). The sources keep f - extend*k where the
// plain form sets NEG (see column above): both values are floored at
// BAD before they are compared, so such a source raises neither.
// kW: the window where the kernel is built for it (the loops below
// unroll and only one of the two forms is compiled), 0 for any other.
template <int L, bool kRef1, int kW>
__device__ __forceinline__ void column_bounded(
        Lanes<L>& st, bool first, bool bad_d0, bool bad_d1, int rc,
        int dprev, const Scores& s, int* row, int own, int w_any, int& dl,
        int& over) {
    const int w = kW > 0 ? kW : w_any;
    int vd[L];
    dl = advance_md<L, kRef1>(st, first, bad_d0, bad_d1, rc, dprev, s, vd);
#pragma unroll
    for (int j = 0; j < L; ++j) row[own + j] = chain_source<L, kRef1>(st, j);
    if (L <= w) {
        // Every lane's windows reach below the thread's first lane, so
        // inside the thread both are one running maximum, as the exact
        // chain's is, and below it they are prefix maxima of the tail
        // T[n] = row[own - n]: the first window of lane j ends at
        // T[w - j], the second at T[2w - j]. The loads come first, in
        // rounds of eight that do not wait for one another (a lone warp
        // has nothing else to hide their latency behind); an index past
        // the span reads its last entry again, which a maximum ignores.
        const int* tail = row + own;
        const int span = w - L + 1;
        int a0 = kNeg, a1 = kNeg, b0 = kNeg, b1 = kNeg;
#pragma unroll
        for (int n = 1; n <= span; n += 4) {
            const int i1 = min(n + 1, span), i2 = min(n + 2, span),
                      i3 = min(n + 3, span);
            const int x0 = tail[-n], x1 = tail[-i1], x2 = tail[-i2],
                      x3 = tail[-i3];
            const int y0 = tail[-(w + n)], y1 = tail[-(w + i1)],
                      y2 = tail[-(w + i2)], y3 = tail[-(w + i3)];
            a0 = __vimax3_s32(a0, x0, x1);
            a1 = __vimax3_s32(a1, x2, x3);
            b0 = __vimax3_s32(b0, y0, y1);
            b1 = __vimax3_s32(b1, y2, y3);
        }
        int one[L], two[L], t_one[L], t_two[L];
#pragma unroll
        for (int j = 0; j + 1 < L; ++j) {
            t_one[j] = tail[-(w - j)];
            t_two[j] = tail[-(2 * w - j)];
        }
        one[L - 1] = imax(a0, a1);                  // T[1 .. w - L + 1]
#pragma unroll
        for (int j = L - 2; j >= 0; --j) one[j] = imax(one[j + 1], t_one[j]);
        two[L - 1] = __vimax3_s32(one[0], b0, b1);  // T[1 .. 2w - L + 1]
#pragma unroll
        for (int j = L - 2; j >= 0; --j) two[j] = imax(two[j + 1], t_two[j]);
        int run = kNeg;
#pragma unroll
        for (int j = 0; j < L; ++j) {
            const int win = imax(one[j], run);
            const int vi = __viaddmax_s32(win, st.e1[j], kBad);
            // the detection value max(BAD, two + e1) exceeds vi =
            // max(BAD, win + e1) exactly where two + e1 does
            over = imax(over, two[j] + st.e1[j] - vi);
            run = imax(run, chain_source<L, kRef1>(st, j));
            finish_lane<L, kRef1>(st, j, first, vi, vd[j], s);
        }
        return;
    }
    // a window shorter than the thread's lanes: the sliding maximum
    // (window maxima by doubling in registers measured 1.5x slower)
    int win[L], low[L];
    window_max<L>(row, own - 1, w, win);
    window_max<L>(row, own - 1 - w, w, low);
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const int vi = __viaddmax_s32(win[j], st.e1[j], kBad);
        over = imax(over, low[j] + st.e1[j] - vi);
        finish_lane<L, kRef1>(st, j, first, vi, vd[j], s);
    }
}

// Set a thread's state and constants at the start of a phase.
template <int L, bool kRef1>
__device__ __forceinline__ void start_phase(Lanes<L>& st, int q0,
                                            const Scores& s) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const int q = q0 + j;
        // the lane's sources take the true offset, whatever st.e1 holds
        // (bounded_e1)
        const int e1 = s.extend * (q + 1);
        st.pm[j] = q * s.off_edge;
        st.pdi[j] = kBad;
        st.src[j] = s.open - e1;
        if (kRef1) {
            st.pj[j] = kBad;
            if (q == 0) st.src[j] = kNeg;
        } else {
            // ref2 keeps J, and J opens a chain without paying open
            st.pjs[j] = st.pj[j] - e1;
        }
    }
}

// The bounded chain's plumbing of one warp. `ring` holds the rows of
// chain sources of the last `slots` columns (column c in slot c mod
// slots), `stride` ints apart: 2w entries for the lanes below the strip,
// then the strip's own 32*L. `stage` holds the 2w entries below the
// strip for the kHand columns of the hand-over chunk last read.
// `below`/`above`: this phase's tail rows (2w ints a column) shared with
// the strip below and the strip above, null where there is none.
struct Tail {
    int* ring;
    int* stage;
    int w, shift;           // the window and log2(2w)
    int slots, stride;
    const int* below;
    int* above;
    int over;               // largest margin of a detection value
};

// Hand the column's top 2w entries (the sources the strip above may
// need) to the strip above.
template <int L>
__device__ __forceinline__ void hand_tail_up(const Tail& tl, int slot,
                                             int c) {
    const int two_w = 2 * tl.w;
    const int* top = tl.ring + slot * tl.stride + 32 * L;
    int* dst = tl.above + (size_t)c * two_w;
    for (int e = threadIdx.x & 31; e < two_w; e += 32) dst[e] = top[e];
}

// One phase of one strip: the columns [0, rlen) of `ref`, thread t one
// column behind thread t - 1. `t_last` is the strip's highest thread
// with a lane at or below the query end. `below`/`above` are the
// hand-over rows of this phase (entry c: column c) shared with the
// strip below and the strip above, null where there is none.
//
// kBounded: the insert chain is the bounded one (column_bounded), and
// what crosses a thread boundary for it is the ring in shared memory: a
// thread writes its lanes' sources into its column's row and reads the
// 2w entries below its own, which the threads below wrote one to
// several steps earlier. One __syncwarp a step orders the two; the ring
// has two slots more than the threads a window reaches down, so a slot
// is never rewritten in the step, or the step after, in which it is
// read. Between strips the row's top 2w entries travel as the two
// boundary values do: int32 words in device memory that say themselves
// whether they have arrived, read a chunk of kHand columns at a time
// into `stage` and copied from there into the row's first 2w entries
// when the strip's first thread reaches the column.
template <int L, bool kRef1, bool kBounded, int kW>
__device__ __forceinline__ void walk_strip(
        Lanes<L>& st, const int* __restrict__ ref, int rlen, int q0, int qn,
        int t_last, const Word* below, Word* above, int* error,
        const Scores& s, Tail& tl) {
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
    // ring slots of this thread's column, of the column the first thread
    // is at, and of the column the last thread has just left
    int slot = 0, slot_in = 0, slot_up = 0;
    const int two_w = kBounded ? 2 * tl.w : 0;
    const int own = two_w + lane * L;
    auto next = [&](int v) { return v + 1 == tl.slots ? 0 : v + 1; };
    if (kBounded) __syncwarp();
    for (int step = 0; step < n_steps; ++step) {
        if ((step & 31) == 0) {
            r_prev = r_cur;
            r_cur = step + lane < rlen ? __ldg(ref + step + lane) : 0;
        }
        if (below != nullptr && (step & (hand - 1)) == 0 && step < rlen) {
            const bool mine = lane < hand && step + lane < rlen;
            const volatile Word* p = below + step + (mine ? lane : 0);
            bchunk = *p;
            int spin = 0;
            for (; !gave_up &&
                 __any_sync(kFull, mine && bchunk == kAbsent); ++spin) {
                if (spin >= kSpinLimit) {
                    gave_up = true;
                    atomicExch(error, 1);
                }
                bchunk = *p;
            }
            if (lane == 0 && spin > 0) atomicAdd(error + 1, spin);
            if (kBounded) {
                // the tails of the chunk's columns, eight loads in
                // flight a thread; read again until every word is there
                const volatile int* tp = tl.below + (size_t)step * two_w;
                const int n = min(hand, rlen - step) * two_w;
                bool missing = true;
                for (spin = 0; !gave_up && missing; ++spin) {
                    missing = false;
                    for (int base = lane; base < n; base += 32 * 8) {
                        int v[8];
#pragma unroll
                        for (int u = 0; u < 8; ++u)
                            v[u] = base + 32 * u < n ? tp[base + 32 * u] : 0;
#pragma unroll
                        for (int u = 0; u < 8; ++u) {
                            if (base + 32 * u >= n) continue;
                            tl.stage[base + 32 * u] = v[u];
                            missing |= v[u] == kAbsentInt;
                        }
                    }
                    missing = __any_sync(kFull, missing);
                    if (missing && spin >= kSpinLimit) {
                        gave_up = true;
                        atomicExch(error, 1);
                    }
                }
                if (lane == 0 && spin > 1) atomicAdd(error + 2, spin - 1);
                __syncwarp();
            }
        }
        if (kBounded) {
            if (tl.below != nullptr && step < rlen) {
                // the first thread reaches column `step`: its tail from
                // the strip below into the row's first 2w entries
                const int* src = tl.stage + (step & (hand - 1)) * two_w;
                int* dst = tl.ring + slot_in * tl.stride;
                for (int e = lane; e < two_w; e += 32) dst[e] = src[e];
            }
            __syncwarp();
            if (tl.above != nullptr && step >= 32 && step - 32 < rlen)
                hand_tail_up<L>(tl, slot_up, step - 32);
        }
        // what the thread below made in the step before, for the column
        // this thread works on now
        int dprev = __shfl_up_sync(kFull, dl, 1);
        int excl = kBounded ? 0 : __shfl_up_sync(kFull, incl, 1);
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
            if (kBounded)
                column_bounded<L, kRef1, kW>(
                    st, first, bad_d0, bad_d1, rc, dprev, s,
                    tl.ring + slot * tl.stride, own, tl.w, dl, tl.over);
            else
                column<L, kRef1>(st, first, bad_d0, bad_d1, rc, dprev, excl,
                                 s, dl, incl);
            if (above != nullptr && lane == 31) above[c] = pack(dl, incl);
        }
        if (kBounded) {
            if (c >= 0) slot = next(slot);
            slot_in = next(slot_in);
            if (step >= 32) slot_up = next(slot_up);
        }
    }
    if (kBounded) {
        __syncwarp();
        if (tl.above != nullptr && n_steps >= 32 && n_steps - 32 < rlen)
            hand_tail_up<L>(tl, slot_up, n_steps - 32);
    }
    // off-edge terms at the phase end
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const int q = q0 + j;
        if (q < qn) st.best = imax(st.best, st.pm[j] + (qn - q) * s.off_edge);
    }
}

// How the bounded chain is laid out in shared memory: 0 rounds is the
// exact chain, which uses none.
struct Bound {
    int rounds;             // the window is 1 << rounds lanes
    int slots, stride;      // of the ring (Tail)
};

// One warp, one block, per (row, strip): blocks of several warps
// measured no faster. `strips` = W strips per row. With W == 1 the
// block index is the row, `scratch` is not read and out[b] is written
// directly. With W > 1 the warp draws a ticket, strip-major (all rows'
// strip 0 first), and out[b], preset below every score, takes the
// strips' results by atomicMax. kBounded: flag_out[b], preset to 0,
// takes the strips' flags by atomicOr.
// The insert offset of lane q in the bounded kernel: extend*(q+1) at
// and below the query end. Above it nothing reads the lane's results,
// and an offset this low puts both of its windows' values under the BAD
// floor (its sources keep the true offset, start_phase), so the lane
// can never raise the row's flag.
__device__ __forceinline__ int bounded_e1(int q, int qn, const Scores& s) {
    return q <= qn ? s.extend * (q + 1) : kNeg / 2;
}

// (One block a multiprocessor is all the launch bound promises: left to
// itself ptxas kept the bounded kernels to 80-128 registers and spilled
// 4-24 bytes in most of them.)
template <int L, bool kBounded, int kW>
__global__ void __launch_bounds__(32, 1)
jump_systolic_kernel(const int* __restrict__ query,
                     const int* __restrict__ qlen,
                     const int* __restrict__ ref1,
                     const int* __restrict__ r1len,
                     const int* __restrict__ ref2,
                     const int* __restrict__ r2len, int* __restrict__ out,
                     int* flag_out, int* scratch, int B, int nq, int nr1,
                     int nr2, int strips, Bound bound, Scores s) {
    extern __shared__ int s_ring[];
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
    // holds nr1 + nr2 entries, ref1's columns then ref2's; the bounded
    // chain's tail rows follow all of them, 2w ints an entry
    const bool has_below = w > 0;
    const bool has_above = w + 1 < strips && (w + 1) * 32 * L <= qn;
    int* error = scratch + 1;
    Word* rows = reinterpret_cast<Word*>(scratch + kHeaderInts);
    const size_t row_len = (size_t)nr1 + nr2;
    const size_t below_at = ((size_t)b * (strips - 1) + (w - 1)) * row_len;
    const size_t above_at = ((size_t)b * (strips - 1) + w) * row_len;
    Word* below = has_below ? rows + below_at : nullptr;
    Word* above = has_above ? rows + above_at : nullptr;

    Tail tl{};
    int* tails = nullptr;
    if (kBounded) {
        tl.w = 1 << bound.rounds;
        tl.shift = bound.rounds + 1;
        tl.slots = bound.slots;
        tl.stride = bound.stride;
        tl.ring = s_ring;
        tl.stage = s_ring + bound.slots * bound.stride;
        tl.over = kNeg;
        tails = reinterpret_cast<int*>(
            rows + (size_t)B * (strips - 1) * row_len);
        tl.below = has_below ? tails + (below_at << tl.shift) : nullptr;
        tl.above = has_above ? tails + (above_at << tl.shift) : nullptr;
        // no lane below the lowest strip opens a chain
        if (!has_below)
            for (int k = 0; k < tl.slots; ++k)
                for (int e = lane; e < 2 * tl.w; e += 32)
                    tl.ring[k * tl.stride + e] = kNeg;
    }

    Lanes<L> st;
    const int* qrow = query + (size_t)b * nq;
#pragma unroll
    for (int j = 0; j < L; ++j) {
        const int q = q0 + j;
        st.qc[j] = (q >= 1 && q <= nq) ? __ldg(qrow + q - 1) : 0;
        st.e1[j] = kBounded ? bounded_e1(q, qn, s) : s.extend * (q + 1);
        st.end[j] = q == qn ? 0 : kNeg;
    }
    st.best = kNeg;
    walk_strip<L, true, kBounded, kW>(st, ref1 + (size_t)b * nr1, rl1, q0, qn,
                                  t_last, below, above, error, s, tl);
    // ref2 restarts M, D and I; J carries over
    if (kBounded) {
        if (has_below) tl.below += (size_t)nr1 << tl.shift;
        if (has_above) tl.above += (size_t)nr1 << tl.shift;
    }
    walk_strip<L, false, kBounded, kW>(st, ref2 + (size_t)b * nr2, rl2, q0, qn,
                                   t_last, has_below ? below + nr1 : nullptr,
                                   has_above ? above + nr1 : nullptr, error,
                                   s, tl);

    int best = st.best;
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
        best = imax(best, __shfl_xor_sync(kFull, best, k));
    const bool flagged = kBounded && __any_sync(kFull, tl.over > 0);
    if (lane == 0) {
        if (strips > 1) atomicMax(out + b, best);
        else out[b] = best;
        if (flagged) atomicOr(flag_out + b, 1);
    }
}

// Lanes per thread the kernel is built for, and the strips (warps) a
// row of nq + 1 lanes takes at each.
constexpr int kLaneChoices[] = {3, 5, 9, 17};
constexpr int kMaxStrips = 64;
constexpr int kSMs = 132;
constexpr int kWarpsWithAScheduler = kSMs * 4 * 4 / 5;
constexpr int kMaxNq = kMaxStrips * 32 * 17 - 1;
constexpr size_t kMaxSharedBytes = 232448;  // a block's most on sm_90

inline int strips_for(int nq, int L) { return (nq + 32 * L) / (32 * L); }

// The ring of the bounded chain at L lanes per thread, window 1 <<
// rounds: two slots more than the threads a detection window reaches
// down (at most the warp's 31), and a stride that spreads a step's
// reads, one column apart from thread to thread, over the banks
// (stride = L - 1 modulo 32).
inline Bound ring_for(int rounds, int L) {
    const long long two_w = 2ll << rounds;
    const int reach = (int)((two_w + L - 1) / L < 31 ? (two_w + L - 1) / L
                                                     : 31);
    const long long used = two_w + 32 * L;
    const int pad = (int)((((L - 1 - used) % 32) + 32) % 32);
    return Bound{rounds, reach + 2, (int)(used + pad)};
}

// Bytes of shared memory a warp of the bounded kernel takes: the ring,
// and for a row of several strips the stage of one hand-over chunk.
inline size_t bounded_shared_bytes(int nq, int rounds, int L) {
    const Bound r = ring_for(rounds, L);
    size_t ints = (size_t)r.slots * r.stride;
    if (strips_for(nq, L) > 1) ints += (size_t)kHand * (2ull << rounds);
    return ints * sizeof(int);
}

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

// Whether the bounded kernel can run a row of nq + 1 lanes at L lanes
// per thread: no more strips than the kernel takes, and a ring that
// fits a block's shared memory.
inline bool bounded_fits(int nq, int rounds, int L) {
    return strips_for(nq, L) <= kMaxStrips &&
           bounded_shared_bytes(nq, rounds, L) <= kMaxSharedBytes;
}

// The same choice for the bounded chain, whose step also reads the 2w
// sources below a thread, and between strips hands them on: more lanes
// per thread share that work among more cells, and fewer strips hand
// over less. Measured at the scorer's buckets, full rows, at windows of
// 8 and 32 lanes: under 32 lanes the fewest lanes from 5 on was the
// fastest or within 3% of it everywhere (9 and 17 lanes are longer than
// the window and take the slower sliding maximum); from 32 lanes on the
// fewest lanes from 9 on for which a row is one warp, and the most
// lanes where none is. 0 where the ring of no layout fits (a window of
// thousands of lanes on a query too wide for one warp).
inline int auto_lanes_bounded(int nq, int rounds) {
    const int first = rounds < 5 ? 5 : 9;
    int widest = 0;
    for (int L : kLaneChoices) {
        if (L < first || !bounded_fits(nq, rounds, L)) continue;
        if (rounds < 5 || strips_for(nq, L) == 1) return L;
        widest = L;
    }
    if (widest) return widest;
    for (int L : kLaneChoices)
        if (bounded_fits(nq, rounds, L)) return L;
    return 0;
}

// Bytes of scratch a launch needs: the header (kHeaderInts) and
// the hand-over rows, with the bounded chain (rounds > 0) also the tail
// rows; 0 for one strip.
inline size_t systolic_scratch_bytes(int B, int nq, int nr1, int nr2, int L,
                                     int rounds = 0) {
    const int W = strips_for(nq, L);
    if (W <= 1) return 0;
    const size_t entries = (size_t)B * (W - 1) * ((size_t)nr1 + nr2);
    size_t bytes = kHeaderInts * sizeof(int) + entries * sizeof(Word);
    if (rounds > 0) bytes += (entries << (rounds + 1)) * sizeof(int);
    return bytes;
}

// rounds == 0: the exact chain, flag_out not touched. rounds > 0: the
// chain bounded to 1 << rounds lanes, flag_out (B,) set.
template <int L, bool kBounded, int kW = 0>
cudaError_t launch_systolic(const Batch& a, int* flag_out, int rounds,
                            int* scratch, size_t scratch_bytes,
                            const Scores& s, cudaStream_t stream) {
    const int W = strips_for(a.nq, L);
    if (W > kMaxStrips) return cudaErrorInvalidValue;
    cudaError_t err;
    Bound bound{0, 0, 0};
    size_t smem = 0;
    if (kBounded) {
        bound = ring_for(rounds, L);
        smem = bounded_shared_bytes(a.nq, rounds, L);
        if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
        if (smem > 48 * 1024) {
            err = cudaFuncSetAttribute(
                jump_systolic_kernel<L, kBounded, kW>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return err;
        }
        err = cudaMemsetAsync(flag_out, 0, (size_t)a.B * sizeof(int), stream);
        if (err != cudaSuccess) return err;
    }
    if (W > 1) {
        const size_t need = systolic_scratch_bytes(a.B, a.nq, a.nr1, a.nr2,
                                                   L, rounds);
        if (scratch == nullptr || scratch_bytes < need)
            return cudaErrorInvalidValue;
        // the header to 0, every hand-over word absent; out below any
        // score
        err = cudaMemsetAsync(scratch, 0, kHeaderInts * sizeof(int), stream);
        if (err != cudaSuccess) return err;
        err = cudaMemsetAsync(scratch + kHeaderInts, kAbsentByte,
                              need - kHeaderInts * sizeof(int), stream);
        if (err != cudaSuccess) return err;
        err = cudaMemsetAsync(a.out, 0x80, (size_t)a.B * sizeof(int), stream);
        if (err != cudaSuccess) return err;
    }
    jump_systolic_kernel<L, kBounded, kW><<<a.B * W, 32, smem, stream>>>(
        a.query, a.qlen, a.ref1, a.r1len, a.ref2, a.r2len, a.out, flag_out,
        scratch, a.B, a.nq, a.nr1, a.nr2, W, bound, s);
    return cudaGetLastError();
}

// The windows the bounded kernel is built for beside the general one:
// prefix_rounds 3 and 5, what the timing tool runs.
template <int L, bool kBounded>
cudaError_t launch_systolic_for(const Batch& a, int* flag_out, int rounds,
                                int* scratch, size_t scratch_bytes,
                                const Scores& s, cudaStream_t st) {
    if (kBounded && rounds == 3)
        return launch_systolic<L, kBounded, kBounded ? 8 : 0>(
            a, flag_out, rounds, scratch, scratch_bytes, s, st);
    if (kBounded && rounds == 5)
        return launch_systolic<L, kBounded, kBounded ? 32 : 0>(
            a, flag_out, rounds, scratch, scratch_bytes, s, st);
    return launch_systolic<L, kBounded, 0>(a, flag_out, rounds, scratch,
                                           scratch_bytes, s, st);
}

// lanes: 0 for the batch's own choice (auto_lanes), or one of
// kLaneChoices.
template <bool kBounded>
inline cudaError_t launch_systolic_any(const Batch& a, int* flag_out,
                                       int rounds, int* scratch,
                                       size_t scratch_bytes, int lanes,
                                       const Scores& s, cudaStream_t st) {
    if (lanes == 0)
        lanes = kBounded ? auto_lanes_bounded(a.nq, rounds)
                         : auto_lanes(a.B, a.nq);
    if (s.extend > 0) return cudaErrorInvalidValue;
    switch (lanes) {
    case 3: return launch_systolic_for<3, kBounded>(
        a, flag_out, rounds, scratch, scratch_bytes, s, st);
    case 5: return launch_systolic_for<5, kBounded>(
        a, flag_out, rounds, scratch, scratch_bytes, s, st);
    case 9: return launch_systolic_for<9, kBounded>(
        a, flag_out, rounds, scratch, scratch_bytes, s, st);
    case 17: return launch_systolic_for<17, kBounded>(
        a, flag_out, rounds, scratch, scratch_bytes, s, st);
    default: return cudaErrorInvalidValue;
    }
}

}  // namespace
