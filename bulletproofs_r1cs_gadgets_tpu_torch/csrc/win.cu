// Hopper kernels for the window walkers: the niels multiple tables
// (table_w5: 16 entries over the fixed generators; table_w4: 8 entries
// over the combined [G|H] layout of IPP rounds 2+) and the window-
// accumulator MSMs that walk them (msm_win5: one walk over a w5 table;
// msm_win: one walk over a w4 table; msm_win_pair: a combined round's L
// and R walks over a w4 table in one launch).  One kernel template each,
// instantiated per digit width.  Plain
// C entry points for ctypes (ops/build.py), with the conventions of
// msm_fold.cu: launch on the caller's stream, never synchronise, allocate
// nothing, return cudaGetLastError().
//
// Layouts (row-major, int32):
//   points (n, 4, 8):       X, Y, Z, T, eight little-endian words each
//   table  (n, TBL, 4, 8):  entry k of point i is (k + 1) * P_i in niels
//                           form (Y+X, Y-X, 2d*T, Z), every word canonical
//   w5 words (m, 16):       51 signed base-32 digits d in [-16, 15] per
//                           scalar, one per byte (code d & 31)
//   w4 words (m, 8):        64 signed base-16 digits d in [-8, 7] per
//                           scalar, one per nibble (code d & 15)
//
// What bounds the walkers: integer multiplies (8 field multiplies per
// niels add, one add per point and window) and, second, the table stream
// (128 B per point per window).  Design: the TPU kernels walk windows in
// order and fold each window's sum in by Horner; here a block owns ONE
// window of ONE walk and WIN_PTS points (windows and walks run in
// parallel, so no thread pays for doublings), each thread sums its
// WIN_PPT selected entries, a block tree reduces them, a second launch
// sums each window's partials, and a third folds each walk's window
// totals by Horner (BITS doublings + 1 add per window, one thread per
// walk) and adds the walk's chain.
#include <cuda_runtime.h>
#include <cstdint>

#include "ge25519.cuh"

#define TABLE_THREADS 128
#define WIN_THREADS 128
#define WIN_PPT 16
#define WIN_PTS (WIN_THREADS * WIN_PPT)

// A signed-digit width: BITS-bit windows, a TBL-entry table, digits packed
// one per FIELD bits into WORDS int32 per scalar.
template <int BITS>
struct Win;

template <>
struct Win<5> {
    static constexpr int WINDOWS = 51;  // ceil(253 / 5)
    static constexpr int TBL = 16;
    static constexpr int FIELD = 8;     // one digit per byte
    static constexpr int WORDS = 16;
};

template <>
struct Win<4> {
    static constexpr int WINDOWS = 64;
    static constexpr int TBL = 8;
    static constexpr int FIELD = 4;     // one digit per nibble
    static constexpr int WORDS = 8;
};

// One walk: steps j in [0, v) read word row woff + j and table row
// poff + j below `split`, poff2 + (j - split) from there on.
struct walk {
    int v, poff, woff, split, poff2;
};

struct walks2 {
    walk s[2];
};

struct niels {
    fe ypx, ymx, t2d, z;
};

__device__ __forceinline__ fe fe_load_vec(const int32_t* src) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4 a = __ldg(s);
    uint4 b = __ldg(s + 1);
    fe r;
    r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
    r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
    return r;
}

__device__ __forceinline__ niels niels_load(const int32_t* src) {
    niels q;
    q.ypx = fe_load_vec(src);
    q.ymx = fe_load_vec(src + 8);
    q.t2d = fe_load_vec(src + 16);
    q.z = fe_load_vec(src + 24);
    return q;
}

__device__ __forceinline__ void fe_store_canon(int32_t* dst, const fe& a) {
    fe c = fe_canon(a);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = c.w[i];
}

// -P in niels form: swap Y+X with Y-X, negate 2dT (fe_neg of 0 is 0).
__device__ __forceinline__ niels niels_neg(const niels& q) {
    niels r;
    r.ypx = q.ymx;
    r.ymx = q.ypx;
    r.t2d = fe_neg(q.t2d);
    r.z = q.z;
    return r;
}

// p (extended) + q (niels): add-2008-hwcd-3 with the 2d product and the
// operand sums of q precomputed; 8 multiplies.  Complete (a = -1), so the
// identity accumulator needs no special case.
__device__ __noinline__ ge ge_add_niels(const ge& p, const niels& q) {
    fe A = fe_mul(fe_sub(p.Y, p.X), q.ymx);
    fe B = fe_mul(fe_add(p.Y, p.X), q.ypx);
    fe C = fe_mul(p.T, q.t2d);
    fe Dz = fe_mul(p.Z, q.z);
    fe Dv = fe_add(Dz, Dz);
    fe E = fe_sub(B, A);
    fe F = fe_sub(Dv, C);
    fe G = fe_add(Dv, C);
    fe H = fe_add(B, A);
    ge r;
    r.X = fe_mul(E, F);
    r.Y = fe_mul(G, H);
    r.Z = fe_mul(F, G);
    r.T = fe_mul(E, H);
    return r;
}

// One thread per point: (k + 1) * P for k = 0..TBL-1 by the TPU kernels'
// sequence (odd multiples t(k-1) + P, even ones doubled from t(k/2)), each
// stored in niels form with canonical words.  The 8-entry table is the
// first half of the 16-entry one, entry for entry.
template <int TBL>
__global__ void __launch_bounds__(TABLE_THREADS)
table_kernel(const int32_t* __restrict__ pts, int32_t* __restrict__ table, int n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    ge t[TBL];
    t[0] = ge_load(pts + 32 * i);
    t[1] = ge_double(t[0]);
#pragma unroll 1
    for (int k = 3; k <= TBL; ++k)
        t[k - 1] = (k & 1) ? ge_add(t[k - 2], t[0]) : ge_double(t[k / 2 - 1]);
    const fe d2 = fe_d2();
#pragma unroll 1
    for (int k = 0; k < TBL; ++k) {
        int32_t* dst = table + 32 * (i * TBL + k);
        fe_store_canon(dst, fe_add(t[k].Y, t[k].X));
        fe_store_canon(dst + 8, fe_sub(t[k].Y, t[k].X));
        fe_store_canon(dst + 16, fe_mul(t[k].T, d2));
        fe_store_canon(dst + 24, t[k].Z);
    }
}

// Pass 1: block (b, win, s) sums, over steps j in [b * WIN_PTS,
// (b + 1) * WIN_PTS) of walk s, the table entry that step j's digit `win`
// selects.  Code TBL is the digit -TBL: entry TBL negated.  Partials are
// stored walk- then window-major: partials[(s * WINDOWS + win) * gridDim.x
// + b]; blocks past a walk's end store the identity.
template <int BITS>
__global__ void __launch_bounds__(WIN_THREADS)
msm_win_partials(const int32_t* __restrict__ table, const int32_t* __restrict__ words,
                 int32_t* __restrict__ partials, walks2 g) {
    using W = Win<BITS>;
    constexpr int PER = 32 / W::FIELD;
    __shared__ ge sh[WIN_THREADS];
    const int b = blockIdx.x;
    const int win = blockIdx.y;
    const int s = blockIdx.z;
    const walk w = g.s[s];
    const int wsel = win / PER;
    const int shift = W::FIELD * (win % PER);
    ge acc = ge_identity();
#pragma unroll 1
    for (int k = 0; k < WIN_PPT; ++k) {
        int j = b * WIN_PTS + k * WIN_THREADS + threadIdx.x;
        if (j >= w.v) break;
        uint32_t e = ((uint32_t)__ldg(words + (long long)W::WORDS * (w.woff + j) + wsel)
                      >> shift) & ((1u << BITS) - 1u);
        if (e == 0u) continue;  // digit 0 adds the identity
        bool neg = e >= (uint32_t)W::TBL;
        uint32_t mag = neg ? (2u * W::TBL) - e : e;
        long long row = j < w.split ? (long long)w.poff + j : (long long)w.poff2 + (j - w.split);
        niels q = niels_load(table + 32ll * (row * W::TBL + (mag - 1)));
        if (neg) q = niels_neg(q);
        acc = ge_add_niels(acc, q);
    }
    block_sum(acc, sh);
    if (threadIdx.x == 0)
        ge_store_raw(partials + 32ll * (((long long)s * W::WINDOWS + win) * gridDim.x + b), sh[0]);
}

// Pass 2: block (win, s) sums that window's nb partials into
// wtot[s * WINDOWS + win].
template <int BITS>
__global__ void __launch_bounds__(WIN_THREADS)
msm_win_windows(const int32_t* __restrict__ partials, int32_t* __restrict__ wtot, int nb) {
    __shared__ ge sh[WIN_THREADS];
    const long long row = (long long)blockIdx.y * Win<BITS>::WINDOWS + blockIdx.x;
    ge v = ge_identity();
#pragma unroll 1
    for (int j = threadIdx.x; j < nb; j += blockDim.x)
        v = ge_add(v, ge_load(partials + 32ll * (row * nb + j)));
    block_sum(v, sh);
    if (threadIdx.x == 0) ge_store_raw(wtot + 32 * row, sh[0]);
}

// Pass 3 (thread s folds walk s): Horner over the walk's window totals,
// most significant first, then its chain:
// out[s] = chain[s] + sum_win 2^(BITS * win) * wtot[s][win].
template <int BITS>
__global__ void msm_win_horner(const int32_t* __restrict__ wtot,
                               const int32_t* __restrict__ chain,
                               int32_t* __restrict__ out, int walks) {
    constexpr int WINDOWS = Win<BITS>::WINDOWS;
    const int s = threadIdx.x;
    if (s >= walks) return;
    const int32_t* t = wtot + 32 * WINDOWS * s;
    ge h = ge_load(t + 32 * (WINDOWS - 1));
#pragma unroll 1
    for (int win = WINDOWS - 2; win >= 0; --win) {
#pragma unroll 1
        for (int d = 0; d < BITS; ++d) h = ge_double(h);
        h = ge_add(h, ge_load(t + 32 * win));
    }
    ge_store(out + 32 * s, ge_add(h, ge_load(chain + 32 * s)));
}

// The three passes over `walks` (1 or 2) walks; nb = the longest walk's
// block count.
template <int BITS>
static int msm_win_launch(const int32_t* table, const int32_t* words, const int32_t* chain,
                          int32_t* out, int32_t* partials, int32_t* wtot, walks2 g,
                          int walks, cudaStream_t s) {
    constexpr int WINDOWS = Win<BITS>::WINDOWS;
    int nb = 0;
    for (int k = 0; k < walks; ++k) {
        int b = (g.s[k].v + WIN_PTS - 1) / WIN_PTS;
        nb = b > nb ? b : nb;
    }
    if (nb > 0)
        msm_win_partials<BITS><<<dim3(nb, WINDOWS, walks), WIN_THREADS, 0, s>>>(
            table, words, partials, g);
    msm_win_windows<BITS><<<dim3(WINDOWS, walks), WIN_THREADS, 0, s>>>(partials, wtot, nb);
    msm_win_horner<BITS><<<1, 32, 0, s>>>(wtot, chain, out, walks);
    return (int)cudaGetLastError();
}

template <int TBL>
static int table_launch(const int32_t* pts, int32_t* table, int n, cudaStream_t s) {
    if (n > 0)
        table_kernel<TBL><<<(n + TABLE_THREADS - 1) / TABLE_THREADS, TABLE_THREADS, 0, s>>>(
            pts, table, n);
    return (int)cudaGetLastError();
}

extern "C" {

int bp_win_points_per_block(void) { return WIN_PTS; }

int bp_win5_windows(void) { return Win<5>::WINDOWS; }

int bp_win4_windows(void) { return Win<4>::WINDOWS; }

int bp_table_w5(const int32_t* pts, int32_t* table, int n, void* stream) {
    return table_launch<Win<5>::TBL>(pts, table, n, (cudaStream_t)stream);
}

int bp_table_w4(const int32_t* pts, int32_t* table, int n, void* stream) {
    return table_launch<Win<4>::TBL>(pts, table, n, (cudaStream_t)stream);
}

// out (1, 4, 8) = chain + sum_{j < v} d_j * P_row(j) (see msm_win_partials).
// partials: scratch for 51 * ceil(v / WIN_PTS) points; wtot: for 51 points.
int bp_msm_win5(const int32_t* table, const int32_t* words, const int32_t* chain,
                int32_t* out, int32_t* partials, int32_t* wtot, int v, int poff,
                int woff, int split, int poff2, void* stream) {
    walks2 g;
    g.s[0] = walk{v, poff, woff, split, poff2};
    g.s[1] = g.s[0];
    return msm_win_launch<5>(table, words, chain, out, partials, wtot, g, 1,
                             (cudaStream_t)stream);
}

// The single w4 walk (pallas_curve.msm_win_dyn): out (1, 4, 8) = chain +
// sum_{j < v} d_j * P_row(j) over a w4 table with w4 words.  partials:
// scratch for 64 * ceil(v / WIN_PTS) points; wtot: for 64 points.
int bp_msm_win(const int32_t* table, const int32_t* words, const int32_t* chain,
               int32_t* out, int32_t* partials, int32_t* wtot, int v, int poff,
               int woff, int split, int poff2, void* stream) {
    walks2 g;
    g.s[0] = walk{v, poff, woff, split, poff2};
    g.s[1] = g.s[0];
    return msm_win_launch<4>(table, words, chain, out, partials, wtot, g, 1,
                             (cudaStream_t)stream);
}

// out (2, 4, 8): row s = chain2[s] + walk s over a w4 table (the two walks
// of a combined IPP round).  partials: scratch for 2 * 64 * ceil(max v /
// WIN_PTS) points; wtot: for 2 * 64 points.
int bp_msm_win_pair(const int32_t* table, const int32_t* words, const int32_t* chain2,
                    int32_t* out, int32_t* partials, int32_t* wtot, int v0, int poff0,
                    int woff0, int split0, int poff20, int v1, int poff1, int woff1,
                    int split1, int poff21, void* stream) {
    walks2 g;
    g.s[0] = walk{v0, poff0, woff0, split0, poff20};
    g.s[1] = walk{v1, poff1, woff1, split1, poff21};
    return msm_win_launch<4>(table, words, chain2, out, partials, wtot, g, 2,
                             (cudaStream_t)stream);
}

}  // extern "C"
