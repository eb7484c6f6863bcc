// Hopper kernels for the window walkers: the niels multiple tables
// (table_w5: 16 entries over the fixed generators; table_w4: 8 entries
// over the combined [G|H] layout of IPP rounds 2+) and the window-
// accumulator MSMs that walk them (msm_win5: one walk over a w5 table;
// msm_win: one walk over a w4 table; msm_win_pair: a combined round's L
// and R walks over a w4 table in one launch).  One kernel template each,
// instantiated per digit width.  Beside them the windowed w4 MSM
// (msm_w4, msm_w4_pair; see "the windowed w4 MSM" below), which builds
// its tables in shared memory and ends in the walkers' passes 2 and 3.
// Plain C entry points for ctypes (ops/build.py), with the conventions of
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
// What bounds the walkers on an H100: 32-bit integer multiplies (8 field
// multiplies per niels add, one add per step and window), then the table
// stream (128 B per step and window: 0.94 GB at 143,704 w5 steps, 0.28 ms
// at 3.35 TB/s against 0.53 ms of multiplies).  Design, three launches:
//  - pass 1 (msm_win_partials): a block owns one window of one walk and
//    ppt * 128 steps.  The blocks per window come from the blocks the card
//    holds at once (occupancy query, 3 an SM at 156 registers), so the
//    pass runs in one wave, which sets ppt (161 steps a thread at 143,704
//    w5 steps, 342 at a pair of 2^17-step w4 walks).  A thread keeps its
//    sum in registers through inlined niels adds on the carry-chain
//    multiply (fe_mul_cc; no stack frame, no spills) and loads the next
//    entry during the current add; a shuffle tree in each warp, then one
//    over the 4 warps, sums the block (7 full adds, ~5% of the work);
//  - pass 2 (msm_win_windows): a warp per window sums its partials and
//    stores the total in niels form;
//  - pass 3 (msm_win_horner): a warp per walk folds the totals by Horner.
//    Its BITS * (WINDOWS - 1) doublings are one dependent chain; each
//    doubling or add is two stages of four independent operations, run on
//    the lanes of a group and exchanged by __shfl_sync: the doubling's
//    squares on one lane (fe_sq_cc), every multiply on two lanes
//    (fe_mul_split), so a stage costs about one multiply's latency.
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py / chip_profile.py
// --walkers): msm_win5 at 143,704 steps 1.78 ms (passes 1.44 + Horner
// 0.27) against 3.02 before this design; msm_win_pair at two 2^17-step
// walks 3.22 ms against 5.39; the Horner tail 0.27-0.28 ms a launch
// against 1.0.  Pass 1 runs at 2.7x its bound, held by the multiply's
// instruction mix: ~320 instructions a field multiply (~165 on the
// integer multiply pipe, ~155 adds and selects on the ALU pipe) against
// the bound's 146 multiplies, at 12 warps an SM.  The Horner tail is the
// latency of ~600 dependent stages (~0.44 us each).
// Tensor cores are not used: wgmma / IMMA take 8-bit integer operands, a
// 256-bit product would need carries across tile outputs, and each add is
// a dependent chain of 8 multiplies.
#include <cuda_runtime.h>
#include <cstdint>

#include "ge25519_cc.cuh"

#define TABLE_THREADS 128
#define WIN_THREADS 128               // pass 1: threads a block (4 warps)
#define WIN_WARPS (WIN_THREADS / 32)
#define WIN_MIN_BLOCKS 3              // pass 1 blocks an SM holds: <= 168 registers
#define WIN_WAVES 1                   // pass 1 blocks: about this many card-fulls
#define WIN_PPT_MIN 4                 // pass 1 steps a thread, at least

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

__device__ __forceinline__ fe fe_shfl(const fe& a, int lane) {
    fe r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = __shfl_sync(0xffffffffu, a.w[i], lane);
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

// Pass 1: block (b, win, s) sums, for walk s, the table entries that
// digit `win` selects at steps j = (b * ppt + k) * WIN_THREADS + t, k <
// ppt, of its threads t (code TBL is the digit -TBL: entry TBL negated;
// code 0 adds the identity).  The thread's sum is register-resident and
// the next entry's eight 16-byte loads are issued before the current add,
// the word two steps ahead before that (on the card this bought 2.5%:
// 1.777 against 1.823 ms at 143,704 w5 steps without it).  Partials are
// stored walk- then window-major: partials[(s * WINDOWS + win) *
// gridDim.x + b]; a block past its walk's end stores the identity.
template <int BITS>
__global__ void __launch_bounds__(WIN_THREADS, WIN_MIN_BLOCKS)
msm_win_partials(const int32_t* __restrict__ table, const int32_t* __restrict__ words,
                 int32_t* __restrict__ partials, walks2 g, int ppt) {
    using W = Win<BITS>;
    constexpr int PER = 32 / W::FIELD;
    constexpr uint32_t MASK = (1u << BITS) - 1u;
    __shared__ ge sh[WIN_WARPS];
    const int b = blockIdx.x;
    const int win = blockIdx.y;
    const int s = blockIdx.z;
    const walk w = g.s[s];
    const int shift = W::FIELD * (win % PER);
    const int32_t* wcol = words + (long long)W::WORDS * w.woff + win / PER;
    const long long j0 = (long long)b * ppt * WIN_THREADS + threadIdx.x;
    int cnt = 0;
    if (j0 < w.v) cnt = min(ppt, (int)((w.v - 1 - j0) / WIN_THREADS) + 1);

    auto code = [&](int k) -> uint32_t {
        const long long j = j0 + (long long)k * WIN_THREADS;
        return ((uint32_t)__ldg(wcol + W::WORDS * j) >> shift) & MASK;
    };
    auto fetch = [&](int k, uint32_t e) -> niels {
        if (e == 0u) return niels_identity();
        const uint32_t mag = e >= (uint32_t)W::TBL ? 2u * W::TBL - e : e;
        const long long j = j0 + (long long)k * WIN_THREADS;
        const long long row = j < w.split ? (long long)w.poff + j
                                          : (long long)w.poff2 + (j - w.split);
        return niels_load(table + 32ll * (row * W::TBL + (mag - 1)));
    };

    ge acc = ge_identity();
    uint32_t e = cnt > 0 ? code(0) : 0u;
    niels q = fetch(0, e);
    uint32_t e2 = cnt > 1 ? code(1) : 0u;
#pragma unroll 1
    for (int k = 0; k < cnt; ++k) {
        const niels cur = q;
        const bool neg = e >= (uint32_t)W::TBL;
        e = e2;
        if (k + 1 < cnt) q = fetch(k + 1, e);
        if (k + 2 < cnt) e2 = code(k + 2);
        acc = ge_add_niels_cc(acc, cur, neg);
    }
    if (tree_sum<WIN_WARPS>(acc, sh))
        ge_store_raw(partials + 32ll * (((long long)s * W::WINDOWS + win) * gridDim.x + b), acc);
}

// Pass 2: warp (win, s) sums that window's nb partials (lane-strided,
// then a shuffle tree) into wtot[s * WINDOWS + win], stored in niels form
// (Y+X, Y-X, 2d*T, Z) for the Horner pass.
template <int BITS>
__global__ void __launch_bounds__(32)
msm_win_windows(const int32_t* __restrict__ partials, int32_t* __restrict__ wtot, int nb) {
    const long long row = (long long)blockIdx.y * Win<BITS>::WINDOWS + blockIdx.x;
    ge v = ge_identity();
#pragma unroll 1
    for (int j = threadIdx.x; j < nb; j += 32)
        v = ge_add_cc(v, ge_load(partials + 32ll * (row * nb + j)));
    if (tree_sum<1>(v, nullptr)) {
        int32_t* dst = wtot + 32 * row;
        fe_store_raw(dst, fe_add(v.Y, v.X));
        fe_store_raw(dst + 8, fe_sub(v.Y, v.X));
        fe_store_raw(dst + 16, fe_mul_cc(v.T, fe_d2()));
        fe_store_raw(dst + 24, v.Z);
    }
}

// ---- the cooperative Horner: a warp per walk, lane 8g + 4h + q.  The
// four independent operations q of each stage of a point operation run in
// each group g of 8 lanes (the warp's four groups repeat the work), a
// multiply on its two lanes h, a square on lane h = 0's; the products are
// exchanged with __shfl_sync.  Every lane holds the whole point between
// stages.

// Rows 4h .. 4h + 3 of a * b on each of two lanes (h = 0, 1; partners
// 4 lanes apart), the upper rows' 12 words passed down by a shuffle and
// added 4 words up: the product, reduced, on the h = 0 lane.
__device__ __forceinline__ fe fe_mul_split(const fe& a, const fe& b, int h) {
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = h ? a.w[4 + i] : a.w[i];
    uint32_t t[12];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = x[0] * b.w[j];
    t[1] = ptx::mad_hi_cc(x[0], b.w[0], t[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j) t[j + 1] = ptx::madc_hi_cc(x[0], b.w[j], t[j + 1]);
    t[8] = ptx::madc_hi(x[0], b.w[7], 0u);
#pragma unroll
    for (int i = 1; i < 4; ++i) {
        t[i] = ptx::mad_lo_cc(x[i], b.w[0], t[i]);
#pragma unroll
        for (int j = 1; j < 8; ++j) t[i + j] = ptx::madc_lo_cc(x[i], b.w[j], t[i + j]);
        t[i + 8] = ptx::carry();
        t[i + 1] = ptx::mad_hi_cc(x[i], b.w[0], t[i + 1]);
#pragma unroll
        for (int j = 1; j < 7; ++j) t[i + j + 1] = ptx::madc_hi_cc(x[i], b.w[j], t[i + j + 1]);
        t[i + 8] = ptx::madc_hi(x[i], b.w[7], t[i + 8]);
    }
    uint32_t u[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) u[k] = __shfl_xor_sync(0xffffffffu, t[k], 4);
    uint32_t s[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = t[k];
    s[4] = ptx::add_cc(t[4], u[0]);
#pragma unroll
    for (int k = 5; k < 12; ++k) s[k] = ptx::addc_cc(t[k], u[k - 4]);
#pragma unroll
    for (int k = 12; k < 15; ++k) s[k] = ptx::addc_cc(u[k - 4], 0u);
    s[15] = u[11] + ptx::carry();
    return fe_reduce_cc(s);
}

// Stage 2 of a doubling or an add: lane q forms product q of (E F, G H,
// F G, E H) = (X, Y, Z, T); T is gathered only if a later add reads it.
__device__ __forceinline__ ge coop_stage2(const fe& E, const fe& F, const fe& G,
                                          const fe& H, int q, int h, int base,
                                          bool with_t) {
    const fe l = fe_select(q == 0 || q == 3, E, fe_select(q == 1, G, F));
    const fe r = fe_select(q == 0, F, fe_select(q == 2, G, H));
    const fe p = fe_mul_split(l, r, h);
    ge o;
    o.X = fe_shfl(p, base);
    o.Y = fe_shfl(p, base + 1);
    o.Z = fe_shfl(p, base + 2);
    o.T = with_t ? fe_shfl(p, base + 3) : fe_zero();
    return o;
}

// 2p (dbl-2008-hwcd): lane q squares X, Y, Z or X + Y
__device__ __forceinline__ ge coop_double(const ge& p, int q, int h, int base, bool with_t) {
    const fe xy = fe_add(p.X, p.Y);
    const fe l = fe_select(q == 0, p.X, fe_select(q == 1, p.Y, fe_select(q == 2, p.Z, xy)));
    const fe sq = fe_sq_cc(l);
    const fe A = fe_shfl(sq, base);
    const fe B = fe_shfl(sq, base + 1);
    const fe Zs = fe_shfl(sq, base + 2);
    const fe S = fe_shfl(sq, base + 3);
    const fe C = fe_add(Zs, Zs);
    const fe H = fe_add(A, B);
    const fe E = fe_sub(H, S);
    const fe G = fe_sub(A, B);
    const fe F = fe_add(C, G);
    return coop_stage2(E, F, G, H, q, h, base, with_t);
}

// p + a point in niels form, of which lane q holds the one coordinate it
// multiplies: (Y-X, Y+X, 2dT, Z)[q] against p's (Y-X, Y+X, T, Z)[q]
__device__ __forceinline__ ge coop_add_niels(const ge& p, const fe& mine, int q, int h,
                                             int base) {
    const fe l = fe_select(q == 0, fe_sub(p.Y, p.X),
                           fe_select(q == 1, fe_add(p.Y, p.X), fe_select(q == 2, p.T, p.Z)));
    const fe m = fe_mul_split(l, mine, h);
    const fe A = fe_shfl(m, base);
    const fe B = fe_shfl(m, base + 1);
    const fe C = fe_shfl(m, base + 2);
    const fe Dz = fe_shfl(m, base + 3);
    const fe Dv = fe_add(Dz, Dz);
    return coop_stage2(fe_sub(B, A), fe_sub(Dv, C), fe_add(Dv, C), fe_add(B, A), q, h, base,
                       true);
}

// Pass 3 (warp s folds walk s): Horner over the walk's window totals,
// most significant first, BITS doublings between windows (the first
// BITS - 1 of them leave T out), then the walk's chain:
// out[s] = chain[s] + sum_win 2^(BITS * win) * wtot[s][win].
template <int BITS>
__global__ void __launch_bounds__(32)
msm_win_horner(const int32_t* __restrict__ wtot, const int32_t* __restrict__ chain,
               int32_t* __restrict__ out) {
    constexpr int WINDOWS = Win<BITS>::WINDOWS;
    __shared__ uint32_t tot[WINDOWS * 32];
    const int s = blockIdx.x;
    const int q = threadIdx.x & 3;
    const int h = (threadIdx.x >> 2) & 1;
    const int base = threadIdx.x & ~7;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(wtot) + 32 * WINDOWS * s;
#pragma unroll 1
    for (int i = threadIdx.x; i < WINDOWS * 32; i += 32) tot[i] = src[i];
    __syncwarp();
    // lane q's coordinate of a niels entry: Y-X, Y+X, 2dT, Z
    const int field = q == 0 ? 1 : q == 1 ? 0 : q;
    ge acc = ge_identity();
#pragma unroll 1
    for (int win = WINDOWS - 1; win >= 0; --win) {
        if (win < WINDOWS - 1) {
#pragma unroll 1
            for (int d = 0; d < BITS; ++d) acc = coop_double(acc, q, h, base, d == BITS - 1);
        }
        fe mine;
#pragma unroll
        for (int i = 0; i < 8; ++i) mine.w[i] = tot[32 * win + 8 * field + i];
        acc = coop_add_niels(acc, mine, q, h, base);
    }
    const ge c = ge_load(chain + 32 * s);
    fe mine = fe_select(q == 0, fe_sub(c.Y, c.X), fe_select(q == 1, fe_add(c.Y, c.X), c.Z));
    if (q == 2) mine = fe_mul_cc(c.T, fe_d2());
    acc = coop_add_niels(acc, mine, q, h, base);
    if (threadIdx.x == 0) ge_store(out + 32 * s, acc);
}

// Pass 1's geometry for walks of at most vmax steps: nb blocks per window
// and walk, ppt steps per thread, nb about WIN_WAVES times the blocks the
// card holds at once over walks x WINDOWS, at most walk_blocks(vmax).
static int walk_blocks(int vmax) {
    return (vmax + WIN_PPT_MIN * WIN_THREADS - 1) / (WIN_PPT_MIN * WIN_THREADS);
}

template <int BITS>
static void win_geometry(int vmax, int walks, int* nb, int* ppt) {
    static int held[64];  // pass 1 blocks the card holds, by device (0: not asked)
    int dev = 0;
    cudaGetDevice(&dev);
    int card = dev >= 0 && dev < 64 ? held[dev] : 0;
    if (card == 0) {
        int sms = 1, per_sm = 1;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, msm_win_partials<BITS>,
                                                      WIN_THREADS, 0);
        card = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
        if (dev >= 0 && dev < 64) held[dev] = card;
    }
    long long want = (long long)WIN_WAVES * card / (walks * Win<BITS>::WINDOWS);
    int most = walk_blocks(vmax);
    int n = (int)(want < most ? want : most);
    n = n > 1 ? n : 1;
    *ppt = (vmax + n * WIN_THREADS - 1) / (n * WIN_THREADS);
    *nb = *ppt > 0 ? (vmax + *ppt * WIN_THREADS - 1) / (*ppt * WIN_THREADS) : 1;
}

// The three passes over `walks` (1 or 2) walks.
template <int BITS>
static int msm_win_launch(const int32_t* table, const int32_t* words, const int32_t* chain,
                          int32_t* out, int32_t* partials, int32_t* wtot, walks2 g,
                          int walks, cudaStream_t s) {
    constexpr int WINDOWS = Win<BITS>::WINDOWS;
    int vmax = 0;
    for (int k = 0; k < walks; ++k) vmax = g.s[k].v > vmax ? g.s[k].v : vmax;
    int nb = 1, ppt = 0;
    win_geometry<BITS>(vmax, walks, &nb, &ppt);
    msm_win_partials<BITS><<<dim3(nb, WINDOWS, walks), WIN_THREADS, 0, s>>>(
        table, words, partials, g, ppt);
    msm_win_windows<BITS><<<dim3(WINDOWS, walks), 32, 0, s>>>(partials, wtot, nb);
    msm_win_horner<BITS><<<walks, 32, 0, s>>>(wtot, chain, out);
    return (int)cudaGetLastError();
}

// ---- the windowed w4 MSM (msm_w4, msm_w4_pair; msm_grid and
// msm_grid_local launch msm_w4's entry over a view).  It replaces
// pallas_curve.py's msm_chunk_acc_w4 (:369) and msm_grid_pair (:768)
// (and msm_grid_acc :438, msm_grid_local :487: the same body): out = acc
// + sum_i d_i P_i over signed w4 words, for the pair over two segments
// with their own accumulators.  What bounds it on an H100: 32-bit integer
// multiplies (per point a 7-operation table and ~60 niels adds, 160 B
// read), and at the main path's 1,024-4,096 points the latency of the
// passes, which cannot fill 132 SMs.  The first version ran one
// 64-window ladder per point on one thread (~330 point operations, out
// of line, its table in local memory): 1.446 ms at the 4,096-point frozen
// pack against a bound of 0.093.  Design: windows, then Horner.  Pass 1
// (msm_w4_tiles) gives each block tiles of 16 or 64 points (by the size
// and the card); it builds their eight multiples in niels form in shared
// memory (two threads a point) and then each thread sums one window's
// selected entries over half a tile in registers, through the walkers'
// inlined niels add; per point that is 7 table operations and <= 64
// niels adds, and the card gets 64 independent sums per block in place
// of serial ladders.  The walkers' pass 2 (msm_win_windows<4>) and
// cooperative Horner (msm_win_horner<4>) finish, with the incoming
// accumulators as the chains.  The kernel lives here, not in
// msm_fold.cu, because passes 2-3 are this file's templates; the point
// operations it shares with the walkers and the fold are
// ge25519_cc.cuh's.  Measured (NVIDIA H100 80GB
// HBM3, 700.00 W; chip_profile.py --kernels, parent and this design in
// turns): the frozen pack 1.43 -> 0.43 ms, of which the Horner tail is
// 0.28 (the floor at the main path's sizes); msm_w4 at 2,048 / 1,024
// points 1.28 / 1.27 -> 0.41 / 0.40, at 2^14 1.45 -> 0.58; msm_grid at
// 143,704 9.6 -> 2.4 (bound 0.67); msm_grid_local at 65,536 4.6 -> 1.4.
// The 64-point tile took msm_grid from 2.9 to 2.4 ms and cost the frozen
// pack 0.49 against 0.43 ms, hence the choice by size.
#define W4_THREADS (2 * Win<4>::WINDOWS)    // pass 1: two threads a window
#define W4_MIN_BLOCKS 3                     // pass 1 blocks an SM holds: <= 168 registers
#define W4_STRIDE (32 * Win<4>::TBL + 1)    // shared words of one point's table
#define W4_TILES 2                          // pass 1's tiles: 16 and 64 points

// One segment of an MSM: points (and word rows) [off, off + n).
struct seg {
    int n, off;
};

struct segs2 {
    seg s[2];
};

// A point's table in shared memory: word j (8c + i: word i of niels
// coordinate c) of entry k at t[8 j + k].  A warp reads one point's
// entries (its threads are windows), which sit in 8 consecutive banks for
// each word; the tables of consecutive points start one bank apart (the
// stride's +1), so a warp of table threads (one point each) stores
// without conflicts.
__device__ __forceinline__ void w4_put(uint32_t* t, int k, const niels& q) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        t[8 * i + k] = q.ypx.w[i];
        t[8 * (8 + i) + k] = q.ymx.w[i];
        t[8 * (16 + i) + k] = q.t2d.w[i];
        t[8 * (24 + i) + k] = q.z.w[i];
    }
}

__device__ __forceinline__ niels w4_get(const uint32_t* t, int k) {
    niels q;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        q.ypx.w[i] = t[8 * i + k];
        q.ymx.w[i] = t[8 * (8 + i) + k];
        q.t2d.w[i] = t[8 * (16 + i) + k];
        q.z.w[i] = t[8 * (24 + i) + k];
    }
    return q;
}

// The multiples (k + 1) P, k = 0..7, of the point at src into its shared
// table in niels form, by two threads (role 0 and 1, in different warps,
// so no warp diverges): both double P; role 0 then makes 4P, 5P = 4P + P
// and 8P (entries 1: 2P, 3, 4, 7), role 1 3P = 2P + P, 6P and 7P = 6P + P
// (entries 0: P, 2, 5, 6).  Each role's four steps are one loop with one
// doubling site and one add site.
__device__ __forceinline__ void w4_table(const int32_t* src, uint32_t* t, int role) {
    const niels nP = ge_to_niels_cc(ge_load(src));
    if (role) w4_put(t, 0, nP);
    ge x = ge_load(src);
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
        ge y;
        if (role ? (k & 1) : k == 2) y = ge_add_niels_cc(x, nP, false);
        else y = ge_double_cc(x, true);
        const int entry = role ? (k == 1 ? 2 : k == 2 ? 5 : 6)
                               : (k == 0 ? 1 : k == 1 ? 3 : k == 2 ? 4 : 7);
        if (!role || k > 0) w4_put(t, entry, ge_to_niels_cc(y));
        if (role || k != 2) x = y;
    }
}

// Pass 1: block (b, s) takes tiles b, b + nb, ... (at most ppt) of
// segment s, TILE points each.  Per tile it loads the word rows and
// builds every live point's eight multiples into shared memory (two
// threads a point: roles in different warps); then thread t adds, for
// window t % 64, the entries its digits select over its half of the
// tile's points (digit code e, e >= 8 the digit e - 16: entry 16 - e
// negated; code 0 adds nothing), into a register-resident sum through the
// inlined niels add.  After its tiles the two halves' sums of each window
// are added, and the block stores one partial per window, walk- then
// window-major: partials[(s * 64 + win) * nb + b], the layout
// msm_win_windows<4> reads.  A block with no tile stores the identity.
template <int TILE>
__global__ void __launch_bounds__(W4_THREADS, W4_MIN_BLOCKS)
msm_w4_tiles(const int32_t* __restrict__ pts, const int32_t* __restrict__ words,
             int32_t* __restrict__ partials, segs2 g, int ppt) {
    constexpr int WINDOWS = Win<4>::WINDOWS;
    constexpr int SPAN = TILE < 32 ? 32 : TILE;  // table threads of one role
    static_assert(TILE % 2 == 0 && 2 * SPAN <= W4_THREADS, "two table threads a point");
    extern __shared__ uint32_t smem[];
    uint32_t* tbl = smem;
    uint32_t* wsh = smem + TILE * W4_STRIDE;
    const int b = blockIdx.x;
    const int s = blockIdx.y;
    const seg sg = g.s[s];
    const int t = threadIdx.x;
    const int win = t % WINDOWS;
    const int half = t / WINDOWS;
    const int tiles = (sg.n + TILE - 1) / TILE;
    ge acc = ge_identity();
#pragma unroll 1
    for (int k = 0; k < ppt; ++k) {
        const int tile = b + k * gridDim.x;
        if (tile >= tiles) break;
        const int base = tile * TILE;
        const int cnt = min(TILE, sg.n - base);
        const long long row0 = (long long)sg.off + base;
        __syncthreads();  // the last tile's tables are read
#pragma unroll 1
        for (int j = t; j < 8 * TILE; j += W4_THREADS)
            wsh[j] = (j >> 3) < cnt ? (uint32_t)__ldg(words + 8 * row0 + j) : 0u;
        __syncthreads();
        const int p = t % SPAN;
        if (t < 2 * SPAN && p < cnt && !fe_is_zero_words(wsh + 8 * p))
            w4_table(pts + 32 * (row0 + p), tbl + p * W4_STRIDE, t / SPAN);
        __syncthreads();
#pragma unroll 1
        for (int i = 0; i < TILE / 2; ++i) {
            const int q = half * (TILE / 2) + i;
            const uint32_t e = (wsh[8 * q + (win >> 3)] >> (4 * (win & 7))) & 15u;
            if (e) {
                const bool neg = e >= 8u;  // e = 8 is the digit -8: entry 8P negated
                acc = ge_add_niels_cc(acc, w4_get(tbl + q * W4_STRIDE, (neg ? 16 - e : e) - 1),
                                      neg);
            }
        }
    }
    __syncthreads();  // the tables are read: their space takes the halves' sums
    ge* sh = reinterpret_cast<ge*>(smem);
    if (half) sh[win] = acc;
    __syncthreads();
    if (!half)
        ge_store_raw(partials + 32ll * (((long long)s * WINDOWS + win) * gridDim.x + b),
                     ge_add_cc(acc, sh[win]));
}

// Pass 1's tile k: its points, its shared memory (tables and words) and
// its kernel.
static const int W4_TILE_POINTS[W4_TILES] = {16, 64};

static size_t w4_smem(int k) {
    return sizeof(uint32_t) * W4_TILE_POINTS[k] * (W4_STRIDE + 8);
}

static void (*const W4_KERNELS[W4_TILES])(const int32_t*, const int32_t*, int32_t*, segs2,
                                          int) = {msm_w4_tiles<16>, msm_w4_tiles<64>};

// Pass 1's geometry for `walks` segments of at most vmax points on the
// current device: the tile (W4_TILE_POINTS[*k]), nb blocks a segment and ppt
// tiles a block, nb at most the blocks the card holds at once (occupancy
// query) over the segments, so the pass runs in one wave.  The tile is
// the small one while its tiles fit that wave one a block (at the main
// path's 1,024-4,096 points the pass is latency: a small tile is a short
// chain), else the large one (a full card is throughput: a large tile
// spends less on tables, syncs and partials).  The first query on a
// device also allows the 64-point tile's dynamic shared memory (above
// 48 KB); a launch it would not allow fails.
static void w4_geometry(int vmax, int walks, int* k, int* nb, int* ppt) {
    static int held[64][W4_TILES];  // pass 1 blocks the card holds (0: not asked)
    int dev = 0;
    cudaGetDevice(&dev);
    const bool cached = dev >= 0 && dev < 64;
    int card[W4_TILES];
    for (int j = 0; j < W4_TILES; ++j) {
        card[j] = cached ? held[dev][j] : 0;
        if (card[j] == 0) {
            const size_t smem = w4_smem(j);
            if (smem > 48 * 1024)
                cudaFuncSetAttribute(W4_KERNELS[j],
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            int sms = 1, per_sm = 1;
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, W4_KERNELS[j], W4_THREADS,
                                                          smem);
            card[j] = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
            if (cached) held[dev][j] = card[j];
        }
    }
    const int j = (vmax + W4_TILE_POINTS[0] - 1) / W4_TILE_POINTS[0] > card[0] / walks;
    const int tiles = (vmax + W4_TILE_POINTS[j] - 1) / W4_TILE_POINTS[j];
    int n = card[j] / walks < tiles ? card[j] / walks : tiles;
    n = n > 1 ? n : 1;
    *k = j;
    *ppt = (tiles + n - 1) / n;
    *nb = *ppt > 0 ? (tiles + *ppt - 1) / *ppt : 1;
}

// The three passes over `walks` (1 or 2) segments: out[s] = chain[s] +
// sum over segment s.
static int msm_w4_launch(const int32_t* pts, const int32_t* words, const int32_t* chain,
                         int32_t* out, int32_t* partials, int32_t* wtot, segs2 g, int walks,
                         cudaStream_t s) {
    constexpr int WINDOWS = Win<4>::WINDOWS;
    int vmax = 0;
    for (int k = 0; k < walks; ++k) vmax = g.s[k].n > vmax ? g.s[k].n : vmax;
    int k = 0, nb = 1, ppt = 0;
    w4_geometry(vmax, walks, &k, &nb, &ppt);
    W4_KERNELS[k]<<<dim3(nb, walks), W4_THREADS, w4_smem(k), s>>>(pts, words, partials, g,
                                                                   ppt);
    msm_win_windows<4><<<dim3(WINDOWS, walks), 32, 0, s>>>(partials, wtot, nb);
    msm_win_horner<4><<<walks, 32, 0, s>>>(wtot, chain, out);
    return (int)cudaGetLastError();
}

template <int TBL>
static int table_launch(const int32_t* pts, int32_t* table, int n, cudaStream_t s) {
    if (n > 0)
        table_kernel<TBL><<<(n + TABLE_THREADS - 1) / TABLE_THREADS, TABLE_THREADS, 0, s>>>(
            pts, table, n);
    return (int)cudaGetLastError();
}

// out[i] = a[i] * b[i] (OP 0: fe_mul, 1: fe_mul_cc) or a[i]^2 (2: fe_sq,
// 3: fe_sq_cc), repeated `reps` times on the result, canonical: holds
// the carry-chain multiply and squaring against fe_mul and times them.
template <int OP>
__global__ void __launch_bounds__(128)
fe_mul_test(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
            int32_t* __restrict__ out, int n, int reps) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fe x = fe_load_vec(a + 8 * i);
    const fe y = fe_load_vec(b + 8 * i);
#pragma unroll 1
    for (int r = 0; r < reps; ++r)
        x = OP == 0 ? fe_mul(x, y) : OP == 1 ? fe_mul_cc(x, y) : OP == 2 ? fe_sq(x) : fe_sq_cc(x);
    fe_store_canon(out + 8 * i, x);
}

extern "C" {

// Scratch points the walk passes need for `walks` walks of at most vmax
// steps at BITS 5 or 4 (pass 1's partials; pass 2's window totals are
// walks * WINDOWS more, from bp_win5_windows / bp_win4_windows).
int bp_win_partials(int vmax, int walks, int bits) {
    const int windows = bits == 5 ? Win<5>::WINDOWS : Win<4>::WINDOWS;
    int nb = walk_blocks(vmax);
    return walks * windows * (nb > 1 ? nb : 1);
}

// The windowed w4 MSM's first pass on the current device for `walks`
// segments of at most vmax points: its tile (points), and the scratch
// points it needs (pass 2's window totals are walks * 64 more, from
// bp_win4_windows).
int bp_w4_tile(int vmax, int walks) {
    int k = 0, nb = 1, ppt = 0;
    w4_geometry(vmax, walks, &k, &nb, &ppt);
    return W4_TILE_POINTS[k];
}

int bp_w4_partials(int vmax, int walks) {
    int k = 0, nb = 1, ppt = 0;
    w4_geometry(vmax, walks, &k, &nb, &ppt);
    return walks * Win<4>::WINDOWS * nb;
}

// Chained MSM: out (1, 4, 8) = acc + sum_{i < n} d_i * P_i (w4 words).
// partials: bp_w4_partials(n, 1) points of scratch; wtot: 64 points.
int bp_msm_w4(const int32_t* pts, const int32_t* words, const int32_t* acc, int32_t* out,
              int32_t* partials, int32_t* wtot, int n, void* stream) {
    segs2 g;
    g.s[0] = seg{n, 0};
    g.s[1] = g.s[0];
    return msm_w4_launch(pts, words, acc, out, partials, wtot, g, 1, (cudaStream_t)stream);
}

// Two chained MSMs in one launch set: out[0] = acc2[0] + sum over points
// [0, lo_n), out[1] = acc2[1] + sum over [half, half + hi_n).  partials:
// bp_w4_partials(max(lo_n, hi_n), 2) points of scratch; wtot: 2 * 64.
int bp_msm_w4_pair(const int32_t* pts, const int32_t* words, const int32_t* acc2,
                   int32_t* out, int32_t* partials, int32_t* wtot, int half, int lo_n,
                   int hi_n, void* stream) {
    segs2 g;
    g.s[0] = seg{lo_n, 0};
    g.s[1] = seg{hi_n, half};
    return msm_w4_launch(pts, words, acc2, out, partials, wtot, g, 2, (cudaStream_t)stream);
}

int bp_win5_windows(void) { return Win<5>::WINDOWS; }

int bp_win4_windows(void) { return Win<4>::WINDOWS; }

int bp_table_w5(const int32_t* pts, int32_t* table, int n, void* stream) {
    return table_launch<Win<5>::TBL>(pts, table, n, (cudaStream_t)stream);
}

int bp_table_w4(const int32_t* pts, int32_t* table, int n, void* stream) {
    return table_launch<Win<4>::TBL>(pts, table, n, (cudaStream_t)stream);
}

// out (1, 4, 8) = chain + sum_{j < v} d_j * P_row(j) (see msm_win_partials).
// partials: bp_win_partials(v, 1, 5) points of scratch; wtot: 51 points.
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
// bp_win_partials(v, 1, 4) points of scratch; wtot: 64 points.
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
// of a combined IPP round).  partials: bp_win_partials(max v, 2, 4)
// points of scratch; wtot: 2 * 64 points.
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

// The test entry of the carry-chain multiply and squaring: out (n, 8) =
// fe_mul_test<op>(a, b) over (n, 8) words, `reps` products deep.
int bp_fe_mul_test(const int32_t* a, const int32_t* b, int32_t* out, int n, int op,
                   int reps, void* stream) {
    if (n > 0) {
        const int blocks = (n + 127) / 128;
        cudaStream_t s = (cudaStream_t)stream;
        if (op == 0) fe_mul_test<0><<<blocks, 128, 0, s>>>(a, b, out, n, reps);
        else if (op == 1) fe_mul_test<1><<<blocks, 128, 0, s>>>(a, b, out, n, reps);
        else if (op == 2) fe_mul_test<2><<<blocks, 128, 0, s>>>(a, b, out, n, reps);
        else if (op == 3) fe_mul_test<3><<<blocks, 128, 0, s>>>(a, b, out, n, reps);
        else return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
