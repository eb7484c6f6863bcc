// Hopper kernels for the window walkers: the niels multiple tables
// (table_w5: 16 entries over the fixed generators; table_w4: 8 entries
// over the combined [G|H] layout of IPP rounds 2+) and the window-
// accumulator MSMs that walk them (msm_win5: one walk over a w5 table;
// msm_win: one walk over a w4 table; msm_win_pair: a combined round's L
// and R walks over a w4 table in one launch).  One kernel template each,
// instantiated per digit width.  Beside them the windowed w4 MSM
// (msm_w4, msm_w4_pair, msm_lane, and over bit words the device-oracle
// path's msm_chunk_acc and msm_block_totals; see "the windowed w4 MSM"
// below), which builds its tables in shared memory and ends in the
// walkers' passes 2 and 3.
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

#define TABLE_THREADS 256             // tables: two roles of TABLE_THREADS / 64 warps
#define TABLE_STRIDE 33               // tables: staged words of one entry
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

// ---- the niels multiple tables (table_w4, table_w5).  They replace
// pallas_curve.py's table_grid_full / _half / _donate (:1012-1026) and
// table_grid5_full (:1233).  Entry k of point i is (k + 1) P_i, made by
// the TPU kernels' sequence (2P = dbl P, odd multiples t(k-1) + P, even
// ones doubled from t(k/2)) and stored in niels form with canonical
// words, so the words equal the plain version's (the carry-chain
// operations compute the plain version's residues).  What
// bounds it on an H100: the 32-bit multiplies of ~TBL point operations a
// point (0.13 ms at 2^18 w4 points against 0.09 ms for its 302 MB of
// stores).  Design: two threads a point, four warps a role, 128 points a block;
// each role runs TBL / 2 inlined carry-chain operations (TBL_SCHED) and keeps
// only the points a later step reads (x and one saved point); each step's
// entry goes to shared memory and the warp stores its 32 entries as
// 16-byte vectors, eight lanes to an entry's 128 contiguous bytes.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_profile.py --kernels):
// fewer resident warps ran faster.  At 2^18 w4 points, 168 registers
// (12 warps an SM, blocks of 64) took 0.56-0.57 ms, 170 (10 warps) 0.51,
// blocks of 128 (8 warps) 0.51, of 256 (one block, 8 warps, 175
// registers) 0.48; role 1 taking 2P from role 0 through shared memory
// (one doubling less a point, a block barrier) 0.59.  Blocks of 256 are
// kept.
#define T_ADD 0x10u   // the step adds P to x (else doubles x)
#define T_SAVE 0x20u  // then saved = the result (else x = the result) ...
#define T_DROP 0x40u  // ... or the result is dropped ...
#define T_BACK 0x60u  // ... or dropped and x = saved
#define T_KEEP_MASK 0x60u

// Step k of role r (low 4 bits: the entry it stores).  Role 0: 2P, 4P,
// 5P (saved), 8P, 9P, 16P (back to 5P), 10P, 11P; role 1: 2P (storing P,
// which no step makes), 3P, 6P, 7P (saved), 12P, 13P (back to 7P), 14P,
// 15P.  The 8-entry tables (table_w4, msm_w4_tiles' w4_table) run the
// first four steps of each role.
static __device__ __constant__ uint8_t TBL_SCHED[2][8] = {
    {1, 3, 4 | T_ADD | T_SAVE, 7, 8 | T_ADD | T_DROP, 15 | T_BACK, 9, 10 | T_ADD | T_DROP},
    {0, 2 | T_ADD, 5, 6 | T_ADD | T_SAVE, 11, 12 | T_ADD | T_BACK, 13, 14 | T_ADD | T_DROP},
};

// Step k of `role` on x (P at the start, nP its niels form; SAVES: the
// 16-entry steps, which keep a second point): x's double or x + P, kept as
// TBL_SCHED says; returns entry TBL_SCHED[role][k] & 15 in niels form
// (role 1's first step stores P, which no step makes).
template <bool SAVES>
__device__ __forceinline__ niels tbl_step(int role, int k, const niels& nP, ge& x, ge& saved) {
    const uint32_t op = TBL_SCHED[role][k];
    ge y;
    if (op & T_ADD) y = ge_add_niels_cc(x, nP, false);
    else y = ge_double_cc(x, true);
    const uint32_t keep = op & T_KEEP_MASK;
    if (keep == 0u) x = y;
    else if (SAVES && keep == T_SAVE) saved = y;
    else if (SAVES && keep == T_BACK) x = saved;
    return role == 1 && k == 0 ? nP : ge_to_niels_cc(y);
}

// Block b: R = TABLE_THREADS / 64 warps a role, points [32 R b, 32 R (b +
// 1)); lane l of warp w runs role w / R for point 32 (R b + w % R) + l
// (lanes past n repeat the last point and store nothing).
// A step's entries are staged at TABLE_STRIDE words a lane (+1: the
// lanes' words fall in distinct banks) and stored by the warp: round r,
// lane l writes 16 bytes, part l % 8 of the entry of point 4 r + l / 8.
template <int TBL>
__global__ void __launch_bounds__(TABLE_THREADS)
table_kernel(const int32_t* __restrict__ pts, int32_t* __restrict__ table, int n) {
    __shared__ uint32_t stage[TABLE_THREADS * TABLE_STRIDE];
    constexpr int R = TABLE_THREADS / 64;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int role = warp / R;
    const long long first = ((long long)blockIdx.x * R + warp % R) * 32;
    const int cnt = (int)max(0ll, min(32ll, (long long)n - first));
    const ge P = ge_load(pts + 32 * (cnt ? first + min(lane, cnt - 1) : n - 1));
    const niels nP = ge_to_niels_cc(P);
    uint32_t* st = stage + warp * 32 * TABLE_STRIDE;
    ge x = P, saved = P;
#pragma unroll 1
    for (int k = 0; k < TBL / 2; ++k) {
        const niels e = tbl_step<(TBL > 8)>(role, k, nP, x, saved);
        fe_store_canon(reinterpret_cast<int32_t*>(st + lane * TABLE_STRIDE), e.ypx);
        fe_store_canon(reinterpret_cast<int32_t*>(st + lane * TABLE_STRIDE + 8), e.ymx);
        fe_store_canon(reinterpret_cast<int32_t*>(st + lane * TABLE_STRIDE + 16), e.t2d);
        fe_store_canon(reinterpret_cast<int32_t*>(st + lane * TABLE_STRIDE + 24), e.z);
        __syncwarp();
        int32_t* dst = table + 32ll * (first * TBL + (TBL_SCHED[role][k] & 15u));
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int j = 4 * r + (lane >> 3);
            const int part = lane & 7;
            if (j < cnt) {
                const uint32_t* src = st + j * TABLE_STRIDE + 4 * part;
                *reinterpret_cast<uint4*>(dst + 32ll * TBL * j + 4 * part) =
                    make_uint4(src[0], src[1], src[2], src[3]);
            }
        }
        __syncwarp();
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

// Pass 3 (warp s folds walk s): Horner over the walk's window totals,
// most significant first, BITS doublings between windows (the first
// BITS - 1 of them leave T out), then the walk's chain:
// out[s] = chain[s] + sum_win 2^(BITS * win) * wtot[s][win].  A null
// chain is the identity (msm_lane's totals): nothing is added.
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
    if (chain != nullptr) {
        const ge c = ge_load(chain + 32 * s);
        fe mine = fe_select(q == 0, fe_sub(c.Y, c.X), fe_select(q == 1, fe_add(c.Y, c.X), c.Z));
        if (q == 2) mine = fe_mul_cc(c.T, fe_d2());
        acc = coop_add_niels(acc, mine, q, h, base);
    }
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

// ---- the windowed w4 MSM (msm_w4, msm_w4_pair, msm_lane; msm_grid and
// msm_grid_local launch msm_w4's entry over a view).  It replaces
// pallas_curve.py's msm_chunk_acc_w4 (:369), msm_grid_pair (:768) and
// msm_lane_dyn (:1515) (and msm_grid_acc :438, msm_grid_local :487: the
// same body): out = acc + sum_i d_i P_i over signed w4 words, for the
// pair over two segments with their own accumulators, for msm_lane over
// v uniform segments with none.  What bounds it on an H100: 32-bit
// integer multiplies (per point a 7-operation table and ~60 niels adds,
// 160 B read), and at the main path's 1,024-4,096 points the latency of
// the passes, which cannot fill 132 SMs.  Design: windows, then Horner.  Pass 1
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

// The segments of one launch: segment s holds min(n[min(s, 1)], total -
// s * stride) points (and word rows) from row s * stride.  One MSM
// (msm_w4, msm_chunk_acc): {n, n}, 0, n; the pair (msm_w4_pair): {lo_n,
// hi_n}, half, 2 half; v uniform segments (msm_lane): {seg, seg}, seg,
// v seg; the block totals (msm_block_totals): {2048, 2048}, 2048, n, the
// last segment ragged.
struct segs {
    int n[2];
    int stride;
    int total;
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
// so no warp diverges): the first four steps of each role of TBL_SCHED.
__device__ __forceinline__ void w4_table(const int32_t* src, uint32_t* t, int role) {
    ge x = ge_load(src), saved;
    const niels nP = ge_to_niels_cc(x);
#pragma unroll 1
    for (int k = 0; k < 4; ++k)
        w4_put(t, TBL_SCHED[role][k] & 15u, tbl_step<false>(role, k, nP, x, saved));
}

// Pass 1: block (b, s) takes tiles b, b + nb, ... (at most ppt) of
// segment s, TILE points each.  Per tile it loads the word rows (signed
// w4 words; with BITS, raw bit words, which one thread a row recodes into
// w4 digit codes as it loads them: fold_recode, a zero row stays zero; a
// template flag, so the w4 words' kernels stay as they were) and builds
// every live point's eight multiples into shared memory (two
// threads a point: roles in different warps); then thread t adds, for
// window t % 64, the entries its digits select over its half of the
// tile's points (digit code e, e >= 8 the digit e - 16: entry 16 - e
// negated; code 0 adds nothing), into a register-resident sum through the
// inlined niels add.  After its tiles the two halves' sums of each window
// are added, and the block stores one partial per window, walk- then
// window-major: partials[(s * 64 + win) * nb + b], the layout
// msm_win_windows<4> reads.  A block with no tile stores the identity.
template <int TILE, bool BITS>
__global__ void __launch_bounds__(W4_THREADS, W4_MIN_BLOCKS)
msm_w4_tiles(const int32_t* __restrict__ pts, const int32_t* __restrict__ words,
             int32_t* __restrict__ partials, segs g, int ppt) {
    constexpr int WINDOWS = Win<4>::WINDOWS;
    constexpr int SPAN = TILE < 32 ? 32 : TILE;  // table threads of one role
    static_assert(TILE % 2 == 0 && 2 * SPAN <= W4_THREADS, "two table threads a point");
    extern __shared__ uint32_t smem[];
    uint32_t* tbl = smem;
    uint32_t* wsh = smem + TILE * W4_STRIDE;
    const int b = blockIdx.x;
    const int s = blockIdx.y;
    const int n = (int)min((long long)g.n[s < 1 ? 0 : 1],
                           max(0ll, (long long)g.total - (long long)s * g.stride));
    const int t = threadIdx.x;
    const int win = t % WINDOWS;
    const int half = t / WINDOWS;
    const int tiles = (n + TILE - 1) / TILE;
    ge acc = ge_identity();
#pragma unroll 1
    for (int k = 0; k < ppt; ++k) {
        const int tile = b + k * gridDim.x;
        if (tile >= tiles) break;
        const int base = tile * TILE;
        const int cnt = min(TILE, n - base);
        const long long row0 = (long long)s * g.stride + base;
        __syncthreads();  // the last tile's tables are read
        if (BITS) {
            if (t < TILE) {
                if (t < cnt) {
                    fold_recode(words + 8 * (row0 + t), wsh + 8 * t);
                } else {
#pragma unroll
                    for (int j = 0; j < 8; ++j) wsh[8 * t + j] = 0u;
                }
            }
        } else {
#pragma unroll 1
            for (int j = t; j < 8 * TILE; j += W4_THREADS)
                wsh[j] = (j >> 3) < cnt ? (uint32_t)__ldg(words + 8 * row0 + j) : 0u;
        }
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
// its kernels (over w4 words, over bit words).
static const int W4_TILE_POINTS[W4_TILES] = {16, 64};

static size_t w4_smem(int k) {
    return sizeof(uint32_t) * W4_TILE_POINTS[k] * (W4_STRIDE + 8);
}

static void (*const W4_KERNELS[W4_TILES][2])(const int32_t*, const int32_t*, int32_t*,
                                             segs, int) = {
    {msm_w4_tiles<16, false>, msm_w4_tiles<16, true>},
    {msm_w4_tiles<64, false>, msm_w4_tiles<64, true>},
};

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
            if (smem > 48 * 1024) {
                for (int b = 0; b < 2; ++b)
                    cudaFuncSetAttribute(W4_KERNELS[j][b],
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
            }
            int sms = 1, per_sm = 1;
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, W4_KERNELS[j][0],
                                                          W4_THREADS, smem);
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

// The three passes over `walks` segments: out[s] = chain[s] + sum over
// segment s (chain null: the sum alone); `bits`: the words are raw bit
// words (recoded by the tiles).
static int msm_w4_launch(const int32_t* pts, const int32_t* words, const int32_t* chain,
                         int32_t* out, int32_t* partials, int32_t* wtot, segs g, int walks,
                         int bits, void* stream) {
    constexpr int WINDOWS = Win<4>::WINDOWS;
    cudaStream_t s = (cudaStream_t)stream;
    if (walks <= 0) return (int)cudaGetLastError();
    const int vmax = walks > 1 && g.n[1] > g.n[0] ? g.n[1] : g.n[0];
    int k = 0, nb = 1, ppt = 0;
    w4_geometry(vmax, walks, &k, &nb, &ppt);
    W4_KERNELS[k][bits ? 1 : 0]<<<dim3(nb, walks), W4_THREADS, w4_smem(k), s>>>(
        pts, words, partials, g, ppt);
    msm_win_windows<4><<<dim3(WINDOWS, walks), 32, 0, s>>>(partials, wtot, nb);
    msm_win_horner<4><<<walks, 32, 0, s>>>(wtot, chain, out);
    return (int)cudaGetLastError();
}

// ---- the device-oracle path's MSMs over bit words (pallas_curve.py
// msm_chunk_acc :279 and msm_block_totals :252, _smul_acc_kernel :269 /
// _smul_reduce_kernel :239 over the bit ladder _ladder :219): acc + sum
// s_i P_i over one chunk, and one total a block of MSM_BLOCK_PTS input
// points, of scalars given as raw bit words (bits 252..0 read).  What
// bounds them on an H100: the windowed w4 MSM's multiplies, as above.
// Design: the windowed w4 MSM itself, its tiles recoding each bit word
// row into signed w4 digits as they load it (fold_recode); msm_chunk_acc
// is one segment chained on acc (msm_w4's shape), the block totals
// ceil(n / MSM_BLOCK_PTS) segments with no chain (msm_lane's), the last
// one ragged.  They replace the first versions' bit ladder a thread (253
// doublings and 253 adds a point, out of line).  Measured (NVIDIA H100
// 80GB HBM3, 700.00 W; chip_profile.py --oracle): msm_chunk_acc at the
// path's 2^14 points 2.22 -> 0.59 ms, at 143,704 14.05 -> 2.43-2.45;
// msm_block_totals at 2^16 + 1,000 6.58 -> 1.39-1.41.  A pre-pass of one
// thread a row recoding into scratch timed the same within 0.03 ms (at
// 2^14 0.587-0.603 against the tiles' 0.584-0.595), so the tiles recode:
// no scratch, one launch fewer.
#define MSM_BLOCK_PTS 2048  // msm_block_totals: input points a total (the TPU's block)

template <int TBL>
static int table_launch(const int32_t* pts, int32_t* table, int n, cudaStream_t s) {
    if (n > 0)
        table_kernel<TBL><<<(n + TABLE_THREADS / 2 - 1) / (TABLE_THREADS / 2), TABLE_THREADS,
                            0, s>>>(pts, table, n);
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
    if (walks <= 0) return 0;
    int k = 0, nb = 1, ppt = 0;
    w4_geometry(vmax, walks, &k, &nb, &ppt);
    return walks * Win<4>::WINDOWS * nb;
}

// Chained MSM: out (1, 4, 8) = acc + sum_{i < n} d_i * P_i (w4 words).
// partials: bp_w4_partials(n, 1) points of scratch; wtot: 64 points.
int bp_msm_w4(const int32_t* pts, const int32_t* words, const int32_t* acc, int32_t* out,
              int32_t* partials, int32_t* wtot, int n, void* stream) {
    return msm_w4_launch(pts, words, acc, out, partials, wtot, segs{{n, n}, 0, n}, 1, 0,
                         stream);
}

// Two chained MSMs in one launch set: out[0] = acc2[0] + sum over points
// [0, lo_n), out[1] = acc2[1] + sum over [half, half + hi_n).  partials:
// bp_w4_partials(max(lo_n, hi_n), 2) points of scratch; wtot: 2 * 64.
int bp_msm_w4_pair(const int32_t* pts, const int32_t* words, const int32_t* acc2,
                   int32_t* out, int32_t* partials, int32_t* wtot, int half, int lo_n,
                   int hi_n, void* stream) {
    return msm_w4_launch(pts, words, acc2, out, partials, wtot,
                         segs{{lo_n, hi_n}, half, 2 * half}, 2, 0, stream);
}

// v independent MSM totals (the flotilla's): out (v, 4, 8), row s = sum
// over points [s * seg, (s + 1) * seg).  partials: bp_w4_partials(seg, v)
// points of scratch; wtot: v * 64.
int bp_msm_lane(const int32_t* pts, const int32_t* words, int32_t* out, int32_t* partials,
                int32_t* wtot, int v, int seg, void* stream) {
    return msm_w4_launch(pts, words, nullptr, out, partials, wtot,
                         segs{{seg, seg}, seg, v * seg}, v, 0, stream);
}

// Chained MSM over bit words (msm_chunk_acc): out (1, 4, 8) = acc + sum_{i
// < n} s_i * P_i, s_i bits 252..0 of word row i.  partials:
// bp_w4_partials(n, 1) points of scratch; wtot: 64 points.
int bp_msm_chunk_acc(const int32_t* pts, const int32_t* words, const int32_t* acc,
                     int32_t* out, int32_t* partials, int32_t* wtot, int n, void* stream) {
    return msm_w4_launch(pts, words, acc, out, partials, wtot, segs{{n, n}, 0, n}, 1, 1,
                         stream);
}

// One total per MSM_BLOCK_PTS input points over bit words
// (msm_block_totals): out (ceil(n / 2048), 4, 8), row b = sum of s_i * P_i
// over points [2048 b, min(2048 (b + 1), n)).  partials:
// bp_w4_partials(min(n, 2048), ceil(n / 2048)) points of scratch; wtot:
// 64 a total.
int bp_msm_block_totals(const int32_t* pts, const int32_t* words, int32_t* out,
                        int32_t* partials, int32_t* wtot, int n, void* stream) {
    const int v = (n + MSM_BLOCK_PTS - 1) / MSM_BLOCK_PTS;
    const int seg = n < MSM_BLOCK_PTS ? n : MSM_BLOCK_PTS;
    return msm_w4_launch(pts, words, nullptr, out, partials, wtot,
                         segs{{seg, seg}, MSM_BLOCK_PTS, n}, v, 1, stream);
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
