// Hopper kernels that run Straus over 8-entry niels tables: the generator
// fold fold_bits, the constant folds of the grid rounds (fold_c,
// fold_c_comb), and the device-oracle path's fold (fold_grid, over w2
// words) and per-lane scalar multiply (smul_lanes, over bit words).  The
// MSMs (msm_w4, msm_w4_pair, msm_lane, and msm_grid / msm_grid_local over
// views) are windowed and live in win.cu beside the walkers whose passes
// they share.  Plain C entry points for ctypes (ops/build.py): each
// launches on the caller's stream, never synchronises, allocates nothing,
// and returns cudaGetLastError().
//
// Layouts (row-major, int32):
//   points  (n, 4, 8): X, Y, Z, T as eight little-endian words each, any
//                      value below 2^256 (gens arrive canonical)
//   words   (n, 8):    one scalar per row: raw little-endian bits
//                      (fold_bits, smul_lanes), a constant's signed
//                      4-bit digits (fold_c*: nibble e, digit e - 16
//                      when e >= 8), or
//                      128 signed base-4 digits (fold_grid: w2 words,
//                      digit d in [-2, 1] coded d & 3, two bits each)
//   out points are stored canonical (every coordinate in [0, p)).
//
// Every point operation is inlined from ge25519_cc.cuh (the carry-chain
// multiply; no calls, no stack frame).  What bounds a fold on an H100
// depends on its outputs.  At the main path's 1,024-2,048 outputs,
// latency: one output is ~330 dependent point operations, and so few
// outputs leave most of 132 SMs idle; there a group of 8 lanes runs each
// output on the cooperative operations, two stages of four multiplies an
// operation (fold_bits, and fold_c and fold_grid up to half the groups the
// card holds at once).  Past that, 32-bit integer multiplies: one thread
// runs each output and the card fills (the thread designs).
#include <cuda_runtime.h>
#include <cstdint>

#include "ge25519_cc.cuh"

// ---- fold_bits: out[i] = wl_i * L_i + wr_i * R_i for raw little-endian
// bit words, of which bits 252..0 are read (pallas_curve.py fold_chunk
// :1566, _emit_fold :1533; both scalars zero gives the identity).  What
// bounds it on an H100: at the main path's 1,024-2,048 lanes, latency
// (the throughput bound is ~0.02-0.04 ms, out of reach of so few
// outputs on a 132-SM card).  Design: a group of 8 lanes computes one output with the
// cooperative point operations (ge25519_cc.cuh: two stages of four
// independent multiplies, ~0.9 us an operation in the walkers' Horner
// pass), four outputs a warp.  Each scalar is recoded into 64 signed
// base-16 digits (the top one takes the carry: <= 2), the group builds
// an 8-entry niels table of L and one of R in shared memory, and Straus
// runs 64 windows of 4 doublings (T on the last) and one niels add per
// nonzero digit of each scalar.  The adds are taken by the whole warp
// when any of its groups has a nonzero digit (the shuffles name the full
// warp; a group with digit 0 adds the identity), so the main path's
// wl = 1 costs one add, and its random wr about one a window: ~330
// dependent operations in all.  Measured (NVIDIA H100 80GB HBM3, 700.00
// W; chip_profile.py --kernels): 0.32-0.33 ms at 1,024 lanes, 0.32 at
// 2,048; 79 registers, no stack.  Blocks of 32 or 128 threads ran the
// same.
#define FB_THREADS 64                 // 8 outputs a block
#define FB_CODES (16 * 32)            // a group's shared words: two tables, then
#define FB_GROUP_WORDS (FB_CODES + 18)  // the two scalars' codes (+2: spread over banks)
#define FC_GROUP_WORDS (8 * 32 + 2)     // fold_c: a group's table (+2: spread over banks)

// Words 4j .. 4j + 3 of p's (X, Y, Z, T), chosen by selects (an index
// into registers would put the point in local memory).
__device__ __forceinline__ uint4 ge_quarter(const ge& p, int j) {
    const int c = j >> 1;
    const fe v = fe_select(c == 0, p.X, fe_select(c == 1, p.Y, fe_select(c == 2, p.Z, p.T)));
    const bool hi = j & 1;
    return make_uint4(hi ? v.w[4] : v.w[0], hi ? v.w[5] : v.w[1], hi ? v.w[6] : v.w[2],
                      hi ? v.w[7] : v.w[3]);
}

// An extended point in a group's shared table: X, Y, Z, T at words 0, 8,
// 16, 24.  Lane j = 4h + q of the group writes words 4j .. 4j + 3.
__device__ __forceinline__ void fb_put(uint32_t* e, const ge& p, int j) {
    const uint4 v = ge_quarter(p, j);
    e[4 * j] = v.x;
    e[4 * j + 1] = v.y;
    e[4 * j + 2] = v.z;
    e[4 * j + 3] = v.w;
}

__device__ __forceinline__ ge fb_get(const uint32_t* e) {
    ge p;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        p.X.w[k] = e[k];
        p.Y.w[k] = e[8 + k];
        p.Z.w[k] = e[16 + k];
        p.T.w[k] = e[24 + k];
    }
    return p;
}

// Lane q's coordinate of p in niels form: (Y-X, Y+X, 2dT, Z)[q], the
// operand coop_add_niels takes.
__device__ __forceinline__ fe niels_coord(const ge& p, int q) {
    fe m = fe_select(q == 0, fe_sub(p.Y, p.X), fe_select(q == 1, fe_add(p.Y, p.X), p.Z));
    if (q == 2) m = fe_mul_cc(p.T, fe_d2());
    return m;
}

// A group's table of the point at `row`, entries 0..7 = (k + 1) P at
// words 32 k, in extended form: 2P = dbl P, odd multiples t(k-1) + P,
// even ones doubled from t(k/2) (the TPU tables' sequence).
__device__ __forceinline__ void coop_table(uint32_t* t, const int32_t* row, int q, int h,
                                           int j, int base) {
    ge x = ge_load(row);
    const fe mineP = niels_coord(x, q);
    fb_put(t, x, j);
#pragma unroll 1
    for (int k = 1; k < 8; ++k) {
        __syncwarp();
        if (k & 1) x = coop_double(fb_get(t + 32 * ((k - 1) / 2)), q, h, base, true);
        else x = coop_add_niels(x, mineP, q, h, base);
        fb_put(t + 32 * k, x, j);
    }
}

// A group's `entries` extended table entries into niels form (Y+X, Y-X,
// 2dT, Z) in place, four a stage, lane q the 2dT multiply of entry 4m + q.
__device__ __forceinline__ void coop_to_niels(uint32_t* tbl, int entries, int q, int h) {
    const fe d2 = fe_d2();
#pragma unroll 1
    for (int m = 0; m < entries / 4; ++m) {
        __syncwarp();
        uint32_t* e = tbl + 32 * (4 * m + q);
        const ge p = fb_get(e);
        const fe t2d = fe_mul_split(p.T, d2, h);
        __syncwarp();
        if (h == 0) {
            const fe ypx = fe_add(p.Y, p.X);
            const fe ymx = fe_sub(p.Y, p.X);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                e[k] = ypx.w[k];
                e[8 + k] = ymx.w[k];
                e[16 + k] = t2d.w[k];
                e[24 + k] = p.Z.w[k];
            }
        }
    }
    __syncwarp();
}

// Straus over a group's `tables` niels tables (table s at words 256 s of
// tbl) and their scalars' signed base-16 digit codes (scalar s's digit
// win is nibble win % 8 of code[K s + win / 8], K = (WINS + 7) / 8 words a
// scalar): WINS windows (64, or 65 for w2_recode's codes), most
// significant first, of 4 doublings (T on the last) once an add was
// taken, and one niels add a scalar.  The warp takes an add when any of
// its groups has a nonzero digit (the shuffles name the full warp; a
// group with digit 0 adds the identity), and doubles once any has added.
// Lane q reads its coordinate (Y-X, Y+X, 2dT, Z)[q] of the selected
// entry; for a negative digit -Q = (Y-X, Y+X, -2dT, Z) in niels form, so
// lanes 0 and 1 swap their reads and lane 2 negates.
template <int WINS = 64>
__device__ __forceinline__ ge coop_straus(const uint32_t* tbl, const uint32_t* code,
                                          int tables, int q, int h, int base) {
    constexpr int K = (WINS + 7) / 8;
    ge acc = ge_identity();
    bool started = false;
#pragma unroll 1
    for (int win = WINS - 1; win >= 0; --win) {
        if (started) {
#pragma unroll 1
            for (int d = 0; d < 4; ++d) acc = coop_double(acc, q, h, base, d == 3);
        }
#pragma unroll 1
        for (int s = 0; s < tables; ++s) {
            const uint32_t c = (code[K * s + (win >> 3)] >> (4 * (win & 7))) & 15u;
            if (!__any_sync(0xffffffffu, c != 0u)) continue;
            fe mine = fe_zero();
            if (q != 2) mine.w[0] = 1u;  // the identity (1, 1, 0, 1)
            if (c != 0u) {
                const bool neg = c >= 8u;  // code 8 is the digit -8: entry 8P negated
                const uint32_t mag = neg ? 16u - c : c;
                const int off = q == 0 ? (neg ? 0 : 8) : q == 1 ? (neg ? 8 : 0) : 8 * q;
                const uint32_t* src = tbl + 32 * (8 * s + mag - 1) + off;
#pragma unroll
                for (int k = 0; k < 8; ++k) mine.w[k] = src[k];
                if (q == 2 && neg) mine = fe_neg(mine);
            }
            acc = coop_add_niels(acc, mine, q, h, base);
            started = true;
        }
    }
    return acc;
}

// Lane j of a group stores words 4j .. 4j + 3 of the canonical point.
__device__ __forceinline__ void coop_store(int32_t* dst, const ge& p, int j) {
    ge c;
    c.X = fe_canon(p.X);
    c.Y = fe_canon(p.Y);
    c.Z = fe_canon(p.Z);
    c.T = fe_canon(p.T);
    *reinterpret_cast<uint4*>(dst + 4 * j) = ge_quarter(c, j);
}

// Block b, group g (threads 8g .. 8g + 7): output 8b + g.  Groups past n
// run lane n - 1's fold and store nothing (every lane takes part in the
// shuffles).  The group's lane 0 recodes both scalars into its shared
// words (codes of wl, then wr); the tables: entries 0..7 of L, 8..15 of R.
__global__ void __launch_bounds__(FB_THREADS)
fold_bits_kernel(const int32_t* __restrict__ left, const int32_t* __restrict__ right,
                 const int32_t* __restrict__ wl, const int32_t* __restrict__ wr,
                 int32_t* __restrict__ out, int n) {
    __shared__ uint32_t tables[(FB_THREADS / 8) * FB_GROUP_WORDS];
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int h = (lane >> 2) & 1;
    const int j = lane & 7;
    const int base = lane & ~7;
    const long long i0 = (long long)blockIdx.x * (FB_THREADS / 8) + (threadIdx.x >> 3);
    const bool live = i0 < n;
    const long long i = live ? i0 : n - 1;
    uint32_t* tbl = tables + (threadIdx.x >> 3) * FB_GROUP_WORDS;
    uint32_t* code = tbl + FB_CODES;
    if (j == 0) {
        fold_recode(wl + 8 * i, code);
        fold_recode(wr + 8 * i, code + 8);
    }
#pragma unroll 1
    for (int s = 0; s < 2; ++s) coop_table(tbl + 256 * s, (s ? right : left) + 32 * i, q, h, j, base);
    coop_to_niels(tbl, 16, q, h);
    const ge acc = coop_straus(tbl, code, 2, q, h, base);
    if (live) coop_store(out + 32 * i, acc, j);
}

// ---- the constant folds (pallas_curve.py fold_grid_c / _donate :541 /
// :548 and fold_grid_c_comb :733, body _fold_c_kernel :490): out[i] =
// P[i] + c_i * P[i + v], c_i the first constant below bp and the second
// from bp on, each given as 64 signed base-16 digits (the codes
// fold_bits' Straus reads after its recode).  Block (x, side): side s
// reads in + s * 2v points and its two constants' words at words + 16 *
// s, and writes out + s * v points.  Each output's thread or group reads
// rows i and i + v and then writes row i only, so one side may fold in
// place (out == in): no other output reads row i (a group past v reads
// row v - 1 and stores nothing).  Two sides must not (output row j of
// side 1 is an input row of side 0), so in and out carry no __restrict__
// and the wrappers never alias the combined fold.  Two designs:
//  - group (fold_c_group): fold_bits' cooperative table and Straus over
//    the one table of P[i + v], the constant's codes read from the words
//    in shared memory (no recode), then P[i] added once in niels form.
//    A constant's digits are the same across a warp but in bp's warp.
//  - thread (fold_c_thread): fold_w3h.cu's pattern, one thread an output:
//    a niels table of P[i + v] (2P = dbl P, then t(k-1) + P) and of P[i]
//    in local memory, each entry copied into registers before its add,
//    the words in shared memory, doublings with T on the 4th of a window
//    only, and P[i] as the add of a last digit with no doublings.
// fold_c_launch takes the group design while the launch's outputs are at
// most 1 / FC_GROUP_SHARE of the groups the card holds at once (occupancy
// query), else the thread design.  Measured (NVIDIA H100 80GB HBM3,
// 700.00 W; chip_profile.py --kernels, each design forced): at 2^11
// outputs group 0.387 ms, thread 0.84-0.88; at 2^13 0.88-0.89 against
// 0.86-0.87 (the crossover: the group's time grows with its resident
// groups, the thread's is one thread's latency up to 2^14); at 2^14 1.63
// against 0.87; at 2^17 12.1-12.2 against 5.60-5.63.  The card holds
// ~14,800 groups (70 registers, 14 blocks an SM), so the switch sits at
// ~7,400 outputs.
#define FC_THREADS 128     // fold_c_thread: threads a block
#define FC_MIN_BLOCKS 3    // fold_c_thread blocks an SM holds: <= 168 registers
#define FC_GROUP_SHARE 2   // the group design up to this share of a card of groups

__global__ void __launch_bounds__(FB_THREADS)
fold_c_group(const int32_t* in, int32_t* out, const int32_t* __restrict__ words, int v,
             int bp) {
    __shared__ uint32_t tables[(FB_THREADS / 8) * FC_GROUP_WORDS];
    __shared__ uint32_t wsh[16];
    const int side = blockIdx.y;
    if (threadIdx.x < 16) wsh[threadIdx.x] = (uint32_t)words[16 * side + threadIdx.x];
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int h = (lane >> 2) & 1;
    const int j = lane & 7;
    const int base = lane & ~7;
    const long long i0 = (long long)blockIdx.x * (FB_THREADS / 8) + (threadIdx.x >> 3);
    const bool live = i0 < v;
    const long long i = live ? i0 : v - 1;
    const int32_t* src = in + 64ll * v * side;
    uint32_t* tbl = tables + (threadIdx.x >> 3) * FC_GROUP_WORDS;
    coop_table(tbl, src + 32 * (i + v), q, h, j, base);
    coop_to_niels(tbl, 8, q, h);
    ge acc = coop_straus(tbl, wsh + (i < bp ? 0 : 8), 1, q, h, base);
    acc = coop_add_niels(acc, niels_coord(ge_load(src + 32 * i), q), q, h, base);
    if (live) coop_store(out + 32ll * v * side + 32 * i, acc, j);
}

__global__ void __launch_bounds__(FC_THREADS, FC_MIN_BLOCKS)
fold_c_thread(const int32_t* in, int32_t* out, const int32_t* __restrict__ words, int v,
              int bp) {
    __shared__ uint32_t wsh[16];
    const int side = blockIdx.y;
    if (threadIdx.x < 16) wsh[threadIdx.x] = (uint32_t)words[16 * side + threadIdx.x];
    __syncthreads();
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= v) return;
    const int32_t* src = in + 64ll * v * side;
    const uint32_t* w = wsh + (i < bp ? 0 : 8);
    niels tbl[9];  // (k + 1) P[i + v] for k < 8, then P[i]: local memory (indexed by digits)
    ge x;
#pragma unroll 1
    for (int k = 0; k < 9; ++k) {
        if (k == 0) {
            x = ge_load(src + 32 * (i + v));
        } else if (k == 1) {
            x = ge_double_cc(x, true);
        } else if (k < 8) {
            const niels nP = tbl[0];
            x = ge_add_niels_cc(x, nP, false);
        } else {
            x = ge_load(src + 32 * i);
        }
        tbl[k] = ge_to_niels_cc(x);
    }
    ge acc = ge_identity();
    bool started = false;
#pragma unroll 1
    for (int pos = 63; pos >= -1; --pos) {  // pos -1: P[i], entry 8, no doublings
        if (started && pos >= 0) {
#pragma unroll 1
            for (int d = 0; d < 4; ++d) acc = ge_double_cc(acc, d == 3);
        }
        const uint32_t code = pos < 0 ? 1u : (w[pos >> 3] >> (4 * (pos & 7))) & 15u;
        if (code) {
            const bool neg = code >= 8u;  // code 8 is the digit -8: entry 8P negated
            const niels e = tbl[pos < 0 ? 8 : (neg ? 16 - code : code) - 1];  // into registers
            acc = ge_add_niels_cc(acc, e, neg);
            started = true;
        }
    }
    ge_store(out + 32ll * v * side + 32 * i, acc);
}

// The outputs a group design's kernel (FB_THREADS threads a block, 8
// lanes an output) holds at once on the current device; held caches its
// blocks by device (0: not asked).
static int group_outputs(const void* kernel, int* held) {
    return card_blocks(kernel, FB_THREADS, held) * (FB_THREADS / 8);
}

// 1 for the group design, 0 for the thread design, for `outputs` outputs.
static int fold_c_design(long long outputs) {
    static int held[64];
    return outputs * FC_GROUP_SHARE <=
                   (long long)group_outputs((const void*)fold_c_group, held)
               ? 1
               : 0;
}

// design: 1 group, 0 thread, -1 by the outputs (fold_c_design).
static int fold_c_launch(const int32_t* in, int32_t* out, const int32_t* words, int v,
                         int bp, int sides, int design, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (v > 0) {
        if (design < 0) design = fold_c_design((long long)sides * v);
        if (design)
            fold_c_group<<<dim3((v + FB_THREADS / 8 - 1) / (FB_THREADS / 8), sides),
                           FB_THREADS, 0, s>>>(in, out, words, v, bp);
        else
            fold_c_thread<<<dim3((v + FC_THREADS - 1) / FC_THREADS, sides), FC_THREADS, 0,
                            s>>>(in, out, words, v, bp);
    }
    return (int)cudaGetLastError();
}

// ---- fold_grid (pallas_curve.py fold_grid :865, _fold_grid_kernel :850,
// _emit_fold_w2 :823): out[i] = wl_i * P[i] + wr_i * P[i + v] for i < v,
// into a tensor apart from the points, each scalar a w2 word row (per
// lane, or one row read by every lane: word stride 0).  The device-oracle
// path's IPP folds run it at v = 2^17 with per-lane words (round 1) and
// then with the constants u^-1, u at v = 2^16 down to 1.  What bounds it
// on an H100: at 2^17 outputs 32-bit integer multiplies (two 8-entry
// tables, 256 doublings and ~120 niels adds an output); at the later
// rounds' few outputs, latency.  Design: each row recoded in the kernel
// (w2_recode) into 64 signed base-16 digits and a borrow window, so the
// TPU's dual w2 ladder (128 windows of 2 doublings and 2 selected adds
// from {P, 2P}) becomes Straus over two 8-entry niels tables, 65 windows
// of 4 doublings (T on the 4th) and up to two niels adds: half the adds
// and the measured tables and window loops of fold_bits and fold_c.  Two
// designs, picked by size as fold_c's (fold_grid_design):
//  - group (fold_grid_group): fold_bits' body, 8 lanes an output, the
//    tables of P[i] and P[i + v] in shared memory and coop_straus over 65
//    windows; the group's lane 0 recodes both rows;
//  - thread (fold_grid_thread): one thread an output, both tables (16
//    niels entries, 2 KB) in local memory, each entry copied into
//    registers before its add, its rows' codes in shared memory, one
//    doubling chain for both scalars.
// fold_grid_design takes the group design while the outputs are at most
// 2/3 of the groups the card holds at once (occupancy query), else the
// thread design.  Measured (NVIDIA H100 80GB HBM3, 700.00 W;
// chip_profile.py --oracle, each design forced, per-lane words): at 2,048
// outputs group 0.387 ms, thread 1.08; at 2^13 1.07 against 1.17; at
// 12,288 1.57 against 1.18; at 2^14 2.08 against 1.22; at 2^17 16.1
// against 8.0.  The card holds ~12,700 groups (79 registers, 12 blocks an
// SM), so the switch sits at ~8,400 outputs, between the measured 2^13
// and 12,288 (the crossover, ~9,000; fold_c's, with one table, is at
// half a card).
#define FG_WINDOWS 65                                       // w2_recode's windows
#define FG_CODE_WORDS 9                                     // its words a row
#define FG_GROUP_WORDS (FB_CODES + 2 * FG_CODE_WORDS + 2)   // (+2: spread over banks)
#define FG_THREAD_WORDS (2 * FG_CODE_WORDS + 1)             // odd: distinct banks
// the group design up to FG_GROUP_NUM / FG_GROUP_DEN of a card of groups
#define FG_GROUP_NUM 2
#define FG_GROUP_DEN 3

// Block b, group g: output 8b + g (groups past v run output v - 1 and
// store nothing); tables: entries 0..7 of P[i], 8..15 of P[i + v].
__global__ void __launch_bounds__(FB_THREADS)
fold_grid_group(const int32_t* __restrict__ pts, const int32_t* __restrict__ wl,
                const int32_t* __restrict__ wr, int32_t* __restrict__ out, int v,
                int wl_stride, int wr_stride) {
    __shared__ uint32_t tables[(FB_THREADS / 8) * FG_GROUP_WORDS];
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int h = (lane >> 2) & 1;
    const int j = lane & 7;
    const int base = lane & ~7;
    const long long i0 = (long long)blockIdx.x * (FB_THREADS / 8) + (threadIdx.x >> 3);
    const bool live = i0 < v;
    const long long i = live ? i0 : v - 1;
    uint32_t* tbl = tables + (threadIdx.x >> 3) * FG_GROUP_WORDS;
    uint32_t* code = tbl + FB_CODES;
    if (j == 0) {
        w2_recode(wl + wl_stride * i, code);
        w2_recode(wr + wr_stride * i, code + FG_CODE_WORDS);
    }
#pragma unroll 1
    for (int s = 0; s < 2; ++s) coop_table(tbl + 256 * s, pts + 32 * (i + s * v), q, h, j, base);
    coop_to_niels(tbl, 16, q, h);
    const ge acc = coop_straus<FG_WINDOWS>(tbl, code, 2, q, h, base);
    if (live) coop_store(out + 32 * i, acc, j);
}

// Thread i: output i.  tbl[8 s + k] = (k + 1) P[i + s v] (2P = dbl P, then
// t(k-1) + P); windows 64..0 of 4 doublings (T on the 4th) once a digit
// was added, and each scalar's niels add (code 0 adds nothing).
__global__ void __launch_bounds__(FC_THREADS, FC_MIN_BLOCKS)
fold_grid_thread(const int32_t* __restrict__ pts, const int32_t* __restrict__ wl,
                 const int32_t* __restrict__ wr, int32_t* __restrict__ out, int v,
                 int wl_stride, int wr_stride) {
    __shared__ uint32_t csh[FC_THREADS * FG_THREAD_WORDS];
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= v) return;
    uint32_t* code = csh + threadIdx.x * FG_THREAD_WORDS;
    w2_recode(wl + wl_stride * i, code);
    w2_recode(wr + wr_stride * i, code + FG_CODE_WORDS);
    niels tbl[16];  // local memory (indexed by digits)
    ge x;
#pragma unroll 1
    for (int k = 0; k < 16; ++k) {
        const int e = k & 7;
        if (e == 0) {
            x = ge_load(pts + 32 * (i + (k ? v : 0)));
        } else if (e == 1) {
            x = ge_double_cc(x, true);
        } else {
            const niels nP = tbl[k - e];
            x = ge_add_niels_cc(x, nP, false);
        }
        tbl[k] = ge_to_niels_cc(x);
    }
    ge acc = ge_identity();
    bool started = false;
#pragma unroll 1
    for (int pos = FG_WINDOWS - 1; pos >= 0; --pos) {
        if (started) {
#pragma unroll 1
            for (int d = 0; d < 4; ++d) acc = ge_double_cc(acc, d == 3);
        }
#pragma unroll 1
        for (int s = 0; s < 2; ++s) {
            const uint32_t c = (code[FG_CODE_WORDS * s + (pos >> 3)] >> (4 * (pos & 7))) & 15u;
            if (c) {
                const bool neg = c >= 8u;  // code 8 is the digit -8: entry 8P negated
                const niels e = tbl[8 * s + (neg ? 16 - c : c) - 1];  // into registers
                acc = ge_add_niels_cc(acc, e, neg);
                started = true;
            }
        }
    }
    ge_store(out + 32 * i, acc);
}

// 1 for the group design, 0 for the thread design, for `outputs` outputs.
static int fold_grid_design(long long outputs) {
    static int held[64];
    return outputs * FG_GROUP_DEN <=
                   (long long)group_outputs((const void*)fold_grid_group, held) * FG_GROUP_NUM
               ? 1
               : 0;
}

// ---- smul_lanes (pallas_curve.py smul_lanes :1519, _smul_kernel :243,
// _ladder :219): out[i] = s_i * P_i for each lane, s_i a raw bit word row
// of which bits 252..0 are read.  The device-oracle path's proving_step
// runs it at 2^16 lanes.  What bounds it on an H100: at 2^16 lanes 32-bit
// integer multiplies (a table and ~250 doublings and ~60 niels adds a
// lane); at a few thousand lanes, latency.  Design: the one-scalar case of
// fold_bits / fold_c: each row recoded in the kernel into 64 signed
// base-16 digits (fold_recode; the top one takes the carry, <= 2; a zero
// row stays the identity), then Straus over an 8-entry niels table of P_i,
// in fold_c's two designs picked by size (smul_lanes_design):
//  - group (smul_lanes_group): fold_bits' body with one table, 8 lanes an
//    output; the group's lane 0 recodes the row into its shared words;
//  - thread (smul_lanes_thread): one thread a lane, the table in local
//    memory (2P = dbl P, then t(k-1) + P), each entry copied into
//    registers before its add, the codes in shared memory, 4 doublings a
//    window (T on the 4th) once a digit was added.
// The first version ran the TPU's bit ladder a thread (253 doublings and
// 253 adds of P or the identity, out of line): ~4,300 field multiplies a
// lane against ~2,300 here.  smul_lanes_design takes the group design
// while the lanes are at most 1 / SL_GROUP_SHARE of the groups the card
// holds at once (occupancy query), else the thread design.  Measured
// (NVIDIA H100 80GB HBM3, 700.00 W; chip_profile.py --oracle, each design
// forced): at 2,048 lanes group 0.387-0.389 ms, thread 0.81-0.82; at 4,096
// 0.49-0.51 against 0.87-0.88; at 8,192 0.89-0.91 against 0.87-0.89 (the
// crossover); at 2^14 1.67-1.69 against 0.86-0.88; at the path's 2^16
// 6.28-6.37 against 3.03-3.07 (the first version 6.47-6.48 there, 2.08 at
// 2^14).  The card holds ~14,800 groups (70 registers), so the switch sits
// at ~7,400 lanes.  The thread design at 4 blocks an SM (119 registers)
// ran 2% faster at 2^16 than at fold_c_thread's 3 (134 registers).
#define SL_CODE_WORDS 9                  // a thread's code words, 8 and a pad (odd: distinct banks)
#define SL_GROUP_WORDS (8 * 32 + 8 + 2)  // a group's table and codes (+2: spread over banks)
#define SL_GROUP_SHARE 2                 // the group design up to this share of a card of groups
#define SL_MIN_BLOCKS 4                  // smul_lanes_thread blocks an SM holds: <= 128 registers

// Block b, group g: lane 8b + g (groups past n run lane n - 1 and store
// nothing).
__global__ void __launch_bounds__(FB_THREADS)
smul_lanes_group(const int32_t* __restrict__ pts, const int32_t* __restrict__ words,
                 int32_t* __restrict__ out, int n) {
    __shared__ uint32_t tables[(FB_THREADS / 8) * SL_GROUP_WORDS];
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    const int h = (lane >> 2) & 1;
    const int j = lane & 7;
    const int base = lane & ~7;
    const long long i0 = (long long)blockIdx.x * (FB_THREADS / 8) + (threadIdx.x >> 3);
    const bool live = i0 < n;
    const long long i = live ? i0 : n - 1;
    uint32_t* tbl = tables + (threadIdx.x >> 3) * SL_GROUP_WORDS;
    uint32_t* code = tbl + 8 * 32;
    if (j == 0) fold_recode(words + 8 * i, code);
    coop_table(tbl, pts + 32 * i, q, h, j, base);
    coop_to_niels(tbl, 8, q, h);
    const ge acc = coop_straus(tbl, code, 1, q, h, base);
    if (live) coop_store(out + 32 * i, acc, j);
}

// Thread i: lane i.
__global__ void __launch_bounds__(FC_THREADS, SL_MIN_BLOCKS)
smul_lanes_thread(const int32_t* __restrict__ pts, const int32_t* __restrict__ words,
                  int32_t* __restrict__ out, int n) {
    __shared__ uint32_t csh[FC_THREADS * SL_CODE_WORDS];
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t* code = csh + threadIdx.x * SL_CODE_WORDS;
    fold_recode(words + 8 * i, code);
    niels tbl[8];  // (k + 1) P: local memory (indexed by digits)
    ge x;
#pragma unroll 1
    for (int k = 0; k < 8; ++k) {
        if (k == 0) {
            x = ge_load(pts + 32 * i);
        } else if (k == 1) {
            x = ge_double_cc(x, true);
        } else {
            const niels nP = tbl[0];
            x = ge_add_niels_cc(x, nP, false);
        }
        tbl[k] = ge_to_niels_cc(x);
    }
    ge acc = ge_identity();
    bool started = false;
#pragma unroll 1
    for (int pos = 63; pos >= 0; --pos) {
        if (started) {
#pragma unroll 1
            for (int d = 0; d < 4; ++d) acc = ge_double_cc(acc, d == 3);
        }
        const uint32_t c = (code[pos >> 3] >> (4 * (pos & 7))) & 15u;
        if (c) {
            const bool neg = c >= 8u;  // code 8 is the digit -8: entry 8P negated
            const niels e = tbl[(neg ? 16 - c : c) - 1];  // into registers
            acc = ge_add_niels_cc(acc, e, neg);
            started = true;
        }
    }
    ge_store(out + 32 * i, acc);
}

// 1 for the group design, 0 for the thread design, for n lanes.
static int smul_lanes_design(long long n) {
    static int held[64];
    return n * SL_GROUP_SHARE <= (long long)group_outputs((const void*)smul_lanes_group, held)
               ? 1
               : 0;
}

extern "C" {

// Makes `device` current for this library's CUDA runtime, which is linked
// in statically and so keeps a current device apart from the caller's;
// every entry point launches on it.  The wrappers call this before each
// launch (the caller may be a pool thread, or drive a second card).
int bp_set_device(int device) { return (int)cudaSetDevice(device); }

int bp_fold_bits(const int32_t* left, const int32_t* right, const int32_t* wl,
                 const int32_t* wr, int32_t* out, int n, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0)
        fold_bits_kernel<<<(n + FB_THREADS / 8 - 1) / (FB_THREADS / 8), FB_THREADS, 0, s>>>(
            left, right, wl, wr, out, n);
    return (int)cudaGetLastError();
}

// The constant folds' design on the current device for `outputs`
// outputs (sides * v): 1 group, 0 thread.
int bp_fold_c_design(int outputs) { return fold_c_design(outputs); }

// out (v, 4, 8) from points (2v, 4, 8); words (1, 2, 8): the signed w4
// words of the constant below bp and of the one from bp on.  out may be
// points' first v rows (in place).  design: 1 group, 0 thread, -1 by size.
int bp_fold_c(const int32_t* pts, int32_t* out, const int32_t* words, int v, int bp,
              int design, void* stream) {
    return fold_c_launch(pts, out, words, v, bp, 1, design, stream);
}

// out (2v, 4, 8) = [G'(v) | H'(v)] from points (4v, 4, 8) = [G(2v) | H(2v)];
// words (2, 2, 8), side 0 for G and 1 for H, both split at bp.  out must
// not overlap points.
int bp_fold_c_comb(const int32_t* pts, int32_t* out, const int32_t* words, int v, int bp,
                   int design, void* stream) {
    return fold_c_launch(pts, out, words, v, bp, 2, design, stream);
}

// fold_grid's design on the current device for v outputs: 1 group, 0 thread.
int bp_fold_grid_design(int v) { return fold_grid_design(v); }

// out (v, 4, 8): out[i] = wl_i * P[i] + wr_i * P[i + v] over points (>= 2v,
// 4, 8); w2 word rows at stride wl_stride / wr_stride words (8 per lane,
// or 0 for one row read by every lane).  out must not overlap pts.
// design: 1 group, 0 thread, -1 by size.
int bp_fold_grid(const int32_t* pts, const int32_t* wl, const int32_t* wr, int32_t* out,
                 int v, int wl_stride, int wr_stride, int design, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (v > 0) {
        if (design < 0) design = fold_grid_design(v);
        if (design)
            fold_grid_group<<<(v + FB_THREADS / 8 - 1) / (FB_THREADS / 8), FB_THREADS, 0, s>>>(
                pts, wl, wr, out, v, wl_stride, wr_stride);
        else
            fold_grid_thread<<<(v + FC_THREADS - 1) / FC_THREADS, FC_THREADS, 0, s>>>(
                pts, wl, wr, out, v, wl_stride, wr_stride);
    }
    return (int)cudaGetLastError();
}

// smul_lanes' design on the current device for n lanes: 1 group, 0 thread.
int bp_smul_lanes_design(int n) { return smul_lanes_design(n); }

// out (n, 4, 8): out[i] = s_i * P_i, s_i from bit words (n, 8) (bits
// 253..255 not read).  design: 1 group, 0 thread, -1 by size.
int bp_smul_lanes(const int32_t* pts, const int32_t* words, int32_t* out, int n, int design,
                  void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0) {
        if (design < 0) design = smul_lanes_design(n);
        if (design)
            smul_lanes_group<<<(n + FB_THREADS / 8 - 1) / (FB_THREADS / 8), FB_THREADS, 0, s>>>(
                pts, words, out, n);
        else
            smul_lanes_thread<<<(n + FC_THREADS - 1) / FC_THREADS, FC_THREADS, 0, s>>>(
                pts, words, out, n);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
