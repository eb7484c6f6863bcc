// Hopper kernels for the VSMT-2 slice: the per-segment totals of the
// batched frozen rounds (msm_lane), the IPP generator fold (fold_bits) and
// the constant folds of the grid rounds (fold_c, fold_c_comb: the w4
// ladder plus one add).  The chained w4 MSMs (msm_w4, msm_w4_pair, and
// msm_grid / msm_grid_local over views) are windowed and live in win.cu
// beside the walkers whose passes they share.  Plain C entry points for
// ctypes (ops/build.py): each
// launches on the caller's stream, never synchronises, allocates nothing,
// and returns cudaGetLastError().
//
// Layouts (row-major, int32):
//   points  (n, 4, 8): X, Y, Z, T as eight little-endian words each, any
//                      value below 2^256 (gens arrive canonical)
//   words   (n, 8):    one scalar per row; signed 4-bit digits for the
//                      ladders (nibble e, digit e - 16 when e >= 8), raw
//                      little-endian bits for the fold
//   out points are stored canonical (every coordinate in [0, p)).
//
// What bounds the ladder kernels (msm_lane, fold_c*): integer multiply
// throughput.  One w4 ladder is ~330 point operations of ~9 field
// multiplies of 64 32x32->64 products each, against 128 B of point and
// 32 B of scalar read, so they are compute bound by three orders of
// magnitude.  Their design answer is one independent ladder per thread
// (no cross-thread traffic until the end) and one block reduction in
// shared memory; per-thread tables live in local memory, which the L1
// serves.  fold_bits, whose main-path launches are too small to fill the
// card, is latency bound and runs cooperatively (see below).
#include <cuda_runtime.h>
#include <cstdint>

#include "ge25519_cc.cuh"

#define MSM_THREADS 128
#define FOLD_THREADS 128

__device__ __forceinline__ void load_words(const int32_t* src, uint32_t w[8]) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = s[i];
}

// d * P for the signed-digit scalar in w (64 nibbles, most significant
// first; msm_lane and the constant folds): an 8-entry table (k+1)P, 4
// doublings + one table add per window.  Nibble 0 adds nothing, so the
// ladder starts at the top nonzero digit.
__device__ ge ladder_w4(const ge& P, const uint32_t w[8]) {
    ge tbl[8];
    tbl[0] = P;
    tbl[1] = ge_double(P);
    tbl[2] = ge_add(tbl[1], P);
    tbl[3] = ge_double(tbl[1]);
    tbl[4] = ge_add(tbl[3], P);
    tbl[5] = ge_double(tbl[2]);
    tbl[6] = ge_add(tbl[5], P);
    tbl[7] = ge_double(tbl[3]);
    ge acc = ge_identity();
    bool started = false;
#pragma unroll 1
    for (int pos = 63; pos >= 0; --pos) {
        if (started) {
            acc = ge_double(acc);
            acc = ge_double(acc);
            acc = ge_double(acc);
            acc = ge_double(acc);
        }
        uint32_t e = (w[pos >> 3] >> (4 * (pos & 7))) & 15u;
        if (e) {
            bool neg = e >= 8u;  // e = 8 is the digit -8: table entry 8P
            uint32_t mag = neg ? 16u - e : e;
            ge s = tbl[mag - 1];
            if (neg) s = ge_neg(s);
            acc = started ? ge_add(acc, s) : s;
            started = true;
        }
    }
    return acc;
}

// msm_lane pass 1: block (b, s) runs the ladders of points
// [b * T, (b + 1) * T) of segment s (rows s * seg + i) and writes one
// partial per block, segment-major.
__global__ void __launch_bounds__(MSM_THREADS)
msm_lane_partials(const int32_t* __restrict__ pts, const int32_t* __restrict__ words,
                  int32_t* __restrict__ partials, int seg) {
    __shared__ ge sh[MSM_THREADS];
    int b = blockIdx.x;
    int s = blockIdx.y;
    long long i = (long long)b * blockDim.x + threadIdx.x;
    ge v = ge_identity();
    if (i < seg) {
        long long row = (long long)s * seg + i;
        uint32_t w[8];
        load_words(words + 8 * row, w);
        if (!fe_is_zero_words(w)) v = ladder_w4(ge_load(pts + 32 * row), w);
    }
    block_sum(v, sh);
    if (threadIdx.x == 0)
        ge_store_raw(partials + 32ll * ((long long)s * gridDim.x + b), sh[0]);
}

// msm_lane pass 2: block s sums segment s's `bps` partials into out[s].
__global__ void __launch_bounds__(MSM_THREADS)
msm_lane_final(const int32_t* __restrict__ partials, int32_t* __restrict__ out, int bps) {
    __shared__ ge sh[MSM_THREADS];
    int s = blockIdx.x;
    ge v = ge_identity();
#pragma unroll 1
    for (int j = threadIdx.x; j < bps; j += blockDim.x)
        v = ge_add(v, ge_load(partials + 32ll * ((long long)s * bps + j)));
    block_sum(v, sh);
    if (threadIdx.x == 0) ge_store(out + 32 * s, sh[0]);
}

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

// 64 signed base-16 digit codes (nibble j of word j / 8: the digit d & 15,
// d in [-8, 7], d = code - 16 for code >= 8) of bits 252..0 of the raw
// words at src, into code[0..7].
__device__ __forceinline__ void fold_recode(const int32_t* src, uint32_t* code) {
    uint32_t w[8];
    load_words(src, w);
    w[7] &= 0x1fffffffu;  // bits 253..255 are not read
    uint32_t carry = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        uint32_t c = 0u;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
            const uint32_t e = ((w[j] >> (4 * t)) & 15u) + carry;
            carry = e >= 8u ? 1u : 0u;
            c |= (e & 15u) << (4 * t);
        }
        code[j] = c;
    }
}

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

// Block b, group g (threads 8g .. 8g + 7): output 8b + g.  Groups past n
// run lane n - 1's fold and store nothing (every lane takes part in the
// shuffles).  The group's lane 0 recodes both scalars into its shared
// words (codes of wl, then wr).  The tables: entries 0..7 (k + 1) L,
// 8..15 (k + 1) R, made in extended form (2P = dbl P, odd multiples t(k-1) + P, even ones
// doubled from t(k/2)), then turned into niels form (Y+X, Y-X, 2dT, Z)
// four entries a stage, lane q the 2dT multiply of entry 4m + q.
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
    for (int s = 0; s < 2; ++s) {
        uint32_t* t = tbl + 256 * s;
        ge x = ge_load((s ? right : left) + 32 * i);
        // this lane's coordinate of P in niels form: (Y-X, Y+X, 2dT, Z)[q]
        fe mineP = fe_select(q == 0, fe_sub(x.Y, x.X), fe_select(q == 1, fe_add(x.Y, x.X), x.Z));
        if (q == 2) mineP = fe_mul_cc(x.T, fe_d2());
        fb_put(t, x, j);
#pragma unroll 1
        for (int k = 1; k < 8; ++k) {
            __syncwarp();
            if (k & 1) x = coop_double(fb_get(t + 32 * ((k - 1) / 2)), q, h, base, true);
            else x = coop_add_niels(x, mineP, q, h, base);
            fb_put(t + 32 * k, x, j);
        }
    }
    const fe d2 = fe_d2();
#pragma unroll 1
    for (int m = 0; m < 4; ++m) {
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

    // Straus: lane q reads its coordinate (Y-X, Y+X, 2dT, Z)[q] of the
    // selected entry; for a negative digit -Q = (Y-X, Y+X, -2dT, Z) in niels
    // form, so lanes 0 and 1 swap their reads and lane 2 negates
    ge acc = ge_identity();
    bool started = false;
#pragma unroll 1
    for (int win = 63; win >= 0; --win) {
        if (started) {
#pragma unroll 1
            for (int d = 0; d < 4; ++d) acc = coop_double(acc, q, h, base, d == 3);
        }
#pragma unroll 1
        for (int s = 0; s < 2; ++s) {
            const uint32_t c = (code[8 * s + (win >> 3)] >> (4 * (win & 7))) & 15u;
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
    if (live) {  // lane j stores words 4j .. 4j + 3 of the canonical point
        ge c;
        c.X = fe_canon(acc.X);
        c.Y = fe_canon(acc.Y);
        c.Z = fe_canon(acc.Z);
        c.T = fe_canon(acc.T);
        *reinterpret_cast<uint4*>(out + 32 * i + 4 * j) = ge_quarter(c, j);
    }
}

// The constant fold of the grid rounds (pallas_curve._fold_c_kernel):
// out[i] = P[i] + c_i * P[i + v], c_i the first constant below bp and the
// second from bp on, by the w4 ladder (~330 point operations per
// output; bound: integer multiplies).  Block (x, side): side s reads
// in + s * 2v points and its two constants' signed w4 words at
// words + 16 * s, and writes out + s * v points.  Thread i reads P[i] and
// P[i + v] and then writes only out[i], so one side may fold in place
// (out == in): no other thread reads row i.  Two sides must not (output
// row j of side 1 is an input row of side 0), so in and out carry no
// __restrict__ and the wrappers never alias the combined fold.
__global__ void __launch_bounds__(FOLD_THREADS)
fold_c_kernel(const int32_t* in, int32_t* out, const int32_t* __restrict__ words,
              int v, int bp) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= v) return;
    const int side = blockIdx.y;
    const int32_t* src = in + 64ll * v * side;
    uint32_t w[8];
    load_words(words + 16 * side + (i < bp ? 0 : 8), w);
    ge left = ge_load(src + 32 * i);
    ge prod = ladder_w4(ge_load(src + 32 * (i + v)), w);
    ge_store(out + 32ll * v * side + 32 * i, ge_add(prod, left));
}

static int msm_blocks(int n) { return (n + MSM_THREADS - 1) / MSM_THREADS; }

static int fold_c_launch(const int32_t* in, int32_t* out, const int32_t* words, int v,
                         int bp, int sides, void* stream) {
    if (v > 0)
        fold_c_kernel<<<dim3((v + FOLD_THREADS - 1) / FOLD_THREADS, sides), FOLD_THREADS, 0,
                        (cudaStream_t)stream>>>(in, out, words, v, bp);
    return (int)cudaGetLastError();
}

extern "C" {

// Makes `device` current for this library's CUDA runtime, which is linked
// in statically and so keeps a current device apart from the caller's;
// every entry point launches on it.  The wrappers call this before each
// launch (the caller may be a pool thread, or drive a second card).
int bp_set_device(int device) { return (int)cudaSetDevice(device); }

int bp_msm_threads(void) { return MSM_THREADS; }

// v independent MSM totals: out[s] = sum over points [s * seg, (s + 1) * seg).
// partials: scratch for v * max(1, ceil(seg / MSM_THREADS)) points.
int bp_msm_lane(const int32_t* pts, const int32_t* words, int32_t* out,
                int32_t* partials, int v, int seg, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int bps = msm_blocks(seg);
    if (v > 0 && bps > 0)
        msm_lane_partials<<<dim3(bps, v), MSM_THREADS, 0, s>>>(pts, words, partials, seg);
    if (v > 0) msm_lane_final<<<v, MSM_THREADS, 0, s>>>(partials, out, bps);
    return (int)cudaGetLastError();
}

int bp_fold_bits(const int32_t* left, const int32_t* right, const int32_t* wl,
                 const int32_t* wr, int32_t* out, int n, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0)
        fold_bits_kernel<<<(n + FB_THREADS / 8 - 1) / (FB_THREADS / 8), FB_THREADS, 0, s>>>(
            left, right, wl, wr, out, n);
    return (int)cudaGetLastError();
}

// out (v, 4, 8) from points (2v, 4, 8); words (1, 2, 8): the signed w4
// words of the constant below bp and of the one from bp on.  out may be
// points' first v rows (in place).
int bp_fold_c(const int32_t* pts, int32_t* out, const int32_t* words, int v, int bp,
              void* stream) {
    return fold_c_launch(pts, out, words, v, bp, 1, stream);
}

// out (2v, 4, 8) = [G'(v) | H'(v)] from points (4v, 4, 8) = [G(2v) | H(2v)];
// words (2, 2, 8), side 0 for G and 1 for H, both split at bp.  out must
// not overlap points.
int bp_fold_c_comb(const int32_t* pts, int32_t* out, const int32_t* words, int v, int bp,
                   void* stream) {
    return fold_c_launch(pts, out, words, v, bp, 2, stream);
}

}  // extern "C"
