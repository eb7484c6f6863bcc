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
// What bounds these kernels: integer multiply throughput.  One w4 ladder
// is ~330 point operations of ~9 field multiplies of 64 32x32->64
// products each, against 128 B of point and 32 B of scalar read, so the
// kernels are compute bound by three orders of magnitude.  The design
// answer is one independent ladder per thread (no cross-thread traffic
// until the end) and one block reduction in shared memory; per-thread
// tables live in local memory, which the L1 serves.
#include <cuda_runtime.h>
#include <cstdint>

#include "ge25519.cuh"

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

// out[i] = wl_i * L_i + wr_i * R_i by the dual bit-serial ladder over bits
// 252..0 (scalars are below the group order, < 2^253).  Both scalars zero
// gives the identity.
__global__ void __launch_bounds__(FOLD_THREADS)
fold_bits_kernel(const int32_t* __restrict__ left, const int32_t* __restrict__ right,
                 const int32_t* __restrict__ wl, const int32_t* __restrict__ wr,
                 int32_t* __restrict__ out, int n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t a[8], b[8];
    load_words(wl + 8 * i, a);
    load_words(wr + 8 * i, b);
    ge acc = ge_identity();
    if (!(fe_is_zero_words(a) && fe_is_zero_words(b))) {
        ge L = ge_load(left + 32 * i);
        ge R = ge_load(right + 32 * i);
        ge LR = ge_add(L, R);
        bool started = false;
#pragma unroll 1
        for (int pos = 252; pos >= 0; --pos) {
            if (started) acc = ge_double(acc);
            uint32_t bl = (a[pos >> 5] >> (pos & 31)) & 1u;
            uint32_t br = (b[pos >> 5] >> (pos & 31)) & 1u;
            if (bl | br) {
                const ge& s = bl ? (br ? LR : L) : R;
                acc = started ? ge_add(acc, s) : s;
                started = true;
            }
        }
    }
    ge_store(out + 32 * i, acc);
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
        fold_bits_kernel<<<(n + FOLD_THREADS - 1) / FOLD_THREADS, FOLD_THREADS, 0, s>>>(
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
