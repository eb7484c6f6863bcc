// Hopper kernels for the w5 shared-table walker: the 16-multiple niels
// table over the fixed generators (table_w5) and the window-accumulator
// MSM that walks it (msm_win5).  Plain C entry points for ctypes
// (ops/build.py), with the conventions of msm_fold.cu: launch on the
// caller's stream, never synchronise, allocate nothing, return
// cudaGetLastError().
//
// Layouts (row-major, int32):
//   points (n, 4, 8):      X, Y, Z, T, eight little-endian words each
//   table  (n, 16, 4, 8):  entry k of point i is (k + 1) * P_i in niels
//                          form (Y+X, Y-X, 2d*T, Z), every word canonical
//   words  (m, 16):        51 signed base-32 digits d in [-16, 15] per
//                          scalar, one per byte (code d & 31; byte i of the
//                          64-byte row is digit i, little-endian words)
//
// What bounds msm_win5: integer multiplies again (8 field multiplies per
// niels add, 51 adds per point) and, second, the table stream (128 B per
// point per window, 1.7 GB for a 2^18-point walk).  Design: the TPU kernel
// walks windows in order and folds each window's sum in by Horner; here a
// block owns ONE window and WIN_PTS points (the windows run in parallel,
// so no thread pays for doublings), each thread sums its WIN_PPT selected
// entries, a block tree reduces them, a second launch sums each window's
// partials, and one thread folds the 51 window totals by Horner (5
// doublings + 1 add each) and adds the chain.
#include <cuda_runtime.h>
#include <cstdint>

#include "ge25519.cuh"

#define W5_WINDOWS 51
#define TBL5 16
#define TABLE_THREADS 128
#define WIN_THREADS 128
#define WIN_PPT 16
#define WIN_PTS (WIN_THREADS * WIN_PPT)

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

// One thread per point: (k + 1) * P for k = 0..15 by the TPU kernel's
// sequence (odd multiples t(k-1) + P, even ones doubled from t(k/2)), each
// stored in niels form with canonical words.
__global__ void __launch_bounds__(TABLE_THREADS)
table_w5_kernel(const int32_t* __restrict__ pts, int32_t* __restrict__ table, int n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    ge t[TBL5];
    t[0] = ge_load(pts + 32 * i);
    t[1] = ge_double(t[0]);
#pragma unroll 1
    for (int k = 3; k <= TBL5; ++k)
        t[k - 1] = (k & 1) ? ge_add(t[k - 2], t[0]) : ge_double(t[k / 2 - 1]);
    const fe d2 = fe_d2();
#pragma unroll 1
    for (int k = 0; k < TBL5; ++k) {
        int32_t* dst = table + 32 * (i * TBL5 + k);
        fe_store_canon(dst, fe_add(t[k].Y, t[k].X));
        fe_store_canon(dst + 8, fe_sub(t[k].Y, t[k].X));
        fe_store_canon(dst + 16, fe_mul(t[k].T, d2));
        fe_store_canon(dst + 24, t[k].Z);
    }
}

// Pass 1: block (b, win) sums, over walk steps j in [b * WIN_PTS,
// (b + 1) * WIN_PTS) of [0, v), the table entry that step j's digit `win`
// selects.  Step j reads table row poff + j below `split` and row
// poff2 + (j - split) from there on, and word row woff + j.  Partials are
// stored window-major: partials[win * gridDim.x + b].
__global__ void __launch_bounds__(WIN_THREADS)
msm_win5_partials(const int32_t* __restrict__ table, const int32_t* __restrict__ words,
                  int32_t* __restrict__ partials, int v, int poff, int woff,
                  int split, int poff2) {
    __shared__ ge sh[WIN_THREADS];
    int b = blockIdx.x;
    int win = blockIdx.y;
    int wsel = win >> 2;
    int shift = 8 * (win & 3);
    ge acc = ge_identity();
#pragma unroll 1
    for (int k = 0; k < WIN_PPT; ++k) {
        int j = b * WIN_PTS + k * WIN_THREADS + threadIdx.x;
        if (j >= v) break;
        uint32_t e = ((uint32_t)__ldg(words + 16ll * (woff + j) + wsel) >> shift) & 31u;
        if (e == 0u) continue;  // digit 0 adds the identity
        bool neg = e >= 16u;    // code 16 is the digit -16: entry 16P negated
        uint32_t mag = neg ? 32u - e : e;
        long long row = j < split ? (long long)poff + j : (long long)poff2 + (j - split);
        niels q = niels_load(table + 32ll * (row * TBL5 + (mag - 1)));
        if (neg) q = niels_neg(q);
        acc = ge_add_niels(acc, q);
    }
    block_sum(acc, sh);
    if (threadIdx.x == 0)
        ge_store_raw(partials + 32ll * ((long long)win * gridDim.x + b), sh[0]);
}

// Pass 2: block `win` sums window win's nb partials into wtot[win].
__global__ void __launch_bounds__(WIN_THREADS)
msm_win5_windows(const int32_t* __restrict__ partials, int32_t* __restrict__ wtot, int nb) {
    __shared__ ge sh[WIN_THREADS];
    int win = blockIdx.x;
    ge v = ge_identity();
#pragma unroll 1
    for (int j = threadIdx.x; j < nb; j += blockDim.x)
        v = ge_add(v, ge_load(partials + 32ll * ((long long)win * nb + j)));
    block_sum(v, sh);
    if (threadIdx.x == 0) ge_store_raw(wtot + 32 * win, sh[0]);
}

// Pass 3 (one thread): Horner over the window totals, most significant
// first, then the chain: out = chain + sum_win 32^win * wtot[win].
__global__ void msm_win5_horner(const int32_t* __restrict__ wtot,
                                const int32_t* __restrict__ chain,
                                int32_t* __restrict__ out) {
    ge h = ge_load(wtot + 32 * (W5_WINDOWS - 1));
#pragma unroll 1
    for (int win = W5_WINDOWS - 2; win >= 0; --win) {
#pragma unroll 1
        for (int d = 0; d < 5; ++d) h = ge_double(h);
        h = ge_add(h, ge_load(wtot + 32 * win));
    }
    ge_store(out, ge_add(h, ge_load(chain)));
}

extern "C" {

int bp_win5_points_per_block(void) { return WIN_PTS; }

int bp_win5_windows(void) { return W5_WINDOWS; }

int bp_table_w5(const int32_t* pts, int32_t* table, int n, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n > 0)
        table_w5_kernel<<<(n + TABLE_THREADS - 1) / TABLE_THREADS, TABLE_THREADS, 0, s>>>(
            pts, table, n);
    return (int)cudaGetLastError();
}

// out (1, 4, 8) = chain + sum_{j < v} d_j * P_row(j) (see msm_win5_partials).
// partials: scratch for W5_WINDOWS * ceil(v / WIN_PTS) points; wtot: for
// W5_WINDOWS points.
int bp_msm_win5(const int32_t* table, const int32_t* words, const int32_t* chain,
                int32_t* out, int32_t* partials, int32_t* wtot, int v, int poff,
                int woff, int split, int poff2, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int nb = (v + WIN_PTS - 1) / WIN_PTS;
    if (nb > 0)
        msm_win5_partials<<<dim3(nb, W5_WINDOWS), WIN_THREADS, 0, s>>>(
            table, words, partials, v, poff, woff, split, poff2);
    msm_win5_windows<<<W5_WINDOWS, WIN_THREADS, 0, s>>>(partials, wtot, nb);
    msm_win5_horner<<<1, 1, 0, s>>>(wtot, chain, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
