// Hopper kernels for the device-oracle path (ops/{field,curve,msm,backend,
// poseidon}.py, parallel/pipeline.py): the pointwise group operations
// (padd, pdbl), the bit-serial scalar ladder with its three epilogues
// (smul_lanes: one point per lane; msm_block_totals: one total per 2048
// input points; msm_chunk_acc: one total plus an incoming accumulator),
// the signed 2-bit dual fold (fold_grid) and the elementwise field
// multiplies mod p and mod l (mul_fp, mul_fq).  Plain C entry points for
// ctypes (ops/build.py): each launches on the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError().
//
// Layouts (row-major, int32): points (n, 4, 8), X, Y, Z, T as eight
// little-endian words, any value below 2^256; scalar bit words (n, 8), bit
// b of the scalar in bit b % 32 of word b / 32 (bits 253..255 are not
// read); w2 fold words (n, 8) or one row for every lane, 128 signed
// base-4 digits d in [-2, 1] coded d & 3, two bits each, digit i in bits
// 2(i % 16) of word i / 16; field elements (n, 8), any value below 2^256.
// Every output is canonical: coordinates in [0, p), field values in
// [0, m).
//
// What bounds them: 32-bit integer multiplies (a bit ladder is 253
// doublings and 253 adds of ~9 field multiplies each per point, against
// 160 B read), except padd / pdbl / mul_*, which read and write a few
// hundred bytes per ~9 (or one) field multiplies and are bound by memory.
// The design answer is the simplest exact one: one thread per output, the
// TPU kernels' own operation sequence (the identity is doubled and added
// like any point, so the outputs equal the plain versions word for word),
// block sums by the shared-memory tree of ge25519.cuh.
#include <cuda_runtime.h>
#include <cstdint>

#include "ge25519.cuh"

// the plain versions (ops/cuda_curve.py ORACLE_THREADS, BLOCK_PTS) sum in
// the same order, so these two must match them
#define OR_THREADS 128                      // threads per block, one partial each
#define OR_BLOCK_PTS 2048                   // msm_block_totals: input points per total
#define OR_PARTS (OR_BLOCK_PTS / OR_THREADS)  // partials per total

// l = 2^252 + 27742317777372353535851937790883648493, little-endian words
static __device__ __constant__ uint32_t SC_L[8] = {
    0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
    0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u,
};
// Barrett's mu = floor(2^512 / l) (260 bits)
static __device__ __constant__ uint32_t SC_MU[9] = {
    0x0a2c131bu, 0xed9ce5a3u, 0x086329a7u, 0x2106215du, 0xffffffebu,
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0x0000000fu,
};

__device__ __forceinline__ void or_load8(const int32_t* src, uint32_t w[8]) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = s[i];
}

__device__ __forceinline__ void or_store8(int32_t* dst, const uint32_t w[8]) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = w[i];
}

// s * P by the TPU's bit-serial ladder (pallas_curve._ladder): from bit 252
// down to bit 0, double, then add P where the bit is set and the identity
// where it is not.  No step is skipped, so the projective result is the
// plain version's (and, mod p, the TPU's) to the word.
static __device__ __noinline__ ge ladder_bits(const ge& P, const uint32_t w[8]) {
    const ge I = ge_identity();
    ge acc = I;
#pragma unroll 1
    for (int pos = 252; pos >= 0; --pos) {
        acc = ge_double(acc);
        const ge& s = ((w[pos >> 5] >> (pos & 31)) & 1u) ? P : I;
        acc = ge_add(acc, s);
    }
    return acc;
}

__global__ void __launch_bounds__(OR_THREADS)
padd_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
            int32_t* __restrict__ out, int n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    ge_store(out + 32 * i, ge_add(ge_load(a + 32 * i), ge_load(b + 32 * i)));
}

__global__ void __launch_bounds__(OR_THREADS)
pdbl_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, int n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    ge_store(out + 32 * i, ge_double(ge_load(a + 32 * i)));
}

// smul_lanes: out[i] = s_i * P_i
__global__ void __launch_bounds__(OR_THREADS)
smul_lanes_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ words,
                  int32_t* __restrict__ out, int n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t w[8];
    or_load8(words + 8 * i, w);
    ge_store(out + 32 * i, ladder_bits(ge_load(pts + 32 * i), w));
}

// The MSM's first pass: block b runs the ladders of points
// [b * T, (b + 1) * T) (the identity past n) and writes their sum, by the
// shared-memory tree, to partials[b].
__global__ void __launch_bounds__(OR_THREADS)
ladder_partials_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ words,
                       int32_t* __restrict__ partials, int n) {
    __shared__ ge sh[OR_THREADS];
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    ge v = ge_identity();
    if (i < n) {
        uint32_t w[8];
        or_load8(words + 8 * i, w);
        v = ladder_bits(ge_load(pts + 32 * i), w);
    }
    block_sum(v, sh);
    if (threadIdx.x == 0) ge_store_raw(partials + 32ll * blockIdx.x, sh[0]);
}

// msm_block_totals' second pass: block b sums the OR_PARTS partials of
// input points [2048 b, 2048 (b + 1)) by the tree (one thread each).
__global__ void __launch_bounds__(OR_PARTS)
block_totals_kernel(const int32_t* __restrict__ partials, int32_t* __restrict__ out) {
    __shared__ ge sh[OR_PARTS];
    block_sum(ge_load(partials + 32ll * (blockIdx.x * OR_PARTS + threadIdx.x)), sh);
    if (threadIdx.x == 0) ge_store(out + 32ll * blockIdx.x, sh[0]);
}

// msm_chunk_acc's second pass (one block): thread t adds partials
// t, t + T, ... to the identity, the tree sums the threads, and the
// incoming accumulator is added last.
__global__ void __launch_bounds__(OR_THREADS)
chunk_acc_final_kernel(const int32_t* __restrict__ partials, const int32_t* __restrict__ acc,
                       int32_t* __restrict__ out, int nparts) {
    __shared__ ge sh[OR_THREADS];
    ge v = ge_identity();
#pragma unroll 1
    for (int j = threadIdx.x; j < nparts; j += blockDim.x)
        v = ge_add(v, ge_load(partials + 32ll * j));
    block_sum(v, sh);
    if (threadIdx.x == 0) ge_store(out, ge_add(sh[0], ge_load(acc)));
}

// d * P for the signed base-4 digit at `pos` (code e = d & 3: e = 2 is
// d = -2, e = 3 is d = -1) from the table {P, 2P} (pallas_curve
// ._w2_digit_select): the identity for d = 0, negated for d < 0.
__device__ __forceinline__ ge w2_select(const uint32_t w[8], int pos, const ge& P1,
                                        const ge& P2, const ge& I) {
    uint32_t e = (w[pos >> 4] >> (2 * (pos & 15))) & 3u;
    bool neg = e >= 2u;
    uint32_t mag = neg ? 4u - e : e;
    ge s = mag == 1u ? P1 : (mag == 2u ? P2 : I);
    return neg ? ge_neg(s) : s;
}

// fold_grid: out[i] = wl_i * P[i] + wr_i * P[i + v] by the TPU's dual w2
// ladder (pallas_curve._emit_fold_w2): 128 windows, most significant
// first, each two doublings and one selected add per side.  A word stride
// of 0 reads one row for every lane (a constant scalar).  Thread i reads
// rows i and i + v and writes out[i] of a tensor apart from the input.
__global__ void __launch_bounds__(OR_THREADS)
fold_grid_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ wl,
                 const int32_t* __restrict__ wr, int32_t* __restrict__ out, int v,
                 int wl_stride, int wr_stride) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= v) return;
    uint32_t a[8], b[8];
    or_load8(wl + (long long)wl_stride * i, a);
    or_load8(wr + (long long)wr_stride * i, b);
    const ge I = ge_identity();
    ge L1 = ge_load(pts + 32 * i);
    ge R1 = ge_load(pts + 32 * (i + v));
    ge L2 = ge_double(L1);
    ge R2 = ge_double(R1);
    ge acc = I;
#pragma unroll 1
    for (int pos = 127; pos >= 0; --pos) {
        acc = ge_double(acc);
        acc = ge_double(acc);
        acc = ge_add(acc, w2_select(a, pos, L1, L2, I));
        acc = ge_add(acc, w2_select(b, pos, R1, R2, I));
    }
    ge_store(out + 32 * i, acc);
}

__global__ void __launch_bounds__(OR_THREADS)
mul_fp_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
              int32_t* __restrict__ out, int n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fe x, y;
    or_load8(a + 8 * i, x.w);
    or_load8(b + 8 * i, y.w);
    fe r = fe_canon(fe_mul(x, y));
    or_store8(out + 8 * i, r.w);
}

// a * b mod l for any a, b < 2^256: the 512-bit schoolbook product, then
// Barrett's reduction with base 2^32 and k = 8 words (Handbook of Applied
// Cryptography 14.42): q3 = floor(floor(x / 2^224) * mu / 2^288),
// r = (x - q3 * l) mod 2^288 < 3l, then at most two subtractions of l.
__device__ __forceinline__ void sc_mul_canon(const uint32_t a[8], const uint32_t b[8],
                                             uint32_t r[8]) {
    uint32_t x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            c += (uint64_t)a[i] * b[j] + x[i + j];
            x[i + j] = (uint32_t)c;
            c >>= 32;
        }
        x[i + 8] = (uint32_t)c;
    }
    // q2 = q1 * mu with q1 = x[7..15] (9 words); q3 = q2[9..17]
    uint32_t q2[18];
#pragma unroll
    for (int i = 0; i < 18; ++i) q2[i] = 0u;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 9; ++j) {
            c += (uint64_t)x[7 + i] * SC_MU[j] + q2[i + j];
            q2[i + j] = (uint32_t)c;
            c >>= 32;
        }
        q2[i + 9] = (uint32_t)c;
    }
    // r2 = q3 * l mod 2^288 (l's ninth word is 0)
    uint32_t r2[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) r2[i] = 0u;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 9 - i; ++j) {
            c += (uint64_t)q2[9 + i] * (j < 8 ? SC_L[j] : 0u) + r2[i + j];
            r2[i + j] = (uint32_t)c;
            c >>= 32;
        }
    }
    // rr = (x mod 2^288) - r2 mod 2^288, in [0, 3l)
    uint32_t rr[9];
    uint64_t br = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        uint64_t d = (uint64_t)x[i] - r2[i] - br;
        rr[i] = (uint32_t)d;
        br = d >> 63;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        uint32_t d[9];
        br = 0;
#pragma unroll
        for (int i = 0; i < 9; ++i) {
            uint64_t t = (uint64_t)rr[i] - (i < 8 ? SC_L[i] : 0u) - br;
            d[i] = (uint32_t)t;
            br = t >> 63;
        }
        if (!br) {
#pragma unroll
            for (int i = 0; i < 9; ++i) rr[i] = d[i];
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = rr[i];
}

__global__ void __launch_bounds__(OR_THREADS)
mul_fq_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
              int32_t* __restrict__ out, int n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[8], y[8], r[8];
    or_load8(a + 8 * i, x);
    or_load8(b + 8 * i, y);
    sc_mul_canon(x, y, r);
    or_store8(out + 8 * i, r);
}

static int or_blocks(long long n) { return (int)((n + OR_THREADS - 1) / OR_THREADS); }

extern "C" {

// out (n, 4, 8) = a + b, pointwise
int bp_padd(const int32_t* a, const int32_t* b, int32_t* out, int n, void* stream) {
    if (n > 0)
        padd_kernel<<<or_blocks(n), OR_THREADS, 0, (cudaStream_t)stream>>>(a, b, out, n);
    return (int)cudaGetLastError();
}

// out (n, 4, 8) = 2 a, pointwise
int bp_pdbl(const int32_t* a, int32_t* out, int n, void* stream) {
    if (n > 0)
        pdbl_kernel<<<or_blocks(n), OR_THREADS, 0, (cudaStream_t)stream>>>(a, out, n);
    return (int)cudaGetLastError();
}

// out (n, 4, 8): out[i] = s_i * P_i, s_i from bit words (n, 8)
int bp_smul_lanes(const int32_t* pts, const int32_t* words, int32_t* out, int n,
                  void* stream) {
    if (n > 0)
        smul_lanes_kernel<<<or_blocks(n), OR_THREADS, 0, (cudaStream_t)stream>>>(
            pts, words, out, n);
    return (int)cudaGetLastError();
}

// out (ceil(n / 2048), 4, 8): out[b] = sum of s_i * P_i over input points
// [2048 b, 2048 (b + 1)); partials: scratch for ceil(n / 2048) * 16 points.
int bp_msm_block_totals(const int32_t* pts, const int32_t* words, int32_t* out,
                        int32_t* partials, int n, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int nb = (n + OR_BLOCK_PTS - 1) / OR_BLOCK_PTS;
    if (nb > 0) {
        ladder_partials_kernel<<<nb * OR_PARTS, OR_THREADS, 0, s>>>(pts, words, partials, n);
        block_totals_kernel<<<nb, OR_PARTS, 0, s>>>(partials, out);
    }
    return (int)cudaGetLastError();
}

// out (1, 4, 8) = acc + sum_i s_i * P_i over n points; partials: scratch
// for max(1, ceil(n / 128)) points.
int bp_msm_chunk_acc(const int32_t* pts, const int32_t* words, const int32_t* acc,
                     int32_t* out, int32_t* partials, int n, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int nparts = or_blocks(n);
    if (nparts > 0)
        ladder_partials_kernel<<<nparts, OR_THREADS, 0, s>>>(pts, words, partials, n);
    chunk_acc_final_kernel<<<1, OR_THREADS, 0, s>>>(partials, acc, out, nparts);
    return (int)cudaGetLastError();
}

// out (v, 4, 8): out[i] = wl_i * P[i] + wr_i * P[i + v] over points
// (>= 2v, 4, 8); w2 word rows at stride wl_stride / wr_stride words (8 per
// lane, or 0 for one row read by every lane).  out must not overlap pts.
int bp_fold_grid(const int32_t* pts, const int32_t* wl, const int32_t* wr, int32_t* out,
                 int v, int wl_stride, int wr_stride, void* stream) {
    if (v > 0)
        fold_grid_kernel<<<or_blocks(v), OR_THREADS, 0, (cudaStream_t)stream>>>(
            pts, wl, wr, out, v, wl_stride, wr_stride);
    return (int)cudaGetLastError();
}

// out (n, 8) = a * b mod p, canonical
int bp_mul_fp(const int32_t* a, const int32_t* b, int32_t* out, int n, void* stream) {
    if (n > 0)
        mul_fp_kernel<<<or_blocks(n), OR_THREADS, 0, (cudaStream_t)stream>>>(a, b, out, n);
    return (int)cudaGetLastError();
}

// out (n, 8) = a * b mod l, canonical
int bp_mul_fq(const int32_t* a, const int32_t* b, int32_t* out, int n, void* stream) {
    if (n > 0)
        mul_fq_kernel<<<or_blocks(n), OR_THREADS, 0, (cudaStream_t)stream>>>(a, b, out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
