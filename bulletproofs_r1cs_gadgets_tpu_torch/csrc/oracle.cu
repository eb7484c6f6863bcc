// Hopper kernels for the device-oracle path (ops/{field,curve,msm,backend,
// poseidon}.py, parallel/pipeline.py): the pointwise group operations
// (padd, pdbl), the bit-serial scalar ladder (smul_lanes: one point per
// lane) and the elementwise field multiplies mod p and mod l (mul_fp,
// mul_fq).  The path's MSMs (msm_chunk_acc, msm_block_totals) run the
// windowed w4 MSM of win.cu, and its fold (fold_grid) the Straus designs
// of msm_fold.cu.  Plain C entry points for ctypes (ops/build.py): each
// launches on the caller's stream, never synchronises, allocates nothing,
// and returns cudaGetLastError().
//
// Layouts (row-major, int32): points (n, 4, 8), X, Y, Z, T as eight
// little-endian words, any value below 2^256; scalar bit words (n, 8), bit
// b of the scalar in bit b % 32 of word b / 32 (bits 253..255 are not
// read); field elements (n, 8), any value below 2^256.  Every output is
// canonical: coordinates in [0, p), field values in [0, m).
//
// What bounds them: 32-bit integer multiplies for the ladder (253
// doublings and 253 adds of ~9 field multiplies each per point, against
// 160 B read); padd / pdbl / mul_* read and write a few hundred bytes per
// ~9 (or one) field multiplies and are bound by memory.  The design answer
// is the simplest exact one: one thread per output, the TPU kernels' own
// operation sequence (the identity is doubled and added like any point,
// so the outputs equal the plain versions word for word).
#include <cuda_runtime.h>
#include <cstdint>

#include "ge25519.cuh"

#define OR_THREADS 128  // threads per block

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
