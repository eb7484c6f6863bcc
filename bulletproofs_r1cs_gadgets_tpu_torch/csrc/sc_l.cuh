// Arithmetic mod l (the scalar field's order) on eight little-endian 32-bit
// words, for the kernels of oracle.cu (mul_fq) and poseidon.cu: the
// 512-bit schoolbook product, Barrett's reduction of any value below 2^512
// with base 2^32 and k = 8 words (Handbook of Applied Cryptography 14.42),
// and the canonical sum.  Every result is canonical, in [0, l).
#pragma once

#include <cstdint>

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

// x (16 words) = a * b, for any a, b < 2^256.
__device__ __forceinline__ void sc_mul_wide(const uint32_t a[8], const uint32_t b[8],
                                            uint32_t x[16]) {
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
}

// r = x mod l for any x < 2^512: q3 = floor(floor(x / 2^224) * mu /
// 2^288), r = (x - q3 * l) mod 2^288 < 3l, then at most two subtractions
// of l.
__device__ __forceinline__ void sc_reduce_wide(const uint32_t x[16], uint32_t r[8]) {
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

// r = a * b mod l for any a, b < 2^256 (r may alias a or b).
__device__ __forceinline__ void sc_mul_canon(const uint32_t a[8], const uint32_t b[8],
                                             uint32_t r[8]) {
    uint32_t x[16];
    sc_mul_wide(a, b, x);
    sc_reduce_wide(x, r);
}

// acc (16 words) += a * b, for a, b < 2^256 and a sum that stays below
// 2^512 (the caller's bound).
__device__ __forceinline__ void sc_mul_acc(const uint32_t a[8], const uint32_t b[8],
                                           uint32_t acc[16]) {
    uint32_t x[16];
    sc_mul_wide(a, b, x);
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        c += (uint64_t)acc[i] + x[i];
        acc[i] = (uint32_t)c;
        c >>= 32;
    }
}

// r = a + b mod l for canonical a, b (r may alias a or b): the sum is
// below 2l < 2^254, so one conditional subtraction of l.
__device__ __forceinline__ void sc_add_canon(const uint32_t a[8], const uint32_t b[8],
                                             uint32_t r[8]) {
    uint32_t s[8], d[8];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (uint64_t)a[i] + b[i];
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    uint64_t br = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t t = (uint64_t)s[i] - SC_L[i] - br;
        d[i] = (uint32_t)t;
        br = t >> 63;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = br ? s[i] : d[i];
}
