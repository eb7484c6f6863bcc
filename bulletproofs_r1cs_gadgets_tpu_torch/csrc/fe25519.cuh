// Field arithmetic mod p = 2^255 - 19 for the Hopper MSM and fold kernels.
//
// An element is eight little-endian 32-bit words holding ANY value in
// [0, 2^256): the kernels keep coordinates in this bounded, non-canonical
// range and reduce to [0, p) only where a point is stored for the host
// (fe_canon).  Every operation folds a carry out of bit 256 back in with
// 2^256 == 38 (mod p), so no intermediate ever leaves the 256-bit range:
//
//   add: a + b < 2^257; the carry c <= 1 folds as +38c.  If that wraps
//        again the low value is < 38 and one more +38 cannot wrap.
//   sub: a - b borrows at most once; a borrow means +2^256 == +38 was
//        added, so 38 is subtracted (at most twice, see fe_sub).
//   mul: 8x8 schoolbook into 16 words with 64-bit accumulators
//        ((2^32-1)^2 + 2(2^32-1) = 2^64 - 1 fits exactly), then
//        low + 38 * high leaves a carry < 40, folded as in add.
#pragma once
#include <cstdint>

struct fe {
    uint32_t w[8];
};

// 2 * d mod p (edwards25519 d), little-endian words; the Python side
// checks these words against the JAX package's constant.  Constants are
// static: every source that includes this header has its own copy.
static __device__ __constant__ uint32_t FE_D2[8] = {
    0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
    0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu,
};

// p = 2^255 - 19
static __device__ __constant__ uint32_t FE_P[8] = {
    0xffffffedu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0x7fffffffu,
};

__device__ __forceinline__ fe fe_zero() {
    fe r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = 0u;
    return r;
}

__device__ __forceinline__ fe fe_one() {
    fe r = fe_zero();
    r.w[0] = 1u;
    return r;
}

__device__ __forceinline__ bool fe_is_zero_words(const uint32_t w[8]) {
    uint32_t x = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) x |= w[i];
    return x == 0u;
}

// r + top * 2^256 (mod p) for top < 2^26, result in [0, 2^256).
__device__ __forceinline__ void fe_fold(uint32_t r[8], uint32_t top) {
    uint64_t c = (uint64_t)top * 38u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += r[i];
        r[i] = (uint32_t)c;
        c >>= 32;
    }
    // a second wrap leaves r < 38 * top, so this add cannot carry
    r[0] += (uint32_t)c * 38u;
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
    fe r;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (uint64_t)a.w[i] + b.w[i];
        r.w[i] = (uint32_t)c;
        c >>= 32;
    }
    fe_fold(r.w, (uint32_t)c);
    return r;
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
    fe r;
    uint64_t br = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t d = (uint64_t)a.w[i] - b.w[i] - br;
        r.w[i] = (uint32_t)d;
        br = d >> 63;
    }
    // a borrow wrapped the value by +2^256 == +38: take 38 off.  A second
    // borrow (value < 38) wraps by 2^256 again and the second pass takes
    // 38 off once more, which cannot borrow.
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        uint64_t s = br * 38u;
        br = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            uint64_t d = (uint64_t)r.w[i] - (i == 0 ? s : 0u) - br;
            r.w[i] = (uint32_t)d;
            br = d >> 63;
        }
    }
    return r;
}

__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
    uint32_t t[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            c += (uint64_t)a.w[i] * b.w[j] + t[i + j];
            t[i + j] = (uint32_t)c;
            c >>= 32;
        }
        t[i + 8] = (uint32_t)c;
    }
    fe r;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (uint64_t)t[i] + (uint64_t)t[i + 8] * 38u;
        r.w[i] = (uint32_t)c;
        c >>= 32;
    }
    fe_fold(r.w, (uint32_t)c);
    return r;
}

__device__ __forceinline__ fe fe_sq(const fe& a) { return fe_mul(a, a); }

__device__ __forceinline__ fe fe_neg(const fe& a) { return fe_sub(fe_zero(), a); }

__device__ __forceinline__ fe fe_d2() {
    fe r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = FE_D2[i];
    return r;
}

// [0, 2^256) -> [0, p): 2^256 < 3p, so at most two subtractions of p.
__device__ __forceinline__ fe fe_canon(const fe& a) {
    fe r = a;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        uint32_t d[8];
        uint64_t br = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            uint64_t x = (uint64_t)r.w[i] - FE_P[i] - br;
            d[i] = (uint32_t)x;
            br = x >> 63;
        }
        if (!br) {
#pragma unroll
            for (int i = 0; i < 8; ++i) r.w[i] = d[i];
        }
    }
    return r;
}
