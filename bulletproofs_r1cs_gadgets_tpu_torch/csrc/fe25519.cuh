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

// ---- the carry-chain multiply and squaring (fe_mul_cc, fe_sq_cc): the
// same values as fe_mul / fe_sq, each partial-product row one PTX carry
// chain (mad.lo.cc / madc.lo.cc, then madc.hi.cc), so no 64-bit adds or
// separate carry words.  One instruction per asm statement, as carry
// chains are written in PTX libraries: the compiler places nothing that
// writes the carry flag between the statements of one chain.  Every point
// operation (ge25519_cc.cuh) uses them; mul_fp and the multiply test entry
// (win.cu fe_mul_test) keep fe_mul.
namespace ptx {
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
// the last of a chain: takes the carry in, sets none
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
// the carry flag as a word (the last of a chain)
__device__ __forceinline__ uint32_t carry() {
    uint32_t r;
    asm volatile("addc.u32 %0, 0, 0;" : "=r"(r));
    return r;
}
}  // namespace ptx

// t (16 words, < 2^512) -> [0, 2^256): low + 38 * high in two chains (the
// top word < 40), then top * 38 folded in as fe_fold does.
__device__ __forceinline__ fe fe_reduce_cc(const uint32_t t[16]) {
    fe r;
    r.w[0] = ptx::mad_lo_cc(t[8], 38u, t[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) r.w[i] = ptx::madc_lo_cc(t[8 + i], 38u, t[i]);
    uint32_t top = ptx::carry();
    r.w[1] = ptx::mad_hi_cc(t[8], 38u, r.w[1]);
#pragma unroll
    for (int i = 1; i < 7; ++i) r.w[i + 1] = ptx::madc_hi_cc(t[8 + i], 38u, r.w[i + 1]);
    top = ptx::madc_hi(t[15], 38u, top);
    r.w[0] = ptx::add_cc(r.w[0], top * 38u);
#pragma unroll
    for (int i = 1; i < 8; ++i) r.w[i] = ptx::addc_cc(r.w[i], 0u);
    // a second wrap leaves r < 38 * 40, so this add cannot carry
    r.w[0] += ptx::carry() * 38u;
    return r;
}

// Row i adds a_i * b to t[i .. i + 8] (t[i + 8] fresh): the low halves in
// one chain, its carry into t[i + 8], the high halves in a second chain
// one word up.  The running sum stays below 2^(32 (i + 9)), so the last
// high add cannot carry out.
__device__ __forceinline__ fe fe_mul_cc(const fe& a, const fe& b) {
    uint32_t t[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = a.w[0] * b.w[j];
    t[1] = ptx::mad_hi_cc(a.w[0], b.w[0], t[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j) t[j + 1] = ptx::madc_hi_cc(a.w[0], b.w[j], t[j + 1]);
    t[8] = ptx::madc_hi(a.w[0], b.w[7], 0u);
#pragma unroll
    for (int i = 1; i < 8; ++i) {
        t[i] = ptx::mad_lo_cc(a.w[i], b.w[0], t[i]);
#pragma unroll
        for (int j = 1; j < 8; ++j) t[i + j] = ptx::madc_lo_cc(a.w[i], b.w[j], t[i + j]);
        t[i + 8] = ptx::carry();
        t[i + 1] = ptx::mad_hi_cc(a.w[i], b.w[0], t[i + 1]);
#pragma unroll
        for (int j = 1; j < 7; ++j) t[i + j + 1] = ptx::madc_hi_cc(a.w[i], b.w[j], t[i + j + 1]);
        t[i + 8] = ptx::madc_hi(a.w[i], b.w[7], t[i + 8]);
    }
    return fe_reduce_cc(t);
}

// a^2 from 36 products: the 28 cross products a_i a_j (i < j) by rows as
// in fe_mul_cc, doubled by a one-bit shift, then the 8 squares a_i^2 in
// one chain.
__device__ __forceinline__ fe fe_sq_cc(const fe& a) {
    uint32_t t[16];
    t[0] = 0u;
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = a.w[0] * a.w[j];
    t[2] = ptx::mad_hi_cc(a.w[0], a.w[1], t[2]);
#pragma unroll
    for (int j = 2; j < 7; ++j) t[j + 1] = ptx::madc_hi_cc(a.w[0], a.w[j], t[j + 1]);
    t[8] = ptx::madc_hi(a.w[0], a.w[7], 0u);
#pragma unroll
    for (int i = 1; i < 6; ++i) {
        t[2 * i + 1] = ptx::mad_lo_cc(a.w[i], a.w[i + 1], t[2 * i + 1]);
#pragma unroll
        for (int j = i + 2; j < 8; ++j) t[i + j] = ptx::madc_lo_cc(a.w[i], a.w[j], t[i + j]);
        t[i + 8] = ptx::carry();
        t[2 * i + 2] = ptx::mad_hi_cc(a.w[i], a.w[i + 1], t[2 * i + 2]);
#pragma unroll
        for (int j = i + 2; j < 7; ++j) t[i + j + 1] = ptx::madc_hi_cc(a.w[i], a.w[j], t[i + j + 1]);
        t[i + 8] = ptx::madc_hi(a.w[i], a.w[7], t[i + 8]);
    }
    t[13] = ptx::mad_lo_cc(a.w[6], a.w[7], t[13]);
    t[14] = ptx::carry() + __umulhi(a.w[6], a.w[7]);
    t[15] = t[14] >> 31;
#pragma unroll
    for (int k = 14; k > 0; --k) t[k] = __funnelshift_l(t[k - 1], t[k], 1);
    t[0] = ptx::mad_lo_cc(a.w[0], a.w[0], 0u);
    t[1] = ptx::madc_hi_cc(a.w[0], a.w[0], t[1]);
#pragma unroll
    for (int i = 1; i < 7; ++i) {
        t[2 * i] = ptx::madc_lo_cc(a.w[i], a.w[i], t[2 * i]);
        t[2 * i + 1] = ptx::madc_hi_cc(a.w[i], a.w[i], t[2 * i + 1]);
    }
    t[14] = ptx::madc_lo_cc(a.w[7], a.w[7], t[14]);
    t[15] = ptx::madc_hi(a.w[7], a.w[7], t[15]);
    return fe_reduce_cc(t);
}

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
