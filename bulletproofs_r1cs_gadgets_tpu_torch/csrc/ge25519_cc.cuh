// Point operations on the carry-chain multiply (fe_mul_cc / fe_sq_cc),
// inlined where they are called: register-resident, no stack frame.  The
// window walkers, the windowed w4 MSM, the niels tables (win.cu), the
// half-width fold (fold_w3h.cu) and the folds of msm_fold.cu (the
// cooperative operations at the end) build on them, and on the two scalar
// recodes into signed base-16 digits (fold_recode, w2_recode); the formulas are
// the JAX package's point emitters (ops/pallas_curve.py emit_point_add /
// emit_point_double) and the host reference core/ristretto.py, operation
// for operation, and fe_mul_cc / fe_sq_cc give fe_mul's residues, so
// every operation gives the same canonical words as the plain versions'
// limb arithmetic (padd / pdbl in oracle.cu rest on it).  A kernel
// keeps one call site of each operation, or its code (and build time)
// grows by ~1k instructions of unrolled multiplies a site.
#pragma once
#include <cuda_runtime.h>

#include "ge25519.cuh"

// The blocks of `threads` threads of `kernel` the current device holds at
// once (occupancy query), for the kernels that size their grids from the
// card; held caches it by device (0: not asked).
static inline int card_blocks(const void* kernel, int threads, int* held) {
    int dev = 0;
    cudaGetDevice(&dev);
    int card = dev >= 0 && dev < 64 ? held[dev] : 0;
    if (card == 0) {
        int sms = 1, per_sm = 1;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
        card = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
        if (dev >= 0 && dev < 64) held[dev] = card;
    }
    return card;
}

// A point in niels form: (Y+X, Y-X, 2d*T, Z).
struct niels {
    fe ypx, ymx, t2d, z;
};

__device__ __forceinline__ void load_words(const int32_t* src, uint32_t w[8]) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = s[i];
}

// ---- scalar recodes into signed base-16 digit codes (nibble j of word
// j / 8: the digit d & 15, d in [-8, 7], d = code - 16 for code >= 8), the
// digits the Straus folds (msm_fold.cu) and the windowed w4 MSM's tiles
// (win.cu) read.

// 64 codes of bits 252..0 of the raw little-endian bit words at src, into
// code[0..7]; the top digit takes the carry (<= 2).
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

// 65 codes of a w2 word row at src (128 signed base-4 digits d_i in [-2,
// 1], coded d & 3, digit i at bits 2 (i % 16) of word i / 16), into
// code[0..8].  Window j pairs digits 2j and 2j + 1, which are nibble j of
// the row: e_j = d_2j + 4 d_2j+1 in [-10, 5], plus the borrow from window
// j - 1, and below -8 it takes 16 and lends -1 to window j + 1, so every
// digit lies in [-8, 7].  The last borrow is window 64 (code[8]: 15 for
// -1, else 0), so the digits hold the row's value exactly whatever the
// row; the words of a canonical scalar (< 2^253) leave window 64 at 0 and
// window 63 at most 2.
__device__ __forceinline__ void w2_recode(const int32_t* src, uint32_t* code) {
    uint32_t w[8];
    load_words(src, w);
    int borrow = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        uint32_t c = 0u;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
            const uint32_t nib = (w[j] >> (4 * t)) & 15u;
            const int lo = (int)(nib & 3u) - ((nib & 2u) ? 4 : 0);
            const int hi = (int)(nib >> 2) - ((nib & 8u) ? 4 : 0);
            int e = lo + 4 * hi + borrow;
            borrow = e < -8 ? -1 : 0;
            e += e < -8 ? 16 : 0;
            c |= ((uint32_t)e & 15u) << (4 * t);
        }
        code[j] = c;
    }
    code[8] = borrow ? 15u : 0u;
}

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

// the identity in niels form: (1, 1, 0, 1)
__device__ __forceinline__ niels niels_identity() {
    niels q;
    q.ypx = fe_one();
    q.ymx = fe_one();
    q.t2d = fe_zero();
    q.z = fe_one();
    return q;
}

__device__ __forceinline__ void fe_store_raw(int32_t* dst, const fe& a) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = a.w[i];
}

__device__ __forceinline__ void fe_store_canon(int32_t* dst, const fe& a) {
    fe_store_raw(dst, fe_canon(a));
}

__device__ __forceinline__ fe fe_select(bool c, const fe& a, const fe& b) {
    fe r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = c ? a.w[i] : b.w[i];
    return r;
}

__device__ __forceinline__ ge ge_shfl_down(const ge& p, int off) {
    ge r;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        r.X.w[i] = __shfl_down_sync(0xffffffffu, p.X.w[i], off);
        r.Y.w[i] = __shfl_down_sync(0xffffffffu, p.Y.w[i], off);
        r.Z.w[i] = __shfl_down_sync(0xffffffffu, p.Z.w[i], off);
        r.T.w[i] = __shfl_down_sync(0xffffffffu, p.T.w[i], off);
    }
    return r;
}

// extended -> niels: (Y+X, Y-X, 2d*T, Z), one multiply
__device__ __forceinline__ niels ge_to_niels_cc(const ge& p) {
    niels q;
    q.ypx = fe_add(p.Y, p.X);
    q.ymx = fe_sub(p.Y, p.X);
    q.t2d = fe_mul_cc(p.T, fe_d2());
    q.z = p.Z;
    return q;
}

// p + (neg ? -q : q), q in niels form: add-2008-hwcd-3 with 2dT and the
// operand sums of q precomputed, 8 multiplies.  -q swaps Y+X with Y-X and
// negates 2dT, so C changes sign and F, G swap.  Complete (a = -1): the
// identity needs no special case.
__device__ __forceinline__ ge ge_add_niels_cc(const ge& p, const niels& q, bool neg) {
    fe A = fe_mul_cc(fe_sub(p.Y, p.X), fe_select(neg, q.ypx, q.ymx));
    fe B = fe_mul_cc(fe_add(p.Y, p.X), fe_select(neg, q.ymx, q.ypx));
    fe C = fe_mul_cc(p.T, q.t2d);
    fe Dz = fe_mul_cc(p.Z, q.z);
    fe Dv = fe_add(Dz, Dz);
    fe E = fe_sub(B, A);
    fe Fm = fe_sub(Dv, C);
    fe Gp = fe_add(Dv, C);
    fe F = fe_select(neg, Gp, Fm);
    fe G = fe_select(neg, Fm, Gp);
    fe H = fe_add(B, A);
    ge r;
    r.X = fe_mul_cc(E, F);
    r.Y = fe_mul_cc(G, H);
    r.Z = fe_mul_cc(F, G);
    r.T = fe_mul_cc(E, H);
    return r;
}

// p + q, both extended: add-2008-hwcd-3 (unified, a = -1, with the 2d
// constant), 9 multiplies
__device__ __forceinline__ ge ge_add_cc(const ge& p, const ge& q) {
    fe A = fe_mul_cc(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
    fe B = fe_mul_cc(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
    fe C = fe_mul_cc(fe_mul_cc(p.T, q.T), fe_d2());
    fe Dz = fe_mul_cc(p.Z, q.Z);
    fe Dv = fe_add(Dz, Dz);
    fe E = fe_sub(B, A);
    fe F = fe_sub(Dv, C);
    fe G = fe_add(Dv, C);
    fe H = fe_add(B, A);
    ge r;
    r.X = fe_mul_cc(E, F);
    r.Y = fe_mul_cc(G, H);
    r.Z = fe_mul_cc(F, G);
    r.T = fe_mul_cc(E, H);
    return r;
}

// 2p (dbl-2008-hwcd, a = -1): four squares (fe_sq_cc) and three
// multiplies, the fourth (T = E H) only if `with_t`: a doubling that feeds
// another doubling leaves T out (0), as a doubling reads X, Y and Z only.
__device__ __forceinline__ ge ge_double_cc(const ge& p, bool with_t) {
    fe A = fe_sq_cc(p.X);
    fe B = fe_sq_cc(p.Y);
    fe Zs = fe_sq_cc(p.Z);
    fe S = fe_sq_cc(fe_add(p.X, p.Y));
    fe C = fe_add(Zs, Zs);
    fe H = fe_add(A, B);
    fe E = fe_sub(H, S);
    fe G = fe_sub(A, B);
    fe F = fe_add(C, G);
    ge r;
    r.X = fe_mul_cc(E, F);
    r.Y = fe_mul_cc(G, H);
    r.Z = fe_mul_cc(F, G);
    r.T = with_t ? fe_mul_cc(E, H) : fe_zero();
    return r;
}

// The sum of one point per thread over a block of WARPS warps: a shuffle
// tree inside each warp (5 levels), then one over the warps' sums in
// warp 0 (sh holds WARPS points).  One ge_add_cc site.  Returns true in
// thread 0, whose v is the sum; the other warps return early.
template <int WARPS>
__device__ __forceinline__ bool tree_sum(ge& v, ge* sh) {
    constexpr int LOG_WARPS = WARPS == 1 ? 0 : WARPS == 2 ? 1 : WARPS == 4 ? 2 : 3;
    static_assert(WARPS == 1 << LOG_WARPS, "WARPS: 1, 2, 4 or 8");
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll 1
    for (int level = 0; level < 5 + LOG_WARPS; ++level) {
        if (level == 5) {
            if (lane == 0) sh[warp] = v;
            __syncthreads();
            if (warp != 0) return false;
            v = lane < WARPS ? sh[lane] : ge_identity();
        }
        const int off = level < 5 ? 16 >> level : WARPS >> (level - 4);
        v = ge_add_cc(v, ge_shfl_down(v, off));
    }
    return threadIdx.x == 0;
}

__device__ __forceinline__ fe fe_shfl(const fe& a, int lane) {
    fe r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = __shfl_sync(0xffffffffu, a.w[i], lane);
    return r;
}

// ---- cooperative point operations: a group of 8 lanes, lane 8g + 4h + q
// of a warp, runs one point operation as two stages of four independent
// operations q, a multiply on its two lanes h (fe_mul_split), a square on
// each lane (fe_sq_cc); the products are exchanged with __shfl_sync, and
// every lane holds the whole point between stages, so a stage costs about
// one multiply's latency.  The walkers' Horner pass (win.cu; its warp's
// four groups repeat one walk) and fold_bits (msm_fold.cu; four outputs a
// warp) build on them.  Every lane of the warp must take part in each
// operation: the shuffles name the full warp.

// Rows 4h .. 4h + 3 of a * b on each of two lanes (h = 0, 1; partners
// 4 lanes apart), the upper rows' 12 words passed down by a shuffle and
// added 4 words up: the product, reduced, on the h = 0 lane.
__device__ __forceinline__ fe fe_mul_split(const fe& a, const fe& b, int h) {
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = h ? a.w[4 + i] : a.w[i];
    uint32_t t[12];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = x[0] * b.w[j];
    t[1] = ptx::mad_hi_cc(x[0], b.w[0], t[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j) t[j + 1] = ptx::madc_hi_cc(x[0], b.w[j], t[j + 1]);
    t[8] = ptx::madc_hi(x[0], b.w[7], 0u);
#pragma unroll
    for (int i = 1; i < 4; ++i) {
        t[i] = ptx::mad_lo_cc(x[i], b.w[0], t[i]);
#pragma unroll
        for (int j = 1; j < 8; ++j) t[i + j] = ptx::madc_lo_cc(x[i], b.w[j], t[i + j]);
        t[i + 8] = ptx::carry();
        t[i + 1] = ptx::mad_hi_cc(x[i], b.w[0], t[i + 1]);
#pragma unroll
        for (int j = 1; j < 7; ++j) t[i + j + 1] = ptx::madc_hi_cc(x[i], b.w[j], t[i + j + 1]);
        t[i + 8] = ptx::madc_hi(x[i], b.w[7], t[i + 8]);
    }
    uint32_t u[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) u[k] = __shfl_xor_sync(0xffffffffu, t[k], 4);
    uint32_t s[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = t[k];
    s[4] = ptx::add_cc(t[4], u[0]);
#pragma unroll
    for (int k = 5; k < 12; ++k) s[k] = ptx::addc_cc(t[k], u[k - 4]);
#pragma unroll
    for (int k = 12; k < 15; ++k) s[k] = ptx::addc_cc(u[k - 4], 0u);
    s[15] = u[11] + ptx::carry();
    return fe_reduce_cc(s);
}

// Stage 2 of a doubling or an add: lane q forms product q of (E F, G H,
// F G, E H) = (X, Y, Z, T); T is gathered only if a later add reads it.
__device__ __forceinline__ ge coop_stage2(const fe& E, const fe& F, const fe& G,
                                          const fe& H, int q, int h, int base,
                                          bool with_t) {
    const fe l = fe_select(q == 0 || q == 3, E, fe_select(q == 1, G, F));
    const fe r = fe_select(q == 0, F, fe_select(q == 2, G, H));
    const fe p = fe_mul_split(l, r, h);
    ge o;
    o.X = fe_shfl(p, base);
    o.Y = fe_shfl(p, base + 1);
    o.Z = fe_shfl(p, base + 2);
    o.T = with_t ? fe_shfl(p, base + 3) : fe_zero();
    return o;
}

// 2p (dbl-2008-hwcd): lane q squares X, Y, Z or X + Y
__device__ __forceinline__ ge coop_double(const ge& p, int q, int h, int base, bool with_t) {
    const fe xy = fe_add(p.X, p.Y);
    const fe l = fe_select(q == 0, p.X, fe_select(q == 1, p.Y, fe_select(q == 2, p.Z, xy)));
    const fe sq = fe_sq_cc(l);
    const fe A = fe_shfl(sq, base);
    const fe B = fe_shfl(sq, base + 1);
    const fe Zs = fe_shfl(sq, base + 2);
    const fe S = fe_shfl(sq, base + 3);
    const fe C = fe_add(Zs, Zs);
    const fe H = fe_add(A, B);
    const fe E = fe_sub(H, S);
    const fe G = fe_sub(A, B);
    const fe F = fe_add(C, G);
    return coop_stage2(E, F, G, H, q, h, base, with_t);
}

// p + a point in niels form, of which lane q holds the one coordinate it
// multiplies: (Y-X, Y+X, 2dT, Z)[q] against p's (Y-X, Y+X, T, Z)[q]
__device__ __forceinline__ ge coop_add_niels(const ge& p, const fe& mine, int q, int h,
                                             int base) {
    const fe l = fe_select(q == 0, fe_sub(p.Y, p.X),
                           fe_select(q == 1, fe_add(p.Y, p.X), fe_select(q == 2, p.T, p.Z)));
    const fe m = fe_mul_split(l, mine, h);
    const fe A = fe_shfl(m, base);
    const fe B = fe_shfl(m, base + 1);
    const fe C = fe_shfl(m, base + 2);
    const fe Dz = fe_shfl(m, base + 3);
    const fe Dv = fe_add(Dz, Dz);
    return coop_stage2(fe_sub(B, A), fe_sub(Dv, C), fe_add(Dv, C), fe_add(B, A), q, h, base,
                       true);
}
