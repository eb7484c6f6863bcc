// Point operations on the carry-chain multiply (fe_mul_cc / fe_sq_cc),
// inlined where they are called: register-resident, no stack frame.  The
// window walkers, the windowed w4 MSM (win.cu) and the half-width fold
// (fold_w3h.cu) build on them; the formulas are ge25519.cuh's, so every
// operation gives the same group element as its out-of-line counterpart.
// A kernel keeps one call site of each operation, or its code (and build
// time) grows by ~1k instructions of unrolled multiplies a site.
#pragma once
#include "ge25519.cuh"

// A point in niels form: (Y+X, Y-X, 2d*T, Z).
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

// p + q, both extended: ge_add on the carry-chain multiply (9 multiplies)
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
