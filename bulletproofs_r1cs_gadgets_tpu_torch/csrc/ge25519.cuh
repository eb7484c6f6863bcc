// Extended twisted-Edwards points (X:Y:Z:T), a = -1, for the MSM and fold
// kernels.  The formulas are the JAX package's point emitters
// (ops/pallas_curve.py emit_point_add / emit_point_double) and the host
// reference core/ristretto.py, operation for operation.
#pragma once
#include "fe25519.cuh"

struct ge {
    fe X, Y, Z, T;
};

__device__ __forceinline__ ge ge_identity() {
    ge r;
    r.X = fe_zero();
    r.Y = fe_one();
    r.Z = fe_one();
    r.T = fe_zero();
    return r;
}

// add-2008-hwcd-3 (unified, a = -1, with the 2d constant); 9 muls.  The
// two point operations stay out of line: inlined, every ladder step would
// copy ~1k instructions of unrolled multiplies and the build would crawl.
// Out-of-line functions here are static: each source that includes this
// header keeps its own copy, and the sources link into one library.
static __device__ __noinline__ ge ge_add(const ge& p, const ge& q) {
    fe A = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
    fe B = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
    fe C = fe_mul(fe_mul(p.T, q.T), fe_d2());
    fe Dz = fe_mul(p.Z, q.Z);
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

// dbl-2008-hwcd (a = -1); reads X, Y, Z only
static __device__ __noinline__ ge ge_double(const ge& p) {
    fe A = fe_sq(p.X);
    fe B = fe_sq(p.Y);
    fe Zs = fe_sq(p.Z);
    fe C = fe_add(Zs, Zs);
    fe H = fe_add(A, B);
    fe E = fe_sub(H, fe_sq(fe_add(p.X, p.Y)));
    fe G = fe_sub(A, B);
    fe F = fe_add(C, G);
    ge r;
    r.X = fe_mul(E, F);
    r.Y = fe_mul(G, H);
    r.Z = fe_mul(F, G);
    r.T = fe_mul(E, H);
    return r;
}

// 32 int32 words: X, Y, Z, T, eight little-endian words each
__device__ __forceinline__ ge ge_load(const int32_t* src) {
    ge r;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        r.X.w[i] = s[i];
        r.Y.w[i] = s[8 + i];
        r.Z.w[i] = s[16 + i];
        r.T.w[i] = s[24 + i];
    }
    return r;
}

// store as is (a partial sum that only a later kernel reads)
__device__ __forceinline__ void ge_store_raw(int32_t* dst, const ge& p) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        d[i] = p.X.w[i];
        d[8 + i] = p.Y.w[i];
        d[16 + i] = p.Z.w[i];
        d[24 + i] = p.T.w[i];
    }
}

// store with every coordinate reduced to [0, p) (for the host)
__device__ __forceinline__ void ge_store(int32_t* dst, const ge& p) {
    ge c;
    c.X = fe_canon(p.X);
    c.Y = fe_canon(p.Y);
    c.Z = fe_canon(p.Z);
    c.T = fe_canon(p.T);
    ge_store_raw(dst, c);
}
