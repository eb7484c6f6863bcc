// Extended twisted-Edwards points (X:Y:Z:T), a = -1, for the MSM and fold
// kernels: the point type, the identity, and loads and stores.  The point
// operations, on the carry-chain multiply, are in ge25519_cc.cuh.
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
