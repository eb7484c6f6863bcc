// Hopper kernels for the device-oracle path (ops/{field,curve,msm,backend,
// poseidon}.py, parallel/pipeline.py): the pointwise group operations
// (padd, pdbl) and the elementwise field multiplies mod p and mod l
// (mul_fp, mul_fq; mod l by sc_l.cuh's Barrett reduction, which the
// Poseidon kernel of poseidon.cu shares).  The path's MSMs (msm_chunk_acc, msm_block_totals) run
// the windowed w4 MSM of win.cu, and its fold (fold_grid) and per-lane
// scalar multiply (smul_lanes) the Straus designs of msm_fold.cu.  Plain C
// entry points for ctypes (ops/build.py): each launches on the caller's
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().
//
// Layouts (row-major, int32): points (n, 4, 8), X, Y, Z, T as eight
// little-endian words, any value below 2^256; field elements (n, 8), any
// value below 2^256.  Every output is canonical: coordinates in [0, p),
// field values in [0, m).
#include <cuda_runtime.h>
#include <cstdint>

#include "ge25519_cc.cuh"
#include "sc_l.cuh"

#define OR_THREADS 128  // threads per block

// ---- padd / pdbl (pallas_curve.py padd :176 / pdbl :190, _padd_kernel
// :163 / _pdbl_kernel :167): out = a + b (add-2008-hwcd-3) or 2a
// (dbl-2008-hwcd), pointwise, every coordinate canonical.  What bounds them
// on an H100: nearly as much the bytes (384 / 256 B a point) as the
// multiplies (9 / 8 field multiplies a point): at 2^18 points ~0.03 /
// 0.02 ms either way.  Design: one thread a point on the inlined
// carry-chain operations of ge25519_cc.cuh (ge_add_cc, ge_double_cc: the
// JAX emitters' formulas, so the canonical words equal the plain
// versions'), one call site each; a block of PW_THREADS threads takes
// tiles of PW_THREADS points, staged through shared memory so that device
// memory sees contiguous 16-byte loads and stores (a point's 128 bytes by
// eight neighbouring threads), and each thread reads its point from a row
// padded to 144 bytes (rows 4 banks apart: a quarter warp's 16-byte reads
// hit 32 distinct banks); a grid of the blocks the card holds at once
// (occupancy query) strides over the tiles.  Measured (NVIDIA H100 80GB
// HBM3, 700.00 W; chip_profile.py --oracle): at 2^18 points padd 0.206 ->
// 0.070-0.072 ms and pdbl 0.183-0.184 -> 0.049-0.051 (the first version:
// ge_add / ge_double out of line on fe_mul, 4-byte loads); each thread
// loading and storing its own point as eight 16-byte vectors ran
// 0.075-0.077 / 0.054-0.055, so the tiles are staged.  At 1 to 2^14 points a launch takes
// 4-8 us on the device (the first version 5-19 us); there the wrapper's
// host work a call sets the time.
#define PW_THREADS 128    // points a tile, threads a block
#define PW_ROW 9          // 16-byte words a staged point: 8 and a pad

// Coordinate k of row r of a staged tile: 16-byte words 2k, 2k + 1.
__device__ __forceinline__ fe pw_get_fe(const uint4* sh, int r, int k) {
    const uint4 lo = sh[PW_ROW * r + 2 * k];
    const uint4 hi = sh[PW_ROW * r + 2 * k + 1];
    fe c;
    c.w[0] = lo.x; c.w[1] = lo.y; c.w[2] = lo.z; c.w[3] = lo.w;
    c.w[4] = hi.x; c.w[5] = hi.y; c.w[6] = hi.z; c.w[7] = hi.w;
    return c;
}

__device__ __forceinline__ ge pw_get(const uint4* sh, int r) {
    ge p;
    p.X = pw_get_fe(sh, r, 0);
    p.Y = pw_get_fe(sh, r, 1);
    p.Z = pw_get_fe(sh, r, 2);
    p.T = pw_get_fe(sh, r, 3);
    return p;
}

// Coordinate k of row r, made canonical.
__device__ __forceinline__ void pw_put_fe(uint4* sh, int r, int k, const fe& a) {
    const fe c = fe_canon(a);
    sh[PW_ROW * r + 2 * k] = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
    sh[PW_ROW * r + 2 * k + 1] = make_uint4(c.w[4], c.w[5], c.w[6], c.w[7]);
}

__device__ __forceinline__ void pw_put(uint4* sh, int r, const ge& p) {
    pw_put_fe(sh, r, 0, p.X);
    pw_put_fe(sh, r, 1, p.Y);
    pw_put_fe(sh, r, 2, p.Z);
    pw_put_fe(sh, r, 3, p.T);
}

// ADD: out = a + b; else out = 2a (b unread).
template <bool ADD>
__global__ void __launch_bounds__(PW_THREADS)
pointwise_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 int32_t* __restrict__ out, int n) {
    __shared__ uint4 sh[(ADD ? 2 : 1) * PW_THREADS * PW_ROW];
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    const int t = threadIdx.x;
#pragma unroll 1
    for (long long first = (long long)blockIdx.x * PW_THREADS; first < n;
         first += (long long)gridDim.x * PW_THREADS) {
        const int count = n - first < PW_THREADS ? (int)(n - first) : PW_THREADS;
#pragma unroll 1
        for (int g = t; g < 8 * count; g += PW_THREADS) {
            const int s = PW_ROW * (g >> 3) + (g & 7);
            sh[s] = __ldg(a4 + 8 * first + g);
            if constexpr (ADD) sh[PW_THREADS * PW_ROW + s] = __ldg(b4 + 8 * first + g);
        }
        __syncthreads();
        if (t < count) {
            const ge p = pw_get(sh, t);
            if constexpr (ADD) pw_put(sh, t, ge_add_cc(p, pw_get(sh + PW_THREADS * PW_ROW, t)));
            else pw_put(sh, t, ge_double_cc(p, true));
        }
        __syncthreads();
#pragma unroll 1
        for (int g = t; g < 8 * count; g += PW_THREADS)
            o4[8 * first + g] = sh[PW_ROW * (g >> 3) + (g & 7)];
        __syncthreads();
    }
}

template <bool ADD>
static int pointwise_launch(const int32_t* a, const int32_t* b, int32_t* out, int n,
                            void* stream) {
    static int held[64];
    if (n > 0) {
        const int card = card_blocks((const void*)pointwise_kernel<ADD>, PW_THREADS, held);
        const int tiles = (n + PW_THREADS - 1) / PW_THREADS;
        pointwise_kernel<ADD><<<tiles < card ? tiles : card, PW_THREADS, 0,
                                (cudaStream_t)stream>>>(a, b, out, n);
    }
    return (int)cudaGetLastError();
}

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

// mul_fp / mul_fq (pallas_field.py :201 / :200): what bounds them is
// memory (96 B an element for one field multiply); one thread an element,
// mod p fe_mul then fe_canon, mod l sc_mul_canon (sc_l.cuh).
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
    return pointwise_launch<true>(a, b, out, n, stream);
}

// out (n, 4, 8) = 2 a, pointwise
int bp_pdbl(const int32_t* a, int32_t* out, int n, void* stream) {
    return pointwise_launch<false>(a, a, out, n, stream);
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
