// Hopper kernel for the half-width generator folds of the IPP's combined
// layout: out[i] = beta_i * P[i] + alpha_i * P[i + v], where (alpha, beta)
// is one of two signed pairs split at a breakpoint bp (|alpha|, |beta| <
// 2^127: a fold constant c = alpha / beta mod L, with beta^-1 carried in
// the host factor vectors).  fold_w3h folds one side (2v points -> v);
// fold_w3h_comb folds both sides of a combined [G(2v) | H(2v)] tensor
// into [G'(v) | H'(v)] in one launch (grid dimension y picks the side).
// Plain C entry points for ctypes (ops/build.py), with the conventions of
// msm_fold.cu.
//
// Layouts (row-major, int32):
//   points (n, 4, 8):       X, Y, Z, T, eight little-endian words each
//   words (sides, 2, 2, 8): [side][pair][beta, alpha] digit words: 44
//                           signed base-8 digits d in [-4, 3] per scalar,
//                           one per nibble (code d & 7), pair 0 for
//                           output index i < bp, pair 1 from bp on
//
// What bounds it: integer multiplies.  One output runs 6 point operations
// of tables and 44 windows of 3 doublings and up to 2 adds (~226 point
// operations, against ~380 for fold_bits's dual bit-serial ladder), for
// 256 B read and 128 B written.  Design: one thread per output point, the
// two 4-entry tables (1..4)L and (1..4)R in local memory, one doubling
// chain shared by both scalars, zero digits skipped.  The output never
// aliases the input: a block may run after the block whose output row is
// its right-hand input (the TPU kernel folds in place because its grid
// runs in order).
#include <cuda_runtime.h>
#include <cstdint>

#include "ge25519.cuh"

#define FOLD_THREADS 128
#define W3H_DIGITS 44

__device__ __forceinline__ void load_words8(const int32_t* src, uint32_t w[8]) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = s[i];
}

// Digit `pos` of a w3h word row -> the signed digit's magnitude (0..4)
// and sign; code 4 is the digit -4 (entry 4 negated).
__device__ __forceinline__ uint32_t w3_digit(const uint32_t w[8], int pos, bool& neg) {
    uint32_t e = (w[pos >> 3] >> (4 * (pos & 7))) & 7u;
    neg = e >= 4u;
    return neg ? 8u - e : e;
}

__device__ __forceinline__ void table4(const ge& P, ge t[4]) {
    t[0] = P;
    t[1] = ge_double(P);
    t[2] = ge_add(t[1], P);
    t[3] = ge_double(t[1]);
}

// Block (x, side): outputs i of that side; side s reads points
// in + s * 2v and writes out + s * v.
__global__ void __launch_bounds__(FOLD_THREADS)
fold_w3h_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                const int32_t* __restrict__ words, int v, int bp) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= v) return;
    const int side = blockIdx.y;
    const int32_t* src = in + 64ll * v * side;
    const int32_t* wrow = words + 32 * side + (i < bp ? 0 : 16);
    uint32_t wb[8], wa[8];
    load_words8(wrow, wb);
    load_words8(wrow + 8, wa);
    ge tl[4], tr[4];
    table4(ge_load(src + 32 * i), tl);
    table4(ge_load(src + 32 * (i + v)), tr);
    ge acc = ge_identity();
    bool started = false;
#pragma unroll 1
    for (int pos = W3H_DIGITS - 1; pos >= 0; --pos) {
        if (started) {
            acc = ge_double(acc);
            acc = ge_double(acc);
            acc = ge_double(acc);
        }
        bool neg;
        uint32_t mag = w3_digit(wb, pos, neg);
        if (mag) {
            ge s = neg ? ge_neg(tl[mag - 1]) : tl[mag - 1];
            acc = started ? ge_add(acc, s) : s;
            started = true;
        }
        mag = w3_digit(wa, pos, neg);
        if (mag) {
            ge s = neg ? ge_neg(tr[mag - 1]) : tr[mag - 1];
            acc = started ? ge_add(acc, s) : s;
            started = true;
        }
    }
    ge_store(out + 32ll * v * side + 32 * i, acc);
}

static int fold_launch(const int32_t* in, int32_t* out, const int32_t* words, int v,
                       int bp, int sides, void* stream) {
    if (v > 0)
        fold_w3h_kernel<<<dim3((v + FOLD_THREADS - 1) / FOLD_THREADS, sides),
                          FOLD_THREADS, 0, (cudaStream_t)stream>>>(in, out, words, v, bp);
    return (int)cudaGetLastError();
}

extern "C" {

// out (v, 4, 8) from points (2v, 4, 8); words (1, 2, 2, 8).
int bp_fold_w3h(const int32_t* pts, int32_t* out, const int32_t* words, int v, int bp,
                void* stream) {
    return fold_launch(pts, out, words, v, bp, 1, stream);
}

// out (2v, 4, 8) = [G'(v) | H'(v)] from points (4v, 4, 8) = [G(2v) | H(2v)];
// words (2, 2, 2, 8), side 0 for G and 1 for H, both split at bp.
int bp_fold_w3h_comb(const int32_t* pts, int32_t* out, const int32_t* words, int v,
                     int bp, void* stream) {
    return fold_launch(pts, out, words, v, bp, 2, stream);
}

}  // extern "C"
