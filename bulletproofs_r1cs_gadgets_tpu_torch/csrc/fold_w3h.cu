// Hopper kernel for the half-width generator folds of the IPP's combined
// layout: out[i] = beta_i * P[i] + alpha_i * P[i + v], where (alpha, beta)
// is one of two signed pairs split at a breakpoint bp (|alpha|, |beta| <
// 2^127: a fold constant c = alpha / beta mod L, with beta^-1 carried in
// the host factor vectors).  fold_w3h folds one side (2v points -> v);
// fold_w3h_comb folds both sides of a combined [G(2v) | H(2v)] tensor
// into [G'(v) | H'(v)] in one launch (grid dimension y picks the side).
// It replaces pallas_curve.py's fold_grid_w3h (:646) and
// fold_grid_w3h_comb (:685), whose body is _emit_fold_w3h (:574).  Plain
// C entry points for ctypes (ops/build.py), with the conventions of
// msm_fold.cu.
//
// Layouts (row-major, int32):
//   points (n, 4, 8):       X, Y, Z, T, eight little-endian words each
//   words (sides, 2, 2, 8): [side][pair][beta, alpha] digit words: 44
//                           signed base-8 digits d in [-4, 3] per scalar,
//                           one per nibble (code d & 7), pair 0 for
//                           output index i < bp, pair 1 from bp on
//
// What bounds it on an H100: 32-bit integer multiplies.  One output runs
// two 4-entry tables and 44 windows of 3 doublings and up to 2 adds (~226
// point operations of ~8 field multiplies), for 256 B read and 128 B
// written; 2^17 outputs fill the card, one thread each.  Design (the
// second version): every point operation is inlined on the carry-chain
// multiply (ge25519_cc.cuh: no stack frame, no calls); doublings square
// with fe_sq_cc, and the first two of each window leave T out (the next
// doubling reads X, Y, Z only); the tables hold niels entries (Y+X, Y-X,
// 2dT, Z), so a table add is 8 multiplies, not 9, and a negative digit
// swaps entries as the walkers' adds do; one doubling chain serves both
// scalars and zero digits are skipped.  The tables (1 KB a thread) sit in
// local memory, through L1: in shared memory they cost occupancy (4.75 ms
// at 128 threads a block, 6.14 at 64, against 3.88).  Measured (NVIDIA
// H100 80GB HBM3, 700.00 W; chip_profile.py --kernels, parent and this
// design in turns): 2^18 -> 2^17 5.90 -> 3.76-3.88 ms (bound 1.54), the
// combined fold 5.78 -> 3.74; 161 registers, no spills.  An entry is
// copied into registers before its add: passed to the add by reference
// from local memory it cost 4.11-4.13 ms.  What is left
// (2.5x the bound) is the multiply's instruction issue, which holds the
// walkers' pass 1 at 2.7x theirs.  The output never aliases the input: a
// block may run after the block whose output row is its right-hand input
// (the TPU kernel folds in place because its grid runs in order).
#include <cuda_runtime.h>
#include <cstdint>

#include "ge25519_cc.cuh"

#define FOLD_THREADS 128
#define FOLD_MIN_BLOCKS 3     // blocks an SM holds: <= 168 registers
#define W3H_DIGITS 44

// Block (x, side): outputs i of that side; side s reads points
// in + s * 2v and writes out + s * v.  Entries 4s + m - 1 hold m * P[i +
// s v] for m = 1..4, made by one loop of three steps (2P, 3P = 2P + P,
// 4P = 2(2P)) with one doubling site and one add site; the windows then
// run 3 doublings (T only on the third) and the two digits' niels adds.
__global__ void __launch_bounds__(FOLD_THREADS, FOLD_MIN_BLOCKS)
fold_w3h_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                const int32_t* __restrict__ words, int v, int bp) {
    __shared__ uint32_t wsh[32];
    const int side = blockIdx.y;
    if (threadIdx.x < 32) wsh[threadIdx.x] = (uint32_t)words[32 * side + threadIdx.x];
    __syncthreads();
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= v) return;
    const int32_t* src = in + 64ll * v * side;
    const uint32_t* w = wsh + (i < bp ? 0 : 16);  // beta's digits, then alpha's at w + 8
    niels tbl[8];  // (1..4) P[i], then (1..4) P[i + v]: local memory (indexed by digits)
#pragma unroll 1
    for (int s = 0; s < 2; ++s) {
        const int32_t* row = src + 32 * (i + (s ? v : 0));
        const niels nP = ge_to_niels_cc(ge_load(row));
        tbl[4 * s] = nP;
        ge x = ge_load(row);
#pragma unroll 1
        for (int k = 1; k < 4; ++k) {
            ge y;
            if (k == 2) y = ge_add_niels_cc(x, nP, false);
            else y = ge_double_cc(x, true);
            tbl[4 * s + k] = ge_to_niels_cc(y);
            if (k == 1) x = y;
        }
    }
    ge acc = ge_identity();
    bool started = false;
#pragma unroll 1
    for (int pos = W3H_DIGITS - 1; pos >= 0; --pos) {
        if (started) {
#pragma unroll 1
            for (int d = 0; d < 3; ++d) acc = ge_double_cc(acc, d == 2);
        }
#pragma unroll 1
        for (int s = 0; s < 2; ++s) {
            const uint32_t code = (w[8 * s + (pos >> 3)] >> (4 * (pos & 7))) & 7u;
            if (code) {
                const bool neg = code >= 4u;  // code 4 is the digit -4: entry 4 negated
                const niels q = tbl[4 * s + (neg ? 8 - code : code) - 1];  // into registers
                acc = ge_add_niels_cc(acc, q, neg);
                started = true;
            }
        }
    }
    ge_store(out + 32ll * v * side + 32 * i, acc);
}

static int fold_launch(const int32_t* in, int32_t* out, const int32_t* words, int v,
                       int bp, int sides, void* stream) {
    if (v > 0)
        fold_w3h_kernel<<<dim3((v + FOLD_THREADS - 1) / FOLD_THREADS, sides), FOLD_THREADS, 0,
                          (cudaStream_t)stream>>>(in, out, words, v, bp);
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
