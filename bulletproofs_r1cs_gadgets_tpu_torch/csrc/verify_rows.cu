// Hopper kernels of the verifier's G/H coefficient rows (ops/verify_rows.py):
// a verification reduces to one MSM over [head, G(N), H(N), tail], whose
// 2N generator coefficients
//
//   g_i = u_g_i (x y^-i wR_i - a s_i)
//   h_i = u_g_i (y^-i (x wL_i + wO_i - b s_(N-1-i)) - 1)
//
// the host used to build with a dozen passes of mod-l arithmetic over the
// rows, after flattening the constraint tape by the powers of z.  Here the
// card builds them from the transcript's challenges and a copy of the tape
// that stays on it, and writes them straight as the w5 walker's words.
// Four entry points, each a plain C function for ctypes (ops/build.py)
// that launches on the caller's stream, never synchronises, allocates
// nothing and returns cudaGetLastError():
//
// * sc_powers: out[kR + t] = lo[t] * prod_{bit b of k} hi[b] (R = SP_RUN):
//   z^1..z^m, y^0..y^-(N-1) (host tables of base^(R 2^b) and base^(e0+t)),
//   and the IPP's s_i = prod_j u_j^(+-1) (hi[b] = u^2 of the challenge that
//   bit b + log2 R of i selects, lo[t] the first R entries);
// * tape_flatten: one thread a wire, summing z^(c+1) * coeff over the
//   wire's terms of the tape in CSR form (L, R, O and V wires in one
//   index space): wL, wR, wO, wV;
// * tape_sums: wc = sum over the constant terms and delta = <y^-n o wR,
//   wL>, block partials and then one block a sum;
// * gh_rows: per row the formulas above, summed mod l over B row sets (a
//   batch's verifications, each with its own constants and padded size
//   N_b <= N: a batch weighs verification b by rho_b, which scales u_g,
//   g and h are linear in u_g, and set b adds 0 from row N_b on), each
//   sum recoded once into the w5 walker's 51 signed base-32 digits, one
//   code a byte (ops/chunks.py ``_signed_recode`` with ``_W5_C``, then
//   ``_digit5_bytes``).  One verification is B = 1.
//
// Every value is canonical mod l (sc_l.cuh's Barrett reduction), so the
// rows equal the host's row for row and the words equal ``w5_words``'
// byte for byte.  What bounds them on an H100: the 32-bit multiplies of
// the mod-l products (about 190 a product: the 8 x 8 product, Barrett's
// 9 x 9 quotient and the 9-word q l), then bytes; at 2^18 rows about
// 7 products and 224 B read a row and row set (y^-i read for g and for
// h), and 128 B written a row.
//
// Layouts (row-major, int32): scalars (n, 8) as eight little-endian
// words; CSR offsets (W + 1), term constraint indices (T), term
// coefficients (T, 8); w5 words (2N, 16), G's rows then H's; gh_rows' row
// sets (B, 6) int64 (GhSet).
#include <cuda_runtime.h>
#include <cstdint>

#include "sc_l.cuh"

#define SP_RUN 8         // sc_powers: consecutive outputs a thread
#define VR_THREADS 256   // threads a block
#define TS_ITEMS 8       // tape_sums: items a thread (a block: 2048)
#define TS_REDUCE 32     // products summed wide before a reduction

// (scalar + C) ^ C, C = 16 in every 5-bit group of 51: the codes d & 31 of
// the signed base-32 digits d in [-16, 15] that sum to the scalar
// (ops/chunks.py _W5_C)
static __device__ __constant__ uint32_t W5C[8] = {
    0x21084210u, 0x08421084u, 0x42108421u, 0x10842108u,
    0x84210842u, 0x21084210u, 0x08421084u, 0x42108421u,
};

__device__ __forceinline__ void vr_load(const int32_t* __restrict__ p,
                                        uint32_t r[8]) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

__device__ __forceinline__ void vr_store(int32_t* p, const uint32_t r[8]) {
    reinterpret_cast<uint4*>(p)[0] = make_uint4(r[0], r[1], r[2], r[3]);
    reinterpret_cast<uint4*>(p)[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// r = a - b mod l for canonical a, b (r may alias either)
__device__ __forceinline__ void sc_sub_canon(const uint32_t a[8], const uint32_t b[8],
                                             uint32_t r[8]) {
    uint32_t d[8];
    uint64_t br = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const uint64_t t = (uint64_t)a[i] - b[i] - br;
        d[i] = (uint32_t)t;
        br = t >> 63;
    }
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (uint64_t)d[i] + (br ? SC_L[i] : 0u);
        r[i] = (uint32_t)c;
        c >>= 32;
    }
}

// acc (16 words) -> its residue in acc[0..7], acc[8..15] cleared
__device__ __forceinline__ void vr_fold(uint32_t acc[16]) {
    uint32_t r[8];
    sc_reduce_wide(acc, r);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        acc[i] = r[i];
        acc[8 + i] = 0u;
    }
}

// ---- sc_powers
__global__ void __launch_bounds__(VR_THREADS)
sc_powers_kernel(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
                 int32_t* __restrict__ out, int m, int nbits) {
    const int k = blockIdx.x * VR_THREADS + threadIdx.x;
    if (k * SP_RUN >= m) return;
    uint32_t p[8], f[8];
    bool one = true;
    for (int b = 0; b < nbits; ++b) {
        if (!((k >> b) & 1)) continue;
        vr_load(hi + 8 * b, f);
        if (one) {
#pragma unroll
            for (int i = 0; i < 8; ++i) p[i] = f[i];
            one = false;
        } else {
            sc_mul_canon(p, f, p);
        }
    }
#pragma unroll
    for (int t = 0; t < SP_RUN; ++t) {
        const int i = k * SP_RUN + t;
        if (i >= m) break;
        vr_load(lo + 8 * t, f);
        if (!one) sc_mul_canon(p, f, f);
        vr_store(out + 8 * i, f);
    }
}

// ---- tape_flatten
__global__ void __launch_bounds__(VR_THREADS)
tape_flatten_kernel(const int32_t* __restrict__ off, const int32_t* __restrict__ cidx,
                    const int32_t* __restrict__ coeff, const int32_t* __restrict__ zp,
                    int32_t* __restrict__ out, int W) {
    const int w = blockIdx.x * VR_THREADS + threadIdx.x;
    if (w >= W) return;
    uint32_t acc[16], z[8], c[8];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0u;
    int k = 0;
    for (int t = __ldg(off + w), e = __ldg(off + w + 1); t < e; ++t) {
        vr_load(zp + 8 * __ldg(cidx + t), z);
        vr_load(coeff + 8 * t, c);
        sc_mul_acc(z, c, acc);
        if (++k == TS_REDUCE) {
            vr_fold(acc);
            k = 1;
        }
    }
    vr_fold(acc);
    vr_store(out + 8 * w, acc);
}

// ---- tape_sums
// A block's canonical values in sh (VR_THREADS rows) summed mod l into row 0.
__device__ __forceinline__ void vr_block_sum(uint32_t (*sh)[8]) {
    for (int s = VR_THREADS / 2; s > 0; s >>= 1) {
        __syncthreads();
        if (threadIdx.x < s) sc_add_canon(sh[threadIdx.x], sh[threadIdx.x + s],
                                          sh[threadIdx.x]);
    }
    __syncthreads();
}

// Blocks [0, ga) sum the constant terms zp[ccidx[t]] * ccoeff[t], blocks
// [ga, ga + gb) the rows (yinv[i] * wR[i]) * wL[i], i < n; one partial a
// block.
__global__ void __launch_bounds__(VR_THREADS)
tape_sums_kernel(const int32_t* __restrict__ ccidx, const int32_t* __restrict__ ccoeff,
                 int tc, const int32_t* __restrict__ zp, const int32_t* __restrict__ wl,
                 const int32_t* __restrict__ wr, const int32_t* __restrict__ yinv, int n,
                 int ga, int32_t* __restrict__ partials) {
    __shared__ uint32_t sh[VR_THREADS][8];
    const bool rows = blockIdx.x >= ga;
    const int base = (rows ? blockIdx.x - ga : blockIdx.x) * VR_THREADS * TS_ITEMS;
    const int count = rows ? n : tc;
    uint32_t acc[16], a[8], b[8];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0u;
#pragma unroll
    for (int j = 0; j < TS_ITEMS; ++j) {
        const int t = base + j * VR_THREADS + threadIdx.x;
        if (t >= count) break;
        if (rows) {
            vr_load(yinv + 8 * t, a);
            vr_load(wr + 8 * t, b);
            sc_mul_canon(a, b, a);
            vr_load(wl + 8 * t, b);
        } else {
            vr_load(zp + 8 * __ldg(ccidx + t), a);
            vr_load(ccoeff + 8 * t, b);
        }
        sc_mul_acc(a, b, acc);
    }
    vr_fold(acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) sh[threadIdx.x][i] = acc[i];
    vr_block_sum(sh);
    if (threadIdx.x == 0) vr_store(partials + 8 * blockIdx.x, sh[0]);
}

// Block 0 sums partials [0, ga) into out[0], block 1 [ga, ga + gb) into
// out[1].
__global__ void __launch_bounds__(VR_THREADS)
tape_sums_finish(const int32_t* __restrict__ partials, int ga, int gb,
                 int32_t* __restrict__ out) {
    __shared__ uint32_t sh[VR_THREADS][8];
    const int lo = blockIdx.x ? ga : 0, hi = blockIdx.x ? ga + gb : ga;
    uint32_t acc[8], v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0u;
    for (int p = lo + threadIdx.x; p < hi; p += VR_THREADS) {
        vr_load(partials + 8 * p, v);
        sc_add_canon(acc, v, acc);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sh[threadIdx.x][i] = acc[i];
    vr_block_sum(sh);
    if (threadIdx.x == 0) vr_store(out + 8 * blockIdx.x, sh[0]);
}

// ---- gh_rows
// The w5 words of canonical v: 51 codes, byte k of the 64 holding code k.
__device__ __forceinline__ void vr_store_w5(int32_t* p, const uint32_t v[8]) {
    uint32_t t[8], o[16];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        c += (uint64_t)v[i] + W5C[i];
        t[i] = (uint32_t)c ^ W5C[i];
        c >>= 32;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) o[j] = 0u;
#pragma unroll
    for (int k = 0; k < 51; ++k) {
        const int wi = (5 * k) >> 5, sh = (5 * k) & 31;
        uint32_t code = t[wi] >> sh;
        if (sh > 27) code |= t[wi + 1] << (32 - sh);
        o[k >> 2] |= (code & 31u) << (8 * (k & 3));
    }
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j)
        q[j] = make_uint4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
}

// One row set of gh_rows: a verification's wires (wL, wR, wO the first three
// n-row blocks), its y^-i and s (N rows each, its padded size), its
// multipliers n and phase-1 multipliers n1 (six int64 on the host)
struct GhSet {
    const int32_t* wires;
    const int32_t* yinv;
    const int32_t* s;
    long long n, n1, N;
};

// Row i of B row sets: g_i = sum_b g_b,i mod l over the sets, stored, then
// h_i the same (one sum live at a time: fewer registers than both), each
// set's consts (8, 8): cx, ca, cu (rows below n1), the same from n1 on, x,
// b; a set adds nothing from its own N on
__global__ void __launch_bounds__(VR_THREADS)
gh_rows_kernel(const GhSet* __restrict__ sets, const int32_t* __restrict__ consts,
               int B, int32_t* __restrict__ words, int N) {
    const int i = blockIdx.x * VR_THREADS + threadIdx.x;
    if (i >= N) return;
    uint32_t acc[8], y[8], t[8], q[8], c[8];
    // g += (u_g x) y^-i wR - (u_g a) s_i
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0u;
    for (int j = 0; j < B; ++j) {
        const GhSet set = sets[j];
        if (i >= set.N) continue;
        const int32_t* cj = consts + 64 * j;
        const int seg = i < set.n1 ? 0 : 3;
        if (i < set.n) {
            vr_load(set.yinv + 8 * i, y);
            vr_load(cj + 8 * seg, c);
            sc_mul_canon(c, y, t);
            vr_load(set.wires + 8 * (set.n + i), q);
            sc_mul_canon(t, q, t);
        } else {
#pragma unroll
            for (int k = 0; k < 8; ++k) t[k] = 0u;
        }
        vr_load(set.s + 8 * i, q);
        vr_load(cj + 8 * (seg + 1), c);
        sc_mul_canon(c, q, q);
        sc_sub_canon(t, q, t);
        sc_add_canon(acc, t, acc);
    }
    vr_store_w5(words + 16 * i, acc);
    // h += (u_g y^-i) (x wL + wO - b s_(N-1-i)) - u_g
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0u;
    for (int j = 0; j < B; ++j) {
        const GhSet set = sets[j];
        if (i >= set.N) continue;
        const int32_t* cj = consts + 64 * j;
        const int seg = i < set.n1 ? 0 : 3;
        if (i < set.n) {
            vr_load(set.wires + 8 * i, q);
            vr_load(cj + 48, c);
            sc_mul_canon(c, q, t);
            vr_load(set.wires + 8 * (2 * set.n + i), q);
            sc_add_canon(t, q, t);
        } else {
#pragma unroll
            for (int k = 0; k < 8; ++k) t[k] = 0u;
        }
        vr_load(set.s + 8 * (set.N - 1 - i), q);
        vr_load(cj + 56, c);
        sc_mul_canon(c, q, q);
        sc_sub_canon(t, q, t);
        vr_load(set.yinv + 8 * i, y);
        vr_load(cj + 8 * (seg + 2), c);
        sc_mul_canon(c, y, q);
        sc_mul_canon(q, t, t);
        sc_sub_canon(t, c, t);
        sc_add_canon(acc, t, acc);
    }
    vr_store_w5(words + 16 * (N + i), acc);
}

static inline int vr_blocks(long long work) {
    return (int)((work + VR_THREADS - 1) / VR_THREADS);
}

extern "C" {

// out (m, 8): out[kR + t] = lo[t] * prod_{bit b of k, b < nbits} hi[b]
int bp_sc_powers(const int32_t* hi, const int32_t* lo, int32_t* out, int m, int nbits,
                 void* stream) {
    if (m > 0)
        sc_powers_kernel<<<vr_blocks((m + SP_RUN - 1) / SP_RUN), VR_THREADS, 0,
                           (cudaStream_t)stream>>>(hi, lo, out, m, nbits);
    return (int)cudaGetLastError();
}

// out (W, 8): out[w] = sum_{t in [off[w], off[w+1])} zp[cidx[t]] * coeff[t]
int bp_tape_flatten(const int32_t* off, const int32_t* cidx, const int32_t* coeff,
                    const int32_t* zp, int32_t* out, int W, void* stream) {
    if (W > 0)
        tape_flatten_kernel<<<vr_blocks(W), VR_THREADS, 0, (cudaStream_t)stream>>>(
            off, cidx, coeff, zp, out, W);
    return (int)cudaGetLastError();
}

// The partials tape_sums takes for tc constant terms and n rows.
int bp_tape_sums_partials(int tc, int n) {
    const int span = VR_THREADS * TS_ITEMS;
    return (tc + span - 1) / span + (n + span - 1) / span;
}

// out (2, 8): sum_t zp[ccidx[t]] * ccoeff[t], sum_{i<n} yinv[i] wr[i] wl[i]
// (wL, wR the first two n-row blocks of wires)
int bp_tape_sums(const int32_t* ccidx, const int32_t* ccoeff, int tc, const int32_t* zp,
                 const int32_t* wires, const int32_t* yinv, int n, int32_t* partials,
                 int32_t* out, void* stream) {
    const int span = VR_THREADS * TS_ITEMS;
    const int ga = (tc + span - 1) / span, gb = (n + span - 1) / span;
    cudaStream_t st = (cudaStream_t)stream;
    if (ga + gb > 0)
        tape_sums_kernel<<<ga + gb, VR_THREADS, 0, st>>>(
            ccidx, ccoeff, tc, zp, wires, wires + 8 * (long long)n, yinv, n, ga, partials);
    tape_sums_finish<<<2, VR_THREADS, 0, st>>>(partials, ga, gb, out);
    return (int)cudaGetLastError();
}

// words (2N, 16): the w5 words of g_i (rows [0, N)) and h_i (rows [N, 2N)),
// each summed over the B row sets (sets (B, 6) int64 with N_b <= N, consts
// (B, 8, 8))
int bp_gh_rows(const int64_t* sets, const int32_t* consts, int B, int32_t* words, int N,
               void* stream) {
    if (N > 0 && B > 0)
        gh_rows_kernel<<<vr_blocks(N), VR_THREADS, 0, (cudaStream_t)stream>>>(
            reinterpret_cast<const GhSet*>(sets), consts, B, words, N);
    return (int)cudaGetLastError();
}

}  // extern "C"
