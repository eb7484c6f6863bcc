// The Poseidon permutation mod l as one Hopper kernel, poseidon_perm: the
// counterpart of the JAX package's jitted DevicePoseidon._permute
// (ops/poseidon.py:62-84, one XLA program over a lax.scan of the rounds)
// and of the TPU kernel pallas_field.mul_fq (ops/pallas_field.py:200) as
// the port's Poseidon called it: three launches a round, over 288, 48 or 8
// elements.  Two entry points of one template:
//
//   bp_poseidon_permute: state (B, w, 8) -> (B, w, 8), all R rounds;
//   bp_poseidon_chain:   witness (B, W, 8) -> (B, 8), acc <- hash_2(acc,
//                        witness[:, i]) for i = 1..W-1 from acc =
//                        witness[:, 0], each hash the permutation of
//                        [0, acc, node_i, 101, 0, ...] read at lane 1
//                        (DevicePoseidon.hash_2's layout).
//
// A round (ops/poseidon.py's order): add the round keys; the S-box on
// every lane in a full round (full[r] != 0), on lane w - 1 alone in a
// partial one: the cube x^2 * x, or the inverse, the Fermat power x^(l-2)
// by square and multiply over the fixed exponent (inv(0) = 0); then the
// MDS mix st'[i] = sum_j M[i][j] * st[j] mod l.  Inputs (state, witness,
// round keys, MDS) are canonical words mod l; so is every output, equal
// word for word to the plain version (cuda_curve.poseidon_permute_plain /
// poseidon_chain_plain).  Widths 2..8 (the chain 4..8); R is a runtime
// argument.  Plain C entry points for ctypes (ops/build.py): each launches
// on the caller's stream, never synchronises, allocates nothing, and
// returns cudaGetLastError() (cudaErrorInvalidValue for a width, round
// count or length it does not take).
//
// What bounds it on an H100: the 32-bit multiplies of the mod-l products
// (a flagship permutation, width 6 and 4 + 140 + 4 rounds with the cube,
// is 376 S-box products and 148 MDS mixes of 36 products), and at the
// chain's B = 8 rows the latency of one row's dependent products: every
// hash waits for the one before it.  Design:
// * lanes: a group of 8 lanes of a warp a state row, lane i holding st[i]
//   (lanes w..7 idle but in the shuffles); PS_ROWS rows a block;
// * MDS: lane i gathers st[j] by __shfl_sync broadcasts within its group,
//   accumulates its w products of 512 bits unreduced (below 8 l^2 <
//   2^509 for canonical inputs) and reduces once with sc_l.cuh's Barrett
//   reduction (which takes any value below 2^512): the JAX program's
//   prod.sum then one FQ._reduce;
// * constants: each block copies the round keys, the MDS matrix and the
//   round mask (R w 32 + w^2 32 + 4 R bytes: 29.6 KB for the flagship)
//   into shared memory once, with plain 4-byte loads (the copy is a few
//   microseconds against thousands of dependent products a row);
// * grid: the blocks the card holds at once (occupancy query at this
//   shared-memory size), striding over tiles of PS_ROWS rows; a warp
//   whose rows all lie past B skips the tile;
// * the chain keeps acc in lane 1's registers across its W - 1 hashes:
//   nothing returns to the host between them.
#include <cuda_runtime.h>
#include <cstdint>

#include "sc_l.cuh"

// PS_LANES and PS_MAX_SHARED are mirrored by ops/cuda_curve.py's
// POSEIDON_MAX_WIDTH and POSEIDON_MAX_SHARED, which check the same limits on
// both devices (tests/test_torch_poseidon_chain.py holds them equal)
#define PS_THREADS 128                     // threads a block
#define PS_LANES 8                         // lanes a state row: the widest state
#define PS_ROWS (PS_THREADS / PS_LANES)    // state rows a block
#define PS_MAX_SHARED 232448               // shared memory a block may use

// the inverse S-box's exponent l - 2, little-endian words (bit 252 the top)
static __device__ __constant__ uint32_t PS_LM2[8] = {
    0x5cf5d3ebu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
    0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u,
};

// x <- S(x): SBOX 0 the cube, 1 the inverse (square and multiply from the
// top bit; the exponent's bits are the same for every thread, so the
// branch never diverges).
template <int SBOX>
__device__ __forceinline__ void ps_sbox(uint32_t x[8]) {
    if constexpr (SBOX == 0) {
        uint32_t s[8];
        sc_mul_canon(x, x, s);
        sc_mul_canon(s, x, x);
    } else {
        uint32_t acc[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = x[k];
#pragma unroll 1
        for (int bit = 251; bit >= 0; --bit) {
            sc_mul_canon(acc, acc, acc);
            if ((PS_LM2[bit >> 5] >> (bit & 31)) & 1u) sc_mul_canon(acc, x, acc);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) x[k] = acc[k];
    }
}

// One permutation of the row this lane's group holds (lane < w: st[lane]).
// Every lane of the warp calls it together (the shuffles).
template <int SBOX>
__device__ __forceinline__ void ps_permute(uint32_t st[8], int lane, int w, int R,
                                           const uint32_t* rk, const uint32_t* mds,
                                           const int* full) {
    const bool holds = lane < w;
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
        if (holds) {
            sc_add_canon(st, rk + 8 * (r * w + lane), st);
            if (full[r] || lane == w - 1) ps_sbox<SBOX>(st);
        }
        uint32_t acc[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] = 0u;
#pragma unroll 1
        for (int j = 0; j < w; ++j) {
            uint32_t sj[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) sj[k] = __shfl_sync(0xffffffffu, st[k], j, PS_LANES);
            if (holds) sc_mul_acc(mds + 8 * (lane * w + j), sj, acc);
        }
        if (holds) sc_reduce_wide(acc, st);
    }
}

// CHAIN false: in = state (B, w, 8), out (B, w, 8); true: in = witness
// (B, W, 8), out (B, 8).
template <int SBOX, bool CHAIN>
__global__ void __launch_bounds__(PS_THREADS)
poseidon_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                const int32_t* __restrict__ rk, const int32_t* __restrict__ mds,
                const int32_t* __restrict__ full, int B, int W, int w, int R) {
    extern __shared__ uint32_t ps_sh[];
    uint32_t* rk_sh = ps_sh;
    uint32_t* mds_sh = rk_sh + 8 * R * w;
    int* full_sh = reinterpret_cast<int*>(mds_sh + 8 * w * w);
    const uint32_t* rk_w = reinterpret_cast<const uint32_t*>(rk);
    const uint32_t* mds_w = reinterpret_cast<const uint32_t*>(mds);
    for (int i = threadIdx.x; i < 8 * R * w; i += PS_THREADS) rk_sh[i] = __ldg(rk_w + i);
    for (int i = threadIdx.x; i < 8 * w * w; i += PS_THREADS) mds_sh[i] = __ldg(mds_w + i);
    for (int i = threadIdx.x; i < R; i += PS_THREADS) full_sh[i] = __ldg(full + i);
    __syncthreads();

    const int lane = threadIdx.x % PS_LANES;
    const int grp = threadIdx.x / PS_LANES;
    const int warp_first = (threadIdx.x / 32) * (32 / PS_LANES);  // its first row in a tile
    const uint32_t* src = reinterpret_cast<const uint32_t*>(in);
    uint32_t* dst = reinterpret_cast<uint32_t*>(out);
#pragma unroll 1
    for (long long first = (long long)blockIdx.x * PS_ROWS; first < B;
         first += (long long)gridDim.x * PS_ROWS) {
        if (first + warp_first >= B) continue;  // the whole warp past B
        const long long row = first + grp;
        const bool live = row < B;
        uint32_t st[8];
        if constexpr (!CHAIN) {
            const bool mine = live && lane < w;
#pragma unroll
            for (int k = 0; k < 8; ++k) st[k] = 0u;
            if (mine) {
#pragma unroll
                for (int k = 0; k < 8; ++k) st[k] = __ldg(src + 8 * (row * w + lane) + k);
            }
            ps_permute<SBOX>(st, lane, w, R, rk_sh, mds_sh, full_sh);
            if (mine) {
#pragma unroll
                for (int k = 0; k < 8; ++k) dst[8 * (row * w + lane) + k] = st[k];
            }
        } else {
            // lane 1 holds acc from one hash into the next; the others take
            // the 2:1 state [0, acc, node_i, 101, 0, ...] (ops/poseidon.py
            // hash_state)
#pragma unroll
            for (int k = 0; k < 8; ++k) st[k] = 0u;
            if (live && lane == 1) {
#pragma unroll
                for (int k = 0; k < 8; ++k) st[k] = __ldg(src + 8 * row * W + k);
            }
#pragma unroll 1
            for (int i = 1; i < W; ++i) {
                if (lane != 1) {
#pragma unroll
                    for (int k = 0; k < 8; ++k) st[k] = 0u;
                    if (lane == 3) st[0] = 101u;
                    if (live && lane == 2) {
#pragma unroll
                        for (int k = 0; k < 8; ++k) st[k] = __ldg(src + 8 * (row * W + i) + k);
                    }
                }
                ps_permute<SBOX>(st, lane, w, R, rk_sh, mds_sh, full_sh);
            }
            if (live && lane == 1) {
#pragma unroll
                for (int k = 0; k < 8; ++k) dst[8 * row + k] = st[k];
            }
        }
    }
}

static size_t ps_shared(int w, int R) {
    return sizeof(uint32_t) * ((size_t)8 * R * w + (size_t)8 * w * w + R);
}

template <int SBOX, bool CHAIN>
static int ps_launch(const int32_t* in, int32_t* out, const int32_t* rk,
                     const int32_t* mds, const int32_t* full, int B, int W, int w,
                     int R, void* stream) {
    if (w < (CHAIN ? 4 : 2) || w > PS_LANES || R < 0 || B < 0 || W < 1 ||
        ps_shared(w, R) > PS_MAX_SHARED)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaGetLastError();
    const size_t sh = ps_shared(w, R);
    void (*kern)(const int32_t*, int32_t*, const int32_t*, const int32_t*,
                 const int32_t*, int, int, int, int) = poseidon_kernel<SBOX, CHAIN>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 1, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, PS_THREADS, sh);
    const long long tiles = ((long long)B + PS_ROWS - 1) / PS_ROWS;
    const long long card = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    kern<<<(int)(tiles < card ? tiles : card), PS_THREADS, sh, (cudaStream_t)stream>>>(
        in, out, rk, mds, full, B, W, w, R);
    return (int)cudaGetLastError();
}

// The depth probe: out = a * b^reps mod l, reps dependent products a thread
// (sc_mul_canon's latency with 32 elements, its rate with many).
__global__ void __launch_bounds__(PS_THREADS)
sc_mul_test_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   int32_t* __restrict__ out, int n, int reps) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t* aw = reinterpret_cast<const uint32_t*>(a) + 8 * i;
    const uint32_t* bw = reinterpret_cast<const uint32_t*>(b) + 8 * i;
    uint32_t x[8], y[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        x[k] = aw[k];
        y[k] = bw[k];
    }
#pragma unroll 1
    for (int r = 0; r < reps; ++r) sc_mul_canon(x, y, x);
    uint32_t* o = reinterpret_cast<uint32_t*>(out) + 8 * i;
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = x[k];
}

extern "C" {

// out (B, w, 8) = the permutation of each state row; sbox 0 cube, 1 inverse
int bp_poseidon_permute(const int32_t* state, int32_t* out, const int32_t* rk,
                        const int32_t* mds, const int32_t* full, int B, int w, int R,
                        int sbox, void* stream) {
    if (sbox == 0) return ps_launch<0, false>(state, out, rk, mds, full, B, 1, w, R, stream);
    if (sbox == 1) return ps_launch<1, false>(state, out, rk, mds, full, B, 1, w, R, stream);
    return (int)cudaErrorInvalidValue;
}

// out (B, 8) = each witness row (W, 8) folded by the 2:1 hash
int bp_poseidon_chain(const int32_t* witness, int32_t* out, const int32_t* rk,
                      const int32_t* mds, const int32_t* full, int B, int W, int w,
                      int R, int sbox, void* stream) {
    if (sbox == 0) return ps_launch<0, true>(witness, out, rk, mds, full, B, W, w, R, stream);
    if (sbox == 1) return ps_launch<1, true>(witness, out, rk, mds, full, B, W, w, R, stream);
    return (int)cudaErrorInvalidValue;
}

// out (n, 8) = a * b^reps mod l (a test entry, on no path)
int bp_sc_mul_test(const int32_t* a, const int32_t* b, int32_t* out, int n, int reps,
                   void* stream) {
    if (n > 0)
        sc_mul_test_kernel<<<(n + PS_THREADS - 1) / PS_THREADS, PS_THREADS, 0,
                             (cudaStream_t)stream>>>(a, b, out, n, reps);
    return (int)cudaGetLastError();
}

}  // extern "C"
