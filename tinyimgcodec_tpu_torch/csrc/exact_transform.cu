// Exact (float64) block transform for Hopper: level shift, separable 8x8
// DCT, multiply by the reciprocal quantization divisors, round half to
// even, zig-zag; plus a per-block flag for roundings within 1e-9 of a tie.
//
// Replaces the double-float Pallas kernel of the JAX package
// (tinyimgcodec_tpu/ops/pallas_exact.py, _make_kernel).  That kernel
// emulates ~48-bit arithmetic with pairs of float32 because the TPU has
// no FP64 units; this card has them, and FP64 tensor cores besides, so the
// same function is computed in `double`.
//
// Bound: bytes.  A block costs 64 B in and 260 B out (64 int32
// coefficients + one int32 flag).  The two 8x8 products, written as 2 x
// (512 + 448) separate FP64 multiplies and adds, would cost about 2 200
// FP64-pipe instructions a block, more time than the bytes take; on the
// FP64 tensor cores (DMMA, mma.sync f64) they are two 8x8x4 products a
// block and one 16x8x8 product for two blocks, for a warp.  Design:
//   - one CTA = a tile of TILE blocks, four warps; the tile's pixels come
//     into shared memory with 16-byte loads when the tensor is 16-byte
//     aligned, 4-byte or 1-byte loads else;
//   - a warp transforms STEP blocks at a time.  Lane l = 4 g + q holds
//     A[g][q], B[q][g] and C[g][2q + {0,1}] of an 8x8x4 product.  Stage 1,
//     Y = D X, one block in two 8x8x4 steps s = 0, 1: A = D[g][q + 4s],
//     B = X[q + 4s][g], so Y[g][2q + {0,1}] lies in the accumulator.
//     Stage 2, C = Y D^T, two blocks in one 16x8x8 product (block u in
//     rows 0..7, block u + 1 in rows 8..15), its sum over j taken in the
//     order j = 2k + s (k < 4 the lane's place q, s = 0, 1 the half of the
//     16x8x8 operand): then the A operand is Y[g][2q + s] of each block,
//     exactly what the lane already holds, and B = D[g][2q + s] is a
//     constant of the lane -- no shuffle and no shared memory between the
//     stages, and C comes out where stage 1 left Y;
//   - quantize, round and flag stay on the FP64 pipe in registers:
//     q = C * R, rint and the int32 result by adding and subtracting
//     1.5 * 2**52 (round half to even, exact for |q| < 2**51), the flag
//     | |q - rint(q)| - 0.5 | < 1e-9 as in the plain version; pixels become
//     doubles by the same kind of exponent trick, without a conversion
//     instruction;
//   - the coefficients go to a (64, TILE) box in shared memory at their
//     zig-zag row and leave row by row, 16 bytes a store when N is a
//     multiple of 4, 4 bytes else.
//
// The tensor cores sum in their own order, so a coefficient may differ
// from the plain version's (which rounds after every multiply and every
// add, ascending i then j) in its last bits: around 1e-13 on these
// magnitudes, far inside the 1e-9 tie window, so an unflagged coefficient
// rounds alike in both, and the caller recomputes every flagged block with
// the float64 host oracle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// zig-zag slot of the row-major coefficient u*8+v (inverse zig-zag order)
__constant__ unsigned char ZZ_SLOT[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;               // blocks a CTA
constexpr int PER_WARP = TILE / WARPS;  // blocks a warp
constexpr int STEP = 4;                 // blocks a warp has in flight, even
constexpr int OUT_STRIDE = TILE + 1;    // odd: column stores spread banks
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr double TIE_SNAP = 1e-9;
constexpr double TWO52 = 4503599627370496.0;       // 2**52
constexpr double RINT_MAGIC = 6755399441055744.0;  // 1.5 * 2**52

// D = A B + C on the FP64 tensor cores, one 8x8x4 step for the warp.
// Lane l = 4 g + q holds A[g][q], B[q][g], C and D[g][2q + {0,1}].
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b, double c0, double c1) {
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%4, %5};"
        : "=d"(d0), "=d"(d1)
        : "d"(a), "d"(b), "d"(c0), "d"(c1));
}

// D = A B on the FP64 tensor cores, one 16x8x8 product for the warp.
// Lane l = 4 g + q holds A[g][q], A[g + 8][q], A[g][q + 4], A[g + 8][q + 4]
// (a0..a3), B[q][g], B[q + 4][g] (b0, b1) and D[g][2q + {0,1}],
// D[g + 8][2q + {0,1}] (d0..d3).
__device__ __forceinline__ void dmma16(double& d0, double& d1, double& d2,
                                       double& d3, double a0, double a1,
                                       double a2, double a3, double b0,
                                       double b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};"
        : "=d"(d0), "=d"(d1), "=d"(d2), "=d"(d3)
        : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1), "d"(0.0),
          "d"(0.0), "d"(0.0), "d"(0.0));
}

// byte - 128 as a double: 2**52 + byte by its bit pattern, then one add
__device__ __forceinline__ double shifted_pixel(uint32_t word, int sh) {
    return __hiloint2double(0x43300000, (int)((word >> sh) & 0xFFu)) -
           (TWO52 + 128.0);
}

// quantize and round one coefficient; returns 1 if it lies near a tie
__device__ __forceinline__ int quantize(double c, double r, int* out) {
    const double q = c * r;
    const double t = q + RINT_MAGIC;  // round half to even, in the low bits
    const double v = t - RINT_MAGIC;  // == rint(q)
    *out = __double2loint(t);
    return fabs(fabs(q - v) - 0.5) < TIE_SNAP;
}

__global__ void __launch_bounds__(THREADS)
exact_transform_kernel(const uint8_t* __restrict__ pix,
                       const double* __restrict__ basis,
                       const double* __restrict__ recip,
                       int* __restrict__ zz, int* __restrict__ flags, int n,
                       int in_align, int out_quads) {
    __shared__ __align__(16) uint32_t s_pix[TILE * 16];  // (TILE, 64) bytes
    __shared__ int s_out[64 * OUT_STRIDE];  // (64, TILE) box
    __shared__ int s_flag[TILE];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wid = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int b0 = blockIdx.x * TILE;
    const int live = min(TILE, n - b0);

    // ---- the tile's pixels into shared memory ---------------------------
    const uint8_t* src = pix + (size_t)b0 * 64;
    const int nbytes = live * 64;
    if (in_align == 16) {
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        uint4* d4 = reinterpret_cast<uint4*>(s_pix);
        for (int i = tid; i < nbytes / 16; i += THREADS) d4[i] = s4[i];
    } else if (in_align == 4) {
        const uint32_t* s1 = reinterpret_cast<const uint32_t*>(src);
        for (int i = tid; i < nbytes / 4; i += THREADS) s_pix[i] = s1[i];
    } else {
        uint8_t* d = reinterpret_cast<uint8_t*>(s_pix);
        for (int i = tid; i < nbytes; i += THREADS) d[i] = src[i];
    }
    // the lane's constants: D[g][q + 4s] (stage 1), D[g][2q + s] (stage 2),
    // R[g][2q + s] and the zig-zag rows of its two coefficients
    const double a0 = basis[g * 8 + q], a1 = basis[g * 8 + q + 4];
    const double d0 = basis[g * 8 + 2 * q], d1 = basis[g * 8 + 2 * q + 1];
    const double r0 = recip[g * 8 + 2 * q], r1 = recip[g * 8 + 2 * q + 1];
    int* out0 = s_out + ZZ_SLOT[g * 8 + 2 * q] * OUT_STRIDE;
    int* out1 = s_out + ZZ_SLOT[g * 8 + 2 * q + 1] * OUT_STRIDE;
    // X[row][g] is byte g & 3 of the tile's word 2 row + g / 4 of a block
    const int sh = (g & 3) * 8;
    __syncthreads();

    // ---- five DMMAs for two blocks, STEP blocks in flight; the tile's
    // blocks past `live` are computed on stale bytes and never stored -----
    for (int k = 0; k < PER_WARP; k += STEP) {
        double y0[STEP], y1[STEP], c0[STEP], c1[STEP];
#pragma unroll
        for (int u = 0; u < STEP; ++u) {
            const uint32_t* w = s_pix + (wid * PER_WARP + k + u) * 16 + 2 * q +
                                (g >> 2);
            dmma(y0[u], y1[u], a0, shifted_pixel(w[0], sh), 0.0, 0.0);
            dmma(y0[u], y1[u], a1, shifted_pixel(w[8], sh), y0[u], y1[u]);
        }
        // two blocks a product: rows 0..7 block u, rows 8..15 block u + 1
#pragma unroll
        for (int u = 0; u < STEP; u += 2)
            dmma16(c0[u], c1[u], c0[u + 1], c1[u + 1], y0[u], y0[u + 1],
                   y1[u], y1[u + 1], d0, d1);
#pragma unroll
        for (int u = 0; u < STEP; ++u) {
            const int bl = wid * PER_WARP + k + u;
            const int tie = quantize(c0[u], r0, out0 + bl) |
                            quantize(c1[u], r1, out1 + bl);
            const unsigned any = __any_sync(FULL, tie);
            if (lane == 0) s_flag[bl] = any ? 1 : 0;
        }
    }
    __syncthreads();

    // ---- out row by row: (64, N) coefficients, then the flags -----------
    if (out_quads) {  // N % 4 == 0, so live % 4 == 0 and rows start on 16 B
        const int quads = live >> 2;
        // a warp a row: TILE / 4 lanes, each 16 bytes; the ragged last tile
        // masks its lanes
        for (int i = tid; i < 64 * (TILE / 4); i += THREADS) {
            const int r = i / (TILE / 4), c = i % (TILE / 4);
            if (c >= quads) continue;
            const int* s = s_out + r * OUT_STRIDE + 4 * c;
            *reinterpret_cast<int4*>(zz + (size_t)r * n + b0 + 4 * c) =
                make_int4(s[0], s[1], s[2], s[3]);
        }
    } else {
        for (int i = tid; i < 64 * live; i += THREADS) {
            const int r = i / live, c = i - r * live;
            zz[(size_t)r * n + b0 + c] = s_out[r * OUT_STRIDE + c];
        }
    }
    for (int i = tid; i < live; i += THREADS) flags[b0 + i] = s_flag[i];
}

}  // namespace

// pix (n, 64) uint8, any byte alignment; basis, recip (64) double; zz
// (64, n) int32; flags (n) int32.  Launches on `stream`, returns
// cudaGetLastError().
extern "C" int exact_transform_launch(const void* pix, const void* basis,
                                      const void* recip, void* zz,
                                      void* flags, int n, void* stream) {
    if (n <= 0) return 0;
    const uintptr_t p = reinterpret_cast<uintptr_t>(pix);
    const int in_align = p % 16 == 0 ? 16 : p % 4 == 0 ? 4 : 1;
    const int out_quads =
        n % 4 == 0 && reinterpret_cast<uintptr_t>(zz) % 16 == 0;
    const int grid = (n + TILE - 1) / TILE;
    exact_transform_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)pix, (const double*)basis, (const double*)recip,
        (int*)zz, (int*)flags, n, in_align, out_quads);
    return (int)cudaGetLastError();
}
