// Exact (float64) block transform for Hopper: level shift, separable 8x8
// DCT, multiply by the reciprocal quantization divisors, round half to
// even, zig-zag; a per-block flag for roundings within 1e-9 of a tie; and
// every flagged block computed again in the float64 oracle's own
// arithmetic, so that every block's coefficients are the oracle's.
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
//     zig-zag row; the flagged blocks of the tile are listed there, and
//     each is settled by eight lanes (below) over the box's column before
//     the box leaves row by row, 16 bytes a store when N is a multiple of
//     4, 4 bytes else; one atomic add a tile counts the flagged blocks.
//
// The tensor cores sum in their own order, so a coefficient may differ
// from the oracle's (scipy's DCT) in its last bits: around 1e-13 on these
// magnitudes, far inside the 1e-9 tie window, so an unflagged coefficient
// rounds as the oracle's does.  A true tie (the DC of a block whose sum is
// 64 mod 128 at quality 50; (0,4), (4,0), (4,4) are rational too) rounds
// whichever way scipy's own arithmetic lands, so a flagged block is
// computed again in scipy's operations and order: lane c of its eight
// takes column c, runs the length-8 DCT of pocketfft (dct8 below, the
// constants baked in bit for bit as that code computes them), the eight
// lanes transpose the 8x8 by three shuffle exchanges, each runs the same
// DCT on its row, divides by the float64 divisors (IEEE division, as the
// oracle; not the reciprocal product) and rounds half to even.  The file
// builds with -fmad=false, so no multiply and add is contracted.  The
// plain version (ops/exact_transform.py) does the same step elementwise.

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

// The length-8 orthonormal DCT-II of v in place, in the operations and
// order of scipy's (pocketfft's T_dcst23, type 2: a pre-pass, a backward
// real FFT of a radix-2 then a radix-4 pass scaled by 1/4, a post-twiddle,
// the DC times sqrt(2) / 2), with its constants as that code computes them
// (the two parts of its root of unity differ in the last bit).
__device__ __forceinline__ void dct8(double v[8]) {
    constexpr double WR = 0x1.6a09e667f3bccp-1, WI = 0x1.6a09e667f3bcdp-1;
    constexpr double T1 = 0x1.f6297cff75cbp-1, T2 = 0x1.d906bcf328d46p-1,
                     T3 = 0x1.a9b66290ea1a3p-1, T4 = 0x1.6a09e667f3bccp-1,
                     T5 = 0x1.1c73b39ae68c8p-1, T6 = 0x1.87de2a6aea963p-2,
                     T7 = 0x1.8f8b83c69a60ap-3;
    constexpr double HALF_SQRT2 = 0x1.6a09e667f3bcdp-1;
    double x[8];
    x[0] = v[0] * 2.0;
    x[7] = v[7] * 2.0;
#pragma unroll
    for (int k = 1; k < 7; k += 2) {
        x[k] = v[k + 1] + v[k];
        x[k + 1] = v[k + 1] - v[k];
    }
    const double tr2 = x[1] - x[5], ti2 = x[2] + x[6];
    const double y[8] = {x[0] + x[7],         x[1] + x[5],
                         x[2] - x[6],         2.0 * x[3],
                         x[0] - x[7],         WR * tr2 - WI * ti2,
                         WR * ti2 + WI * tr2, -2.0 * x[4]};
    double r[8];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const double a = y[4 * k], b = y[4 * k + 1], c = y[4 * k + 2],
                     d = y[4 * k + 3];
        const double s2 = a + d, s1 = a - d, s3 = 2.0 * b, s4 = 2.0 * c;
        r[k] = s2 + s3;
        r[k + 4] = s2 - s3;
        r[k + 6] = s1 + s4;
        r[k + 2] = s1 - s4;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] *= 0.25;
    v[0] = r[0] * HALF_SQRT2;
    double t1 = T1 * r[7] + T7 * r[1], t2 = T1 * r[1] - T7 * r[7];
    v[1] = 0.5 * (t1 + t2);
    v[7] = 0.5 * (t1 - t2);
    t1 = T2 * r[6] + T6 * r[2];
    t2 = T2 * r[2] - T6 * r[6];
    v[2] = 0.5 * (t1 + t2);
    v[6] = 0.5 * (t1 - t2);
    t1 = T3 * r[5] + T5 * r[3];
    t2 = T3 * r[3] - T5 * r[5];
    v[3] = 0.5 * (t1 + t2);
    v[5] = 0.5 * (t1 - t2);
    v[4] = r[4] * T4;
}

// Eight lanes (an aligned eighth of the warp, c = lane & 7) holding an
// 8x8 by columns, v[i] = M[i][c], come to hold it by rows, v[j] = M[c][j]:
// three exchanges, the step-m one swapping M's entries whose lane and
// register differ in bit m with the lane across that bit.
__device__ __forceinline__ void transpose8(double v[8], int c) {
#pragma unroll
    for (int m = 4; m >= 1; m >>= 1) {
        const bool hi = c & m;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            if (i & m) continue;
            const double send = hi ? v[i] : v[i | m];
            const double got = __shfl_xor_sync(FULL, send, m);
            if (hi)
                v[i] = got;
            else
                v[i | m] = got;
        }
    }
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
                       const double* __restrict__ divisors,
                       int* __restrict__ zz, int* __restrict__ flags,
                       unsigned long long* __restrict__ flagged, int n,
                       int in_align, int out_quads) {
    static_assert(TILE == THREADS, "a thread lists one block's flag");
    __shared__ __align__(16) uint32_t s_pix[TILE * 16];  // (TILE, 64) bytes
    __shared__ int s_out[64 * OUT_STRIDE];  // (64, TILE) box
    __shared__ int s_flag[TILE];  // the flags, then the flagged blocks
    __shared__ int s_nflag;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wid = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int b0 = blockIdx.x * TILE;
    const int live = min(TILE, n - b0);
    if (tid == 0) s_nflag = 0;

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

    // ---- the flags out, and the flagged blocks listed -------------------
    const int mine = tid < live ? s_flag[tid] : 0;
    if (tid < live) flags[b0 + tid] = mine;
    __syncthreads();
    if (mine) s_flag[atomicAdd(&s_nflag, 1)] = tid;
    __syncthreads();
    const int nflag = s_nflag;
    if (tid == 0 && nflag) atomicAdd(flagged, (unsigned long long)nflag);

    // ---- each flagged block settled in the oracle's arithmetic: eight
    // lanes a block, four blocks a warp; lanes past the list redo its last
    // block and store nothing -------------------------------------------
    const int col = lane & 7;
    for (int base = wid * 4; base < nflag; base += 4 * WARPS) {
        const int f = base + (lane >> 3);
        const int bl = s_flag[min(f, nflag - 1)];
        const uint8_t* px = reinterpret_cast<const uint8_t*>(s_pix) + bl * 64;
        double v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = (double)px[i * 8 + col] - 128.0;
        dct8(v);  // column col: v[u] = Y[u][col]
        transpose8(v, col);
        dct8(v);  // row col: v[j] = C[col][j]
        if (f < nflag) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                s_out[ZZ_SLOT[col * 8 + j] * OUT_STRIDE + bl] =
                    __double2int_rn(v[j] / divisors[col * 8 + j]);
        }
    }
    __syncthreads();

    // ---- out row by row: (64, N) coefficients ---------------------------
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
}

}  // namespace

// pix (n, 64) uint8, any byte alignment; basis, recip, divisors (64)
// double; zz (64, n) int32; flags (n) int32; flagged one int64, set to the
// count of flagged blocks.  Launches on `stream`, returns
// cudaGetLastError().
extern "C" int exact_transform_launch(const void* pix, const void* basis,
                                      const void* recip,
                                      const void* divisors, void* zz,
                                      void* flags, void* flagged, int n,
                                      void* stream) {
    cudaMemsetAsync(flagged, 0, sizeof(unsigned long long),
                    (cudaStream_t)stream);
    if (n <= 0) return (int)cudaGetLastError();
    const uintptr_t p = reinterpret_cast<uintptr_t>(pix);
    const int in_align = p % 16 == 0 ? 16 : p % 4 == 0 ? 4 : 1;
    const int out_quads =
        n % 4 == 0 && reinterpret_cast<uintptr_t>(zz) % 16 == 0;
    const int grid = (n + TILE - 1) / TILE;
    exact_transform_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)pix, (const double*)basis, (const double*)recip,
        (const double*)divisors, (int*)zz, (int*)flags,
        (unsigned long long*)flagged, n, in_align, out_quads);
    return (int)cudaGetLastError();
}
