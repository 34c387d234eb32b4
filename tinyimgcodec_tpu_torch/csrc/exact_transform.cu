// Exact (float64) block transform for Hopper: level shift, separable 8x8
// DCT, multiply by the reciprocal quantization divisors, round half to
// even, zig-zag; plus a per-block flag for roundings within 1e-9 of a tie.
//
// Replaces the double-float Pallas kernel of the JAX package
// (tinyimgcodec_tpu/ops/pallas_exact.py, _make_kernel).  That kernel
// emulates ~48-bit arithmetic with pairs of float32 because the TPU has
// no FP64 units; this card has them, so the same function is computed in
// plain `double`.
//
// Bound: bytes.  A block costs 64 B in and 260 B out (64 int32
// coefficients + one int32 flag) against ~2.2 kflop of FP64, far below
// the card's FP64 rate per byte.  Design: one thread per block; the
// thread's 64 pixels arrive as four 16-byte loads, the basis and the
// reciprocals are broadcast from shared memory, all 64 stage-1 sums stay
// in registers (every loop is fully unrolled), and the coefficient-major
// (64, N) output makes every store of a warp contiguous.
//
// Arithmetic order is fixed and documented because the plain PyTorch
// version repeats it operation for operation (and the file is compiled
// with -fmad=false), so kernel and plain version agree bit for bit:
//   Y[u][j] = (((D[u][0]*x[0][j]) + D[u][1]*x[1][j]) + ... )   i ascending
//   C[u][v] = (((Y[u][0]*D[v][0]) + Y[u][1]*D[v][1]) + ... )   j ascending
//   q = C[u][v] * R[u][v];  r = rint(q);  flag |= | |q - r| - 0.5 | < 1e-9

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
constexpr double TIE_SNAP = 1e-9;

__global__ void __launch_bounds__(THREADS)
exact_transform_kernel(const uint8_t* __restrict__ pix,
                       const double* __restrict__ basis,
                       const double* __restrict__ recip,
                       int* __restrict__ zz, int* __restrict__ flags, int n) {
    __shared__ double sD[64];
    __shared__ double sR[64];
    if (threadIdx.x < 64) {
        sD[threadIdx.x] = basis[threadIdx.x];
        sR[threadIdx.x] = recip[threadIdx.x];
    }
    __syncthreads();
    const int b = blockIdx.x * THREADS + threadIdx.x;
    if (b >= n) return;

    uint32_t w[16];
    const uint4* p = reinterpret_cast<const uint4*>(pix + (size_t)b * 64);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint4 q = p[i];
        w[4 * i + 0] = q.x;
        w[4 * i + 1] = q.y;
        w[4 * i + 2] = q.z;
        w[4 * i + 3] = q.w;
    }

    double y[64];  // y[u*8 + j]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        double x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int idx = i * 8 + j;
            const uint32_t byte = (w[idx >> 2] >> ((idx & 3) * 8)) & 0xFFu;
            x[i] = (double)byte - 128.0;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            double acc = sD[u * 8] * x[0];
#pragma unroll
            for (int i = 1; i < 8; ++i) acc = acc + sD[u * 8 + i] * x[i];
            y[u * 8 + j] = acc;
        }
    }

    int flag = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int v = 0; v < 8; ++v) {
            double acc = y[u * 8] * sD[v * 8];
#pragma unroll
            for (int j = 1; j < 8; ++j) acc = acc + y[u * 8 + j] * sD[v * 8 + j];
            const double q = acc * sR[u * 8 + v];
            const double r = rint(q);  // round half to even
            if (fabs(fabs(q - r) - 0.5) < TIE_SNAP) flag = 1;
            zz[(size_t)ZZ_SLOT[u * 8 + v] * n + b] = (int)r;
        }
    }
    flags[b] = flag;
}

}  // namespace

// pix (n, 64) uint8; basis, recip (64) double; zz (64, n) int32; flags (n)
// int32.  Launches on `stream`, returns cudaGetLastError().
extern "C" int exact_transform_launch(const void* pix, const void* basis,
                                      const void* recip, void* zz,
                                      void* flags, int n, void* stream) {
    if (n <= 0) return 0;
    const int grid = (n + THREADS - 1) / THREADS;
    exact_transform_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)pix, (const double*)basis, (const double*)recip,
        (int*)zz, (int*)flags, n);
    return (int)cudaGetLastError();
}
