// Symbol statistics of one image for Hopper: the coefficient-major (64, n)
// int32 coefficients of a block range, already on the card, -> the image's
// Huffman symbol histograms and two per-block maxima, summed into one small
// buffer over every range of the image.  From them the host builds the
// image's own tables (about 2 KB pulled) and proves that no block passes
// the encode kernels' 52-word row, with no pull of the coefficients.
//
// It replaces no TPU kernel: the JAX package counts the symbols on the
// host, in numpy, after pulling the coefficients
// (tinyimgcodec_tpu/engine.py:423, huffman.symbol_counts and
// block_bit_counts), and the port did the same until this kernel.
//
// Layout of `stats` (int64, zeroed by the caller, summed over launches; 64
// bits because the EOB and (0, 1) counts of a gigapixel image pass 2**31):
//   [0, 16)     DC histogram by category of the DPCM'd DC;
//   [16, 272)   AC histogram at 16 + (run & 15) * 16 + size, the folded ZRL
//               prefixes at 16 + 15 * 16, one EOB a block at 16;
//   272, 273    the largest DC category, the largest AC size;
//   274, 275    the most symbols one block codes (DC, nonzero AC, ZRLs,
//               EOB) and the most magnitude bits one block carries.
// A category or size past 15 is counted at 15; the wrapper raises on it.
//
// Bound: neither bytes nor operations.  A 512x512 image is 1 MB read once
// (0.3 us at 3.35 TB/s) and about 20 integer operations a coefficient; at
// 4096 blocks the launch and the latency of one pass of dependent loads
// set the time, a few microseconds.  Design:
//   - one thread a block: the coefficients are coefficient-major, so row k
//     of a warp's 32 consecutive blocks is one coalesced 128-byte load (a
//     warp a block would read 64 scattered sectors).  The rows come in
//     sixteen at a time into registers before any is used, so a thread
//     has sixteen loads in flight;
//   - a running index of the last nonzero coefficient gives the runs; a
//     value's size is 32 - clz(|v|); the DC difference is taken against the
//     block before, or, for a range's first block, against `dc_prev` (the
//     previous range's last DC, as encode2 carries it; none: 0), in int32
//     wrap-around as the host's int32 diff;
//   - each CTA keeps a private histogram in shared memory (shared atomics
//     for the nonzero coefficients, one add a CTA for the EOBs), then adds
//     its nonzero bins to `stats` with global atomics; the maxima are
//     reduced in the warp, then atomicMax in shared memory and to `stats`.
//     Integer sums are the same in any order, so the counts are exact on
//     every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // blocks a CTA
constexpr int DC_CATS = 16;
constexpr int AC_SIZES = 16;
constexpr int AC0 = DC_CATS;                     // first AC bin
constexpr int HIST = DC_CATS + 16 * AC_SIZES;    // 272 bins
constexpr int MAXIMA = 4;
constexpr int CHUNK = 16;  // coefficient rows loaded before any is used
constexpr unsigned FULL = 0xFFFFFFFFu;

// JPEG size of v: the bits of |v| (0 for 0), |INT_MIN| as 2**31.
__device__ __forceinline__ unsigned size_of(int v) {
    const unsigned a = v < 0 ? 0u - (unsigned)v : (unsigned)v;
    return 32u - (unsigned)__clz(a);
}

__global__ void __launch_bounds__(THREADS) symbol_stats_kernel(
    const int* __restrict__ zz, const int* __restrict__ dc_prev,
    unsigned long long* __restrict__ stats, int n) {
    __shared__ unsigned hist[HIST];
    __shared__ unsigned maxima[MAXIMA];
    for (int i = threadIdx.x; i < HIST; i += THREADS) hist[i] = 0u;
    if (threadIdx.x < MAXIMA) maxima[threadIdx.x] = 0u;
    __syncthreads();

    const int b = blockIdx.x * THREADS + threadIdx.x;
    unsigned dc_cat = 0, ac_size = 0, symbols = 0, magnitude = 0;
    if (b < n) {
        const size_t stride = (size_t)n;
        const int* col = zz + b;
        const int before = b > 0 ? col[-1] : (dc_prev ? *dc_prev : 0);
        unsigned zrl = 0;
        int last = 0;  // the last nonzero position (the DC's to start)
#pragma unroll
        for (int k0 = 0; k0 < 64; k0 += CHUNK) {
            int v[CHUNK];
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) v[j] = col[(k0 + j) * stride];
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
                const int k = k0 + j;
                if (k == 0) {
                    dc_cat = size_of((int)((unsigned)v[0] - (unsigned)before));
                    atomicAdd(&hist[min(dc_cat, (unsigned)DC_CATS - 1)], 1u);
                    magnitude = dc_cat;
                    symbols = 2;  // the DC and the EOB
                } else if (v[j] != 0) {
                    const unsigned s = size_of(v[j]);
                    const int run = k - last - 1;
                    atomicAdd(&hist[AC0 + (run & 15) * AC_SIZES +
                                    min(s, (unsigned)AC_SIZES - 1)],
                              1u);
                    zrl += run >> 4;
                    symbols += 1 + (run >> 4);
                    magnitude += s;
                    ac_size = max(ac_size, s);
                    last = k;
                }
            }
        }
        if (zrl) atomicAdd(&hist[AC0 + 15 * AC_SIZES], zrl);
    }
    if (threadIdx.x == 0) {  // one EOB a block of the CTA
        const int blocks = n - (int)blockIdx.x * THREADS;
        atomicAdd(&hist[AC0], (unsigned)(blocks < THREADS ? blocks : THREADS));
    }
    dc_cat = __reduce_max_sync(FULL, dc_cat);
    ac_size = __reduce_max_sync(FULL, ac_size);
    symbols = __reduce_max_sync(FULL, symbols);
    magnitude = __reduce_max_sync(FULL, magnitude);
    if ((threadIdx.x & 31) == 0) {
        atomicMax(&maxima[0], dc_cat);
        atomicMax(&maxima[1], ac_size);
        atomicMax(&maxima[2], symbols);
        atomicMax(&maxima[3], magnitude);
    }
    __syncthreads();

    for (int i = threadIdx.x; i < HIST; i += THREADS) {
        if (hist[i]) atomicAdd(&stats[i], (unsigned long long)hist[i]);
    }
    if (threadIdx.x < MAXIMA) {
        atomicMax(&stats[HIST + threadIdx.x],
                  (unsigned long long)maxima[threadIdx.x]);
    }
}

}  // namespace

// zz: (64, n) int32 coefficient-major, contiguous; dc_prev: one int32 on the
// card, the DC before the range's first block, or null for 0; stats: the
// (276,) int64 buffer above, zeroed once an image.
extern "C" int symbol_stats_launch(const void* zz, const void* dc_prev,
                                   void* stats, int n, void* stream) {
    if (n <= 0) return 0;
    const unsigned grid = (unsigned)((n + THREADS - 1) / THREADS);
    symbol_stats_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)zz, (const int*)dc_prev, (unsigned long long*)stats, n);
    return (int)cudaGetLastError();
}
