// Fused entropy encode for Hopper: quantized zig-zag coefficients (or
// pixels, through the float32 fast transform) -> per-block stream words
// already shifted to their final bit phase, plus every block's global bit
// offset and bit count.
//
// Replaces the coefficient-major fused Pallas encode kernel of the JAX
// package (tinyimgcodec_tpu/ops/pallas_encode2.py, _make_kernel) and keeps
// its interface: (N, 56) uint32 rows, (2, N) meta, an overflow flag.
//
// What had to change.  The TPU kernel runs its grid in order on one core
// and carries the DC predictor and the running stream offset from tile to
// tile in scalar memory.  CUDA blocks run in no order, so here
//   - a block's DC predictor is read from its left neighbour's
//     coefficient directly (zero at the first block of an image);
//   - the global offsets come from a scan written out in launches:
//       count:   per-block bit counts                       (N threads)
//       scan:    exclusive scan inside each image           (one CTA an image)
//       starts:  image starts, each rounded up to a byte    (serial over B)
//       emit:    offset = image start + local offset; pack the words;
//   - table lookups are real lookups from shared memory (the TPU kernel's
//     compare-select chains stand in for a gather Mosaic does not have),
//     and the tables are arguments, not compile-time constants;
//   - the category of a value is 32 - clz(|v|).
//
// Bound: bytes.  From coefficients a block reads 256 B and writes 224 B of
// row + 8 B of meta; from pixels it reads 64 B.  The integer work per
// coefficient is a handful of operations.  Design: one thread per block
// with coefficient-major (64, N) input, so that every load of a warp is
// contiguous; each thread streams its code words through a 64-bit
// accumulator into its own row in shared memory (row stride 57 words: no
// bank conflicts), and the CTA copies its contiguous tile of rows out with
// coalesced stores.  The coefficients are read twice (count and emit) and
// the pixel mode writes them to a scratch buffer first; fusing those
// passes is left for a later change.
//
// The tables, the symbolizer, the float32 fast transform and the scans
// live in codec_common.cuh, shared with encode1.cu and stitch.cu.

#include "codec_common.cuh"

namespace {

constexpr int ROW_WORDS = 56;
constexpr int ROW_PAD = 57;

// ---- pass 1: per-block bit counts + table-range flag --------------------
__global__ void __launch_bounds__(ENC_THREADS)
count_kernel(const int* __restrict__ zz, const uint32_t* dc,
             const uint32_t* ac, const uint32_t* zhi, const uint32_t* zlo,
             int* __restrict__ bits, int* __restrict__ over, int n, int nb) {
    __shared__ Tables t;
    load_tables(t, dc, ac, zhi, zlo);
    const int b = blockIdx.x * ENC_THREADS + threadIdx.x;
    if (b >= n) return;
    CountSink sink;
    if (encode_block(zz, n, b, nb, t, sink)) atomicOr(over, 1);
    bits[b] = sink.bits;
}

// ---- pass 2 (scan_images_kernel) and pass 3 (image_starts_kernel): see
// codec_common.cuh ------------------------------------------------------

// ---- pass 4: pack every block's words at its final bit phase ------------
__global__ void __launch_bounds__(ENC_THREADS)
emit_kernel(const int* __restrict__ zz, const uint32_t* dc,
            const uint32_t* ac, const uint32_t* zhi, const uint32_t* zlo,
            const int* __restrict__ starts, int* __restrict__ off,
            uint32_t* __restrict__ packed, int n, int nb) {
    __shared__ Tables t;
    __shared__ uint32_t rows[ENC_THREADS * ROW_PAD];
    for (int i = threadIdx.x; i < ENC_THREADS * ROW_PAD; i += ENC_THREADS)
        rows[i] = 0u;
    load_tables(t, dc, ac, zhi, zlo);  // ends with __syncthreads()
    const int base = blockIdx.x * ENC_THREADS;
    const int b = base + threadIdx.x;
    if (b < n) {
        const int o = starts[b / nb] + off[b];  // off holds the local offset
        off[b] = o;
        WordSink sink(rows + threadIdx.x * ROW_PAD, o & 31);
        encode_block(zz, n, b, nb, t, sink);
        sink.flush();
    }
    __syncthreads();
    const int live = min(ENC_THREADS, n - base);
    uint32_t* out = packed + (size_t)base * ROW_WORDS;
    for (int i = threadIdx.x; i < live * ROW_WORDS; i += ENC_THREADS) {
        const int r = i / ROW_WORDS;
        out[i] = rows[r * ROW_PAD + (i - r * ROW_WORDS)];
    }
}

}  // namespace

// x: (n, 64) uint8 pixels (from_zz == 0; zz_scratch (64, n) int32 receives
// the coefficients) or (64, n) int32 coefficients (from_zz != 0).
// m (64, 64) float32, off0: fast transform.  dc (12), ac (176), zhi (4),
// zlo (4): uint32 symbol tables.  packed (n, 56) uint32; meta (2, n) int32
// = [global bit offset; bit count]; img_bits (n / nb) int32 scratch;
// starts (n / nb + 1) int32 (image starts, then the total); over (1)
// int32, zeroed by the caller.  n must be a multiple of nb.  All launches
// go to `stream`; returns the first non-zero cudaGetLastError().
extern "C" int encode2_launch(const void* x, int from_zz, const void* m,
                              float off0, const void* dc, const void* ac,
                              const void* zhi, const void* zlo,
                              void* zz_scratch, void* packed, void* meta,
                              void* img_bits, void* starts, void* over,
                              int n, int nb, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const int grid = (n + ENC_THREADS - 1) / ENC_THREADS;
    const int nimg = n / nb;
    const int* zz = (const int*)x;
    cudaError_t err;
    if (!from_zz) {
        fast_transform_kernel<<<grid, ENC_THREADS, 0, s>>>(
            (const uint8_t*)x, (const float*)m, off0, (int*)zz_scratch, n);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        zz = (const int*)zz_scratch;
    }
    int* off = (int*)meta;
    int* bits = (int*)meta + n;
    count_kernel<<<grid, ENC_THREADS, 0, s>>>(
        zz, (const uint32_t*)dc, (const uint32_t*)ac, (const uint32_t*)zhi,
        (const uint32_t*)zlo, bits, (int*)over, n, nb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    scan_images_kernel<<<nimg, SCAN_THREADS, 0, s>>>(bits, off,
                                                     (int*)img_bits, nb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    image_starts_kernel<<<1, 1, 0, s>>>((const int*)img_bits, (int*)starts,
                                        nimg);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    emit_kernel<<<grid, ENC_THREADS, 0, s>>>(
        zz, (const uint32_t*)dc, (const uint32_t*)ac, (const uint32_t*)zhi,
        (const uint32_t*)zlo, (const int*)starts, off, (uint32_t*)packed, n,
        nb);
    return (int)cudaGetLastError();
}

// The float32 transform pass alone: pix (n, 64) uint8 -> zz (64, n) int32.
extern "C" int fast_transform_launch(const void* pix, const void* m,
                                     float off0, void* zz, int n,
                                     void* stream) {
    if (n <= 0) return 0;
    const int grid = (n + ENC_THREADS - 1) / ENC_THREADS;
    fast_transform_kernel<<<grid, ENC_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)pix, (const float*)m, off0, (int*)zz, n);
    return (int)cudaGetLastError();
}
