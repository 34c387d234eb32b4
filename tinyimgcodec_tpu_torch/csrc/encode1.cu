// Block-local entropy encode for Hopper: pixels (through the float32 fast
// transform) or quantized zig-zag coefficients -> every block's code words
// packed from bit 0 of its own 52-word row, plus its bit count.
//
// Replaces the block-major fused Pallas encode kernel of the JAX package
// (tinyimgcodec_tpu/ops/pallas_encode.py, _make_kernel) and keeps its
// function: words (N, 52) uint32, bits (N,) int32, an overflow flag.  The
// ragged rows are concatenated into one stream by stitch.cu.
//
// What had to change.  The TPU kernel carries the DC predictor from tile
// to tile of a sequential grid, looks codes up with compare-select chains
// and packs a block with 65 masked whole-tile OR steps.  Here a block's
// predictor is its left neighbour's DC (zero at an image's first block),
// the tables sit in shared memory as real lookups and are arguments, and
// each thread streams its code words through a 64-bit accumulator.
//
// The transform and the symbolizer are the device code of encode2.cu
// (codec_common.cuh): pixel input runs the same fast_transform_kernel into
// a (64, N) scratch and the same encode_block, so this path and the
// encode2 path produce the same bits for the same pixels by construction.
//
// Bound: from pixels, operations (2 x 64 x 64 float32 per block against
// 64 B in and 212 B out); from coefficients, bytes (256 B in, 212 B out).
// Design: one thread per block; the row is built in shared memory (row
// stride 53 words, odd, so threads of a warp hit different banks) and the
// CTA copies its contiguous tile of rows out with coalesced stores.
// Block-major (N, 64) coefficient input is read with a 256-byte stride
// between threads, which wastes sectors; that input form exists for
// parity with the JAX kernel, the pipeline feeds pixels.

#include "codec_common.cuh"

namespace {

constexpr int ROW_WORDS = 52;
constexpr int ROW_PAD = 53;

template <bool BlockMajor>
__global__ void __launch_bounds__(ENC_THREADS)
encode1_kernel(const int* __restrict__ zz, const uint32_t* dc,
               const uint32_t* ac, const uint32_t* zhi, const uint32_t* zlo,
               uint32_t* __restrict__ words, int* __restrict__ bits,
               int* __restrict__ over, int n, int nb) {
    __shared__ Tables t;
    __shared__ uint32_t rows[ENC_THREADS * ROW_PAD];
    for (int i = threadIdx.x; i < ENC_THREADS * ROW_PAD; i += ENC_THREADS)
        rows[i] = 0u;
    load_tables(t, dc, ac, zhi, zlo);  // ends with __syncthreads()
    const int base = blockIdx.x * ENC_THREADS;
    const int b = base + threadIdx.x;
    if (b < n) {
        WordSink sink(rows + threadIdx.x * ROW_PAD, 0);
        if (encode_block(GlobalCoef<BlockMajor>{zz, n, b, nb}, t, sink))
            atomicOr(over, 1);
        sink.flush();  // <= 1662 bits: at most 52 words
        bits[b] = sink.bits;
    }
    __syncthreads();
    const int live = min(ENC_THREADS, n - base);
    uint32_t* out = words + (size_t)base * ROW_WORDS;
    for (int i = threadIdx.x; i < live * ROW_WORDS; i += ENC_THREADS) {
        const int r = i / ROW_WORDS;
        out[i] = rows[r * ROW_PAD + (i - r * ROW_WORDS)];
    }
}

}  // namespace

// x: (n, 64) uint8 pixels (from_zz == 0; zz_scratch (64, n) int32 receives
// the coefficients) or (n, 64) int32 coefficients, block-major (from_zz !=
// 0).  m (64, 64) float32, off0: fast transform.  dc (12), ac (176), zhi
// (4), zlo (4): uint32 symbol tables.  words (n, 52) uint32; bits (n)
// int32; over (1) int32, zeroed by the caller.  All launches go to
// `stream`; returns the first non-zero cudaGetLastError().
extern "C" int encode1_launch(const void* x, int from_zz, const void* m,
                              float off0, const void* dc, const void* ac,
                              const void* zhi, const void* zlo,
                              void* zz_scratch, void* words, void* bits,
                              void* over, int n, int nb, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const int grid = (n + ENC_THREADS - 1) / ENC_THREADS;
    if (from_zz) {
        encode1_kernel<true><<<grid, ENC_THREADS, 0, s>>>(
            (const int*)x, (const uint32_t*)dc, (const uint32_t*)ac,
            (const uint32_t*)zhi, (const uint32_t*)zlo, (uint32_t*)words,
            (int*)bits, (int*)over, n, nb);
        return (int)cudaGetLastError();
    }
    fast_transform_kernel<<<grid, ENC_THREADS, 0, s>>>(
        (const uint8_t*)x, (const float*)m, off0, (int*)zz_scratch, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    encode1_kernel<false><<<grid, ENC_THREADS, 0, s>>>(
        (const int*)zz_scratch, (const uint32_t*)dc, (const uint32_t*)ac,
        (const uint32_t*)zhi, (const uint32_t*)zlo, (uint32_t*)words,
        (int*)bits, (int*)over, n, nb);
    return (int)cudaGetLastError();
}
