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
// (codec_common.cuh), so this path and the encode2 path produce the same
// bits for the same pixels by construction.
//
// Bound: from pixels, operations (2 x 64 x 64 float32 per block against
// 64 B in and 212 B out); from coefficients, bytes (256 B in, 212 B out).
// Design, one launch that moves each byte once:
//   - one CTA = a tile of up to 128 consecutive blocks, one thread a block.
//     Rows need no stream offset, so tiles ignore image boundaries (only
//     the predictor resets at b % nb == 0) and the last tile may be ragged;
//     there is no scan and no state to zero;
//   - the tile's coefficients live in shared memory as a (64, 129) matrix,
//     one column a block: the odd stride lets a lane read its own column
//     and lets neighbouring lanes store neighbouring coefficients of one
//     block, both without bank conflicts.  From pixels the transform writes
//     into it (its matrix borrows the rows' space first), so no coefficient
//     matrix ever exists in device memory; block-major (N, 64) coefficients
//     are one contiguous piece a tile, read 16 bytes a load when the tensor
//     is aligned (4 bytes else) and turned on the way in;
//   - a tile's first predictor lies in the tile before it: one coefficient
//     read from device memory or, from pixels, recomputed from the
//     neighbour's pixels in the transform's own arithmetic;
//   - the symbolizer packs each block from bit 0 of a shared-memory row
//     (stride 53 words: no bank conflicts) and the CTA copies its
//     contiguous tile of rows out 16 bytes a store (a row is 208 bytes, so
//     every piece is aligned).
// Shared memory: 33 KB tile + 27 KB rows + tables = 60 KB a CTA of 128
// threads, three CTAs an SM.

#include "codec_common.cuh"

namespace {

constexpr int ROW_WORDS = 52;
constexpr int ROW_PAD = 53;
constexpr int TILE = ENC_THREADS;
constexpr int TILE_STRIDE = TILE + 1;
constexpr int TILE_WORDS = 64 * TILE_STRIDE;  // a multiple of 4
constexpr int ROWS_WORDS = TILE * ROW_PAD;    // >= 64 * 64: holds the matrix
constexpr size_t SHARED_BYTES = 4 * (TILE_WORDS + ROWS_WORDS);

template <bool FromZZ>
__global__ void __launch_bounds__(ENC_THREADS)
encode1_kernel(const void* __restrict__ x, const float* __restrict__ m,
               float off0, const uint32_t* dc, const uint32_t* ac,
               const uint32_t* zhi, const uint32_t* zlo,
               uint32_t* __restrict__ words, int* __restrict__ bits,
               int* __restrict__ over, int n, int nb, int aligned16) {
    extern __shared__ __align__(16) unsigned char shared_raw[];
    int* tile = reinterpret_cast<int*>(shared_raw);  // (64, TILE_STRIDE)
    uint32_t* rows = reinterpret_cast<uint32_t*>(tile + TILE_WORDS);
    __shared__ Tables t;
    __shared__ int s_prev;
    const int tid = threadIdx.x;
    const int b0 = blockIdx.x * TILE;  // the tile's first block
    const int live = min(TILE, n - b0);
    load_tables(t, dc, ac, zhi, zlo);  // ends with __syncthreads()

    // ---- the tile's coefficients into shared memory ---------------------
    if (FromZZ) {
        const int* zz = static_cast<const int*>(x) + (size_t)b0 * 64;
        if (aligned16) {
            const uint4* src = reinterpret_cast<const uint4*>(zz);
#pragma unroll 4
            for (int i = tid; i < live * 16; i += ENC_THREADS) {
                const uint4 v = src[i];
                int* d = tile + (4 * (i & 15)) * TILE_STRIDE + (i >> 4);
                d[0] = (int)v.x;
                d[TILE_STRIDE] = (int)v.y;
                d[2 * TILE_STRIDE] = (int)v.z;
                d[3 * TILE_STRIDE] = (int)v.w;
            }
        } else {
#pragma unroll 4
            for (int i = tid; i < live * 64; i += ENC_THREADS)
                tile[(i & 63) * TILE_STRIDE + (i >> 6)] = zz[i];
        }
        if (tid == 0) s_prev = b0 % nb == 0 ? 0 : zz[-64];
        for (int i = tid; i < ROWS_WORDS; i += ENC_THREADS) rows[i] = 0u;
        __syncthreads();
    } else {
        const uint8_t* pix = static_cast<const uint8_t*>(x);
        float* sM = reinterpret_cast<float*>(rows);
        for (int i = tid; i < 64 * 64; i += ENC_THREADS) sM[i] = m[i];
        __syncthreads();
        if (tid < live)
            fast_transform_block(
                pix + (size_t)(b0 + tid) * 64, sM, off0,
                [&](int k, int v) { tile[k * TILE_STRIDE + tid] = v; });
        if (tid == ENC_THREADS - 1)
            s_prev = b0 % nb == 0
                         ? 0
                         : fast_transform_dc(pix + (size_t)(b0 - 1) * 64, sM,
                                             off0);
        __syncthreads();
        for (int i = tid; i < ROWS_WORDS; i += ENC_THREADS) rows[i] = 0u;
        __syncthreads();
    }

    // ---- symbols, packed from bit 0 of the block's row ------------------
    if (tid < live) {
        const int b = b0 + tid;
        const int prev = b % nb == 0 ? 0 : tid == 0 ? s_prev : tile[tid - 1];
        WordSink sink(rows + tid * ROW_PAD, 0);
        if (encode_block(TileCoef{tile + tid, TILE_STRIDE, prev}, t, sink))
            atomicOr(over, 1);
        sink.flush();  // <= 1662 bits: at most 52 words
        bits[b] = sink.bits;
    }
    __syncthreads();

    // ---- rows out: 16 bytes a store, 13 stores a row ----------------------
    uint4* out = reinterpret_cast<uint4*>(words + (size_t)b0 * ROW_WORDS);
    constexpr int QUADS = ROW_WORDS / 4;
    for (int i = tid; i < live * QUADS; i += ENC_THREADS) {
        const int r = i / QUADS;
        const uint32_t* row = rows + r * ROW_PAD + 4 * (i - r * QUADS);
        out[i] = make_uint4(row[0], row[1], row[2], row[3]);
    }
}

}  // namespace

// x: (n, 64) uint8 pixels (from_zz == 0) or (n, 64) int32 coefficients,
// block-major (from_zz != 0).  m (64, 64) float32, off0: fast transform.
// dc (12), ac (176), zhi (4), zlo (4): uint32 symbol tables.  words (n, 52)
// uint32, 16-byte aligned; bits (n) int32; over (1) int32, zeroed by the
// caller.  One launch, on `stream`; returns the first non-zero CUDA error.
extern "C" int encode1_launch(const void* x, int from_zz, const void* m,
                              float off0, const void* dc, const void* ac,
                              const void* zhi, const void* zlo, void* words,
                              void* bits, void* over, int n, int nb,
                              void* stream) {
    if (n <= 0) return 0;
    const int grid = (n + TILE - 1) / TILE;
    const int aligned16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
    auto kernel = from_zz ? encode1_kernel<true> : encode1_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SHARED_BYTES);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, ENC_THREADS, SHARED_BYTES, (cudaStream_t)stream>>>(
        x, (const float*)m, off0, (const uint32_t*)dc, (const uint32_t*)ac,
        (const uint32_t*)zhi, (const uint32_t*)zlo, (uint32_t*)words,
        (int*)bits, (int*)over, n, nb, aligned16);
    return (int)cudaGetLastError();
}
