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
//   - a block's DC predictor is its left neighbour's DC (at the first
//     block of an image zero, or the caller's dc_init: a range of one
//     image's blocks carries the DC before it in); a tile's first block
//     reads (or, from pixels, computes) the one coefficient of the tile
//     before it;
//   - the running offset comes from a single-pass scan across the CTAs
//     (decoupled look-back, below) instead of a carried scalar;
//   - table lookups are real lookups from shared memory (the TPU kernel's
//     compare-select chains stand in for a gather Mosaic does not have),
//     and the tables are arguments, not compile-time constants;
//   - the category of a value is 32 - clz(|v|).
//
// Bound: from coefficients bytes (a block reads 256 B and writes 224 B of
// row + 8 B of meta); from pixels (64 B in) the operations of the float32
// transform, 2 x 64 x 64 a block, which -fmad=false keeps as separate
// multiplies and adds.  The design moves each byte once and makes one
// launch:
//   - one CTA = one tile of up to 128 blocks of one image (tiles do not
//     straddle images; an image's last tile may be ragged), one thread a
//     block.  The (64, tile) box of the coefficient-major matrix comes
//     into shared memory by cp.async, 16 bytes a copy when every row piece
//     is 16-byte aligned (nb and N multiples of 4 and an aligned tensor),
//     else 4 bytes a copy; from pixels the transform writes its
//     coefficients straight into that tile, so no coefficient matrix ever
//     exists in device memory;
//   - the symbolizer runs once a block, on its shared-memory column --
//     first a mask of the nonzero coefficients from 63 loads that do not
//     wait for one another, then one turn for each nonzero one -- and
//     packs the block from bit 0 of a shared-memory row (stride 57 words:
//     no bank conflicts); that gives the bit count too, so there is no
//     separate counting pass;
//   - a CTA-wide scan turns the counts into offsets inside the tile, and
//     the tile's own offset comes from the tiles before it: every tile
//     publishes one 64-bit word (status, starts-an-image, value) -- first
//     its own bit sum, then, once known, the stream offset at its end --
//     and looks back over its predecessors' words, 32 at a time with a
//     warp, until it meets one that already knows its end.  Image starts
//     are rounded up to a byte, so what a run of tiles does to a running
//     offset s is s + a or, when it holds an image start,
//     align8(s + a1) + a2; that family is closed under composition and the
//     warp reduces it in order.  Tiles take their index from an atomic
//     ticket, so a tile only ever waits for tiles that already run; the
//     word carries state and value together, so one store publishes both;
//     ticket and words are zeroed by the caller before every launch.  The
//     sums are integers: the result does not depend on who resolves first;
//   - the rows leave through a coalesced copy, 16 bytes a store, that
//     shifts each row to its block's bit phase on the way out (a funnel
//     shift of neighbouring words), which is why the symbolizer did not
//     need the offset.
// What holds it at about twice its bound: the phases of a CTA (load, code,
// scan, copy out) follow one another, and only three CTAs fit an SM.
// Shared memory: 32 KB tile + 29 KB rows (the transform's matrix borrows
// the rows' space before they are needed) + tables = 62 KB a CTA of 128
// threads, three CTAs an SM.
//
// The tables, the symbolizer and the float32 fast transform live in
// codec_common.cuh, shared with encode1.cu; so do the scan's state words
// and look_back, shared with stitch.cu.

#include <cuda_pipeline.h>

#include "codec_common.cuh"

namespace {

constexpr int ROW_WORDS = 56;
constexpr int ROW_PAD = 57;
constexpr int TILE = ENC_THREADS;
constexpr int ROWS_WORDS = TILE * ROW_PAD;  // >= 64 * 64: holds the matrix
constexpr size_t SHARED_BYTES = 4 * (64 * TILE + ROWS_WORDS);

template <bool FromZZ>
__global__ void __launch_bounds__(ENC_THREADS)
encode2_kernel(const void* __restrict__ x, const float* __restrict__ m,
               float off0, const uint32_t* dc, const uint32_t* ac,
               const uint32_t* zhi, const uint32_t* zlo,
               const int* __restrict__ dc_init, unsigned long long* scan,
               uint32_t* __restrict__ packed, int* __restrict__ meta, int n,
               int nb, int tiles_per_image, int aligned16) {
    extern __shared__ __align__(16) unsigned char shared_raw[];
    int* tile = reinterpret_cast<int*>(shared_raw);  // (64, TILE)
    uint32_t* rows = reinterpret_cast<uint32_t*>(tile + 64 * TILE);
    __shared__ Tables t;
    __shared__ int s_ticket, s_prev, s_tile_off;
    __shared__ int warp_sums[ENC_THREADS / 32];
    __shared__ int s_phase[TILE];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wid = tid >> 5;

    // scan[0]: the ticket, scan[1]: the overflow flag, scan[2 + g]: tile g
    if (tid == 0) s_ticket = (int)atomicAdd(scan, 1ull);
    load_tables(t, dc, ac, zhi, zlo);  // ends with __syncthreads()
    const int g = s_ticket;
    const int img = g / tiles_per_image;
    const int tt = g - img * tiles_per_image;
    const int b0 = img * nb + tt * TILE;  // the tile's first block
    const int live = min(TILE, nb - tt * TILE);

    // ---- the tile's coefficients into shared memory ---------------------
    if (FromZZ) {
        const int* zz = static_cast<const int*>(x);
        if (aligned16) {
            const int quads = live >> 2;  // live % 4 == 0 here
            for (int i = tid; i < 64 * quads; i += ENC_THREADS) {
                const int k = i / quads, q = i - k * quads;
                __pipeline_memcpy_async(tile + k * TILE + 4 * q,
                                        zz + (size_t)k * n + b0 + 4 * q, 16);
            }
        } else {
            for (int i = tid; i < 64 * live; i += ENC_THREADS) {
                const int k = i / live, c = i - k * live;
                __pipeline_memcpy_async(tile + k * TILE + c,
                                        zz + (size_t)k * n + b0 + c, 4);
            }
        }
        __pipeline_commit();
        // an image's first block: the predictor carried in, or zero
        if (tid == 0)
            s_prev = tt > 0 ? zz[b0 - 1] : dc_init ? dc_init[img] : 0;
        for (int i = tid; i < ROWS_WORDS; i += ENC_THREADS) rows[i] = 0u;
        __pipeline_wait_prior(0);
        __syncthreads();
    } else {
        const uint8_t* pix = static_cast<const uint8_t*>(x);
        float* sM = reinterpret_cast<float*>(rows);
        for (int i = tid; i < 64 * 64; i += ENC_THREADS) sM[i] = m[i];
        __syncthreads();
        if (tid < live)
            fast_transform_block(pix + (size_t)(b0 + tid) * 64, sM, off0,
                                 [&](int k, int v) { tile[k * TILE + tid] = v; });
        // the predictor of the tile's first block lies in another tile
        if (tid == ENC_THREADS - 1)
            s_prev = tt > 0 ? fast_transform_dc(pix + (size_t)(b0 - 1) * 64,
                                                sM, off0)
                   : dc_init ? dc_init[img] : 0;
        __syncthreads();
        for (int i = tid; i < ROWS_WORDS; i += ENC_THREADS) rows[i] = 0u;
        __syncthreads();
    }

    // ---- symbols, packed from bit 0 of the block's row ------------------
    int bits = 0;
    if (tid < live) {
        WordSink sink(rows + tid * ROW_PAD, 0);
        const TileCoef c{tile + tid, TILE, tid == 0 ? s_prev : tile[tid - 1]};
        if (encode_block(c, t, sink)) atomicOr(scan + 1, 1ull);
        sink.flush();  // <= 1662 bits: at most 52 words
        bits = sink.bits;
    }

    // ---- offsets inside the tile, the tile's own from the tiles before --
    int incl = bits;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sums[wid] = incl;
    __syncthreads();
    int before = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < ENC_THREADS / 32; ++w) {
        if (w < wid) before += warp_sums[w];
        sum += warp_sums[w];
    }
    if (wid == 0) {
        volatile unsigned long long* states = scan + 2;
        const unsigned long long start = tt == 0 ? ST_START : 0ull;
        int at = 0;  // tile 0 starts the stream
        if (g > 0) {
            if (lane == 0) states[g] = ST_SUM | start | (uint32_t)sum;
            at = look_back(states, g, lane);
            if (tt == 0) at = align8(at);
        }
        if (lane == 0) {
            states[g] = ST_END | start | (uint32_t)(at + sum);
            s_tile_off = at;
        }
    }
    __syncthreads();
    if (tid < live) {
        const int o = s_tile_off + before + incl - bits;
        meta[b0 + tid] = o;
        meta[n + b0 + tid] = bits;
        s_phase[tid] = o & 31;
    }
    __syncthreads();

    // ---- rows out, each shifted to its block's bit phase: 16 bytes a
    // store, 14 stores a row (a row is 224 bytes, so every piece is
    // aligned) -----------------------------------------------------------
    uint4* out = reinterpret_cast<uint4*>(packed + (size_t)b0 * ROW_WORDS);
    constexpr int QUADS = ROW_WORDS / 4;
    for (int i = tid; i < live * QUADS; i += ENC_THREADS) {
        const int r = i / QUADS;
        const int j = 4 * (i - r * QUADS);
        const uint32_t* row = rows + r * ROW_PAD + j;
        const int phase = s_phase[r];
        const uint32_t before = j > 0 ? row[-1] : 0u;
        const uint32_t w0 = row[0], w1 = row[1], w2 = row[2], w3 = row[3];
        // (previous : word) >> phase, low word; phase 0 gives the word
        out[i] = make_uint4(__funnelshift_r(w0, before, phase),
                            __funnelshift_r(w1, w0, phase),
                            __funnelshift_r(w2, w1, phase),
                            __funnelshift_r(w3, w2, phase));
    }
}

}  // namespace

// x: (n, 64) uint8 pixels (from_zz == 0) or (64, n) int32 coefficients
// (from_zz != 0).  m (64, 64) float32, off0: fast transform.  dc (12), ac
// (176), zhi (4), zlo (4): uint32 symbol tables.  dc_init: (n / nb) int32,
// the DC predictor of each image's first block, or null for zero (a
// range of one image's blocks carries its predecessor's last DC in).
// packed (n, 56) uint32;
// meta (2, n) int32 = [global bit offset; bit count]; scan (2 + tiles)
// uint64, zeroed by the caller before every call, tiles = (n / nb) *
// ceil(nb / 128): [0] ticket, [1] non-zero on return if a coefficient lay
// outside the tables, then one state word a tile.  n must be a multiple of
// nb.  One launch, on `stream`; returns the first non-zero CUDA error.
extern "C" int encode2_launch(const void* x, int from_zz, const void* m,
                              float off0, const void* dc, const void* ac,
                              const void* zhi, const void* zlo,
                              const void* dc_init, void* scan, void* packed,
                              void* meta, int n, int nb, void* stream) {
    if (n <= 0) return 0;
    const int tiles_per_image = (nb + TILE - 1) / TILE;
    const int grid = (n / nb) * tiles_per_image;
    // every row piece of the (64, n) matrix starts on 16 bytes
    const int aligned16 = from_zz && n % 4 == 0 && nb % 4 == 0 &&
                          reinterpret_cast<uintptr_t>(x) % 16 == 0;
    auto kernel = from_zz ? encode2_kernel<true> : encode2_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SHARED_BYTES);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, ENC_THREADS, SHARED_BYTES, (cudaStream_t)stream>>>(
        x, (const float*)m, off0, (const uint32_t*)dc, (const uint32_t*)ac,
        (const uint32_t*)zhi, (const uint32_t*)zlo, (const int*)dc_init,
        (unsigned long long*)scan, (uint32_t*)packed, (int*)meta, n, nb,
        tiles_per_image, aligned16);
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
