// Word placement for Hopper: every word of the stream is the OR of the
// pre-shifted row words of the few consecutive blocks that cover it.
//
// Replaces the three generations of placement kernel of the JAX package
// (tinyimgcodec_tpu/ops/pallas_place.py: _make_kernel_v4 matmul scatter,
// _make_kernel_v3 log masked-roll, _make_kernel delta chain), which are
// one function, assemble_cm.  Their rolls, groups and one-hot matmuls
// exist because a TPU has no scatter.  The function is not a scatter
// either: block offsets are monotone and blocks tile the stream without
// gaps (bar the <= 7 pad bits before an image start), so it is a gather
// over the output with plain stores.
//
// Bound: bytes (the words the blocks own and the meta in, the stream out).
// Design, one launch:
//   - the gather of gather.cuh: a CTA stages the offsets and ends of SPAN
//     consecutive blocks and stores every word it owns whole; a block's
//     word in the stream is its row word (word - (offset >> 5)), already
//     shifted to its bit phase, and blocks past the span's end (a word
//     shared with the next span) have their offsets read from device
//     memory.  6 blocks meet in a word with the standard tables, more with
//     shorter codes;
//   - the words from the stream's end to `cap` are stored as zero by all
//     CTAs together, 16 bytes a store;
//   - image starts, total bits and the overflow flag are written by the
//     same launch into one small tensor.
// A word at or beyond `cap` is never stored; the caller learns of it from
// total_bits > cap * 32, computed in 64 bits.
//
// Precondition (what encode2 produces): offsets ascend, a block's bits end
// before the next block begins, and a row is zero outside its block's bits.

#include "gather.cuh"

namespace {

constexpr int ROW_WORDS = 56;
constexpr int THREADS = 256;
constexpr int SPAN = 256;  // blocks a CTA stages

// The blocks of one span, as gather_span asks for them.
struct PlacedBlocks {
    const uint32_t* __restrict__ packed;
    const int* __restrict__ off;
    const uint32_t* s_off;
    int b0, live;
    __device__ __forceinline__ uint32_t offset(int i) const {
        return i <= live ? s_off[i] : (uint32_t)off[b0 + i];
    }
    __device__ __forceinline__ uint32_t word(int i, uint32_t o,
                                             uint32_t t) const {
        const uint32_t j = t - (o >> 5);  // rows come pre-shifted
        return j < ROW_WORDS ? packed[(size_t)(b0 + i) * ROW_WORDS + j] : 0u;
    }
};

__global__ void __launch_bounds__(THREADS)
place_kernel(const uint32_t* __restrict__ packed, const int* __restrict__ off,
             const int* __restrict__ bits, uint32_t* __restrict__ stream,
             int* __restrict__ summary, int n, int nb, uint32_t cap) {
    __shared__ uint32_t s_off[SPAN + 1];  // [live]: where the next span begins
    __shared__ uint32_t s_end[SPAN];
    const int tid = threadIdx.x;
    const int b0 = blockIdx.x * SPAN;
    const int live = min(SPAN, n - b0);
    const uint32_t total = (uint32_t)off[n - 1] + (uint32_t)bits[n - 1];
    for (int i = tid; i < live; i += THREADS) {
        const uint32_t o = (uint32_t)off[b0 + i];
        s_off[i] = o;
        s_end[i] = o + (uint32_t)bits[b0 + i];
    }
    if (tid == 0)
        s_off[live] = b0 + live < n ? (uint32_t)off[b0 + live] : total;
    __syncthreads();

    // ---- the span's words: one owner each, stored whole -----------------
    gather_span<THREADS>(stream, s_off, s_end, live, n - b0,
                         blockIdx.x == 0, cap,
                         PlacedBlocks{packed, off, s_off, b0, live});

    // ---- from the stream's end to the capacity: zeros --------------------
    const uint32_t used = min((total + 31u) >> 5, cap);
    if (used < cap)
        zero_words(stream, used, cap, blockIdx.x * THREADS + tid,
                   gridDim.x * THREADS);

    // ---- image starts, total bits, overflow ------------------------------
    if (summary != nullptr) {
        const int nimg = n / nb;
        for (int i = blockIdx.x * THREADS + tid; i < nimg;
             i += gridDim.x * THREADS)
            summary[i] = off[(size_t)i * nb];
        if (blockIdx.x == 0 && tid == 0) {
            summary[nimg] = (int)total;
            summary[nimg + 1] = (long long)(int)total > (long long)cap * 32;
        }
    }
}

}  // namespace

// packed (n, 56) uint32; off, bits (n) int32; stream (cap) uint32, every
// word of which is written; summary (n / nb + 2) int32 = [image starts,
// total bits, total bits > cap * 32] or null.  One launch, on `stream_`;
// returns cudaGetLastError().
extern "C" int place_launch(const void* packed, const void* off,
                            const void* bits, void* stream, void* summary,
                            int n, int nb, int cap, void* stream_) {
    if (n <= 0 || cap <= 0) return 0;
    const unsigned grid = (unsigned)((n + SPAN - 1) / SPAN);
    place_kernel<<<grid, THREADS, 0, (cudaStream_t)stream_>>>(
        (const uint32_t*)packed, (const int*)off, (const int*)bits,
        (uint32_t*)stream, (int*)summary, n, nb, (uint32_t)cap);
    return (int)cudaGetLastError();
}
