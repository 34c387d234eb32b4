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
//   - threads follow the output.  A CTA takes a span of SPAN consecutive
//     blocks, stages their offsets and ends in shared memory, and owns the
//     words whose first bit lies at or after its first block's offset and
//     before the next span's (span 0 from word 0, the last span up to the
//     stream's last word): every word has one owner, which stores it whole,
//     so there are no atomics and the stream needs no zero fill first;
//   - a thread finds the first block whose end lies past its word's first
//     bit by bisection in the staged ends, and walks on while the next
//     block begins inside the word, ORing row word (word - (offset >> 5))
//     of each; blocks past the span's end (a word shared with the next
//     span) are read from device memory.  How many blocks meet in a word
//     is not built in: 6 with the standard tables, more with shorter codes;
//   - words no block covers (the pad bits before an image start) come out
//     zero, and the words from the stream's end to `cap` are stored as zero
//     by all CTAs together, 16 bytes a store;
//   - image starts, total bits and the overflow flag are written by the
//     same launch into one small tensor.
// A word at or beyond `cap` is never stored; the caller learns of it from
// total_bits > cap * 32, computed in 64 bits.
//
// Precondition (what encode2 produces): offsets ascend, a block's bits end
// before the next block begins, and a row is zero outside its block's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_WORDS = 56;
constexpr int THREADS = 256;
constexpr int SPAN = 256;  // blocks a CTA stages

// stream[lo, hi) = 0 by the whole grid: 16-byte stores between 4-byte edges
__device__ __forceinline__ void zero_words(uint32_t* stream, uint32_t lo,
                                           uint32_t hi) {
    const uint32_t step = gridDim.x * THREADS;
    const uint32_t gid = blockIdx.x * THREADS + threadIdx.x;
    uint32_t a = lo, b = lo;  // quads cover [a, b)
    if (reinterpret_cast<uintptr_t>(stream) % 16 == 0 && hi - lo >= 8) {
        a = (lo + 3u) & ~3u;
        b = hi & ~3u;
        uint4* q = reinterpret_cast<uint4*>(stream);
        for (uint32_t i = (a >> 2) + gid; i < (b >> 2); i += step)
            q[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    for (uint32_t i = lo + gid; i < a; i += step) stream[i] = 0u;
    for (uint32_t i = b + gid; i < hi; i += step) stream[i] = 0u;
}

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
    const uint32_t first = blockIdx.x == 0 ? 0u : (s_off[0] + 31u) >> 5;
    const uint32_t last = min((s_off[live] + 31u) >> 5, cap);
    for (uint32_t t = first + tid; t < last; t += THREADS) {
        const uint32_t lo = t << 5;  // the word's first bit
        int l = 0, r = live;  // least i with s_end[i] > lo, or live
        while (l < r) {
            const int m = (l + r) >> 1;
            if (s_end[m] > lo) r = m; else l = m + 1;
        }
        uint32_t acc = 0u;
        for (int b = b0 + l; b < n; ++b) {
            const int i = b - b0;
            const uint32_t o = i <= live ? s_off[i] : (uint32_t)off[b];
            if (o >= lo + 32u) break;  // begins after the word
            const uint32_t j = t - (o >> 5);
            if (j < ROW_WORDS) acc |= packed[(size_t)b * ROW_WORDS + j];
        }
        stream[t] = acc;
    }

    // ---- from the stream's end to the capacity: zeros --------------------
    const uint32_t used = min((total + 31u) >> 5, cap);
    if (used < cap) zero_words(stream, used, cap);

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
