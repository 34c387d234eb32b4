// Stream assembly by gather, shared by place.cu and stitch.cu: every word
// of the stream is the OR of the bits of the few consecutive blocks that
// cover it.
//
// Block offsets ascend and blocks tile the stream without gaps (bar the
// <= 7 pad bits before an image start), so threads follow the output.  A
// CTA takes a span of consecutive blocks, stages their offsets and ends in
// shared memory, and owns the words whose first bit lies at or after its
// first block's offset and before the next span's (span 0 from word 0, the
// last span up to the stream's last word): every word has one owner, which
// stores it whole, so there are no atomics and the stream needs no zero
// fill first.  Words no block covers (the pad bits before an image start)
// come out zero.  The two kernels differ only in how a block's bits sit in
// its row and where the offsets of blocks past the span come from: that is
// the `Blocks` argument of gather_span, a template, so neither kernel
// branches on the other's case.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// stream[lo, hi) = 0, the thread `from` of `step` taking every step-th
// store: 16-byte stores between 4-byte edges
__device__ __forceinline__ void zero_words(uint32_t* stream, uint32_t lo,
                                           uint32_t hi, uint32_t from,
                                           uint32_t step) {
    uint32_t a = lo, b = lo;  // quads cover [a, b)
    if (reinterpret_cast<uintptr_t>(stream) % 16 == 0 && hi - lo >= 8) {
        a = (lo + 3u) & ~3u;
        b = hi & ~3u;
        uint4* q = reinterpret_cast<uint4*>(stream);
        for (uint32_t i = (a >> 2) + from; i < (b >> 2); i += step)
            q[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    for (uint32_t i = lo + from; i < a; i += step) stream[i] = 0u;
    for (uint32_t i = b + from; i < hi; i += step) stream[i] = 0u;
}

// The words a span owns, below `cap`.  s_off[0, live] holds the span's
// offsets and, at [live], where the next span begins (the stream's end
// after the last span); s_end[0, live) the ends.  A thread finds the first
// block whose end lies past its word's first bit by bisection in s_end and
// walks on while the next block begins inside the word, past the span's
// end too (a word shared with the next span), ORing each block's bits in
// the word.  How many blocks meet in a word is not built in.  `rest` is
// the number of blocks from the span's first to the last of all.
//
// `Blocks` is the caller's view of its blocks, copied for each word so
// that it may carry the walk's state:
//   uint32_t offset(int i)  the offset of the span's block i, asked in
//                           ascending i from the bisection's result on;
//   uint32_t word(int i, uint32_t o, uint32_t t)  block i's bits (at
//                           offset o) that fall in stream word t, in place.
template <int THREADS, class Blocks>
__device__ __forceinline__ void gather_span(
    uint32_t* __restrict__ stream, const uint32_t* s_off,
    const uint32_t* s_end, int live, int rest, bool first_span,
    uint32_t cap, const Blocks& blocks) {
    const uint32_t first = first_span ? 0u : (s_off[0] + 31u) >> 5;
    const uint32_t last = min((s_off[live] + 31u) >> 5, cap);
    for (uint32_t t = first + threadIdx.x; t < last; t += THREADS) {
        const uint32_t lo = t << 5;  // the word's first bit
        int l = 0, r = live;  // least i with s_end[i] > lo, or live
        while (l < r) {
            const int m = (l + r) >> 1;
            if (s_end[m] > lo) r = m; else l = m + 1;
        }
        Blocks walk = blocks;
        uint32_t acc = 0u;
        for (int i = l; i < rest; ++i) {
            const uint32_t o = walk.offset(i);
            if (o >= lo + 32u) break;  // begins after the word
            acc |= walk.word(i, o, t);
        }
        stream[t] = acc;
    }
}

}  // namespace
