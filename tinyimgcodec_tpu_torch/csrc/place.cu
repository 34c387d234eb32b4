// Word placement for Hopper: OR every block's pre-shifted stream words
// into one zeroed stream at word (bit_offset >> 5) + j.
//
// Replaces the three generations of placement kernel of the JAX package
// (tinyimgcodec_tpu/ops/pallas_place.py: _make_kernel_v4 matmul scatter,
// _make_kernel_v3 log masked-roll, _make_kernel delta chain), which are
// one function, assemble_cm.  Their rolls, groups and one-hot matmuls
// exist because a TPU has no scatter; this card has atomics, so the
// function is a scatter.
//
// Bound: bytes.  Blocks' bits never overlap, so OR == ADD and only the
// first and last word of a block can meet a neighbour's; atomicOr makes
// those meetings safe in any order and the result is deterministic.  A
// block at offset o with c bits owns ceil(((o & 31) + c) / 32) words (the
// encode kernel leaves the rest of its 56-word row zero), so a thread
// reads a row word only below that count: the bytes read follow the data
// (~6 words a block at quality 50) instead of the 224-byte row.
//
// A target word at or beyond `cap` is dropped, never clamped onto earlier
// data; the caller learns of it from total_bits > cap * 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_WORDS = 56;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
place_kernel(const uint32_t* __restrict__ packed, const int* __restrict__ off,
             const int* __restrict__ bits, uint32_t* __restrict__ stream,
             long long total, int cap) {
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= total) return;
    const int b = (int)(idx / ROW_WORDS);
    const int j = (int)(idx - (long long)b * ROW_WORDS);
    const int o = off[b];
    const int nwords = ((o & 31) + bits[b] + 31) >> 5;
    if (j >= nwords) return;
    const uint32_t w = packed[idx];
    if (w == 0u) return;
    const long long t = (long long)(o >> 5) + j;
    if (t < 0 || t >= cap) return;
    atomicOr(stream + t, w);
}

}  // namespace

// packed (n, 56) uint32; off, bits (n) int32; stream (cap) uint32, zeroed
// by the caller.  Launches on `stream_`, returns cudaGetLastError().
extern "C" int place_launch(const void* packed, const void* off,
                            const void* bits, void* stream, int n, int cap,
                            void* stream_) {
    if (n <= 0) return 0;
    const long long total = (long long)n * ROW_WORDS;
    const unsigned grid = (unsigned)((total + THREADS - 1) / THREADS);
    place_kernel<<<grid, THREADS, 0, (cudaStream_t)stream_>>>(
        (const uint32_t*)packed, (const int*)off, (const int*)bits,
        (uint32_t*)stream, total, cap);
    return (int)cudaGetLastError();
}
