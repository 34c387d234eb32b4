// Stream assembly for Hopper: concatenate ragged per-block bit strings
// (each packed from bit 0 of its own 52-word row) into one stream, every
// image starting on a byte boundary.
//
// Replaces the sequential device bit writer of the JAX package
// (tinyimgcodec_tpu/ops/pallas_stitch.py, _make_kernel_windowed).  That
// kernel appends block after block through a 128-word rolling window with
// chunked flushes, in grid order, because a TPU cannot scatter.  Here the
// order is computed, not walked:
//   scan:    exclusive scan of the bit counts inside each image (one CTA
//            an image) and the image's bit sum
//   starts:  image starts, each rounded up to a byte (serial over B)
//   stitch:  one thread per (block, output word): the block's row funnel-
//            shifted by (offset & 31) gives at most 53 words, which are
//            ORed into the zeroed stream at word (offset >> 5) + j.
// Two neighbouring blocks share a word, and so do an image's last block
// and the pad bits before the next image; atomicOr into a zeroed stream
// makes those meetings safe in any order.  The scans are the device code
// of encode2.cu (codec_common.cuh).
//
// A target word at or beyond `cap` is dropped, never clamped onto earlier
// data; the caller learns of it from total_bits > cap * 32.
//
// Bound: bytes.  A thread reads row words only below the count its block
// owns, ceil(((offset & 31) + bits) / 32), so the bytes read follow the
// data (~3 words a block at quality 50) instead of the 208-byte row.

#include "codec_common.cuh"

namespace {

constexpr int ROW_WORDS = 52;
constexpr int OUT_WORDS = ROW_WORDS + 1;  // a shifted row can spill one word
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
stitch_kernel(const uint32_t* __restrict__ words,
              const int* __restrict__ bits, const int* __restrict__ local_off,
              const int* __restrict__ starts, uint32_t* __restrict__ stream,
              long long total, int nb, int cap) {
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= total) return;
    const int b = (int)(idx / OUT_WORDS);
    const int j = (int)(idx - (long long)b * OUT_WORDS);
    const int o = starts[b / nb] + local_off[b];
    const int sh = o & 31;
    const int owned = (sh + bits[b] + 31) >> 5;
    if (j >= owned) return;
    const uint32_t* row = words + (size_t)b * ROW_WORDS;
    const uint32_t cur = j < ROW_WORDS ? row[j] : 0u;
    const uint32_t prev = j > 0 ? row[j - 1] : 0u;
    // (prev : cur) >> sh, low word; sh == 0 gives cur
    const uint32_t w = __funnelshift_r(cur, prev, sh);
    if (w == 0u) return;
    const long long t = (long long)(o >> 5) + j;
    if (t < 0 || t >= cap) return;
    atomicOr(stream + t, w);
}

}  // namespace

// words (n, 52) uint32; bits (n) int32; local_off (n), img_bits (n / nb)
// int32 scratch; starts (n / nb + 1) int32 out (image starts, then the
// total bits); stream (cap) uint32, zeroed by the caller.  n must be a
// multiple of nb.  Launches on `stream_`; returns the first non-zero
// cudaGetLastError().
extern "C" int stitch_launch(const void* words, const void* bits,
                             void* local_off, void* img_bits, void* starts,
                             void* stream, int n, int nb, int cap,
                             void* stream_) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream_;
    const int nimg = n / nb;
    cudaError_t err;
    scan_images_kernel<<<nimg, SCAN_THREADS, 0, s>>>(
        (const int*)bits, (int*)local_off, (int*)img_bits, nb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    image_starts_kernel<<<1, 1, 0, s>>>((const int*)img_bits, (int*)starts,
                                        nimg);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long total = (long long)n * OUT_WORDS;
    const unsigned grid = (unsigned)((total + THREADS - 1) / THREADS);
    stitch_kernel<<<grid, THREADS, 0, s>>>(
        (const uint32_t*)words, (const int*)bits, (const int*)local_off,
        (const int*)starts, (uint32_t*)stream, total, nb, cap);
    return (int)cudaGetLastError();
}
