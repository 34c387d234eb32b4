// Stream assembly for Hopper: concatenate ragged per-block bit strings
// (each packed from bit 0 of its own 52-word row) into one stream, every
// image starting on a byte boundary.
//
// Replaces the sequential device bit writer of the JAX package
// (tinyimgcodec_tpu/ops/pallas_stitch.py, _make_kernel_windowed).  That
// kernel appends block after block through a 128-word rolling window with
// chunked flushes, in grid order, because a TPU cannot scatter.  Here the
// order is computed, not walked, and the stream is gathered, not
// scattered: block offsets are monotone and blocks tile the stream without
// gaps (bar the <= 7 pad bits before an image start), so every word of the
// stream is the OR of the funnel-shifted row words of the few consecutive
// blocks that cover it.
//
// Bound: bytes (the row words that hold bits and the counts in, the stream
// out).  Design, one launch after a zero fill of the scan's state:
//   - a CTA takes a span of SPAN consecutive blocks (spans may straddle
//     images) by an atomic ticket, one block a thread.  A CTA-wide scan of
//     what each block does to the running offset (align8 if it starts an
//     image, then + its bits: the Run family of codec_common.cuh) gives the
//     blocks' offsets inside the span; the span's starting offset comes
//     from the spans before it by look_back, the decoupled look-back that
//     encode2.cu runs across its tiles;
//   - the gather of gather.cuh: a CTA stores every word it owns whole;
//     a block's word in the stream is its row word shifted to the block's
//     bit phase (a funnel shift of two neighbouring row words).  Blocks
//     past the span's end (a word shared with the next span) get their
//     offsets from the owner itself, from its own end offset and their bit
//     counts, rounded up to a byte where one starts an image: the next
//     span has not published them yet.  16 blocks meet in a word with
//     2-bit blocks;
//   - the words from the stream's end to `cap` are zeroed by the CTAs that
//     can learn where the stream ends without waiting for a CTA that has
//     not started (all of them when the grid fits the card at once, the
//     last CTA always), in chunks taken from a second ticket, 16 bytes a
//     store;
//   - image starts, the total bits and the status (2 exactly when the
//     total exceeds cap * 32, compared in 64 bits) are written by the same
//     launch into one small tensor.
// A word at or beyond `cap` is never stored.
//
// Precondition (what encode1 produces): 0 <= bits <= 1664 and a row is
// zero past its block's bits (the plain version reads the same words, so
// the two agree on any row within the bound).

#include "codec_common.cuh"
#include "gather.cuh"

namespace {

constexpr int ROW_WORDS = 52;
constexpr int THREADS = 256;
constexpr int SPAN = THREADS;  // blocks a CTA takes, one a thread
constexpr int WARPS = THREADS / 32;
constexpr uint32_t CHUNK = 16 * THREADS;  // tail words a CTA zeroes a turn

// The blocks of one span, as gather_span asks for them: staged offsets
// and ends inside the span, the running offset walked on past it.
struct StitchedBlocks {
    const uint32_t* __restrict__ words;
    const int* __restrict__ bits;
    const uint32_t* s_off;
    const uint32_t* s_end;
    int b0, live, nb;
    uint32_t pos;  // the running offset past the span's end
    uint32_t len;  // the bits of the block offset() last gave
    __device__ __forceinline__ uint32_t offset(int i) {
        const int b = b0 + i;
        uint32_t o;
        if (i < live) {
            o = s_off[i];
            len = s_end[i] - o;
        } else {
            o = b % nb == 0 ? (uint32_t)align8((int)pos) : pos;
            len = (uint32_t)bits[b];
            pos = o + len;
        }
        return o;
    }
    __device__ __forceinline__ uint32_t word(int i, uint32_t o,
                                             uint32_t t) const {
        const uint32_t sh = o & 31u;
        const uint32_t j = t - (o >> 5);  // the word of the shifted row
        if (j >= ((sh + len + 31u) >> 5)) return 0u;  // not the block's
        const uint32_t* row = words + (size_t)(b0 + i) * ROW_WORDS;
        const uint32_t cur = j < ROW_WORDS ? row[j] : 0u;
        const uint32_t prev = j > 0 && j <= ROW_WORDS ? row[j - 1] : 0u;
        // (prev : cur) >> sh, low word; sh == 0 gives cur
        return __funnelshift_r(cur, prev, sh);
    }
};

__device__ __forceinline__ Run shfl_up_run(const Run& r, int d) {
    return Run{__shfl_up_sync(FULL, r.has, d), __shfl_up_sync(FULL, r.a1, d),
               __shfl_up_sync(FULL, r.a2, d)};
}

__global__ void __launch_bounds__(THREADS)
stitch_kernel(const uint32_t* __restrict__ words, const int* __restrict__ bits,
              unsigned long long* scan, uint32_t* __restrict__ stream,
              int* __restrict__ summary, int n, int nb, uint32_t cap) {
    __shared__ uint32_t s_off[SPAN + 1];  // [live]: where the next span begins
    __shared__ uint32_t s_end[SPAN];
    __shared__ Run s_warp[WARPS];
    __shared__ int s_ticket, s_go;
    __shared__ uint32_t s_at, s_span_end, s_total, s_chunk;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wid = tid >> 5;
    const int grid = (int)gridDim.x;
    // scan[0]: the span ticket, scan[1]: the tail's chunk ticket,
    // scan[2 + g]: span g's state word
    volatile unsigned long long* states = scan + 2;

    if (tid == 0) s_ticket = (int)atomicAdd(scan, 1ull);
    __syncthreads();
    const int g = s_ticket;
    const int b0 = g * SPAN;
    const int live = min(SPAN, n - b0);
    const int b = b0 + tid;

    // ---- offsets inside the span: a scan of Runs ------------------------
    const int nbits = tid < live ? bits[b] : 0;
    const bool starts = tid < live && b % nb == 0;
    const Run f = starts ? Run{1, 0, nbits} : Run{0, nbits, 0};
    Run incl = f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const Run o = shfl_up_run(incl, d);
        if (lane >= d) incl = then(o, incl);
    }
    if (lane == 31) s_warp[wid] = incl;
    Run excl = shfl_up_run(incl, 1);
    if (lane == 0) excl = Run{0, 0, 0};
    __syncthreads();
    Run before{0, 0, 0}, all{0, 0, 0};
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        if (w < wid) before = then(before, s_warp[w]);
        all = then(all, s_warp[w]);
    }
    excl = then(before, excl);

    // ---- the span's own offset from the spans before it -----------------
    if (wid == 0) {
        int at = 0;  // span 0 starts the stream
        if (g > 0) {
            if (lane == 0) states[g] = sum_state(all);
            at = look_back(states, g, lane);
        }
        if (lane == 0) {
            states[g] = ST_END | (uint32_t)all.apply(at);
            s_at = (uint32_t)at;
        }
    }
    __syncthreads();
    const int at = (int)s_at;
    const int nimg = n / nb;
    if (tid < live) {
        const int pos = excl.apply(at);  // the running offset before it
        const uint32_t o = (uint32_t)(starts ? align8(pos) : pos);
        s_off[tid] = o;
        s_end[tid] = o + (uint32_t)nbits;
        if (starts) summary[b / nb] = (int)o;
    }
    if (tid == 0) {
        const int end = all.apply(at);  // the running offset after the span
        const int nx = b0 + live;
        s_span_end = (uint32_t)end;
        s_off[live] = (uint32_t)(nx < n && nx % nb == 0 ? align8(end) : end);
        if (nx >= n) {  // the last span: the stream's end
            summary[nimg] = end;
            summary[nimg + 1] = (long long)end > (long long)cap * 32 ? 2 : 0;
        }
    }
    __syncthreads();

    // ---- the span's words: one owner each, stored whole -----------------
    gather_span<THREADS>(
        stream, s_off, s_end, live, n - b0, g == 0, cap,
        StitchedBlocks{words, bits, s_off, s_end, b0, live, nb, s_span_end,
                       0u});

    // ---- from the stream's end to the capacity: zeros --------------------
    // Waiting for the last span is safe once every span has its ticket:
    // the last one then runs, and it waits only for spans that published.
    if (tid == 0) {
        int go = 1;
        if (g == grid - 1) {
            s_total = s_span_end;
        } else if (*(volatile unsigned long long*)scan >= (unsigned)grid) {
            unsigned long long s;
            do {
                s = states[grid - 1];
            } while ((s >> 62) != 2);
            s_total = (uint32_t)s;
        } else {
            go = 0;  // the spans still to start zero the tail
        }
        s_go = go;
    }
    __syncthreads();
    if (!s_go) return;
    const uint32_t used = min((s_total + 31u) >> 5, cap);
    const uint32_t base = used & ~3u;  // chunks begin on 16 bytes
    for (;;) {
        if (tid == 0) s_chunk = (uint32_t)atomicAdd(scan + 1, 1ull);
        __syncthreads();
        const unsigned long long lo =
            base + (unsigned long long)s_chunk * CHUNK;
        __syncthreads();  // every thread has read s_chunk
        if (lo >= cap) return;
        zero_words(stream, max((uint32_t)lo, used),
                   (uint32_t)min(lo + CHUNK, (unsigned long long)cap),
                   threadIdx.x, THREADS);
    }
}

}  // namespace

// words (n, 52) uint32; bits (n) int32; scan (2 + ceil(n / 256)) uint64,
// zeroed by the caller before every call; stream (cap) uint32, every word
// of which is written; summary (n / nb + 2) int32 = [image starts, total
// bits, status 0 or 2].  n must be a multiple of nb.  One launch, on
// `stream_`; returns cudaGetLastError().
extern "C" int stitch_launch(const void* words, const void* bits, void* scan,
                             void* stream, void* summary, int n, int nb,
                             int cap, void* stream_) {
    if (n <= 0 || cap <= 0) return 0;
    const unsigned grid = (unsigned)((n + SPAN - 1) / SPAN);
    stitch_kernel<<<grid, THREADS, 0, (cudaStream_t)stream_>>>(
        (const uint32_t*)words, (const int*)bits, (unsigned long long*)scan,
        (uint32_t*)stream, (int*)summary, n, nb, (uint32_t)cap);
    return (int)cudaGetLastError();
}
