// Chunk-parallel Huffman entropy decode for Hopper: the payload words of a
// batch of TICX-indexed streams -> zig-zag coefficient rows (nb_total, 64)
// with the DPCM'd DC in column 0, and one validity flag per chunk.
//
// No TPU kernel stands behind this one: in the JAX package the function
// (tinyimgcodec_tpu/ops/entropy_decode.py, entropy_decode_chunks) is an
// XLA program -- lockstep chain steps over all chunks with 64K-entry
// window tables, record buffers sized by slot budgets, resume passes and a
// one-hot matmul to put coefficients in place -- all of it there because
// that machine has no cheap per-lane gather or scatter and no independent
// threads.  A CUDA thread has its own bit cursor, so here the function is
// the textbook decoder, one thread per chunk:
//   window = 32 stream bits at the cursor (two words, funnel-shifted)
//   length = first l in 1..16 with (window >> (32 - l)) <= maxcode[l]
//   symbol = huffval[valptr[l] + code - mincode[l]]
//   value  = the next `size` bits, JPEG one's-complement sign extension
// with the canonical tables (mincode / maxcode / valptr / huffval for DC
// and AC) always passed as a tensor and staged in shared memory, so
// standard and dynamic-table streams run the same kernel.
//
// Validation, as in the JAX package: a chunk is ok only if it decoded
// exactly its block count, every coefficient landed at a zig-zag position
// in [0, 63] of a block in [0, nb_total), every code matched the table,
// and its final cursor lies in [end_lo, end_hi].  A chunk stops at its
// first violation (it cannot become ok again), so garbage ends early; a
// block takes at most MAX_BLOCK_SYMBOLS symbols.  Reads beyond the word
// array return zero bits; nothing is written outside `zz`.
//
// Bound: bytes (the stream in, 256 B a block out).  Design: correctness
// first -- one thread per chunk, 32 threads a CTA so that the ~3000 chunks
// of a batch spread over all SMs.  The cursor's two words stay in
// registers and are reloaded only when the cursor crosses a word.  Loads
// and stores of a warp are scattered (each thread walks its own part of
// the stream and writes its own rows); a warp per chunk with shared-memory
// staging is left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;
constexpr int MAX_BLOCK_SYMBOLS = 68;  // 1 DC + 63 AC + <= 3 ZRL + EOB
constexpr int TABLE_INTS = 3 * 17 + 256;

struct DecodeTable {
    int mincode[17];
    int maxcode[17];
    int valptr[17];
    int huffval[256];
};

struct Cursor {
    const uint32_t* words;
    long long nwords;
    long long pos;
    long long wi = -2;
    uint32_t w0 = 0, w1 = 0;

    __device__ __forceinline__ uint32_t word(long long i) const {
        return (i >= 0 && i < nwords) ? words[i] : 0u;
    }
    // the 32 stream bits that start at the cursor
    __device__ __forceinline__ uint32_t window() {
        const long long i = pos >> 5;
        if (i != wi) {
            w0 = (i == wi + 1) ? w1 : word(i);
            w1 = word(i + 1);
            wi = i;
        }
        return __funnelshift_l(w1, w0, (unsigned)(pos & 31));
    }
};

// One symbol at the head of `win`: code length (0 = no code of the table
// matches) and the table's symbol value.
__device__ __forceinline__ int decode_symbol(uint32_t win,
                                             const DecodeTable& t, int& sym) {
    const int c16 = (int)(win >> 16);
    for (int l = 1; l <= 16; ++l) {
        const int code = c16 >> (16 - l);
        if (code <= t.maxcode[l]) {
            int idx = t.valptr[l] + code - t.mincode[l];
            idx = idx < 0 ? 0 : (idx > 255 ? 255 : idx);
            sym = t.huffval[idx];
            return l;
        }
    }
    return 0;
}

// `size` (0..15) magnitude bits that follow a code of `len` (1..16) bits
__device__ __forceinline__ int read_value(uint32_t win, int len, int size) {
    if (size == 0) return 0;
    const int mag = (int)((win << len) >> (32 - size));
    return mag < (1 << (size - 1)) ? mag - (1 << size) + 1 : mag;
}

__global__ void __launch_bounds__(THREADS)
entropy_decode_kernel(const uint32_t* __restrict__ words, long long nwords,
                      const int* __restrict__ chunk_start,
                      const int* __restrict__ chunk_blocks,
                      const int* __restrict__ chunk_block_base,
                      const int* __restrict__ chunk_end_lo,
                      const int* __restrict__ chunk_end_hi,
                      const int* __restrict__ tables, int* __restrict__ zz,
                      uint8_t* __restrict__ ok, int nchunks, int nb_total) {
    __shared__ DecodeTable tab[2];  // DC, AC
    int* flat = reinterpret_cast<int*>(tab);
    for (int i = threadIdx.x; i < 2 * TABLE_INTS; i += THREADS)
        flat[i] = tables[i];
    __syncthreads();
    const int c = blockIdx.x * THREADS + threadIdx.x;
    if (c >= nchunks) return;

    Cursor cur{words, nwords, (long long)chunk_start[c]};
    const int nblk = chunk_blocks[c];
    const int base = chunk_block_base[c];
    bool good = cur.pos >= 0;
    for (int i = 0; good && i < nblk; ++i) {
        const long long blk = (long long)base + i;
        if (blk < 0 || blk >= nb_total) {
            good = false;
            break;
        }
        int* row = zz + blk * 64;
        int sym;
        uint32_t win = cur.window();
        int len = decode_symbol(win, tab[0], sym);
        if (len == 0) {
            good = false;
            break;
        }
        int size = sym < 0 ? 0 : (sym > 15 ? 15 : sym);
        row[0] = read_value(win, len, size);
        cur.pos += len + size;
        int p = 0;
        bool eob = false;
        for (int s = 1; s < MAX_BLOCK_SYMBOLS; ++s) {
            win = cur.window();
            len = decode_symbol(win, tab[1], sym);
            if (len == 0) break;
            size = sym & 15;
            cur.pos += len + size;
            if (sym == 0) {
                eob = true;
                break;
            }
            p += ((sym >> 4) & 15) + 1;  // ZRL: run 15, size 0
            if (p > 63) break;
            row[p] = read_value(win, len, size);
        }
        good = eob;
    }
    ok[c] = good && cur.pos >= chunk_end_lo[c] && cur.pos <= chunk_end_hi[c];
}

}  // namespace

// words (nwords) uint32 big-endian payload words; chunk_* (nchunks) int32;
// tables (2, 307) int32 = [mincode 17, maxcode 17, valptr 17, huffval 256]
// for DC then AC; zz (nb_total, 64) int32, zeroed by the caller; ok
// (nchunks) uint8.  Launches on `stream`, returns cudaGetLastError().
extern "C" int entropy_decode_launch(const void* words, long long nwords,
                                     const void* chunk_start,
                                     const void* chunk_blocks,
                                     const void* chunk_block_base,
                                     const void* chunk_end_lo,
                                     const void* chunk_end_hi,
                                     const void* tables, void* zz, void* ok,
                                     int nchunks, int nb_total,
                                     void* stream) {
    if (nchunks <= 0) return 0;
    const int grid = (nchunks + THREADS - 1) / THREADS;
    entropy_decode_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, nwords, (const int*)chunk_start,
        (const int*)chunk_blocks, (const int*)chunk_block_base,
        (const int*)chunk_end_lo, (const int*)chunk_end_hi,
        (const int*)tables, (int*)zz, (uint8_t*)ok, nchunks, nb_total);
    return (int)cudaGetLastError();
}
