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
// the textbook decoder, one lane per chunk:
//   window = 32 stream bits at the cursor
//   length = first l in 1..16 with (window >> (32 - l)) <= maxcode[l]
//   symbol = huffval[valptr[l] + code - mincode[l]]
//   value  = the next `size` bits, JPEG one's-complement sign extension
// with the canonical tables (mincode / maxcode / valptr / huffval for DC
// and AC) always passed as tensors, so standard and dynamic-table streams
// run the same kernel.
//
// Validation, as in the JAX package: a chunk is ok only if it decoded
// exactly its block count, every coefficient landed at a zig-zag position
// in [0, 63] of a block in [0, nb_total), every code matched the table,
// and its final cursor lies in [end_lo, end_hi].  A chunk stops at its
// first violation (it cannot become ok again), so garbage ends early.
// Reads beyond the word array return zero bits; nothing is written
// outside `zz`.  (The plain version also bounds a block's symbols by
// MAX_BLOCK_SYMBOLS = 68; every AC symbol but EOB moves the zig-zag
// position forward, so position > 63 always comes first and the kernel
// keeps no such count.)
//
// Bound: bytes on paper (the stream in, 256 B a block out), but what the
// kernel really waits for is the serial chain of each chunk: a batch has
// only as many independent chains as it has chunks (3136 for 49 images of
// 512x512; the longest has 761 symbols), a symbol cannot start before the
// one before it gave its length, and a warp that runs alone on its
// scheduler pays the full latency of every dependent instruction.  So the
// design makes the step short and keeps everything else off the chain:
//   - lookup, not search: a first-level table indexed by the window's
//     leading bits (built on the host from the canonical tables, an
//     argument) answers in one shared-memory read with a packed entry --
//     bits to advance, size of the value, zig-zag step, end of block --
//     so that DC and AC symbols run the same few instructions (a DC is an
//     AC with step 0 from the DC half of the table); a code longer than
//     the index goes on with the canonical search from that length, and a
//     window that matches nothing fails the chunk;
//   - the stream through shared memory: the CTA's chunks are neighbours
//     in the stream, so it copies one window of words, starting at its
//     first chunk, with 16-byte cp.async; a cursor reads a word inside
//     the window from shared memory and any other word from device
//     memory (chosen by the address alone, bounded as ever), and keeps
//     three words in registers so that the next word is on its way before
//     the cursor crosses into it;
//   - coefficients stored where they belong as they are decoded, 4 bytes
//     a store into a zz the caller zeroed: stores cost a lone warp nothing
//     but the slot they are sent in.  Building the row in shared memory
//     and writing it whole -- by the warp together behind a vote, or by
//     each lane for itself -- was measured and was slower, and zeroing the
//     rows in the kernel instead of before it was no faster (PERF.md):
//     a vote, a read-back of the row or sixteen more stores a block sit in
//     every lane's path, while the memset before the kernel runs at the
//     card's memory rate;
//   - no votes, no barriers and few branches in the loop: the lanes of a
//     warp share an instruction stream, so a warp is as slow as its
//     longest chunk and runs every lane's start-of-block code; with few
//     chunks a warp that costs little, and more warps run side by side on
//     the card's 528 schedulers.  The caller gives chunks a warp and warps
//     a CTA (ops/entropy_decode.py: 8 and 4, by measurement).
// What is left is the chain itself: about 59 instructions a symbol
// (cuobjdump -sass), most of them waiting for the one before.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TABLE_INTS = 3 * 17 + 256;  // one canonical table
constexpr int CANON_INTS = 616;           // two tables, padded to 16 bytes

// A first-level entry, and what the slow path packs for itself: bits 0..4
// the bits to advance (code + value; 0 = no code this short), 5..8 the
// value's size, 9..13 the zig-zag step (0 for a DC and for EOB), 14 EOB.
constexpr int E_EOB = 1 << 14;
__device__ __forceinline__ int pack_entry(int len, int sym, bool dc) {
    if (dc) {
        const int size = sym > 15 ? 15 : sym;  // symbols are bytes, >= 0
        return (len + size) | (size << 5);
    }
    const int size = sym & 15;
    if (sym == 0) return len | E_EOB;
    return (len + size) | (size << 5) | ((((sym >> 4) & 15) + 1) << 9);
}

// Where a stream word comes from: word lo4 + j lies at stage[j] for j in
// [0, stage_words) (zero where that is outside the stream); everything
// else is device memory, and zero outside [0, nwords).
struct Stream {
    const uint32_t* words;
    const uint32_t* stage;
    uint32_t nwords, lo4, stage_words;
    __device__ __forceinline__ uint32_t word(uint32_t i) const {
        const uint32_t j = i - lo4;  // wraps for a word before the window
        if (j < stage_words) return stage[j];
        return i < nwords ? words[i] : 0u;
    }
};

// A code longer than the first-level index: the canonical search from
// length `from` on.  Returns the packed entry, 0 if no code matches.
__device__ __noinline__ int search_long(uint32_t win, const int* t, int from,
                                        bool dc) {
    const int c16 = (int)(win >> 16);
    for (int l = from; l <= 16; ++l) {
        const int code = c16 >> (16 - l);
        if (code <= t[17 + l]) {
            int idx = t[34 + l] + code - t[l];
            idx = idx < 0 ? 0 : (idx > 255 ? 255 : idx);
            return pack_entry(l, t[51 + idx], dc);
        }
    }
    return 0;
}

__global__ void entropy_decode_kernel(
    const uint32_t* __restrict__ words, uint32_t nwords,
    const int* __restrict__ chunk_start, const int* __restrict__ chunk_blocks,
    const int* __restrict__ chunk_block_base,
    const int* __restrict__ chunk_end_lo, const int* __restrict__ chunk_end_hi,
    const int* __restrict__ tables, const int* __restrict__ lookup,
    int lookup_bits, int* __restrict__ zz, uint8_t* __restrict__ ok,
    int nchunks, int nb_total, int cpw, int stage_words) {
    extern __shared__ __align__(16) uint32_t smem[];
    uint32_t* stage = smem;
    int* canon = reinterpret_cast<int*>(stage + stage_words);
    int* lut = canon + CANON_INTS;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int cta_first = blockIdx.x * nwarps * cpw;

    // ---- the CTA's window of the stream, 16 bytes a copy ----------------
    long long lo4;
    {
        long long lo = (long long)chunk_start[cta_first] >> 5;
        lo = lo < 0 ? 0 : (lo > nwords ? nwords : lo);
        // words + lo4 is 16-byte aligned whatever the tensor's own offset
        const int mis = (int)((reinterpret_cast<uintptr_t>(words) >> 2) & 3);
        lo4 = ((lo + mis) & ~3LL) - mis;  // >= -3
    }
    for (int g = threadIdx.x * 4; g < stage_words; g += blockDim.x * 4) {
        const long long i = lo4 + g;
        if (i >= 0 && i + 4 <= (long long)nwords) {
            __pipeline_memcpy_async(stage + g, words + i, 16);
        } else {
            for (int j = 0; j < 4; ++j)
                stage[g + j] = (i + j >= 0 && i + j < (long long)nwords)
                                   ? words[i + j] : 0u;
        }
    }
    __pipeline_commit();
    for (int i = threadIdx.x; i < 2 * TABLE_INTS; i += blockDim.x)
        canon[i] = tables[i];
    for (int i = threadIdx.x; i < (2 << lookup_bits); i += blockDim.x)
        lut[i] = lookup[i];
    __pipeline_wait_prior(0);
    __syncthreads();

    // ---- one lane per chunk ----------------------------------------------
    const int c = cta_first + warp * cpw + lane;
    if (lane >= cpw || c >= nchunks) return;
    const Stream st{words, stage, nwords, (uint32_t)lo4,
                    (uint32_t)stage_words};
    const int start = chunk_start[c];
    const int nblk = chunk_blocks[c];
    const int base = chunk_block_base[c];
    // blocks this chunk may write: i < limit keeps base + i in [0, nb_total)
    int limit = 0;
    if (base >= 0 && base < nb_total)
        limit = nblk < nb_total - base ? nblk : nb_total - base;
    uint32_t wi = 0;
    int bit = 0;
    // a chunk with no blocks is good where it stands; one whose first block
    // lies outside zz fails before any read
    bool good = start >= 0 && (nblk <= 0 || limit > 0);
    if (start >= 0) {
        wi = (uint32_t)start >> 5;
        bit = start & 31;
    }
    if (good && nblk > 0) {
        uint32_t w0 = st.word(wi), w1 = st.word(wi + 1), nxt = st.word(wi + 2);
        const int shift = 32 - lookup_bits;
        const int ac_half = 1 << lookup_bits;
        int half = 0;  // the DC half of the table; ac_half after a DC
        int p = 0;
        int* dst = zz + (size_t)base * 64;
        bool run = true;
        int i = 1;  // blocks this chunk has begun
        // One symbol a turn.  The turn is written without branches but for
        // one test of what is rare (a long code, a word outside the staged
        // window), the end of a block and the loop itself: a lone warp
        // waits out every branch that hangs on fresh data.
        do {
            const uint32_t win = __funnelshift_l(w1, w0, (unsigned)bit);
            int e = lut[half + (int)(win >> shift)];
            // the word after the next one, asked for before it is needed
            const uint32_t j = wi + 3 - st.lo4;
            uint32_t ahead = stage[j < st.stage_words ? j : 0u];
            if ((e & 31) == 0 || j >= st.stage_words) {
                if (j >= st.stage_words)
                    ahead = wi + 3 < nwords ? words[wi + 3] : 0u;
                if ((e & 31) == 0)
                    e = search_long(win, canon + (half ? TABLE_INTS : 0),
                                    lookup_bits + 1, half == 0);
                if (e == 0) {  // no code of the table matches
                    good = false;
                    break;
                }
            }
            const int adv = e & 31;
            const int size = (e >> 5) & 15;
            // the value: the low `size` of the `adv` bits at the window's head
            const int mag = (int)((win >> (32 - adv)) & ((1u << size) - 1u));
            const int value =
                (size && mag < (1 << (size - 1))) ? mag - (1 << size) + 1 : mag;
            bit += adv;  // at most 31 + 31
            const bool cross = bit >= 32;
            bit &= 31;
            wi += cross;
            w0 = cross ? w1 : w0;
            w1 = cross ? nxt : w1;
            nxt = cross ? ahead : nxt;
            if (e & E_EOB) {
                if (i >= limit) {  // done, or the next block lies outside zz
                    good = i >= nblk;
                    run = false;
                } else {
                    ++i;
                    dst += 64;
                    p = 0;
                    half = 0;
                }
            } else {
                p += (e >> 9) & 31;  // 0 for a DC; ZRL: 16 with size 0
                if (p <= 63) dst[p] = value;
                half = ac_half;
                if (p > 63) {
                    good = false;
                    run = false;
                }
            }
        } while (run);
    }
    const long long pos = ((long long)wi << 5) + bit;
    ok[c] = good && pos >= chunk_end_lo[c] && pos <= chunk_end_hi[c];
}

}  // namespace

// words (nwords < 2**31) uint32 big-endian payload words; chunk_* (nchunks)
// int32; tables (2, 307) int32 = [mincode 17, maxcode 17, valptr 17,
// huffval 256] for DC then AC; lookup (2, 1 << lookup_bits) int32
// first-level entries in the packed form of pack_entry (bits to advance,
// value size, zig-zag step, end of block), 0 = no code of at most
// lookup_bits bits; zz (nb_total, 64) int32, zeroed by the caller: only
// decoded coefficients are written; ok (nchunks) bytes, 0 or 1.
// chunks_per_warp in 1..32, warps a CTA; stage_words: size of the CTA's
// stream window, a multiple of 4.  Launches on `stream`, returns the first
// non-zero CUDA error.
extern "C" int entropy_decode_launch(
    const void* words, unsigned nwords, const void* chunk_start,
    const void* chunk_blocks, const void* chunk_block_base,
    const void* chunk_end_lo, const void* chunk_end_hi, const void* tables,
    const void* lookup, int lookup_bits, void* zz, void* ok, int nchunks,
    int nb_total, int chunks_per_warp, int warps, int stage_words,
    void* stream) {
    if (nchunks <= 0) return 0;
    if (chunks_per_warp < 1 || chunks_per_warp > 32 || warps < 1 ||
        warps > 32 || stage_words < 0 || stage_words % 4 || lookup_bits < 1 ||
        lookup_bits > 12)
        return (int)cudaErrorInvalidValue;
    const int per_cta = warps * chunks_per_warp;
    const int grid = (nchunks + per_cta - 1) / per_cta;
    const size_t shared =
        4 * ((size_t)stage_words + CANON_INTS + (2 << lookup_bits));
    cudaError_t err = cudaFuncSetAttribute(
        entropy_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (err != cudaSuccess) return (int)err;
    entropy_decode_kernel<<<grid, warps * 32, shared, (cudaStream_t)stream>>>(
        (const uint32_t*)words, nwords, (const int*)chunk_start,
        (const int*)chunk_blocks, (const int*)chunk_block_base,
        (const int*)chunk_end_lo, (const int*)chunk_end_hi,
        (const int*)tables, (const int*)lookup, lookup_bits, (int*)zz,
        (uint8_t*)ok, nchunks, nb_total, chunks_per_warp, stage_words);
    return (int)cudaGetLastError();
}
