// Device code shared by the encode kernels (encode2.cu, encode1.cu) and
// the stream assembly (stitch.cu): the Huffman symbol tables in shared
// memory, the per-block symbolizer and its bit sink, the float32 fast
// transform, and the single-pass scan of the running stream offset that
// encode2.cu and stitch.cu run across their CTAs.
//
// Both encode paths include the *same* transform and the *same*
// symbolizer from here, so their fast-mode bytes are equal by
// construction, not by two implementations agreeing.  The symbolizer is a
// template over where a coefficient comes from; both kernels give it a
// column of a tile they staged in shared memory (TileCoef).  The transform
// is a device function over where a coefficient goes: both kernels store
// into that tile, fast_transform_kernel (the transform alone, for
// measurements and tests) to device memory.
//
// The fast transform is float32 and order-dependent: each coefficient is
// the sum over pixels p = 0..63 in ascending order of x[p] * M[p][k], one
// rounding after every multiply and every add (compiled with -fmad=false),
// then DC - offset, then rintf (half to even).  What bounds it is the
// operation count: 2 x 64 x 64 separate multiplies and adds a block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ENC_THREADS = 128;
constexpr int ZRL_INDEX = 15 * 11;  // AC table entry of (run 15, size 0)

struct Tables {
    uint32_t dc[12];
    uint32_t ac[176];
    uint32_t zhi[4];
    uint32_t zlo[4];
};

__device__ __forceinline__ void load_tables(Tables& t, const uint32_t* dc,
                                            const uint32_t* ac,
                                            const uint32_t* zhi,
                                            const uint32_t* zlo) {
    for (int i = threadIdx.x; i < 176; i += blockDim.x) t.ac[i] = ac[i];
    if (threadIdx.x < 12) t.dc[threadIdx.x] = dc[threadIdx.x];
    if (threadIdx.x < 4) {
        t.zhi[threadIdx.x] = zhi[threadIdx.x];
        t.zlo[threadIdx.x] = zlo[threadIdx.x];
    }
    __syncthreads();
}

// Big-endian bit writer into a row of 32-bit words.  `nbits` < 32 holds
// between calls; a put appends at most 32 bits, so one word at most
// becomes complete per call and every shift stays below 64.
struct WordSink {
    uint32_t* row;
    unsigned long long acc = 0;
    int nbits;
    int w = 0;
    int bits = 0;
    __device__ __forceinline__ WordSink(uint32_t* r, int phase)
        : row(r), nbits(phase) {}
    __device__ __forceinline__ void put(uint32_t v, int len) {
        acc = (acc << len) | v;
        nbits += len;
        bits += len;
        if (nbits >= 32) {
            row[w++] = (uint32_t)(acc >> (nbits - 32));
            nbits -= 32;
        }
    }
    __device__ __forceinline__ void flush() {
        if (nbits > 0) row[w++] = (uint32_t)(acc << (32 - nbits));
    }
};

__device__ __forceinline__ int category(int v) {
    const uint32_t a = v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
    return 32 - __clz((int)a);
}

// JPEG magnitude bits: v >= 0 -> v, v < 0 -> v - 1, low `size` bits
__device__ __forceinline__ uint32_t magnitude(int v, int size) {
    return ((uint32_t)v - (v < 0 ? 1u : 0u)) & ((1u << size) - 1u);
}

// Where the symbolizer reads a block's coefficients: a (64, stride) tile
// in shared memory, one column a block (a lane reads its own column: no
// bank conflict); the caller knows the predictor, the left neighbour's DC
// or zero at an image's first block.
struct TileCoef {
    const int* col;
    int stride, prev;
    __device__ __forceinline__ int operator()(int k) const {
        return col[k * stride];
    }
    __device__ __forceinline__ int prev_dc() const { return prev; }
};

// Symbols of one block into `sink`; returns 1 if a coefficient lies outside
// the tables' range (DC category > 11 or AC size > 10; it is then clamped).
template <class Sink, class Coef>
__device__ __forceinline__ int encode_block(const Coef& c, const Tables& t,
                                            Sink& sink) {
    int over = 0;
    const int diff = (int)((uint32_t)c(0) - (uint32_t)c.prev_dc());
    int cat = category(diff);
    if (cat > 11) {
        over = 1;
        cat = 11;
    }
    uint32_t comb = t.dc[cat];
    sink.put(((comb >> 8) << cat) | magnitude(diff, cat),
             (int)(comb & 0xFFu) + cat);

    const int zrl_len = (int)(t.ac[ZRL_INDEX] & 0xFFu);
    // Which AC coefficients are nonzero: 63 loads that do not wait for one
    // another and no branch; then one turn for each nonzero coefficient
    // (about five a block at quality 50) instead of one for each of the 63.
    unsigned long long nonzero = 0ull;
#pragma unroll
    for (int k = 1; k < 64; ++k)
        nonzero |= (unsigned long long)(c(k) != 0) << k;
    int last = 0;  // position of the nonzero coefficient before this one
    while (nonzero) {
        const int k = __ffsll((long long)nonzero) - 1;
        nonzero &= nonzero - 1;
        const int v = c(k);
        const int run = k - last - 1;
        last = k;
        int size = category(v);
        if (size > 10) {
            over = 1;
            size = 10;
        }
        const int z = run >> 4;  // <= 3 since run <= 62
        if (z) {
            // z-fold ZRL prefix, left-aligned in (zhi, zlo)
            const int zl = z * zrl_len;
            const int first = zl < 32 ? zl : 32;
            sink.put(t.zhi[z] >> (32 - first), first);
            if (zl > 32) sink.put(t.zlo[z] >> (64 - zl), zl - 32);
        }
        comb = t.ac[(run & 15) * 11 + size];
        sink.put(((comb >> 8) << size) | magnitude(v, size),
                 (int)(comb & 0xFFu) + size);
    }
    comb = t.ac[0];  // EOB, always emitted
    sink.put(comb >> 8, (int)(comb & 0xFFu));
    return over;
}

// ---- fast transform of one block ----------------------------------------
// 64 pixels at `pix` (16-byte aligned), the fused matrix sM[pixel][coeff]
// in shared memory; store(k, value) receives the 64 rounded coefficients.
template <class Store>
__device__ __forceinline__ void fast_transform_block(
    const uint8_t* __restrict__ pix, const float* sM, float off0,
    Store store) {
    float x[64];
    const uint4* p = reinterpret_cast<const uint4*>(pix);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint4 q = p[i];
        const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 16; ++j)
            x[16 * i + j] = (float)((w[j >> 2] >> ((j & 3) * 8)) & 0xFFu);
    }
    for (int kc = 0; kc < 8; ++kc) {
        float acc[8];
        {
            const float4 a = *reinterpret_cast<const float4*>(&sM[kc * 8]);
            const float4 c = *reinterpret_cast<const float4*>(&sM[kc * 8 + 4]);
            acc[0] = x[0] * a.x; acc[1] = x[0] * a.y;
            acc[2] = x[0] * a.z; acc[3] = x[0] * a.w;
            acc[4] = x[0] * c.x; acc[5] = x[0] * c.y;
            acc[6] = x[0] * c.z; acc[7] = x[0] * c.w;
        }
#pragma unroll
        for (int q = 1; q < 64; ++q) {
            const float4 a =
                *reinterpret_cast<const float4*>(&sM[q * 64 + kc * 8]);
            const float4 c =
                *reinterpret_cast<const float4*>(&sM[q * 64 + kc * 8 + 4]);
            acc[0] = acc[0] + x[q] * a.x; acc[1] = acc[1] + x[q] * a.y;
            acc[2] = acc[2] + x[q] * a.z; acc[3] = acc[3] + x[q] * a.w;
            acc[4] = acc[4] + x[q] * c.x; acc[5] = acc[5] + x[q] * c.y;
            acc[6] = acc[6] + x[q] * c.z; acc[7] = acc[7] + x[q] * c.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int k = kc * 8 + i;
            const float v = (k == 0) ? acc[i] - off0 : acc[i];
            store(k, (int)rintf(v));
        }
    }
}

// The DC coefficient alone, in the arithmetic of fast_transform_block.
__device__ __forceinline__ int fast_transform_dc(
    const uint8_t* __restrict__ pix, const float* sM, float off0) {
    float acc = (float)pix[0] * sM[0];
    for (int q = 1; q < 64; ++q) acc = acc + (float)pix[q] * sM[q * 64];
    return (int)rintf(acc - off0);
}

// ---- fast transform: (N, 64) uint8 pixels -> (64, N) int32 zig-zag -----
__global__ void __launch_bounds__(ENC_THREADS)
fast_transform_kernel(const uint8_t* __restrict__ pix,
                      const float* __restrict__ m, float off0,
                      int* __restrict__ zz, int n) {
    __shared__ __align__(16) float sM[64 * 64];
    for (int i = threadIdx.x; i < 64 * 64; i += ENC_THREADS) sM[i] = m[i];
    __syncthreads();
    const int b = blockIdx.x * ENC_THREADS + threadIdx.x;
    if (b >= n) return;
    fast_transform_block(pix + (size_t)b * 64, sM, off0, [&](int k, int v) {
        zz[(size_t)k * n + b] = v;
    });
}

// ---- the running stream offset across CTAs (encode2.cu, stitch.cu) -----
// A single-pass scan: every CTA publishes one 64-bit state word -- first
// what its run of blocks does to the running offset, then, once known, the
// offset at its end -- and looks back over its predecessors' words, 32 at a
// time with a warp, until it meets one that already knows its end.  CTAs
// take their index from an atomic ticket, so a CTA only ever waits for CTAs
// that already run; the word carries state and value together, so one
// store publishes both; the words are zeroed by the caller before every
// launch.  The sums are integers: the result does not depend on who
// resolves first.
//
// Image starts are rounded up to a byte, so what a run of blocks does to a
// running offset s is s + a1 or, when it holds an image start,
// align8(s + a1) + a2; that family is closed under composition (Run,
// then).  A state word: bits 0..31 a2 if the run holds an image start,
// else a1 (ST_SUM), or the offset at the run's end (ST_END); bit 32 the
// run holds an image start; bits 33..61 a1 of a run that holds one;
// bits 62..63 the status.
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long ST_SUM = 1ull << 62;  // value = the run's Run
constexpr unsigned long long ST_END = 2ull << 62;  // value = offset at end
constexpr unsigned long long ST_START = 1ull << 32;
constexpr unsigned long long A1_MASK = (1ull << 29) - 1;

__device__ __forceinline__ int align8(int s) { return (s + 7) & ~7; }

// What a run of blocks does to the running offset s:
// has ? align8(s + a1) + a2 : s + a1.
struct Run {
    int has, a1, a2;
    __device__ __forceinline__ int apply(int s) const {
        return has ? align8(s + a1) + a2 : s + a1;
    }
};

// `older` first, then `newer`.  align8(x + y) = x + align8(y) for x a
// multiple of 8 keeps the family closed.
__device__ __forceinline__ Run then(const Run& older, const Run& newer) {
    if (!newer.has) {
        return older.has ? Run{1, older.a1, older.a2 + newer.a1}
                         : Run{0, older.a1 + newer.a1, 0};
    }
    return older.has ? Run{1, older.a1, align8(older.a2 + newer.a1) + newer.a2}
                     : Run{1, older.a1 + newer.a1, newer.a2};
}

// The ST_SUM word of a run (a1 < 2**29 when it holds an image start).
__device__ __forceinline__ unsigned long long sum_state(const Run& r) {
    return r.has ? ST_SUM | ST_START | ((unsigned long long)r.a1 << 33) |
                       (uint32_t)r.a2
                 : ST_SUM | (uint32_t)r.a1;
}

// The stream offset at the end of CTA g - 1, by warp 0 (all 32 lanes).
__device__ __forceinline__ int look_back(
    const volatile unsigned long long* states, int g, int lane) {
    Run acc{0, 0, 0};  // the CTAs between the window and CTA g
    for (int j0 = g - 1;; j0 -= 32) {
        const int j = j0 - lane;  // lane 0 holds the nearest CTA
        // before CTA 0 the stream is at offset 0
        unsigned long long s = ST_END;
        if (j >= 0) {
            do {
                s = states[j];
            } while ((s >> 62) == 0);
        }
        const unsigned ends = __ballot_sync(FULL, (s >> 62) == 2);
        const int k = ends ? __ffs(ends) - 1 : 32;  // nearest known end
        const int a = (int)(uint32_t)s;
        Run f{0, 0, 0};
        if (lane < k)
            f = (s & ST_START) ? Run{1, (int)((s >> 33) & A1_MASK), a}
                               : Run{0, a, 0};
        // lanes [lane, lane + 2d) in order: the higher lanes are older
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            Run o;
            o.has = __shfl_down_sync(FULL, f.has, d);
            o.a1 = __shfl_down_sync(FULL, f.a1, d);
            o.a2 = __shfl_down_sync(FULL, f.a2, d);
            if (lane + d < 32) f = then(o, f);
        }
        Run w;
        w.has = __shfl_sync(FULL, f.has, 0);
        w.a1 = __shfl_sync(FULL, f.a1, 0);
        w.a2 = __shfl_sync(FULL, f.a2, 0);
        acc = then(w, acc);
        if (k < 32) return acc.apply(__shfl_sync(FULL, a, k));
    }
}

}  // namespace
