// Device code shared by the encode kernels (encode2.cu, encode1.cu) and
// the stream assembly (stitch.cu): the Huffman symbol tables in shared
// memory, the per-block symbolizer and its bit sink, the float32 fast
// transform, and the per-image offset scans of stitch.cu.
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
constexpr int SCAN_THREADS = 1024;
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

// ---- exclusive scan of per-block bit counts inside each image (stitch.cu;
// encode2.cu scans across its tiles in one pass of its own) ---------------
// One CTA per image walks its nb counts in chunks of SCAN_THREADS with a
// running carry: warp shuffles inside a warp, shared memory across warps.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_images_kernel(const int* __restrict__ bits, int* __restrict__ local_off,
                   int* __restrict__ img_bits, int nb) {
    __shared__ int warp_sums[32];
    const int img = blockIdx.x;
    const int* src = bits + (size_t)img * nb;
    int* dst = local_off + (size_t)img * nb;
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    int carry = 0;
    for (int base = 0; base < nb; base += SCAN_THREADS) {
        const int i = base + threadIdx.x;
        const int v = (i < nb) ? src[i] : 0;
        int x = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31) warp_sums[wid] = x;
        __syncthreads();
        if (wid == 0) {
            int s = warp_sums[lane];
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(0xFFFFFFFFu, s, d);
                if (lane >= d) s += y;
            }
            warp_sums[lane] = s;
        }
        __syncthreads();
        const int before = (wid > 0) ? warp_sums[wid - 1] : 0;
        if (i < nb) dst[i] = carry + before + x - v;
        carry += warp_sums[31];
        __syncthreads();
    }
    if (threadIdx.x == 0) img_bits[img] = carry;
}

// ---- image starts, byte-aligned, serially over the B images -------------
// starts[i] for i < B; starts[B] = total stream bits (last image unpadded).
__global__ void image_starts_kernel(const int* __restrict__ img_bits,
                                    int* __restrict__ starts, int nimg) {
    if (blockIdx.x != 0 || threadIdx.x != 0) return;
    int s = 0;
    for (int i = 0; i < nimg; ++i) {
        starts[i] = s;
        s += img_bits[i];
        if (i + 1 < nimg) s = (s + 7) & ~7;
    }
    starts[nimg] = s;
}

}  // namespace
