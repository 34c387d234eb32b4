// Fused entropy encode for Hopper: quantized zig-zag coefficients (or
// pixels, through the float32 fast transform) -> per-block stream words
// already shifted to their final bit phase, plus every block's global bit
// offset and bit count.
//
// Replaces the coefficient-major fused Pallas encode kernel of the JAX
// package (tinyimgcodec_tpu/ops/pallas_encode2.py, _make_kernel) and keeps
// its interface: (N, 56) uint32 rows, (2, N) meta, an overflow flag.
//
// What had to change.  The TPU kernel runs its grid in order on one core
// and carries the DC predictor and the running stream offset from tile to
// tile in scalar memory.  CUDA blocks run in no order, so here
//   - a block's DC predictor is read from its left neighbour's
//     coefficient directly (zero at the first block of an image);
//   - the global offsets come from a scan written out in launches:
//       count:   per-block bit counts                       (N threads)
//       scan:    exclusive scan inside each image           (one CTA an image)
//       starts:  image starts, each rounded up to a byte    (serial over B)
//       emit:    offset = image start + local offset; pack the words;
//   - table lookups are real lookups from shared memory (the TPU kernel's
//     compare-select chains stand in for a gather Mosaic does not have),
//     and the tables are arguments, not compile-time constants;
//   - the category of a value is 32 - clz(|v|).
//
// Bound: bytes.  From coefficients a block reads 256 B and writes 224 B of
// row + 8 B of meta; from pixels it reads 64 B.  The integer work per
// coefficient is a handful of operations.  Design: one thread per block
// with coefficient-major (64, N) input, so that every load of a warp is
// contiguous; each thread streams its code words through a 64-bit
// accumulator into its own row in shared memory (row stride 57 words: no
// bank conflicts), and the CTA copies its contiguous tile of rows out with
// coalesced stores.  The coefficients are read twice (count and emit) and
// the pixel mode writes them to a scratch buffer first; fusing those
// passes is left for a later change.
//
// The fast transform is float32 and order-dependent: each coefficient is
// the sum over pixels p = 0..63 in ascending order of x[p] * M[p][k], one
// rounding after every multiply and every add (compiled with -fmad=false),
// then DC - offset, then rintf (half to even).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_WORDS = 56;
constexpr int ROW_PAD = 57;
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

struct CountSink {
    int bits = 0;
    __device__ __forceinline__ void put(uint32_t, int len) { bits += len; }
};

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

// Symbols of block b into `sink`; returns 1 if a coefficient lies outside
// the tables' range (DC category > 11 or AC size > 10; it is then clamped).
template <class Sink>
__device__ __forceinline__ int encode_block(const int* __restrict__ zz, int n,
                                            int b, int nb, const Tables& t,
                                            Sink& sink) {
    int over = 0;
    const int dc = zz[b];
    const int prev = (b % nb == 0) ? 0 : zz[b - 1];
    const int diff = (int)((uint32_t)dc - (uint32_t)prev);
    int cat = category(diff);
    if (cat > 11) {
        over = 1;
        cat = 11;
    }
    uint32_t comb = t.dc[cat];
    sink.put(((comb >> 8) << cat) | magnitude(diff, cat),
             (int)(comb & 0xFFu) + cat);

    const int zrl_len = (int)(t.ac[ZRL_INDEX] & 0xFFu);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        const int v = zz[(size_t)k * n + b];
        if (v == 0) {
            ++run;
            continue;
        }
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
        run = 0;
    }
    comb = t.ac[0];  // EOB, always emitted
    sink.put(comb >> 8, (int)(comb & 0xFFu));
    return over;
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

    float x[64];
    const uint4* p = reinterpret_cast<const uint4*>(pix + (size_t)b * 64);
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
            zz[(size_t)k * n + b] = (int)rintf(v);
        }
    }
}

// ---- pass 1: per-block bit counts + table-range flag --------------------
__global__ void __launch_bounds__(ENC_THREADS)
count_kernel(const int* __restrict__ zz, const uint32_t* dc,
             const uint32_t* ac, const uint32_t* zhi, const uint32_t* zlo,
             int* __restrict__ bits, int* __restrict__ over, int n, int nb) {
    __shared__ Tables t;
    load_tables(t, dc, ac, zhi, zlo);
    const int b = blockIdx.x * ENC_THREADS + threadIdx.x;
    if (b >= n) return;
    CountSink sink;
    if (encode_block(zz, n, b, nb, t, sink)) atomicOr(over, 1);
    bits[b] = sink.bits;
}

// ---- pass 2: exclusive scan of the bit counts inside each image ---------
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

// ---- pass 3: image starts, byte-aligned, serially over the B images -----
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

// ---- pass 4: pack every block's words at its final bit phase ------------
__global__ void __launch_bounds__(ENC_THREADS)
emit_kernel(const int* __restrict__ zz, const uint32_t* dc,
            const uint32_t* ac, const uint32_t* zhi, const uint32_t* zlo,
            const int* __restrict__ starts, int* __restrict__ off,
            uint32_t* __restrict__ packed, int n, int nb) {
    __shared__ Tables t;
    __shared__ uint32_t rows[ENC_THREADS * ROW_PAD];
    for (int i = threadIdx.x; i < ENC_THREADS * ROW_PAD; i += ENC_THREADS)
        rows[i] = 0u;
    load_tables(t, dc, ac, zhi, zlo);  // ends with __syncthreads()
    const int base = blockIdx.x * ENC_THREADS;
    const int b = base + threadIdx.x;
    if (b < n) {
        const int o = starts[b / nb] + off[b];  // off holds the local offset
        off[b] = o;
        WordSink sink(rows + threadIdx.x * ROW_PAD, o & 31);
        encode_block(zz, n, b, nb, t, sink);
        sink.flush();
    }
    __syncthreads();
    const int live = min(ENC_THREADS, n - base);
    uint32_t* out = packed + (size_t)base * ROW_WORDS;
    for (int i = threadIdx.x; i < live * ROW_WORDS; i += ENC_THREADS) {
        const int r = i / ROW_WORDS;
        out[i] = rows[r * ROW_PAD + (i - r * ROW_WORDS)];
    }
}

}  // namespace

// x: (n, 64) uint8 pixels (from_zz == 0; zz_scratch (64, n) int32 receives
// the coefficients) or (64, n) int32 coefficients (from_zz != 0).
// m (64, 64) float32, off0: fast transform.  dc (12), ac (176), zhi (4),
// zlo (4): uint32 symbol tables.  packed (n, 56) uint32; meta (2, n) int32
// = [global bit offset; bit count]; img_bits (n / nb) int32 scratch;
// starts (n / nb + 1) int32 (image starts, then the total); over (1)
// int32, zeroed by the caller.  n must be a multiple of nb.  All launches
// go to `stream`; returns the first non-zero cudaGetLastError().
extern "C" int encode2_launch(const void* x, int from_zz, const void* m,
                              float off0, const void* dc, const void* ac,
                              const void* zhi, const void* zlo,
                              void* zz_scratch, void* packed, void* meta,
                              void* img_bits, void* starts, void* over,
                              int n, int nb, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const int grid = (n + ENC_THREADS - 1) / ENC_THREADS;
    const int nimg = n / nb;
    const int* zz = (const int*)x;
    cudaError_t err;
    if (!from_zz) {
        fast_transform_kernel<<<grid, ENC_THREADS, 0, s>>>(
            (const uint8_t*)x, (const float*)m, off0, (int*)zz_scratch, n);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        zz = (const int*)zz_scratch;
    }
    int* off = (int*)meta;
    int* bits = (int*)meta + n;
    count_kernel<<<grid, ENC_THREADS, 0, s>>>(
        zz, (const uint32_t*)dc, (const uint32_t*)ac, (const uint32_t*)zhi,
        (const uint32_t*)zlo, bits, (int*)over, n, nb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    scan_images_kernel<<<nimg, SCAN_THREADS, 0, s>>>(bits, off,
                                                     (int*)img_bits, nb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    image_starts_kernel<<<1, 1, 0, s>>>((const int*)img_bits, (int*)starts,
                                        nimg);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    emit_kernel<<<grid, ENC_THREADS, 0, s>>>(
        zz, (const uint32_t*)dc, (const uint32_t*)ac, (const uint32_t*)zhi,
        (const uint32_t*)zlo, (const int*)starts, off, (uint32_t*)packed, n,
        nb);
    return (int)cudaGetLastError();
}

// The float32 transform pass alone: pix (n, 64) uint8 -> zz (64, n) int32.
extern "C" int fast_transform_launch(const void* pix, const void* m,
                                     float off0, void* zz, int n,
                                     void* stream) {
    if (n <= 0) return 0;
    const int grid = (n + ENC_THREADS - 1) / ENC_THREADS;
    fast_transform_kernel<<<grid, ENC_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)pix, (const float*)m, off0, (int*)zz, n);
    return (int)cudaGetLastError();
}
