// Exact (float64) inverse transform for Hopper: entropy_decode's zig-zag
// rows, the DC still as DPCM differences, -> each image's cropped pixels
// in raster order, equal to the float64 oracle's (container.decompress:
// running DC, dequantize, scipy's inverse DCT, + 128, clip, truncate) in
// every block, and the count of blocks whose values sat within 1e-9 of a
// floor boundary, which the kernel settles in the oracle's own arithmetic.
//
// It replaces no TPU kernel: in the JAX package the decode transform is an
// XLA program (ops/transform.py: undo_dpcm, decode_blocks, unblockify), and
// the port ran it as a dozen plain-torch passes over float64 arrays, then
// pulled the flagged blocks to the host for scipy.  Here it is one call of
// two kernels and a memset: no float64 array reaches device memory, and the
// host waits on nothing but the pixel pull.
//
// Bound: on paper bytes (256 B in, 64 B out a block: 19 us for the 49-image
// corpus at 3.35 TB/s); in fact the FP64 pipes.  A block's two 8x8 products
// are separate multiplies and adds (-fmad=false: no multiply and add is
// contracted, so the plain version, ops/exact_inverse.py, gives the same
// values bit for bit), about 1 600 FP64 instructions a block with the tie
// test, and the FP64 pipes of an SM retire 64 a clock.  Design:
//   - dc_scan_kernel: the running DC of every block, int32 wrap-around as
//     the oracle's int64 sum cast back.  A CTA sums 2 048 blocks of one
//     image (coalesced across its lanes, a CTA-wide scan a round) and an
//     image's later CTAs carry the DC across by a single-pass look-back,
//     as encode2.cu's scan does.  Measured on the card (PERF.md), the same
//     look-back inside the transform kernel, a tile of 32 blocks a step,
//     cost more than this launch: every CTA waited one or more L2 round
//     trips at a barrier while it held its SM's slots;
//   - exact_inverse_kernel: a CTA takes TILE horizontally adjacent blocks of
//     one block row of one image; their rows come in by cp.async, 16 bytes
//     a copy, their running DCs over the DC slots; eight lanes a block,
//     lane c dequantizes column c (the oracle's product; scaled-DCT streams
//     divide by the AAN scales and multiply by 2**qfactor first, as the
//     oracle does), sums the column's inverse DCT in even and odd halves (a
//     butterfly: the basis is symmetric about the middle, so four outputs
//     give eight), the eight lanes exchange the 8x8 by three shuffles, and
//     lane c sums row c's the same way; the basis is a kernel argument, so
//     its values are operands from the constant bank, not loads;
//   - + 128, the tie test (a value within 1e-9 of an integer inside
//     (0.5, 255.5)), floor and clip with the exponent trick of
//     exact_transform.cu, no conversion instruction; the eight bytes of the
//     lane's row go to the tile's eight output rows in shared memory;
//   - the tile's flagged blocks (about one tile in thirty at quality 50)
//     are listed in shared memory and each is computed again by eight
//     lanes in scipy's operations and order (idct8 below: pocketfft's
//     T_dcst23 type-3 branch of length 8, its constants bit for bit, the
//     columns then the rows), clipped and truncated as the oracle does;
//   - the eight output rows leave as contiguous spans, 16 bytes a store
//     when the width is a multiple of 16, byte by byte where the crop cuts
//     a row.
// The separable sums run in another order than scipy's, so a value may
// differ from the oracle's in its last bits, around 1e-12 on these
// magnitudes: far inside the 1e-9 window, so an unflagged value floors and
// clips as the oracle's does.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// zig-zag slot of the row-major coefficient u*8+v (inverse zig-zag order)
__constant__ unsigned char ZZ_SLOT[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

constexpr int TILE = 32;             // blocks a CTA, one block row's run
constexpr int THREADS = 8 * TILE;    // eight lanes a block
constexpr int WARPS = THREADS / 32;  // four blocks a warp
constexpr int MIN_CTAS = 4;          // CTAs an SM: 64 registers a thread
constexpr int RS = 68;  // ints a block's row in shared memory: 16-byte
                        // aligned, 4 mod 32 to spread the banks
constexpr int OS = 2 * TILE + 4;  // words an output row, 16-byte aligned
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_PER = 8;  // DCs a scan thread
constexpr int SCAN_BLOCKS = SCAN_THREADS * SCAN_PER;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long ST_SUM = 1ull << 62;  // value: the CTA's sum
constexpr unsigned long long ST_END = 2ull << 62;  // value: DC at its end
constexpr double TIE_EPS = 1e-9;
constexpr double RINT_MAGIC = 6755399441055744.0;  // 1.5 * 2**52

// The DCT basis d[u * 8 + i] (tables.dct_basis), passed by value.
struct Basis {
    double d[64];
};

// The orthonormal inverse DCT of length 8 of v in place, in the operations
// and order of scipy's (scipy.fftpack.idct, norm="ortho": pocketfft's
// T_dcst23, type 3: the DC times sqrt(2), a pre-twiddle, a forward real
// FFT of a radix-4 then a radix-2 pass scaled by 1/4, a butterfly), with its
// constants as that code computes them (the two parts of its root of unity
// differ in the last bit).
__device__ __forceinline__ void idct8(double v[8]) {
    constexpr double WR = 0x1.6a09e667f3bccp-1, WI = 0x1.6a09e667f3bcdp-1;
    constexpr double T1 = 0x1.f6297cff75cbp-1, T2 = 0x1.d906bcf328d46p-1,
                     T3 = 0x1.a9b66290ea1a3p-1, T4 = 0x1.6a09e667f3bccp-1,
                     T5 = 0x1.1c73b39ae68c8p-1, T6 = 0x1.87de2a6aea963p-2,
                     T7 = 0x1.8f8b83c69a60ap-3;
    constexpr double SQRT2 = 0x1.6a09e667f3bcdp+0;
    double c[8];
    c[0] = v[0] * SQRT2;
    double t1 = v[1] + v[7], t2 = v[1] - v[7];
    c[1] = T1 * t2 + T7 * t1;
    c[7] = T1 * t1 - T7 * t2;
    t1 = v[2] + v[6];
    t2 = v[2] - v[6];
    c[2] = T2 * t2 + T6 * t1;
    c[6] = T2 * t1 - T6 * t2;
    t1 = v[3] + v[5];
    t2 = v[3] - v[5];
    c[3] = T3 * t2 + T5 * t1;
    c[5] = T3 * t1 - T5 * t2;
    c[4] = v[4] * (2.0 * T4);
    // radix-4 pass (two groups)
    double h[8];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const double s1 = c[k + 6] + c[k + 2], s2 = c[k] + c[k + 4];
        h[4 * k + 2] = c[k + 6] - c[k + 2];
        h[4 * k + 1] = c[k] - c[k + 4];
        h[4 * k] = s2 + s1;
        h[4 * k + 3] = s2 - s1;
    }
    // radix-2 pass (one group of four), then the scale
    const double tr2 = WR * h[5] + WI * h[6], ti2 = WR * h[6] - WI * h[5];
    double o[8];
    o[0] = h[0] + h[4];
    o[7] = h[0] - h[4];
    o[4] = -h[7];
    o[3] = h[3];
    o[1] = h[1] + tr2;
    o[5] = h[1] - tr2;
    o[2] = ti2 + h[2];
    o[6] = ti2 - h[2];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] *= 0.25;
    v[0] = o[0];
    v[7] = o[7];
#pragma unroll
    for (int k = 1; k < 7; k += 2) {
        v[k] = o[k] - o[k + 1];
        v[k + 1] = o[k + 1] + o[k];
    }
}

// Eight lanes (an aligned eighth of the warp, c = lane & 7) holding an
// 8x8 by columns, v[i] = M[i][c], come to hold it by rows, v[j] = M[c][j]:
// three exchanges, the step-m one swapping M's entries whose lane and
// register differ in bit m with the lane across that bit.
__device__ __forceinline__ void transpose8(double v[8], int c) {
#pragma unroll
    for (int m = 4; m >= 1; m >>= 1) {
        const bool hi = c & m;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            if (i & m) continue;
            const double send = hi ? v[i] : v[i | m];
            const double got = __shfl_xor_sync(FULL, send, m);
            if (hi)
                v[i] = got;
            else
                v[i | m] = got;
        }
    }
}

// The running DC at the end of CTA g - 1, by warp 0 (all 32 lanes): the
// sums of the CTAs back to the nearest one that knows its end, and that
// end.  An image's first CTA publishes its end without looking back, so
// the walk never leaves the image.
__device__ __forceinline__ uint32_t look_back(
    const volatile unsigned long long* states, int g, int lane) {
    uint32_t acc = 0;
    for (int j0 = g - 1;; j0 -= 32) {
        const int j = j0 - lane;  // lane 0 holds the nearest CTA
        unsigned long long s = ST_END;  // no CTA before 0: an end of 0
        if (j >= 0) {
            do {
                s = states[j];
            } while ((s >> 62) == 0);
        }
        const unsigned ends = __ballot_sync(FULL, (s >> 62) == 2);
        const int k = ends ? __ffs(ends) - 1 : 32;  // nearest known end
        uint32_t v = lane <= k ? (uint32_t)s : 0u;
#pragma unroll
        for (int d = 16; d >= 1; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
        acc += v;
        if (k < 32) return acc;
    }
}

// zz (nb * B, 64) -> dc_abs (nb * B) the running DC of each image.  CTAs
// take their index from an atomic ticket, so a CTA only waits for CTAs
// that already run; scan[0] the ticket, scan[2 + g] CTA g's state word,
// zeroed by the caller.
__global__ void __launch_bounds__(SCAN_THREADS)
dc_scan_kernel(const int* __restrict__ zz, int* __restrict__ dc_abs,
               unsigned long long* __restrict__ scan, int nb, int chunks) {
    __shared__ uint32_t s_w[SCAN_THREADS / 32];
    __shared__ int s_ticket;
    __shared__ uint32_t s_before;
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    if (tid == 0) s_ticket = (int)atomicAdd(scan, 1ull);
    __syncthreads();
    const int g = s_ticket;
    const int img = g / chunks, ck = g - img * chunks;
    const size_t b0 = (size_t)img * nb + (size_t)ck * SCAN_BLOCKS;
    const int live = min(SCAN_BLOCKS, nb - ck * SCAN_BLOCKS);
    // round q holds blocks q * 256 + tid: neighbouring lanes, neighbouring
    // blocks
    uint32_t v[SCAN_PER];
#pragma unroll
    for (int q = 0; q < SCAN_PER; ++q) {
        const int i = q * SCAN_THREADS + tid;
        v[q] = i < live ? (uint32_t)__ldg(zz + (b0 + i) * 64) : 0u;
    }
    uint32_t carry = 0;  // the sum of the rounds before
#pragma unroll
    for (int q = 0; q < SCAN_PER; ++q) {
        uint32_t incl = v[q];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t y = __shfl_up_sync(FULL, incl, d);
            if (lane >= d) incl += y;
        }
        if (lane == 31) s_w[wid] = incl;
        __syncthreads();
        uint32_t before = 0, total = 0;
#pragma unroll
        for (int k = 0; k < SCAN_THREADS / 32; ++k) {
            const uint32_t x = s_w[k];
            if (k < wid) before += x;
            total += x;
        }
        v[q] = carry + before + incl;
        carry += total;
        __syncthreads();
    }
    if (wid == 0) {
        volatile unsigned long long* states = scan + 2;
        uint32_t before = 0;  // an image's first CTA starts from 0
        if (ck != 0) {
            if (lane == 0) states[g] = ST_SUM | carry;
            before = look_back(states, g, lane);
        }
        if (lane == 0) {
            states[g] = ST_END | (uint32_t)(before + carry);
            s_before = before;
        }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < SCAN_PER; ++q) {
        const int i = q * SCAN_THREADS + tid;
        if (i < live) dc_abs[b0 + i] = (int)(s_before + v[q]);
    }
}

// Column c of a block's coefficients (q[u] = C[u][c]) dequantized in the
// oracle's steps: q * mul[u] for a standard stream; for a scaled-DCT one
// (`divides`) q / dequant[0][.] * dequant[1][.] * mul[u].
__device__ __forceinline__ void dequantize(const int q[8],
                                           const double* __restrict__ dequant,
                                           const double mul[8], int c,
                                           int divides, double out[8]) {
    if (divides) {
#pragma unroll
        for (int u = 0; u < 8; ++u)
            out[u] = (double)q[u] / __ldg(dequant + u * 8 + c) *
                     __ldg(dequant + 64 + u * 8 + c) * mul[u];
    } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) out[u] = (double)q[u] * mul[u];
    }
}

// out[i] = sum_u d[u][i] in[u] for i = 0..7, as even and odd halves:
// e = d[0][i] in[0] + d[2][i] in[2] + ..., o = d[1][i] in[1] + ..., each in
// ascending u, then out[i] = e + o and out[7 - i] = e - o (i < 4).
__device__ __forceinline__ void inverse8(const Basis& b, const double in[8],
                                         double out[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        double e = b.d[i] * in[0], o = b.d[8 + i] * in[1];
#pragma unroll
        for (int u = 2; u < 8; u += 2) {
            e = e + b.d[u * 8 + i] * in[u];
            o = o + b.d[(u + 1) * 8 + i] * in[u + 1];
        }
        out[i] = e + o;
        out[7 - i] = e - o;
    }
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
exact_inverse_kernel(const int* __restrict__ zz, const int* __restrict__ dc,
                     const Basis basis, const double* __restrict__ dequant,
                     uint8_t* __restrict__ out,
                     unsigned long long* __restrict__ flagged, int bw, int bh,
                     int tiles_per_row, int h, int w, int divides, int in16,
                     int out16) {
    __shared__ __align__(16) int s_zz[TILE * RS];     // rows, zig-zag
    __shared__ __align__(16) uint32_t s_out[8 * OS];  // the tile's 8 rows
    __shared__ int s_list[TILE];                      // flagged blocks
    __shared__ int s_nflag;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wid = tid >> 5;
    const int t = tid >> 3;  // the lane's block in the tile
    const int c = tid & 7;   // its column, then its row
    const int per_image = bh * tiles_per_row;
    const int img = blockIdx.x / per_image;
    const int rem = blockIdx.x - img * per_image;
    const int by = rem / tiles_per_row;
    const int bx0 = (rem - by * tiles_per_row) * TILE;
    const int live = min(TILE, bw - bx0);
    const size_t blk0 = (size_t)img * bh * bw + (size_t)by * bw + bx0;

    // ---- the tile's rows into shared memory; the running DC into slot 0
    const int* src = zz + blk0 * 64;
    if (in16) {
        for (int i = tid; i < live * 16; i += THREADS)
            __pipeline_memcpy_async(s_zz + (i >> 4) * RS + (i & 15) * 4,
                                    src + (size_t)i * 4, 16);
    } else {
        for (int i = tid; i < live * 64; i += THREADS)
            __pipeline_memcpy_async(s_zz + (i >> 6) * RS + (i & 63),
                                    src + i, 4);
    }
    __pipeline_commit();
    if (tid == 0) s_nflag = 0;
    // the lane's multipliers and slots of column c, while the rows come in
    double mul[8];
    int slot[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        mul[u] = __ldg(dequant + 128 + u * 8 + c);
        slot[u] = ZZ_SLOT[u * 8 + c];
    }
    const int my_dc = tid < live ? __ldg(dc + blk0 + tid) : 0;
    __pipeline_wait_prior(0);
    __syncthreads();
    if (tid < live) s_zz[tid * RS] = my_dc;
    __syncthreads();

    // ---- dequantize, column c's inverse DCT, exchange, row c's -----------
    const int* row = s_zz + t * RS;
    int q[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) q[u] = row[slot[u]];
    double y[8];
    {
        double cf[8];
        dequantize(q, dequant, mul, c, divides, cf);
        inverse8(basis, cf, y);  // y[i] = Y[i][c]
    }
    transpose8(y, c);  // y[v] = Y[c][v]
    double x[8];
    inverse8(basis, y, x);  // x[j] = X[c][j]
    uint32_t lo = 0u, hi = 0u;
    int near = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const double v = x[j] + 128.0;
        const double r8 = v + RINT_MAGIC;  // rint(v) in the low bits
        const double d = v - (r8 - RINT_MAGIC);
        const bool inside = v > 0.5 && v < 255.5;
        near |= inside && fabs(d) < TIE_EPS;
        // floor, clipped to 0..255: rint(v), less one below it
        const int p = inside ? __double2loint(r8) - (d < 0.0 ? 1 : 0)
                             : (v > 0.5 ? 255 : 0);
        if (j < 4)
            lo |= (uint32_t)p << (8 * j);
        else
            hi |= (uint32_t)p << (8 * (j - 4));
    }
    *reinterpret_cast<uint2*>(s_out + c * OS + 2 * t) = make_uint2(lo, hi);

    // ---- the flagged blocks listed, counted ------------------------------
    const unsigned any = __ballot_sync(FULL, near);
    if (c == 0 && t < live && ((any >> (lane & 24)) & 0xFFu))
        s_list[atomicAdd(&s_nflag, 1)] = t;
    __syncthreads();
    const int nflag = s_nflag;
    if (tid == 0 && nflag) atomicAdd(flagged, (unsigned long long)nflag);

    // ---- each flagged block again, in the oracle's arithmetic: eight
    // lanes a block, four blocks a warp; lanes past the list redo its last
    // block and store nothing ----------------------------------------------
    for (int base = wid * 4; base < nflag; base += 4 * WARPS) {
        const int f = base + (lane >> 3);
        const int bl = s_list[min(f, nflag - 1)];
        const int* frow = s_zz + bl * RS;
#pragma unroll
        for (int u = 0; u < 8; ++u) q[u] = frow[slot[u]];
        double v[8];
        dequantize(q, dequant, mul, c, divides, v);
        idct8(v);  // column c: v[i] = X'[i][c]
        transpose8(v, c);
        idct8(v);  // row c: v[j] = X[c][j]
        if (f < nflag) {
            uint32_t flo = 0u, fhi = 0u;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                // clip, then truncate toward zero, as the oracle's astype
                const int p =
                    (int)__double2uint_rz(fmin(fmax(v[j] + 128.0, 0.0), 255.0));
                if (j < 4)
                    flo |= (uint32_t)p << (8 * j);
                else
                    fhi |= (uint32_t)p << (8 * (j - 4));
            }
            *reinterpret_cast<uint2*>(s_out + c * OS + 2 * bl) =
                make_uint2(flo, fhi);
        }
    }
    __syncthreads();

    // ---- out: the tile's rows of the cropped image -----------------------
    const int y0 = by * 8;
    const int rows = min(8, h - y0);
    uint8_t* dst = out + ((size_t)img * h + y0) * w + (size_t)bx0 * 8;
    if (out16) {  // w % 16 == 0: every span starts on 16 bytes, live is even
        const int quads = live >> 1;
        for (int i = tid; i < rows * quads; i += THREADS) {
            const int r = i / quads, k = i - r * quads;
            *reinterpret_cast<uint4*>(dst + (size_t)r * w + 16 * k) =
                *reinterpret_cast<const uint4*>(s_out + r * OS + 4 * k);
        }
    } else {
        const int span = min(live * 8, w - bx0 * 8);
        const uint8_t* sb = reinterpret_cast<const uint8_t*>(s_out);
        for (int i = tid; i < rows * span; i += THREADS) {
            const int r = i / span, k = i - r * span;
            dst[(size_t)r * w + k] = sb[r * OS * 4 + k];
        }
    }
}

}  // namespace

// zz (n_images * bh * bw, 64) int32, 4-byte aligned; basis (64) double in
// host memory; dequant (3, 64) double on the device; out (n_images, h, w)
// uint8; dc (n_images * bh * bw) int32 scratch; scan (2 + n_images *
// ceil(bh * bw / 2048)) int64 scratch, zeroed here, scan[1] the count of
// flagged blocks on return; divides: dequant's first two rows are not all
// ones.  Launches on `stream`, returns cudaGetLastError().
extern "C" int exact_inverse_launch(const void* zz, const double* basis,
                                    const void* dequant, void* out,
                                    void* dc, void* scan, int n_images,
                                    int bw, int bh, int h, int w,
                                    int divides, void* stream) {
    const int nb = bw * bh;
    const int chunks = (nb + SCAN_BLOCKS - 1) / SCAN_BLOCKS;
    const int tiles_per_row = (bw + TILE - 1) / TILE;
    const long long tiles = (long long)n_images * bh * tiles_per_row;
    cudaStream_t s = (cudaStream_t)stream;
    unsigned long long* sc = (unsigned long long*)scan;
    cudaMemsetAsync(scan, 0, (size_t)(2 + (long long)n_images * chunks) * 8,
                    s);
    if (tiles <= 0) return (int)cudaGetLastError();
    dc_scan_kernel<<<(unsigned)(n_images * chunks), SCAN_THREADS, 0, s>>>(
        (const int*)zz, (int*)dc, sc, nb, chunks);
    Basis b;
    memcpy(b.d, basis, sizeof b.d);
    const int in16 = reinterpret_cast<uintptr_t>(zz) % 16 == 0;
    const int out16 = w % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    exact_inverse_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(
        (const int*)zz, (const int*)dc, b, (const double*)dequant,
        (uint8_t*)out, sc + 1, bw, bh, tiles_per_row, h, w, divides, in16,
        out16);
    return (int)cudaGetLastError();
}
