/* Embedded-profile fixed-point encoder (scaled_dct streams).
 *
 * Counterpart of the reference's embedded C encoder (c/img.c, c/encode.c):
 * an FPU-free, table-driven encoder for microcontroller-class targets that
 * emits flag-bit-30 ("scaled DCT") streams decodable by the main decoder's
 * AAN-descaling path (reference codec.py:59-62).  This is an independent
 * implementation: AAN butterflies in Q10 fixed point, reciprocal
 * quantization, incremental Huffman emission into a caller buffer.
 *
 * Output scaling contract: the 2-D AAN fast DCT naturally produces
 * coefficients scaled by 64*s_i*s_j (= the AAN_SCALES table) relative to
 * the orthonormal DCT; quantization divides by QUANT[i] << qfactor, so the
 * decoder reconstructs with quality-50 tables after descaling.
 *
 * DECISION RECORD -- quantizer rounding (SURVEY quirk 2.5-12): the
 * reference C encoder's rounding offset is always QUANT[i]>>1
 * (reference c/img.c:197) even when the effective divisor is
 * QUANT[i]<<qfactor, i.e. for qfactor>0 it rounds at 1/2^(qfactor+1)
 * instead of 1/2 -- a deliberate approximation there to keep one table.
 * We round with half of the EFFECTIVE divisor ((QUANT<<qfactor)>>1,
 * below), i.e. true round-half-away.  Measured rate/distortion shift on
 * Lenna vs the reference binary (best/high/med/low): CR 3.31/4.66/6.72/
 * 10.17 vs 3.26/5.13/8.10/12.99; PSNR 40.42/38.85/37.38/35.83 dB vs
 * 40.45/38.33/36.45/34.60 dB -- we trade ~10-25% compression ratio at
 * qfactor>0 for +0.5..+1.2 dB fidelity.  Identical at qfactor=0.
 * Quantified parity is pinned by tests/test_embedded.py
 * (test_embedded_rd_parity_vs_reference_published).
 */

#include <stdint.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

/* Q10 AAN rotation constants: c4, c6, c2-c6, c2+c6 (ck = cos(k*pi/16)) */
#define C_A1 724   /* 0.70710678 * 1024 */
#define C_A2 554   /* 0.54119610 * 1024 */
#define C_A3 724   /* c4 again */
#define C_A4 1338  /* 1.30656296 * 1024 */
#define C_A5 392   /* 0.38268343 * 1024 */
#define QMUL(x, c) ((int32_t)(((int64_t)(x) * (c)) >> 10))

/* Annex K luminance quantization table, zig-zag order is applied later */
static const uint8_t QUANT8[64] = {
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
};

static const uint8_t ZZ[64] = {
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
};

/* Canonical Annex K luminance codes, generated from BITS/HUFFVAL (see
 * constants.py); numeric (code, length) layout for O(1) lookup. */
static const uint16_t DC_CODE[12] = {0x0, 0x2, 0x3, 0x4, 0x5, 0x6,
                                     0xE, 0x1E, 0x3E, 0x7E, 0xFE, 0x1FE};
static const uint8_t DC_LEN[12] = {2, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9};

/* AC_CODE[run][size], size 1..10; EOB and ZRL separate */
static uint16_t AC_CODE[16][11];
static uint8_t AC_LEN[16][11];
#define EOB_CODE 0x0A
#define EOB_LEN 4
#define ZRL_CODE 0x7F9
#define ZRL_LEN 11

static const uint8_t AC_BITS[16] = {0, 2, 1, 3, 3, 2, 4,
                                    3, 5, 5, 4, 4, 0, 0, 1, 0x7D};
static const uint8_t AC_HUFFVAL[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
    0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
};

static void init_ac_table(void) {
    if (AC_LEN[0][1]) return;
    uint32_t code = 0;
    int k = 0;
    for (int length = 1; length <= 16; length++) {
        for (int c = 0; c < AC_BITS[length - 1]; c++) {
            uint8_t sym = AC_HUFFVAL[k++];
            int run = sym >> 4, size = sym & 0xF;
            if (size <= 10) {
                AC_CODE[run][size] = (uint16_t)code;
                AC_LEN[run][size] = (uint8_t)length;
            }
            code++;
        }
        code <<= 1;
    }
}

typedef struct {
    uint8_t *out;
    long capacity;
    long pos_bits;
    uint32_t err;
    int prev_dc;
    uint8_t qfactor;
    uint16_t recip[64]; /* 65536 / (QUANT << qfactor) */
} TicEmbedded;

static void put_bits(TicEmbedded *e, uint32_t value, int nbits) {
    if (nbits == 0) return;
    if (e->pos_bits + nbits > e->capacity * 8) { e->err = 1; return; }
    for (int k = nbits - 1; k >= 0; k--) {
        long p = e->pos_bits++;
        if ((value >> k) & 1)
            e->out[p >> 3] |= (uint8_t)(0x80u >> (p & 7));
    }
}

/* 1-D AAN forward DCT on 8 int32 values (in place, stride s). */
static void fdct8(int32_t *d, int s) {
    int32_t x0 = d[0], x1 = d[s], x2 = d[2 * s], x3 = d[3 * s];
    int32_t x4 = d[4 * s], x5 = d[5 * s], x6 = d[6 * s], x7 = d[7 * s];
    int32_t t0 = x0 + x7, t7 = x0 - x7;
    int32_t t1 = x1 + x6, t6 = x1 - x6;
    int32_t t2 = x2 + x5, t5 = x2 - x5;
    int32_t t3 = x3 + x4, t4 = x3 - x4;
    /* even */
    int32_t u0 = t0 + t3, u3 = t0 - t3;
    int32_t u1 = t1 + t2, u2 = t1 - t2;
    d[0] = u0 + u1;
    d[4 * s] = u0 - u1;
    int32_t z1 = QMUL(u2 + u3, C_A1);
    d[2 * s] = u3 + z1;
    d[6 * s] = u3 - z1;
    /* odd */
    int32_t v0 = t4 + t5, v1 = t5 + t6, v2 = t6 + t7;
    int32_t z5 = QMUL(v0 - v2, C_A5);
    int32_t z2 = QMUL(v0, C_A2) + z5;
    int32_t z4 = QMUL(v2, C_A4) + z5;
    int32_t z3 = QMUL(v1, C_A3);
    int32_t z11 = t7 + z3, z13 = t7 - z3;
    d[5 * s] = z13 + z2;
    d[3 * s] = z13 - z2;
    d[s] = z11 + z4;
    d[7 * s] = z11 - z4;
}

static int bitlen_u32(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

EXPORT void tic_embedded_init(TicEmbedded *e, uint8_t qfactor, uint8_t *out,
                              long capacity) {
    init_ac_table();
    memset(e, 0, sizeof(*e));
    e->out = out;
    e->capacity = capacity;
    e->qfactor = qfactor;
    memset(out, 0, capacity);
    for (int i = 0; i < 64; i++)
        e->recip[i] =
            (uint16_t)(65536u / ((uint32_t)QUANT8[i] << qfactor));
}

EXPORT void tic_embedded_header(TicEmbedded *e, uint32_t height,
                                uint32_t width) {
    /* 16-byte LE header, flag bit 30 = scaled_dct, quality = qfactor */
    uint32_t hdr[4] = {height, width, e->qfactor, 1u << 30};
    if (e->pos_bits % 8 || e->capacity < 16) { e->err = 1; return; }
    memcpy(e->out + e->pos_bits / 8, hdr, 16);
    e->pos_bits += 16 * 8;
}

EXPORT void tic_embedded_block(TicEmbedded *e, const uint8_t pixels[64]) {
    int32_t blk[64];
    for (int i = 0; i < 64; i++) blk[i] = (int32_t)pixels[i] - 128;
    for (int r = 0; r < 8; r++) fdct8(blk + 8 * r, 1);
    for (int c = 0; c < 8; c++) fdct8(blk + c, 8);
    /* quantize (rounding via half-divisor offset) + zig-zag */
    int32_t q[64];
    for (int i = 0; i < 64; i++) {
        int32_t v = blk[i];
        uint32_t div_half = ((uint32_t)QUANT8[i] << e->qfactor) >> 1;
        int32_t mag = v < 0 ? -v : v;
        int32_t qq =
            (int32_t)(((uint32_t)(mag + div_half) * e->recip[i]) >> 16);
        q[i] = v < 0 ? -qq : qq;
    }
    /* DC */
    int32_t diff = q[0] - e->prev_dc;
    e->prev_dc = q[0];
    uint32_t mag = (uint32_t)(diff < 0 ? -diff : diff);
    int cat = bitlen_u32(mag);
    if (cat > 11) { e->err = 1; return; }
    put_bits(e, DC_CODE[cat], DC_LEN[cat]);
    if (cat)
        put_bits(e, diff < 0 ? (~mag) & ((1u << cat) - 1) : mag, cat);
    /* AC in zig-zag order */
    int last = 0;
    for (int k = 63; k >= 1; k--)
        if (q[ZZ[k]]) { last = k; break; }
    int run = 0;
    for (int k = 1; k <= last; k++) {
        int32_t v = q[ZZ[k]];
        if (v == 0) { run++; continue; }
        while (run >= 16) { put_bits(e, ZRL_CODE, ZRL_LEN); run -= 16; }
        uint32_t m = (uint32_t)(v < 0 ? -v : v);
        int size = bitlen_u32(m);
        if (size > 10) { e->err = 1; return; }
        put_bits(e, AC_CODE[run][size], AC_LEN[run][size]);
        put_bits(e, v < 0 ? (~m) & ((1u << size) - 1) : m, size);
        run = 0;
    }
    put_bits(e, EOB_CODE, EOB_LEN);
}

EXPORT long tic_embedded_finish(TicEmbedded *e) {
    if (e->err) return -1;
    return (e->pos_bits + 7) / 8;
}

EXPORT long tic_embedded_sizeof(void) { return (long)sizeof(TicEmbedded); }

/* One-shot convenience: whole image in row-major order. */
EXPORT long tic_embedded_encode(const uint8_t *pixels, uint32_t width,
                                uint32_t height, uint8_t qfactor,
                                uint8_t *out, long capacity) {
    if (width % 8 || height % 8) return -2;
    TicEmbedded e;
    tic_embedded_init(&e, qfactor, out, capacity);
    tic_embedded_header(&e, height, width);
    uint8_t blockbuf[64];
    for (uint32_t by = 0; by < height / 8; by++) {
        for (uint32_t bx = 0; bx < width / 8; bx++) {
            for (int r = 0; r < 8; r++)
                memcpy(blockbuf + 8 * r,
                       pixels + (by * 8 + r) * width + bx * 8, 8);
            tic_embedded_block(&e, blockbuf);
        }
    }
    return tic_embedded_finish(&e);
}

#ifdef TIC_EMBEDDED_MAIN
/* Streaming CLI: encode <width> <height> [qfactor 0-3] < raw.gray > out.img
 * (same pipe UX as the reference's c/encode.c, minus its duplicated
 * final-band bug -- SURVEY quirk 2.5-3). */
#include <stdio.h>
#include <stdlib.h>

int main(int argc, char **argv) {
    if (argc < 3) {
        fprintf(stderr, "usage: %s <width> <height> [qfactor 0-3]\n",
                argv[0]);
        return 1;
    }
    uint32_t width = (uint32_t)strtoul(argv[1], NULL, 10);
    uint32_t height = (uint32_t)strtoul(argv[2], NULL, 10);
    uint8_t qf = argc > 3 ? (uint8_t)strtoul(argv[3], NULL, 10) : 2;
    if (width % 8 || height % 8 || qf > 3) {
        fprintf(stderr, "dims must be multiples of 8; qfactor 0-3\n");
        return 1;
    }
    long cap = 16 + (long)width * height; /* worst case ~8 bpp */
    uint8_t *out = malloc(cap);
    uint8_t *band = malloc((size_t)width * 8);
    TicEmbedded e;
    tic_embedded_init(&e, qf, out, cap);
    tic_embedded_header(&e, height, width);
    uint8_t blockbuf[64];
    for (uint32_t by = 0; by < height / 8; by++) {
        if (fread(band, 1, (size_t)width * 8, stdin) != (size_t)width * 8) {
            fprintf(stderr, "short read\n");
            return 1;
        }
        for (uint32_t bx = 0; bx < width / 8; bx++) {
            for (int r = 0; r < 8; r++)
                memcpy(blockbuf + 8 * r, band + r * width + bx * 8, 8);
            tic_embedded_block(&e, blockbuf);
        }
    }
    long n = tic_embedded_finish(&e);
    if (n < 0) return 1;
    fwrite(out, 1, (size_t)n, stdout);
    return 0;
}
#endif
