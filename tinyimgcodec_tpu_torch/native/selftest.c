/* Sanitizer self-test for the native host runtime (codec_native.c +
 * embedded.c).  Built with -fsanitize=address,undefined by
 * tests/test_native.py and run as a subprocess: exercises the entropy
 * encoder/decoder roundtrip, the ragged stitcher against a naive bit
 * appender, corrupt/truncated-payload decode (must stay in bounds), the
 * batch entry point's int8 and int16 rows against the int32 decode, and
 * the embedded encoder's capacity handling.  Exit 0 = clean; any memory
 * or UB error aborts via the sanitizer runtime.
 *
 * Table data (code tables + 16-bit peek LUTs) is supplied by the Python
 * side in one flat binary file so the C test needs no table-building
 * logic of its own.
 *
 * Usage: selftest <tables.bin>
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

long tic_stitch(const uint32_t *words, const int32_t *bits, long n,
                long stride, uint8_t *out, long out_capacity);
long tic_entropy_decode(const uint8_t *data, long nbits, long nblocks,
                        const uint8_t *dc_lut_len, const uint8_t *dc_lut_sym,
                        const uint8_t *ac_lut_len, const uint8_t *ac_lut_sym,
                        int32_t *dc, int32_t *ac);
long tic_entropy_decode_batch(const int64_t *plan, int64_t *cursor, long n,
                              long nblocks, int width, int16_t *dc,
                              void *ac, long exc_cap, int64_t *exc_idx,
                              int16_t *exc_val, int64_t *n_exc);
long tic_entropy_encode(const int32_t *dc, const int32_t *ac, long nblocks,
                        const uint32_t *dc_code, const uint8_t *dc_len,
                        const uint32_t *ac_code, const uint8_t *ac_len,
                        uint8_t *out, long out_capacity);
long tic_embedded_encode(const uint8_t *pixels, uint32_t width,
                         uint32_t height, uint8_t qfactor, uint8_t *out,
                         long capacity);

static uint32_t lcg_state = 12345;
static uint32_t lcg(void) {
    lcg_state = lcg_state * 1664525u + 1013904223u;
    return lcg_state;
}

#define CHECK(cond, msg)                                                   \
    do {                                                                   \
        if (!(cond)) {                                                     \
            fprintf(stderr, "FAIL: %s\n", msg);                            \
            return 1;                                                      \
        }                                                                  \
    } while (0)

/* naive MSB-first bit appender used as the stitch oracle */
static void naive_append(const uint32_t *row, int32_t nbits, uint8_t *out,
                         long *bitpos) {
    for (int32_t b = 0; b < nbits; b++) {
        uint32_t w = row[b / 32];
        int bit = (w >> (31 - (b % 32))) & 1;
        if (bit) out[*bitpos / 8] |= (uint8_t)(0x80 >> (*bitpos % 8));
        (*bitpos)++;
    }
}

int main(int argc, char **argv) {
    if (argc < 2) {
        fprintf(stderr, "usage: selftest <tables.bin>\n");
        return 2;
    }
    FILE *f = fopen(argv[1], "rb");
    CHECK(f != NULL, "open tables.bin");
    static uint32_t dc_code[12], ac_code[176];
    static uint8_t dc_len[12], ac_len[176];
    static uint8_t dc_lut_len[65536], dc_lut_sym[65536];
    static uint8_t ac_lut_len[65536], ac_lut_sym[65536];
    CHECK(fread(dc_code, 4, 12, f) == 12, "read dc_code");
    CHECK(fread(dc_len, 1, 12, f) == 12, "read dc_len");
    CHECK(fread(ac_code, 4, 176, f) == 176, "read ac_code");
    CHECK(fread(ac_len, 1, 176, f) == 176, "read ac_len");
    CHECK(fread(dc_lut_len, 1, 65536, f) == 65536, "read dc_lut_len");
    CHECK(fread(dc_lut_sym, 1, 65536, f) == 65536, "read dc_lut_sym");
    CHECK(fread(ac_lut_len, 1, 65536, f) == 65536, "read ac_lut_len");
    CHECK(fread(ac_lut_sym, 1, 65536, f) == 65536, "read ac_lut_sym");
    fclose(f);

    /* 1) entropy encode -> decode roundtrip on random legal blocks */
    enum { NB = 257 };  /* odd count: exercises tail handling */
    static int32_t dc[NB], ac[NB * 63], dc2[NB], ac2[NB * 63];
    for (int i = 0; i < NB; i++) {
        dc[i] = (int32_t)(lcg() % 4095) - 2047;
        for (int j = 0; j < 63; j++) {
            /* mostly zero, magnitudes within the standard AC table */
            uint32_t r = lcg();
            ac[i * 63 + j] =
                (r % 5 == 0) ? (int32_t)(r % 2047) - 1023 : 0;
        }
    }
    long cap = NB * 212 + 16;
    uint8_t *payload = calloc(cap, 1);
    CHECK(payload != NULL, "alloc payload");
    long nbits = tic_entropy_encode(dc, ac, NB, dc_code, dc_len, ac_code,
                                    ac_len, payload, cap);
    CHECK(nbits > 0, "entropy encode");
    long ok = tic_entropy_decode(payload, nbits, NB, dc_lut_len, dc_lut_sym,
                                 ac_lut_len, ac_lut_sym, dc2, ac2);
    CHECK(ok == NB, "decode block count");
    CHECK(memcmp(dc, dc2, sizeof dc) == 0, "dc roundtrip");
    CHECK(memcmp(ac, ac2, sizeof ac) == 0, "ac roundtrip");

    /* 2) exact-capacity encode succeeds; one byte less fails cleanly */
    long tight = (nbits + 7) / 8;
    uint8_t *tightbuf = calloc(tight, 1);
    CHECK(tightbuf != NULL, "alloc tight");
    CHECK(tic_entropy_encode(dc, ac, NB, dc_code, dc_len, ac_code, ac_len,
                             tightbuf, tight) == nbits,
          "exact-capacity encode");
    free(tightbuf);
    if (tight > 1) {
        uint8_t *small = calloc(tight - 1, 1);
        CHECK(small != NULL, "alloc small");
        CHECK(tic_entropy_encode(dc, ac, NB, dc_code, dc_len, ac_code,
                                 ac_len, small, tight - 1) == -1,
              "undersized encode returns -1");
        free(small);
    }

    /* 3) stitch vs naive appender on ragged random rows */
    enum { SN = 100, STRIDE = 52 };
    static uint32_t rows[SN * STRIDE];
    static int32_t rbits[SN];
    long total_bits = 0;
    for (int i = 0; i < SN; i++) {
        rbits[i] = (int32_t)(lcg() % (STRIDE * 32 + 1));
        total_bits += rbits[i];
        /* bits past rbits[i] are random on purpose: the stitcher must
         * mask them out, and the oracle never reads them */
        for (int j = 0; j < STRIDE; j++) rows[i * STRIDE + j] = lcg();
    }
    long scap = total_bits / 8 + 8;
    uint8_t *sout = calloc(scap, 1);
    uint8_t *oracle = calloc(scap, 1);
    CHECK(sout && oracle, "alloc stitch");
    long written = tic_stitch(rows, rbits, SN, STRIDE, sout, scap);
    CHECK(written == (total_bits + 7) / 8, "stitch byte count");
    long bitpos = 0;
    for (int i = 0; i < SN; i++)
        naive_append(rows + i * STRIDE, rbits[i], oracle, &bitpos);
    CHECK(memcmp(sout, oracle, (size_t)written) == 0, "stitch oracle");
    CHECK(tic_stitch(rows, rbits, SN, STRIDE, sout, written - 1) == -1,
          "stitch capacity check");
    free(sout);
    free(oracle);

    /* 4) corrupt / truncated payload decode stays in bounds */
    for (int trial = 0; trial < 50; trial++) {
        long blen = 1 + (long)(lcg() % 400);
        uint8_t *junk = malloc(blen);
        CHECK(junk != NULL, "alloc junk");
        for (long i = 0; i < blen; i++) junk[i] = (uint8_t)lcg();
        memset(dc2, 0, sizeof dc2);
        memset(ac2, 0, sizeof ac2);
        long got = tic_entropy_decode(junk, blen * 8, NB, dc_lut_len,
                                      dc_lut_sym, ac_lut_len, ac_lut_sym,
                                      dc2, ac2);
        CHECK(got >= 0 && got <= NB, "junk decode bounds");
        /* truncated prefix of a valid stream */
        long cut = nbits / 2;
        got = tic_entropy_decode(payload, cut, NB, dc_lut_len, dc_lut_sym,
                                 ac_lut_len, ac_lut_sym, dc2, ac2);
        CHECK(got >= 0 && got < NB, "truncated decode bounds");
        free(junk);
    }

    /* 6) the batch entry point: the valid payload, a truncated one and
     * junk through the serial cursor, and the valid one as two chunks,
     * the second's start past the payload; int8 rows with lists of an
     * eighth of a stream's AC (the valid payload's overflows), then int16
     * rows.  Every row,
     * widened, must equal tic_entropy_decode's (the chunked stream: its
     * first half, then zeros). */
    enum { BS = 4, CAP = NB * 63 / 8 };
    static uint8_t junk6[300];
    for (int i = 0; i < 300; i++) junk6[i] = (uint8_t)lcg();
    int64_t starts6[2] = {0, nbits + 9};
    const uint8_t *bdata[BS] = {payload, payload, junk6, payload};
    long bbits[BS] = {nbits, nbits / 3, 300 * 8, nbits};
    int64_t plan[BS * 9];
    for (int s = 0; s < BS; s++) {
        int64_t *p = plan + s * 9;
        p[0] = (int64_t)(intptr_t)bdata[s];
        p[1] = bbits[s];
        p[2] = s == 3 ? (int64_t)(intptr_t)starts6 : 0;
        p[3] = 2;
        p[4] = (NB + 1) / 2;
        p[5] = (int64_t)(intptr_t)dc_lut_len;
        p[6] = (int64_t)(intptr_t)dc_lut_sym;
        p[7] = (int64_t)(intptr_t)ac_lut_len;
        p[8] = (int64_t)(intptr_t)ac_lut_sym;
    }
    static int16_t bdc[BS * NB], bac16[BS * NB * 63];
    static int8_t bac8[BS * NB * 63];
    static int64_t bidx[BS * CAP], bn[BS];
    static int16_t bval[BS * CAP];
    /* two calls share a cursor, as two threads would */
    int64_t cursor = 0;
    tic_entropy_decode_batch(plan, &cursor, BS, NB, 1, bdc, bac8, CAP, bidx,
                             bval, bn);
    CHECK(cursor > BS, "batch cursor spent");
    CHECK(tic_entropy_decode_batch(plan, &cursor, BS, NB, 1, bdc, bac8, CAP,
                                   bidx, bval, bn) == 0,
          "a spent cursor decodes nothing");
    CHECK(bn[0] == -1, "batch list overflow flagged");
    cursor = 0;
    tic_entropy_decode_batch(plan, &cursor, BS, NB, 2, bdc, bac16, 0, NULL,
                             NULL, NULL);
    for (int s = 0; s < BS; s++) {
        memset(dc2, 0, sizeof dc2);
        memset(ac2, 0, sizeof ac2);
        tic_entropy_decode(bdata[s], bbits[s], s == 3 ? (NB + 1) / 2 : NB,
                           dc_lut_len, dc_lut_sym, ac_lut_len, ac_lut_sym,
                           dc2, ac2);
        for (long i = 0; i < NB; i++) {
            CHECK(bdc[s * NB + i] == dc2[i], "batch dc");
            for (int k = 0; k < 63; k++) {
                long j = (s * NB + i) * 63 + k;
                CHECK(bac16[j] == ac2[i * 63 + k], "batch int16 ac");
                CHECK(bac8[j] == (int8_t)ac2[i * 63 + k], "batch int8 ac");
            }
        }
        CHECK(s == 0 || s == 3 || bn[s] >= 0, "batch list in range");
        if (s == 1) CHECK(bn[s] > 0, "batch outliers listed");
        if (bn[s] >= 0)
            for (long e = 0; e < bn[s]; e++) {
                long j = bidx[s * CAP + e] - (long)s * NB * 63;
                CHECK(j >= 0 && j < NB * 63, "batch outlier index");
                CHECK(bval[s * CAP + e] == ac2[j] - (int8_t)ac2[j],
                      "batch outlier delta");
            }
    }
    free(payload);

    /* 5) embedded encoder: roundtrip size + undersized capacity */
    enum { W = 64, H = 32 };
    static uint8_t pixels[W * H];
    for (int i = 0; i < W * H; i++) pixels[i] = (uint8_t)lcg();
    long ecap = 16 + W * H;
    uint8_t *eout = calloc(ecap, 1);
    CHECK(eout != NULL, "alloc embedded");
    long n = tic_embedded_encode(pixels, W, H, 2, eout, ecap);
    CHECK(n > 16, "embedded encode");
    long n2 = tic_embedded_encode(pixels, W, H, 2, eout, n - 1);
    CHECK(n2 < 0, "embedded undersized returns error");
    CHECK(tic_embedded_encode(pixels, W - 1, H, 2, eout, ecap) == -2,
          "embedded rejects non-multiple-of-8");
    free(eout);

    printf("selftest OK\n");
    return 0;
}
