/* Native host runtime for tinyimgcodec_tpu.
 *
 * TPU-native counterpart of the reference's embedded C components
 * (reference c/img.c, c/fifo.c): the device does the parallel math; this
 * module covers the inherently-serial host work at memory speed:
 *
 *   - tic_stitch: concatenate ragged per-block/per-shard bit buffers
 *     (device packing output) into the final byte stream.
 *   - tic_entropy_decode: LUT-based Huffman+RLE decode of a payload into
 *     (dc, ac) coefficient arrays.  One 16-bit peek resolves any code
 *     (max code length 16) in O(1), replacing the reference's
 *     bit-at-a-time Python loop (reference huffman.py:66-74, ~86% of its
 *     decode time per SURVEY 3.2).
 *
 * Exposed via ctypes (no pybind11 dependency); see native/__init__.py.
 */

#include <stdint.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

/* ------------------------------------------------------------------ */
/* Ragged bit-buffer concatenation                                     */
/* ------------------------------------------------------------------ */

/* words: n rows of stride uint32 big-endian bit buffers (bit 0 = MSB of
 * word 0); bits[i] = valid bits in row i.  Appends all rows' bits in
 * order into out (byte buffer, zero-padded tail).  Returns the number of
 * bytes written, or -1 if out_capacity would be exceeded. */
EXPORT long tic_stitch(const uint32_t *words, const int32_t *bits, long n,
                       long stride, uint8_t *out, long out_capacity) {
    uint64_t acc = 0;  /* bit accumulator, MSB-first, acc_bits valid */
    int acc_bits = 0;
    long out_pos = 0;
    for (long i = 0; i < n; i++) {
        const uint32_t *row = words + i * stride;
        int32_t remaining = bits[i];
        long w = 0;
        while (remaining > 0) {
            int take = remaining >= 32 ? 32 : remaining;
            uint32_t v = row[w++];
            /* keep the top `take` bits of v */
            uint64_t chunk = (uint64_t)(v >> (32 - take));
            acc = (acc << take) | chunk;
            acc_bits += take;
            remaining -= take;
            while (acc_bits >= 8) {
                if (out_pos >= out_capacity) return -1;
                out[out_pos++] = (uint8_t)(acc >> (acc_bits - 8));
                acc_bits -= 8;
            }
        }
    }
    if (acc_bits > 0) {
        if (out_pos >= out_capacity) return -1;
        out[out_pos++] = (uint8_t)(acc << (8 - acc_bits));
    }
    return out_pos;
}

/* ------------------------------------------------------------------ */
/* Entropy decode                                                      */
/* ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *data;
    long nbits;
    long nbytes;
    long pos;
} BitReader;

static inline uint32_t br_peek16(const BitReader *br) {
    /* 16 bits starting at pos, zero-padded past the end */
    long byte = br->pos >> 3;
    int shift = (int)(br->pos & 7);
    uint32_t v;
    if (byte + 3 <= br->nbytes) {
        v = ((uint32_t)br->data[byte] << 16) |
            ((uint32_t)br->data[byte + 1] << 8) |
            (uint32_t)br->data[byte + 2];
    } else {
        v = 0;
        for (int k = 0; k < 3; k++) {
            long idx = byte + k;
            uint8_t b = idx < br->nbytes ? br->data[idx] : 0;
            v = (v << 8) | b;
        }
    }
    return (v >> (8 - shift)) & 0xFFFF;
}

static inline int32_t br_read_signed(BitReader *br, int size) {
    /* JPEG signed magnitude: leading 1 -> positive; else one's
     * complement negative (reference bitbuffer.py:56-66).  One 4-byte
     * window load instead of a bit-at-a-time loop: size <= 16 and the
     * bit phase <= 7, so the field always fits 32 loaded bits. */
    if (size == 0) return 0;
    if (br->pos + size > br->nbits) { br->pos = br->nbits + 1; return 0; }
    long byte = br->pos >> 3;
    int shift = (int)(br->pos & 7);
    uint32_t v;
    if (byte + 4 <= br->nbytes) {
        v = ((uint32_t)br->data[byte] << 24) |
            ((uint32_t)br->data[byte + 1] << 16) |
            ((uint32_t)br->data[byte + 2] << 8) |
            (uint32_t)br->data[byte + 3];
    } else {
        v = 0;
        for (int k = 0; k < 4; k++) {
            long idx = byte + k;
            uint8_t b = idx < br->nbytes ? br->data[idx] : 0;
            v = (v << 8) | b;
        }
    }
    uint32_t raw = (uint32_t)((v << shift) >> (32 - size));
    br->pos += size;
    if (raw >> (size - 1)) return (int32_t)raw;
    return -(int32_t)((~raw) & ((1u << size) - 1));
}

/* Decode nblocks blocks starting at bit `start`.  LUTs: 65536 entries
 * indexed by the next 16 bits; *_len gives the code length (0 =
 * invalid), *_sym the decoded symbol (DC: category; AC: run<<4|size).
 * Returns the number of fully decoded blocks (partial/corrupt blocks
 * are left zero, matching the reference's per-block try/except
 * semantics, codec.py:178-186). */
static long entropy_decode_from(const uint8_t *data, long nbits, long start,
                                long nblocks,
                                const uint8_t *dc_lut_len,
                                const uint8_t *dc_lut_sym,
                                const uint8_t *ac_lut_len,
                                const uint8_t *ac_lut_sym, int32_t *dc,
                                int32_t *ac) {
    BitReader br = {data, nbits, (nbits + 7) / 8, start};
    long ok = 0;
    for (long i = 0; i < nblocks; i++) {
        long start = br.pos;
        /* DC */
        uint32_t peek = br_peek16(&br);
        int len = dc_lut_len[peek];
        if (len == 0 || br.pos + len > nbits) goto corrupt;
        br.pos += len;
        int cat = dc_lut_sym[peek];
        int32_t dv = br_read_signed(&br, cat);
        if (br.pos > nbits) goto corrupt;
        /* AC: fill until EOB or 63 coefficients */
        int k = 0;
        int32_t acbuf[64];
        memset(acbuf, 0, sizeof(acbuf));
        for (;;) {
            peek = br_peek16(&br);
            len = ac_lut_len[peek];
            if (len == 0 || br.pos + len > nbits) goto corrupt;
            br.pos += len;
            int sym = ac_lut_sym[peek];
            int run = sym >> 4, size = sym & 0xF;
            if (sym == 0x00) break; /* EOB */
            if (sym == 0xF0) {      /* ZRL: 16 zeros */
                k += 16;
                if (k > 63) goto corrupt;
                continue;
            }
            k += run;
            int32_t v = br_read_signed(&br, size);
            if (br.pos > nbits || k >= 63) goto corrupt;
            acbuf[k++] = v;
        }
        dc[i] = dv;
        memcpy(ac + i * 63, acbuf, 63 * sizeof(int32_t));
        ok++;
        continue;
    corrupt:
        /* leave this block zero; try the next one from wherever the
         * cursor stopped (graceful degradation, SURVEY quirk 2.5-10) */
        dc[i] = 0;
        memset(ac + i * 63, 0, 63 * sizeof(int32_t));
        if (br.pos <= start) br.pos = start + 1;
        if (br.pos > nbits) {
            for (long j = i + 1; j < nblocks; j++) {
                dc[j] = 0;
                memset(ac + j * 63, 0, 63 * sizeof(int32_t));
            }
            break;
        }
    }
    return ok;
}

EXPORT long tic_entropy_decode(const uint8_t *data, long nbits, long nblocks,
                               const uint8_t *dc_lut_len,
                               const uint8_t *dc_lut_sym,
                               const uint8_t *ac_lut_len,
                               const uint8_t *ac_lut_sym, int32_t *dc,
                               int32_t *ac) {
    return entropy_decode_from(data, nbits, 0, nblocks, dc_lut_len,
                               dc_lut_sym, ac_lut_len, ac_lut_sym, dc, ac);
}

/* Chunked entry point for index-parallel decode: start at an arbitrary
 * bit offset (from a block-offset index; see container.py's trailing
 * TICX extension).  Caller decodes disjoint chunks concurrently. */
EXPORT long tic_entropy_decode_at(const uint8_t *data, long nbits,
                                  long start_bit, long nblocks,
                                  const uint8_t *dc_lut_len,
                                  const uint8_t *dc_lut_sym,
                                  const uint8_t *ac_lut_len,
                                  const uint8_t *ac_lut_sym, int32_t *dc,
                                  int32_t *ac) {
    if (start_bit < 0 || start_bit > nbits) {
        memset(dc, 0, (size_t)nblocks * sizeof(int32_t));
        memset(ac, 0, (size_t)nblocks * 63 * sizeof(int32_t));
        return 0;
    }
    return entropy_decode_from(data, nbits, start_bit, nblocks, dc_lut_len,
                               dc_lut_sym, ac_lut_len, ac_lut_sym, dc, ac);
}

/* Decode a run of indexed chunks in one call (ctypes/thread dispatch
 * overhead would otherwise dwarf the ~20 us of work per 64-block
 * chunk).  starts[c] is the payload bit offset of block c*stride;
 * callers split the chunk range across threads, one call per thread. */
EXPORT long tic_entropy_decode_chunks(
    const uint8_t *data, long nbits, const int64_t *starts, long nchunks,
    long stride, long nblocks, const uint8_t *dc_lut_len,
    const uint8_t *dc_lut_sym, const uint8_t *ac_lut_len,
    const uint8_t *ac_lut_sym, int32_t *dc, int32_t *ac) {
    long ok = 0;
    for (long c = 0; c < nchunks; c++) {
        long b0 = c * stride;
        long nb = nblocks - b0;
        if (nb <= 0) break;
        if (nb > stride) nb = stride;
        long s = starts[c];
        if (s < 0 || s > nbits) continue; /* outputs stay zero */
        ok += entropy_decode_from(data, nbits, s, nb, dc_lut_len,
                                  dc_lut_sym, ac_lut_len, ac_lut_sym,
                                  dc + b0, ac + b0 * 63);
    }
    return ok;
}

/* ------------------------------------------------------------------ */
/* Entropy encode (host fallback / CPU reference for the device path)  */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t *out;
    long capacity;
    long pos_bits;
} BitWriterC;

static inline int bw_put(BitWriterC *bw, uint32_t value, int nbits) {
    if (nbits == 0) return 0;
    long end = bw->pos_bits + nbits;
    if (end > bw->capacity * 8) return -1;
    for (int k = nbits - 1; k >= 0; k--) {
        long p = bw->pos_bits++;
        if ((value >> k) & 1) bw->out[p >> 3] |= (uint8_t)(0x80u >> (p & 7));
    }
    return 0;
}

static inline int bitlen_u32(uint32_t v) {
    return v ? 32 - __builtin_clz(v) : 0;
}

/* Encode nblocks blocks of (dc diff, 63 zig-zag AC) into out.
 * Code tables: dc_code/dc_len indexed by category (12), ac_code/ac_len
 * indexed by run*11+size (176).  Returns payload bit length or -1. */
EXPORT long tic_entropy_encode(const int32_t *dc, const int32_t *ac,
                               long nblocks, const uint32_t *dc_code,
                               const uint8_t *dc_len,
                               const uint32_t *ac_code,
                               const uint8_t *ac_len, uint8_t *out,
                               long out_capacity) {
    BitWriterC bw = {out, out_capacity, 0};
    memset(out, 0, out_capacity);
    for (long i = 0; i < nblocks; i++) {
        int32_t d = dc[i];
        uint32_t mag = (uint32_t)(d < 0 ? -d : d);
        int cat = bitlen_u32(mag);
        if (cat > 11) return -1;
        if (bw_put(&bw, dc_code[cat], dc_len[cat])) return -1;
        if (cat) {
            uint32_t bits = d < 0 ? (~mag) & ((1u << cat) - 1) : mag;
            if (bw_put(&bw, bits, cat)) return -1;
        }
        const int32_t *row = ac + i * 63;
        int last = -1;
        for (int k = 62; k >= 0; k--)
            if (row[k]) { last = k; break; }
        int run = 0;
        for (int k = 0; k <= last; k++) {
            if (row[k] == 0) { run++; continue; }
            while (run >= 16) {
                if (bw_put(&bw, ac_code[15 * 11 + 0], ac_len[15 * 11 + 0]))
                    return -1; /* ZRL */
                run -= 16;
            }
            uint32_t m = (uint32_t)(row[k] < 0 ? -row[k] : row[k]);
            int size = bitlen_u32(m);
            if (size > 10) return -1;
            int idx = run * 11 + size;
            if (bw_put(&bw, ac_code[idx], ac_len[idx])) return -1;
            uint32_t bits = row[k] < 0 ? (~m) & ((1u << size) - 1) : m;
            if (bw_put(&bw, bits, size)) return -1;
            run = 0;
        }
        if (bw_put(&bw, ac_code[0], ac_len[0])) return -1; /* EOB */
    }
    return bw.pos_bits;
}
