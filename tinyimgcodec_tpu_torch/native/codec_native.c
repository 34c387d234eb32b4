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

/* The 16-bit peek LUTs of a stream: 65536 entries indexed by the next 16
 * bits; *_len gives the code length (0 = invalid), *_sym the decoded
 * symbol (DC: category; AC: run<<4|size). */
typedef struct {
    const uint8_t *dc_len, *dc_sym, *ac_len, *ac_sym;
} Luts;

/* Decode the block at the cursor into *dv and acbuf[0..62].  Returns 1,
 * with *big set where an AC value lies outside int8, or 0 where the
 * block is corrupt (the cursor then stays where the fault was found). */
static inline int decode_block(BitReader *br, const Luts *t, int32_t *dv,
                               int32_t *acbuf, int *big) {
    long nbits = br->nbits;
    /* DC */
    uint32_t peek = br_peek16(br);
    int len = t->dc_len[peek];
    if (len == 0 || br->pos + len > nbits) return 0;
    br->pos += len;
    int cat = t->dc_sym[peek];
    *dv = br_read_signed(br, cat);
    if (br->pos > nbits) return 0;
    /* AC: fill until EOB or 63 coefficients */
    int k = 0;
    uint32_t out8 = 0;
    memset(acbuf, 0, 64 * sizeof(int32_t));
    for (;;) {
        peek = br_peek16(br);
        len = t->ac_len[peek];
        if (len == 0 || br->pos + len > nbits) return 0;
        br->pos += len;
        int sym = t->ac_sym[peek];
        int run = sym >> 4, size = sym & 0xF;
        if (sym == 0x00) break; /* EOB */
        if (sym == 0xF0) {      /* ZRL: 16 zeros */
            k += 16;
            if (k > 63) return 0;
            continue;
        }
        k += run;
        int32_t v = br_read_signed(br, size);
        if (br->pos > nbits || k >= 63) return 0;
        acbuf[k++] = v;
        out8 |= (uint32_t)(v + 128) > 255u;
    }
    *big = out8 != 0;
    return 1;
}

/* Where decoded blocks go.  OUT_I32: int32 DC and AC rows (the arrays of
 * tic_entropy_decode*).  OUT_I8: the narrow upload form, int16 DC and
 * int8 AC (wrapped, as numpy's astype(int8) wraps), each AC value outside
 * int8 listed apart: its flat index (base + block * 63 + k) and its
 * delta from the wrapped value, while the list has room; n_exc counts
 * them all, and wide is set for a delta beyond int16.  OUT_I16: int16 DC
 * and AC. */
enum { OUT_I32, OUT_I8, OUT_I16 };

typedef struct {
    int kind;
    int32_t *dc32, *ac32;
    int16_t *dc16, *ac16;
    int8_t *ac8;
    int64_t *exc_idx;
    int16_t *exc_val;
    int64_t exc_base, exc_cap, n_exc;
    int wide;
} Out;

static inline void out_block(Out *o, long i, int32_t dv,
                             const int32_t *acbuf, int big) {
    if (o->kind == OUT_I32) {
        o->dc32[i] = dv;
        memcpy(o->ac32 + i * 63, acbuf, 63 * sizeof(int32_t));
        return;
    }
    o->dc16[i] = (int16_t)dv;
    if (o->kind == OUT_I16) {
        int16_t *row = o->ac16 + i * 63;
        for (int k = 0; k < 63; k++) row[k] = (int16_t)acbuf[k];
        return;
    }
    int8_t *row = o->ac8 + i * 63;
    for (int k = 0; k < 63; k++) row[k] = (int8_t)acbuf[k];
    if (!big) return;
    for (int k = 0; k < 63; k++) {
        int32_t d = acbuf[k] - (int8_t)acbuf[k];
        if (d == 0) continue;
        if (o->n_exc < o->exc_cap) {
            o->exc_idx[o->n_exc] = o->exc_base + i * 63 + k;
            o->exc_val[o->n_exc] = (int16_t)d;
        }
        o->n_exc++;
        if (d > 32767 || d < -32767) o->wide = 1;
    }
}

/* Blocks i .. i+n-1 all zero. */
static inline void out_zero(Out *o, long i, long n) {
    if (n <= 0) return;
    if (o->kind == OUT_I32) {
        memset(o->dc32 + i, 0, (size_t)n * sizeof(int32_t));
        memset(o->ac32 + i * 63, 0, (size_t)n * 63 * sizeof(int32_t));
        return;
    }
    memset(o->dc16 + i, 0, (size_t)n * sizeof(int16_t));
    if (o->kind == OUT_I16)
        memset(o->ac16 + i * 63, 0, (size_t)n * 63 * sizeof(int16_t));
    else
        memset(o->ac8 + i * 63, 0, (size_t)n * 63);
}

/* Decode nblocks blocks starting at bit `start` into blocks b0 ..
 * b0+nblocks-1 of `o`.  Returns the number of fully decoded blocks
 * (partial/corrupt blocks are left zero, matching the reference's
 * per-block try/except semantics, codec.py:178-186). */
static long entropy_decode_from(const uint8_t *data, long nbits, long start,
                                long nblocks, const Luts *t, Out *o,
                                long b0) {
    BitReader br = {data, nbits, (nbits + 7) / 8, start};
    long ok = 0;
    for (long i = 0; i < nblocks; i++) {
        long at = br.pos;
        int32_t dv, acbuf[64];
        int big;
        if (decode_block(&br, t, &dv, acbuf, &big)) {
            out_block(o, b0 + i, dv, acbuf, big);
            ok++;
            continue;
        }
        /* leave this block zero; try the next one from wherever the
         * cursor stopped (graceful degradation, SURVEY quirk 2.5-10) */
        out_zero(o, b0 + i, 1);
        if (br.pos <= at) br.pos = at + 1;
        if (br.pos > nbits) {
            out_zero(o, b0 + i + 1, nblocks - i - 1);
            break;
        }
    }
    return ok;
}

/* Chunks 0 .. nchunks-1 of an indexed stream: starts[c] is the payload
 * bit offset of block c*stride; a chunk whose start lies outside the
 * payload is left zero. */
static long decode_chunks(const uint8_t *data, long nbits,
                          const int64_t *starts, long nchunks, long stride,
                          long nblocks, const Luts *t, Out *o) {
    long ok = 0;
    for (long c = 0; c < nchunks; c++) {
        long b0 = c * stride;
        long nb = nblocks - b0;
        if (nb <= 0) break;
        if (nb > stride) nb = stride;
        long s = starts[c];
        if (s < 0 || s > nbits) {
            out_zero(o, b0, nb);
            continue;
        }
        ok += entropy_decode_from(data, nbits, s, nb, t, o, b0);
    }
    return ok;
}

static Out out_i32(int32_t *dc, int32_t *ac) {
    Out o = {0};
    o.kind = OUT_I32;
    o.dc32 = dc;
    o.ac32 = ac;
    return o;
}

EXPORT long tic_entropy_decode(const uint8_t *data, long nbits, long nblocks,
                               const uint8_t *dc_lut_len,
                               const uint8_t *dc_lut_sym,
                               const uint8_t *ac_lut_len,
                               const uint8_t *ac_lut_sym, int32_t *dc,
                               int32_t *ac) {
    Luts t = {dc_lut_len, dc_lut_sym, ac_lut_len, ac_lut_sym};
    Out o = out_i32(dc, ac);
    return entropy_decode_from(data, nbits, 0, nblocks, &t, &o, 0);
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
    Luts t = {dc_lut_len, dc_lut_sym, ac_lut_len, ac_lut_sym};
    Out o = out_i32(dc, ac);
    return entropy_decode_from(data, nbits, start_bit, nblocks, &t, &o, 0);
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
    Luts t = {dc_lut_len, dc_lut_sym, ac_lut_len, ac_lut_sym};
    Out o = out_i32(dc, ac);
    return decode_chunks(data, nbits, starts, nchunks, stride, nblocks, &t,
                         &o);
}

/* The columns of a row of tic_entropy_decode_batch's plan: one stream's
 * payload (address and bit length), its TICX chunk starts (address, 0
 * for the serial cursor; count; blocks a chunk) and its four LUTs. */
enum {
    P_DATA, P_NBITS, P_STARTS, P_NCHUNKS, P_STRIDE,
    P_DC_LEN, P_DC_SYM, P_AC_LEN, P_AC_SYM, P_COLS
};

/* A batch of n streams of nblocks blocks each, decoded straight into
 * their rows of the batch's upload form: dc (n, nblocks) int16; ac
 * (n, nblocks, 63) int8 where width is 1, int16 where it is 2.  Each
 * stream is decoded as tic_entropy_decode (no starts) or
 * tic_entropy_decode_chunks (starts) decodes it, every block written,
 * corrupt ones zero.  Width 1 lists each stream's AC values outside int8
 * in its row of exc_idx / exc_val (exc_cap entries a row; the flat index
 * into ac, and the value less its int8 wrap) and writes n_exc[s], the
 * count, or -1 where the row overflowed or a delta lies beyond int16:
 * the batch then goes up at width 2.  Several threads may call this at
 * once on one batch: each takes the next stream from *cursor until none
 * is left, so a thread that is slowed (a shared host) holds up only the
 * stream it is on.  Returns the fully decoded blocks of this call. */
EXPORT long tic_entropy_decode_batch(const int64_t *plan, int64_t *cursor,
                                     long n, long nblocks, int width,
                                     int16_t *dc, void *ac, long exc_cap,
                                     int64_t *exc_idx, int16_t *exc_val,
                                     int64_t *n_exc) {
    long ok = 0;
    for (;;) {
        long s = (long)__atomic_fetch_add(cursor, 1, __ATOMIC_RELAXED);
        if (s >= n) break;
        const int64_t *p = plan + s * P_COLS;
        const uint8_t *data = (const uint8_t *)(intptr_t)p[P_DATA];
        const int64_t *starts = (const int64_t *)(intptr_t)p[P_STARTS];
        long nbits = (long)p[P_NBITS];
        Luts t = {(const uint8_t *)(intptr_t)p[P_DC_LEN],
                  (const uint8_t *)(intptr_t)p[P_DC_SYM],
                  (const uint8_t *)(intptr_t)p[P_AC_LEN],
                  (const uint8_t *)(intptr_t)p[P_AC_SYM]};
        Out o = {0};
        o.dc16 = dc + s * nblocks;
        if (width == 1) {
            o.kind = OUT_I8;
            o.ac8 = (int8_t *)ac + s * nblocks * 63;
            o.exc_idx = exc_idx + s * exc_cap;
            o.exc_val = exc_val + s * exc_cap;
            o.exc_cap = exc_cap;
            o.exc_base = (int64_t)s * nblocks * 63;
        } else {
            o.kind = OUT_I16;
            o.ac16 = (int16_t *)ac + s * nblocks * 63;
        }
        if (starts) {
            long nchunks = (long)p[P_NCHUNKS], stride = (long)p[P_STRIDE];
            long covered = nchunks * stride;
            ok += decode_chunks(data, nbits, starts, nchunks, stride,
                                nblocks, &t, &o);
            if (covered < nblocks) out_zero(&o, covered, nblocks - covered);
        } else {
            ok += entropy_decode_from(data, nbits, 0, nblocks, &t, &o, 0);
        }
        if (width == 1)
            n_exc[s] = (o.n_exc > o.exc_cap || o.wide) ? -1 : o.n_exc;
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
