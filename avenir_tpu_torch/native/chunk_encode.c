/* The schema encode: a delimited byte buffer into the encoder's matrices
 * in one pass, the only schema encode of the port.  It takes every
 * chunk of the chunked encode, every buffer of the shared scan and the
 * one-shot encode of a whole file with its id column; the parallelism
 * of a parse is the caller's (ingest.parse.threads), never this file's.
 *
 *   - the caller sizes the outputs by a row capacity (a chunk's line
 *     budget, the row count csv_scan gives, or a bound from the byte
 *     length); the pass skips blank lines, counts rows and returns the
 *     count, or CHUNK_OVERFLOW when the rows outnumber the capacity,
 *     before it writes past it;
 *   - it writes every output cell, so the caller allocates them
 *     uninitialised: a bin or a code in x, -1 in x for a float column,
 *     the raw value in values (0.0 for a categorical column), the class
 *     code in ycol, and a row's id, zero-padded to id_width bytes, in
 *     ids;
 *   - bins truncate toward zero with C '/' (Java's rule), a CR is
 *     stripped only at a line's end, blanks around integer fields are
 *     tolerated, and categorical codes are the buffer's own first-seen
 *     codes;
 *   - integer text in a float column (an optional sign, 1 to 15 digits,
 *     trailing blanks) converts exactly, with no strtod: every such
 *     value is below 2^53, so the double is the one strtod rounds to,
 *     and -0 gives -0.0 as strtod does.  Anything else goes through
 *     csv_ingest.c's parse_float_field;
 *   - the error codes are -2 unparseable, -3 max_uniq exceeded, -4 out of
 *     memory, -5 a ragged line.
 *
 * This file includes csv_ingest.c, so the two build as one translation
 * unit with one compiler call and share its field parsers and
 * categorical tables.
 */

#include "csv_ingest.c"

#ifdef __SSE2__
#include <emmintrin.h>
#endif

#define CHUNK_OVERFLOW (-6)

/* The column roles (col_type) */
enum { ROLE_SKIP = 0, ROLE_BUCKET = 1, ROLE_FLOAT = 2, ROLE_ID = 3,
       ROLE_CAT = 4 };

/* Where the fields end: a bit mask of the stop bytes ('\n' and the
 * delimiter) of one 64-byte block at a time, taken sixteen bytes to an
 * instruction where SSE2 is there, and handed out in order, so a field's
 * end costs a count of trailing zeros and not a test of each byte. */
typedef struct {
    const char *blk;     /* the current block */
    const char *end;
    uint64_t mask;       /* its stop bytes not yet handed out */
    char delim;
} StopScan;

static inline uint64_t stop_mask64(const char *p, const char *end,
                                   char delim) {
    uint64_t m = 0;
#ifdef __SSE2__
    if (end - p >= 64) {
        const __m128i nl = _mm_set1_epi8('\n'), dl = _mm_set1_epi8(delim);
        for (int i = 0; i < 4; i++) {
            __m128i v = _mm_loadu_si128((const __m128i *)(p + 16 * i));
            __m128i e = _mm_or_si128(_mm_cmpeq_epi8(v, nl),
                                     _mm_cmpeq_epi8(v, dl));
            m |= (uint64_t)(uint16_t)_mm_movemask_epi8(e) << (16 * i);
        }
        return m;
    }
#endif
    long long n = end - p < 64 ? end - p : 64;
    for (long long k = 0; k < n; k++)
        m |= (uint64_t)(p[k] == '\n' || p[k] == delim) << k;
    return m;
}

static inline void stop_scan_init(StopScan *s, const char *buf,
                                  const char *end, char delim) {
    s->blk = buf;
    s->end = end;
    s->delim = delim;
    s->mask = buf < end ? stop_mask64(buf, end, delim) : 0;
}

/* The next stop byte not yet handed out, or the buffer's end. */
static inline const char *next_stop(StopScan *s) {
    while (!s->mask) {
        s->blk += 64;
        if (s->blk >= s->end) return s->end;
        s->mask = stop_mask64(s->blk, s->end, s->delim);
    }
    const char *q = s->blk + __builtin_ctzll(s->mask);
    s->mask &= s->mask - 1;
    return q;
}

/* Eight bytes as one word, where the host is little-endian: byte k of
 * the word is p[k].  Elsewhere the word forms are not taken. */
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
#define WORDS_LE 1
#else
#define WORDS_LE 0
#endif
#define ONES 0x0101010101010101ULL
#define HIGHS 0x8080808080808080ULL

static inline uint64_t load8(const char *p) {
    uint64_t w;
    memcpy(&w, p, 8);
    return w;
}

/* How many of w's bytes, from the first, are ASCII digits (0 to 8).  A
 * digit's high nibble is 3 and stays 3 after adding 6; no digit carries,
 * so the first byte that breaks either test is found exactly. */
static inline int lead_digits8(uint64_t w) {
    uint64_t hi = w & (ONES * 0xF0);
    uint64_t hi6 = ((w + ONES * 6) & (ONES * 0xF0)) >> 4;
    uint64_t nd = (hi | hi6) ^ (ONES * 0x33);
    uint64_t m = (((nd & ~HIGHS) + ~HIGHS) | nd) & HIGHS;
    return m ? __builtin_ctzll(m) >> 3 : 8;
}

/* The value of w's first n bytes, all digits (1 <= n <= 8): they move to
 * the top of the word behind leading zeros, then pairs, quads and
 * octets of digits combine in three multiplies. */
static inline long long digits_value8(uint64_t w, int n) {
    uint64_t v = (w << (8 * (8 - n))) & (ONES * 0x0F);
    v = (v * 2561) >> 8;
    v = ((v & 0x00FF00FF00FF00FFULL) * 6553601) >> 16;
    v = ((v & 0x0000FFFF0000FFFFULL) * 42949672960001ULL) >> 32;
    return (long long)v;
}

/* The common numeric field [p, fe): an optional minus and 1 to 8 digits,
 * with eight bytes readable before end.  Returns 1 with the digits'
 * value in *mag and the sign in *neg, or 0 for any other field. */
static inline int plain_int(const char *p, const char *fe, const char *end,
                            long long *mag, int *neg) {
    *neg = (p < fe && *p == '-');
    const char *d0 = p + *neg;
    long long n = fe - d0;
    if (!WORDS_LE || n < 1 || n > 8 || end - d0 < 8) return 0;
    uint64_t w = load8(d0);
    if (lead_digits8(w) < n) return 0;
    *mag = digits_value8(w, (int)n);
    return 1;
}

/* A bucket column's bin and value.  C '/' truncates toward zero (Java's
 * rule).  Where the value fits 32 bits and the width is 2 to 2^32 - 1,
 * the quotient of its magnitude is a multiply by div_m = 2^64 / w
 * rounded up, exact for every 32-bit dividend (Lemire, Kaser and Kurz,
 * "Faster remainder by direct computation", 2019, theorem 1). */
static inline void put_bin(int32_t *xr, double *vr, int j, long long v,
                           long long w, uint64_t div_m) {
#ifdef __SIZEOF_INT128__
    if (div_m && v == (int32_t)v) {
        uint32_t mag = (uint32_t)(v < 0 ? -v : v);
        uint32_t q = (uint32_t)(((unsigned __int128)div_m * mag) >> 64);
        xr[j] = v < 0 ? -(int32_t)q : (int32_t)q;
    } else
#endif
    xr[j] = (int32_t)(v / w);
    vr[j] = (double)v;
}

/* A categorical column's recent keys of up to 8 bytes, as words, in 64
 * direct-mapped entries: a key met again takes its code without the
 * table's hash and compare.  An entry holds a code the table gave. */
#define MEMO_BITS 6
typedef struct {
    uint64_t word;
    int len;                /* -1: empty */
    int code;
} CatMemo;

static inline int cat_code_memo(CatTable *t, CatMemo *memo, const char *buf,
                                const char *p, int flen, const char *end) {
    if (flen > 8) return cat_code(t, buf, p, flen);
    uint64_t w = 0;
    if (WORDS_LE && end - p >= 8)
        w = load8(p) & (flen == 8 ? ~0ULL : (1ULL << (8 * flen)) - 1);
    else
        for (int k = 0; k < flen; k++)
            w |= (uint64_t)(unsigned char)p[k] << (8 * k);
    CatMemo *m = &memo[((w ^ (uint64_t)flen) * 0x9E3779B97F4A7C15ULL)
                       >> (64 - MEMO_BITS)];
    if (m->len == flen && m->word == w) return m->code;
    int code = cat_code(t, buf, p, flen);
    if (code >= 0) {
        m->word = w;
        m->len = flen;
        m->code = code;
    }
    return code;
}

/* parse_float_field's result, with integer text converted exactly. */
static int parse_float_exact(const char *p, const char *e, double *out) {
    long long w = e - p;
    if (w <= 0 || w >= 64) return -1;   /* parse_float_field's limits */
    const char *q = p;
    int neg = 0;
    if (*q == '-' || *q == '+') { neg = (*q == '-'); q++; }
    const char *d0 = q;
    long long v = 0;
    while (q < e && (unsigned)(*q - '0') < 10u && q - d0 < 16) {
        v = v * 10 + (*q - '0');
        q++;
    }
    long long nd = q - d0;
    if (nd > 0 && nd <= 15) {
        while (q < e && (*q == ' ' || *q == '\t')) q++;
        if (q == e) {
            double d = (double)v;
            *out = neg ? -d : d;
            return 0;
        }
    }
    return parse_float_field(p, e, out);
}

/* Per file column (size n_cols): col_type 0 skip | 1 bucket | 2 float |
 * 3 id | 4 categorical; feat_idx the destination column of x and values
 * (-2 routes a categorical column to ycol); bucket_w the divisor of a
 * bucket column.  Every feature column 0..F-1 is the destination of
 * exactly one file column (the caller checks).  The id column, where
 * there is one, goes to ids, id_width bytes a row.  The k-th first-seen
 * unique of the i-th categorical column (in file order) is the byte
 * range uniq_start/uniq_len[i * max_uniq + k], and n_uniq[i] their
 * count.  Returns the row count (at most row_cap), or a negative code. */
long long chunk_encode(const char *buf, long long len, char delim,
                       int n_cols, const int *col_type, const int *feat_idx,
                       const long long *bucket_w, int F, long long row_cap,
                       int32_t *x, double *values, int32_t *ycol,
                       long long *uniq_start, int *uniq_len, int *n_uniq,
                       int max_uniq, char *ids, int id_width) {
    CatTable *tables = (CatTable *)calloc((size_t)n_cols, sizeof(CatTable));
    CatMemo *memo = (CatMemo *)malloc((size_t)n_cols * sizeof(CatMemo)
                                      << MEMO_BITS);
    uint64_t *div_m = (uint64_t *)calloc((size_t)n_cols, sizeof(uint64_t));
    if (!tables || !memo || !div_m) {
        free(tables); free(memo); free(div_m);
        return -4;
    }
    for (long long k = 0; k < (long long)n_cols << MEMO_BITS; k++)
        memo[k].len = -1;
    for (int c = 0; c < n_cols; c++)
        if (col_type[c] == ROLE_BUCKET && bucket_w[c] >= 2
            && bucket_w[c] <= UINT32_MAX)
            div_m[c] = UINT64_MAX / (uint64_t)bucket_w[c] + 1;
    long long rc = 0;
    int n_cat = 0;
    for (int c = 0; c < n_cols && !rc; c++)
        if (col_type[c] == ROLE_CAT) {
            long long off = (long long)n_cat++ * max_uniq;
            if (cat_init(&tables[c], uniq_start + off, uniq_len + off,
                         max_uniq))
                rc = -4;
        }

    const char *p = buf, *end = buf + len;
    StopScan scan;
    stop_scan_init(&scan, buf, end, delim);
    long long row = 0;
    while (!rc && p < end) {
        if (*p == '\n') {           /* a blank line: its stop byte */
            next_stop(&scan);
            p++;
            continue;
        }
        if (row >= row_cap) { rc = CHUNK_OVERFLOW; break; }
        int32_t *xr = x + row * F;
        double *vr = values + row * F;
        for (int c = 0;; c++) {
            const char *q = next_stop(&scan);
            int eol = (q == end || *q == '\n');
            const char *fe = q;     /* a CR before the line's end is not
                                     * the field's */
            if (eol && fe > p && fe[-1] == '\r') fe--;
            int t = col_type[c], j = feat_idx[c], neg;
            long long v;
            if (t == ROLE_BUCKET) {
                if (plain_int(p, fe, end, &v, &neg)) {
                    if (neg) v = -v;
                } else if (parse_int_field(p, fe, &v)) {
                    rc = -2;
                    break;
                }
                put_bin(xr, vr, j, v, bucket_w[c], div_m[c]);
            } else if (t == ROLE_FLOAT) {
                if (plain_int(p, fe, end, &v, &neg)) {
                    double d = (double)v;
                    vr[j] = neg ? -d : d;       /* -0 gives -0.0 */
                } else if (parse_float_exact(p, fe, &vr[j])) {
                    rc = -2;
                    break;
                }
                xr[j] = -1;
            } else if (t == ROLE_CAT) {
                int code = cat_code_memo(&tables[c],
                                         memo + ((long long)c << MEMO_BITS),
                                         buf, p, (int)(fe - p), end);
                if (code < 0) { rc = code == -1 ? -3 : -4; break; }
                if (j == -2) {
                    ycol[row] = code;
                } else {
                    xr[j] = code;
                    vr[j] = 0.0;
                }
            } else if (t == ROLE_ID) {
                long long fl = fe - p < id_width ? fe - p : id_width;
                char *dst = ids + row * id_width;
                memcpy(dst, p, (size_t)fl);
                memset(dst + fl, 0, (size_t)(id_width - fl));
            }
            if (eol) {
                if (c != n_cols - 1) rc = -5;        /* short row */
                p = q == end ? end : q + 1;
                break;
            }
            if (c == n_cols - 1) { rc = -5; break; } /* long row */
            p = q + 1;
        }
        row++;
    }

    n_cat = 0;
    for (int c = 0; c < n_cols; c++)
        if (col_type[c] == ROLE_CAT) {
            n_uniq[n_cat++] = tables[c].n;
            free(tables[c].slots);
        }
    free(tables);
    free(memo);
    free(div_m);
    return rc ? rc : row;
}
