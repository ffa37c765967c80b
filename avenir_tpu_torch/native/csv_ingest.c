/* Native CSV ingest kernel: delimited text buffer -> typed columns.
 *
 * This is the framework's runtime-side replacement for the per-record text
 * parsing the reference delegates to Hadoop's LineRecordReader + per-mapper
 * String.split (every mapper, e.g.
 * src/main/java/org/avenir/bayesian/BayesianDistribution.java:137-143).  On
 * TPU the compute path is XLA; the ingest path is host-bound, so it is
 * implemented natively: two passes over the raw byte buffer, the first to
 * validate rectangularity and size the outputs, the second to parse fields
 * straight into preallocated NumPy buffers (int64 / float64 / fixed-width
 * bytes) with zero intermediate Python objects.
 *
 * Called from avenir_tpu/native/__init__.py via ctypes.  Returns negative
 * codes instead of raising so the Python caller can fall back to the
 * pure-NumPy path on any malformed input.
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <stdlib.h>

/* Pass 1: scan the buffer.  Counts non-empty lines, verifies every line has
 * exactly n_cols fields, and records the maximum field width per column
 * (used to size fixed-width bytes outputs).  Returns the row count, or -1
 * on a ragged line / column overflow. */
long long csv_scan(const char *buf, long long len, char delim, int n_cols,
                   int *max_width) {
    long long nrows = 0, i = 0;
    while (i < len) {
        if (buf[i] == '\n') { i++; continue; }
        int col = 0;
        long long fstart = i;
        for (;;) {
            if (i == len || buf[i] == '\n' || buf[i] == delim) {
                long long end = i;
                if (end > fstart && buf[end - 1] == '\r'
                    && (i == len || buf[i] == '\n'))
                    end--; /* CRLF: strip the CR at end of line only */
                if (col >= n_cols) return -1;
                long long w = end - fstart;
                if (w > max_width[col]) max_width[col] = (int)w;
                col++;
                if (i == len) break;
                char c = buf[i];
                i++;
                if (c == '\n') break;
                fstart = i;
            } else {
                i++;
            }
        }
        if (col != n_cols) return -1;
        nrows++;
    }
    return nrows;
}

/* Field parse helpers.  Leading/trailing blanks tolerated (matches Java's
 * trim-free Integer.parseInt failure behavior closely enough: junk -> error). */
static int parse_int_field(const char *p, const char *e, long long *out) {
    while (p < e && (*p == ' ' || *p == '\t')) p++;
    int neg = 0;
    if (p < e && (*p == '-' || *p == '+')) { neg = (*p == '-'); p++; }
    if (p == e) return -1;
    long long v = 0;
    for (; p < e; p++) {
        char c = *p;
        if (c < '0' || c > '9') {
            const char *q = p;
            while (q < e && (*q == ' ' || *q == '\t')) q++;
            if (q != e) return -1;
            break;
        }
        v = v * 10 + (c - '0');
    }
    *out = neg ? -v : v;
    return 0;
}

static int parse_float_field(const char *p, const char *e, double *out) {
    char tmp[64];
    long long w = e - p;
    if (w <= 0 || w >= (long long)sizeof(tmp)) return -1;
    memcpy(tmp, p, (size_t)w);
    tmp[w] = 0;
    char *endp;
    double d = strtod(tmp, &endp);
    while (*endp == ' ' || *endp == '\t') endp++;
    if (endp == tmp || *endp != 0) return -1;
    *out = d;
    return 0;
}

/* ------------------------------------------------------------------ */
/* Categorical hash table: first-seen code assignment over (ptr,len)
 * byte-string keys pointing into the input buffer (no copies).        */

typedef struct {
    long long *start;   /* caller-provided: uniq value byte offsets  */
    int *len;           /* caller-provided: uniq value byte lengths  */
    int n;              /* uniques so far                            */
    int cap;            /* capacity of start/len                     */
    int *slots;         /* open-addressed table: uniq index + 1      */
    int n_slots;        /* power of two                              */
} CatTable;

static unsigned long long hash_bytes(const char *p, int len) {
    unsigned long long h = 1469598103934665603ULL; /* FNV-1a */
    for (int i = 0; i < len; i++) {
        h ^= (unsigned char)p[i];
        h *= 1099511628211ULL;
    }
    return h;
}

static int cat_init(CatTable *t, long long *start, int *len, int cap) {
    t->start = start;
    t->len = len;
    t->n = 0;
    t->cap = cap;
    t->n_slots = 4096;
    t->slots = (int *)calloc((size_t)t->n_slots, sizeof(int));
    return t->slots ? 0 : -1;
}

static int cat_grow(CatTable *t, const char *buf) {
    int n_new = t->n_slots * 2;
    int *slots = (int *)calloc((size_t)n_new, sizeof(int));
    if (!slots) return -1;
    for (int k = 0; k < t->n; k++) {
        unsigned long long h =
            hash_bytes(buf + t->start[k], t->len[k]) & (n_new - 1);
        while (slots[h]) h = (h + 1) & (n_new - 1);
        slots[h] = k + 1;
    }
    free(t->slots);
    t->slots = slots;
    t->n_slots = n_new;
    return 0;
}

/* Returns the first-seen code for the field, or -1 (capacity) / -2 (oom). */
static int cat_code(CatTable *t, const char *buf, const char *p, int flen) {
    if ((long long)t->n * 10 >= (long long)t->n_slots * 7)
        if (cat_grow(t, buf)) return -2;
    unsigned long long h = hash_bytes(p, flen) & (t->n_slots - 1);
    while (t->slots[h]) {
        int idx = t->slots[h] - 1;
        if (t->len[idx] == flen && !memcmp(buf + t->start[idx], p, (size_t)flen))
            return idx;
        h = (h + 1) & (t->n_slots - 1);
    }
    if (t->n >= t->cap) return -1;
    t->start[t->n] = p - buf;
    t->len[t->n] = flen;
    t->slots[h] = ++t->n;
    return t->n - 1;
}

/* Schema-aware single-pass encode: the whole DatasetEncoder hot path.
 *
 * Per file column (size n_cols):
 *   col_type: 0 skip | 1 bucket-int | 2 float | 3 bytes | 4 categorical
 *   feat_idx: destination column j in x/values; -2 routes a categorical
 *             column's codes to ycol (the class attribute); -1 unused
 *             (bytes columns use bytes_out instead)
 *   bucket_w: divisor for type 1 (Java semantics: C '/' truncates toward
 *             zero, matching BayesianDistribution.java:153)
 * Outputs:
 *   x[n_rows, F] int32: bin index / categorical code per feature column
 *   values[n_rows, F] double: raw numeric value (types 1 and 2)
 *   ycol[n_rows] int32: class codes (feat_idx == -2)
 *   bytes_out[col]: fixed-width byte strings (type 3), width bytes_width[col]
 *   uniq_start/uniq_len[col * max_uniq + k]: k-th first-seen unique of a
 *     categorical column (byte range into buf); n_uniq[col] = count
 * Returns 0, or -2 unparseable numeric / -3 max_uniq exceeded / -4 oom /
 * -5 ragged line (column count != n_cols).  The ragged check runs here,
 * not only in csv_scan, because callers supplying a pre-counted row hint
 * skip the scan pass -- without it a short line would silently leave
 * zero/garbage cells and an extra field would index past the spec arrays.
 */
static int encode_range(const char *buf, long long start, long long len,
                        char delim, int n_cols,
                        const int *col_type, const int *feat_idx,
                        const long long *bucket_w, int F,
                        long long row_base, long long row_limit,
                        int32_t *x, double *values, int32_t *ycol,
                        void **bytes_out, const int *bytes_width,
                        CatTable *tables) {
    int rc = 0;
    long long row = row_base, i = start;
    while (!rc && i < len && row < row_limit) {
        if (buf[i] == '\n') { i++; continue; }
        int col = 0;
        long long fstart = i;
        for (;;) {
            if (i == len || buf[i] == '\n' || buf[i] == delim) {
                long long end = i;
                if (end > fstart && buf[end - 1] == '\r'
                    && (i == len || buf[i] == '\n'))
                    end--;
                if (col >= n_cols) { rc = -5; break; }
                int t = col_type[col];
                if (t == 1) {
                    long long v;
                    if (parse_int_field(buf + fstart, buf + end, &v)) {
                        rc = -2; break;
                    }
                    int j = feat_idx[col];
                    x[row * F + j] = (int32_t)(v / bucket_w[col]);
                    values[row * F + j] = (double)v;
                } else if (t == 2) {
                    double d;
                    if (parse_float_field(buf + fstart, buf + end, &d)) {
                        rc = -2; break;
                    }
                    values[row * F + feat_idx[col]] = d;
                } else if (t == 3) {
                    int w = bytes_width[col];
                    long long fl = end - fstart;
                    char *dst = (char *)bytes_out[col] + row * w;
                    if (fl > w) fl = w;
                    memcpy(dst, buf + fstart, (size_t)fl);
                    memset(dst + fl, 0, (size_t)(w - fl));
                } else if (t == 4) {
                    int code = cat_code(&tables[col], buf, buf + fstart,
                                        (int)(end - fstart));
                    if (code < 0) { rc = code == -1 ? -3 : -4; break; }
                    if (feat_idx[col] == -2)
                        ycol[row] = code;
                    else
                        x[row * F + feat_idx[col]] = code;
                }
                col++;
                if (i == len) break;
                char c = buf[i];
                i++;
                if (c == '\n') break;
                fstart = i;
            } else {
                i++;
            }
        }
        if (!rc && col != n_cols) rc = -5;
        row++;
    }
    return rc;
}


int csv_encode(const char *buf, long long len, char delim, int n_cols,
               const int *col_type, const int *feat_idx,
               const long long *bucket_w, int F, long long n_rows,
               int32_t *x, double *values, int32_t *ycol,
               void **bytes_out, const int *bytes_width,
               long long *uniq_start, int *uniq_len, int *n_uniq,
               int max_uniq) {
    CatTable *tables = (CatTable *)calloc((size_t)n_cols, sizeof(CatTable));
    if (!tables) return -4;
    int rc = 0;
    for (int c = 0; c < n_cols && !rc; c++)
        if (col_type[c] == 4)
            if (cat_init(&tables[c], uniq_start + (long long)c * max_uniq,
                         uniq_len + (long long)c * max_uniq, max_uniq))
                rc = -4;
    if (!rc)
        rc = encode_range(buf, 0, len, delim, n_cols, col_type, feat_idx,
                          bucket_w, F, 0, n_rows, x, values, ycol,
                          bytes_out, bytes_width, tables);
    for (int c = 0; c < n_cols; c++) {
        if (col_type[c] == 4) {
            n_uniq[c] = tables[c].n;
            free(tables[c].slots);
        }
    }
    free(tables);
    return rc;
}

/* ------------------------------------------------------------------ */
/* Multithreaded encode.
 *
 * Chunk the buffer at line boundaries; each thread encodes its rows with
 * THREAD-LOCAL categorical tables; then local vocabularies merge into the
 * global first-seen tables IN THREAD ORDER — which reproduces the serial
 * first-seen code assignment exactly, because every value a later chunk
 * contributes first-occurs after all occurrences in earlier chunks — and a
 * final parallel pass remaps local codes to global ones.               */

typedef struct {
    const char *buf;
    long long start, end;        /* byte range (line-aligned)           */
    long long row_base, n_rows;  /* global row offset / rows in chunk   */
    char delim;
    int n_cols;
    const int *col_type;
    const int *feat_idx;
    const long long *bucket_w;
    int F;
    int32_t *x;
    double *values;
    int32_t *ycol;
    void **bytes_out;
    const int *bytes_width;
    CatTable *tables;            /* thread-local, n_cols entries        */
    int *remap;                  /* [n_cat * max_uniq] local->global    */
    const int *cat_slot;         /* file col -> cat scratch slot (-1)   */
    int max_uniq;
    int rc;
} EncodeTask;

static void *count_worker(void *arg) {
    EncodeTask *t = (EncodeTask *)arg;
    long long n = 0;
    const char *p = t->buf + t->start, *e = t->buf + t->end;
    while (p < e) {
        const char *nl = (const char *)memchr(p, '\n', (size_t)(e - p));
        if (!nl) { if (e > p) n++; break; }
        if (nl > p) n++;          /* skip empty lines, matching csv_scan */
        p = nl + 1;
    }
    t->n_rows = n;
    return 0;
}

static void *encode_worker(void *arg) {
    EncodeTask *t = (EncodeTask *)arg;
    t->rc = encode_range(t->buf, t->start, t->end, t->delim, t->n_cols,
                         t->col_type, t->feat_idx, t->bucket_w, t->F,
                         t->row_base, t->row_base + t->n_rows,
                         t->x, t->values, t->ycol, t->bytes_out,
                         t->bytes_width, t->tables);
    return 0;
}

static void *remap_worker(void *arg) {
    EncodeTask *t = (EncodeTask *)arg;
    for (int c = 0; c < t->n_cols; c++) {
        if (t->col_type[c] != 4) continue;
        const int *rm = t->remap + (long long)t->cat_slot[c] * t->max_uniq;
        int j = t->feat_idx[c];
        if (j == -2) {
            for (long long r = t->row_base; r < t->row_base + t->n_rows; r++)
                t->ycol[r] = rm[t->ycol[r]];
        } else {
            for (long long r = t->row_base; r < t->row_base + t->n_rows; r++)
                t->x[r * t->F + j] = rm[t->x[r * t->F + j]];
        }
    }
    return 0;
}

int csv_encode_mt(const char *buf, long long len, char delim, int n_cols,
                  const int *col_type, const int *feat_idx,
                  const long long *bucket_w, int F, long long n_rows,
                  int32_t *x, double *values, int32_t *ycol,
                  void **bytes_out, const int *bytes_width,
                  long long *uniq_start, int *uniq_len, int *n_uniq,
                  int max_uniq, int n_threads) {
    if (n_threads < 2)
        return csv_encode(buf, len, delim, n_cols, col_type, feat_idx,
                          bucket_w, F, n_rows, x, values, ycol, bytes_out,
                          bytes_width, uniq_start, uniq_len, n_uniq,
                          max_uniq);
    int T = n_threads;
    /* scratch only for the categorical columns (not every file column) */
    int *cat_slot = (int *)malloc((size_t)n_cols * sizeof(int));
    int n_cat = 0;
    if (cat_slot)
        for (int c = 0; c < n_cols; c++)
            cat_slot[c] = (col_type[c] == 4) ? n_cat++ : -1;
    long long per_t = (long long)(n_cat ? n_cat : 1) * max_uniq;
    EncodeTask *tasks = (EncodeTask *)calloc((size_t)T, sizeof(EncodeTask));
    pthread_t *tids = (pthread_t *)calloc((size_t)T, sizeof(pthread_t));
    long long *lstart = (long long *)malloc(
        (size_t)T * per_t * sizeof(long long));
    int *llen = (int *)malloc((size_t)T * per_t * sizeof(int));
    int *remaps = (int *)malloc((size_t)T * per_t * sizeof(int));
    CatTable *all_tables =
        (CatTable *)calloc((size_t)T * n_cols, sizeof(CatTable));
    int rc = 0;
    if (!cat_slot || !tasks || !tids || !lstart || !llen || !remaps
        || !all_tables)
        rc = -4;

    /* line-aligned chunk boundaries */
    long long pos = 0;
    for (int t = 0; t < T && !rc; t++) {
        EncodeTask *tk = &tasks[t];
        tk->buf = buf; tk->delim = delim; tk->n_cols = n_cols;
        tk->col_type = col_type; tk->feat_idx = feat_idx;
        tk->bucket_w = bucket_w; tk->F = F;
        tk->x = x; tk->values = values; tk->ycol = ycol;
        tk->bytes_out = bytes_out; tk->bytes_width = bytes_width;
        tk->max_uniq = max_uniq;
        tk->tables = all_tables + (long long)t * n_cols;
        tk->remap = remaps + (long long)t * per_t;
        tk->cat_slot = cat_slot;
        tk->start = pos;
        long long target = len * (t + 1) / T;
        if (target < pos) target = pos;
        if (t == T - 1) target = len;
        else {
            const char *nl = (const char *)memchr(buf + target, '\n',
                                                  (size_t)(len - target));
            target = nl ? (nl - buf) + 1 : len;
        }
        tk->end = target;
        pos = target;
        for (int c = 0; c < n_cols && !rc; c++)
            if (col_type[c] == 4) {
                long long off = (long long)t * per_t
                    + (long long)cat_slot[c] * max_uniq;
                if (cat_init(&tk->tables[c], lstart + off, llen + off,
                             max_uniq))
                    rc = -4;
            }
    }

    /* round 1: count rows per chunk, prefix-sum into row bases */
    if (!rc) {
        int created = 0;
        for (int t = 0; t < T; t++, created++)
            if (pthread_create(&tids[t], 0, count_worker, &tasks[t])) {
                rc = -4; break;
            }
        for (int t = 0; t < created; t++) pthread_join(tids[t], 0);
    }
    if (!rc) {
        long long base = 0;
        for (int t = 0; t < T; t++) {
            tasks[t].row_base = base;
            base += tasks[t].n_rows;
        }
        if (base != n_rows) rc = -1;
    }

    /* round 2: parallel encode with thread-local vocabularies */
    if (!rc) {
        int created = 0;
        for (int t = 0; t < T; t++, created++)
            if (pthread_create(&tids[t], 0, encode_worker, &tasks[t])) {
                rc = -4; break;
            }
        for (int t = 0; t < created; t++) {
            pthread_join(tids[t], 0);
            if (tasks[t].rc) rc = tasks[t].rc;
        }
        if (created < T && !rc) rc = -4;
    }

    /* serial merge in thread order = global first-seen order */
    if (!rc) {
        CatTable *gtab = (CatTable *)calloc((size_t)n_cols, sizeof(CatTable));
        if (!gtab) rc = -4;
        for (int c = 0; c < n_cols && !rc; c++) {
            if (col_type[c] != 4) continue;
            if (cat_init(&gtab[c], uniq_start + (long long)c * max_uniq,
                         uniq_len + (long long)c * max_uniq, max_uniq)) {
                rc = -4; break;
            }
            for (int t = 0; t < T && !rc; t++) {
                CatTable *lt = &tasks[t].tables[c];
                int *rm = tasks[t].remap
                    + (long long)cat_slot[c] * max_uniq;
                for (int k = 0; k < lt->n; k++) {
                    int code = cat_code(&gtab[c], buf, buf + lt->start[k],
                                        lt->len[k]);
                    if (code < 0) { rc = code == -1 ? -3 : -4; break; }
                    rm[k] = code;
                }
            }
            n_uniq[c] = gtab[c].n;
        }
        if (gtab) {
            for (int c = 0; c < n_cols; c++)
                if (col_type[c] == 4) free(gtab[c].slots);
            free(gtab);
        }
    }

    /* round 3: parallel local->global code remap */
    if (!rc) {
        int created = 0;
        for (int t = 0; t < T; t++, created++)
            if (pthread_create(&tids[t], 0, remap_worker, &tasks[t])) {
                rc = -4; break;
            }
        for (int t = 0; t < created; t++) pthread_join(tids[t], 0);
        if (created < T && !rc) rc = -4;
    }

    if (all_tables)
        for (long long i = 0; i < (long long)T * n_cols; i++)
            free(all_tables[i].slots);
    free(all_tables); free(remaps); free(llen); free(lstart);
    free(tids); free(tasks); free(cat_slot);
    return rc;
}

/* Pass 2: parse fields into preallocated column buffers.
 *
 * col_type per column: 0 = skip, 1 = int64, 2 = float64, 3 = fixed-width
 * bytes (width[col] from csv_scan; short fields are zero-padded, matching
 * NumPy 'S' semantics).  outs[col] points at the column's buffer (NULL for
 * skipped columns).  Returns 0, or -2 on an unparseable numeric field. */
int csv_parse(const char *buf, long long len, char delim, int n_cols,
              const int *col_type, const int *width, void **outs,
              long long n_rows) {
    long long row = 0, i = 0;
    while (i < len && row < n_rows) {
        if (buf[i] == '\n') { i++; continue; }
        int col = 0;
        long long fstart = i;
        for (;;) {
            if (i == len || buf[i] == '\n' || buf[i] == delim) {
                long long end = i;
                if (end > fstart && buf[end - 1] == '\r'
                    && (i == len || buf[i] == '\n'))
                    end--;
                int t = col_type[col];
                if (t == 1) {
                    if (parse_int_field(buf + fstart, buf + end,
                                        &((long long *)outs[col])[row]))
                        return -2;
                } else if (t == 2) {
                    if (parse_float_field(buf + fstart, buf + end,
                                          &((double *)outs[col])[row]))
                        return -2;
                } else if (t == 3) {
                    int w = width[col];
                    long long fl = end - fstart;
                    char *dst = (char *)outs[col] + (long long)row * w;
                    if (fl > w) fl = w;
                    memcpy(dst, buf + fstart, (size_t)fl);
                    memset(dst + fl, 0, (size_t)(w - fl));
                }
                col++;
                if (i == len) break;
                char c = buf[i];
                i++;
                if (c == '\n') break;
                fstart = i;
            } else {
                i++;
            }
        }
        row++;
    }
    return 0;
}
