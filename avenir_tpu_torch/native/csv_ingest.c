/* The port's CSV field parsers: a delimited text buffer into typed
 * columns, with no Python string objects.
 *
 * csv_scan counts a buffer's non-blank lines, checks that every line has
 * n_cols fields and records each column's widest field; csv_parse then
 * parses the columns a caller asks for into preallocated numpy buffers
 * (int64, float64 through strtod, fixed-width bytes).  The kNN column
 * parse and the shared scan's ChunkContext.columns take a job's columns
 * with them.  The field parsers (parse_int_field, parse_float_field) and
 * the first-seen categorical table (CatTable) are shared with the
 * schema encode, chunk_encode.c, which includes this file.
 *
 * Called from avenir_tpu_torch/native/__init__.py via ctypes.  Returns
 * negative codes instead of raising, so the Python caller can fall back
 * to its numpy path on malformed input.
 */

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
