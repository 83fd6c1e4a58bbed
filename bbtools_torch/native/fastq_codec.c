/* fastq_codec.c — native FASTQ record scanner + base/qual gatherer.
 *
 * The host-side analog of the reference's ByteFile/FASTQ fast paths
 * (fileIO/ByteFile2, stream/FASTQ.java): one pass over a raw byte block
 * finds the 4-line record boundaries; a second pass fills the padded
 * SoA matrices (2-bit base codes with N=4, phred-adjusted quals) that
 * ship to the device. Exposed via ctypes (no pybind11 in this image);
 * bbtools_tpu/native/__init__.py compiles it on first use with cc -O3.
 *
 * Everything is plain C99; buffers are caller-allocated numpy arrays.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* Scan `buf[0..n)` for newline positions; writes line-end offsets into
 * `ends` (capacity `cap`). Returns the number of newlines found. */
long scan_newlines(const uint8_t *buf, long n, long *ends, long cap) {
    long count = 0;
    for (long i = 0; i < n && count < cap; i++) {
        if (buf[i] == '\n') {
            ends[count++] = i;
        }
    }
    return count;
}

/* Fill padded record matrices for `nrec` FASTQ records.
 *
 * line_starts/line_ends: 4*nrec line spans (header, seq, plus, qual),
 * ends exclusive of the newline (and of a trailing \r).
 * Outputs (caller-allocated):
 *   bases  [nrec * pad]  2-bit codes, undefined = 4, padding = 4
 *   quals  [nrec * pad]  phred (qual byte - offset, clamped 0..93)
 *   ascii  [nrec * pad]  raw sequence bytes, padding = 'N'
 *   lengths[nrec]
 * Returns 0, or -1 if any record's seq/qual lengths mismatch.
 */
int fill_records(const uint8_t *buf,
                 const long *line_starts, const long *line_ends,
                 long nrec, long pad, int qual_offset,
                 uint8_t *bases, uint8_t *quals, uint8_t *ascii,
                 int32_t *lengths) {
    static uint8_t lut[256];
    static int lut_init = 0;
    if (!lut_init) {
        memset(lut, 4, 256);
        lut['A'] = lut['a'] = 0;
        lut['C'] = lut['c'] = 1;
        lut['G'] = lut['g'] = 2;
        lut['T'] = lut['t'] = 3;
        lut['U'] = lut['u'] = 3;
        lut_init = 1;
    }
    int rc = 0;
    for (long r = 0; r < nrec; r++) {
        long ss = line_starts[4 * r + 1], se = line_ends[4 * r + 1];
        long qs = line_starts[4 * r + 3], qe = line_ends[4 * r + 3];
        long len = se - ss;
        if (qe - qs != len) rc = -1;
        if (len > pad) len = pad;
        lengths[r] = (int32_t)len;
        uint8_t *brow = bases + r * pad;
        uint8_t *qrow = quals ? quals + r * pad : 0;
        uint8_t *arow = ascii ? ascii + r * pad : 0;
        long i = 0;
        for (; i < len; i++) {
            uint8_t c = buf[ss + i];
            if (arow) arow[i] = c;
            brow[i] = lut[c];
            if (qrow) {
                int q = (int)buf[qs + i] - qual_offset;
                if (q < 0) q = 0;
                if (q > 93) q = 93;
                qrow[i] = (uint8_t)q;
            }
        }
        for (; i < pad; i++) {
            brow[i] = 4;
            if (qrow) qrow[i] = 0;
            if (arow) arow[i] = 'N';
        }
    }
    return rc;
}

/* Pack 2-bit base codes 4-per-byte with a 1-bit-per-base N mask
 * (the wire format of ops/encode.py). bases [n*pad] -> packed
 * [n*ceil(pad/4)], nmask [n*ceil(pad/8)]. */
void pack_2bit(const uint8_t *bases, long n, long pad,
               uint8_t *packed, uint8_t *nmask) {
    long pb = (pad + 3) / 4, nb = (pad + 7) / 8;
    for (long r = 0; r < n; r++) {
        const uint8_t *row = bases + r * pad;
        uint8_t *prow = packed + r * pb;
        uint8_t *mrow = nmask + r * nb;
        memset(prow, 0, pb);
        memset(mrow, 0, nb);
        for (long i = 0; i < pad; i++) {
            uint8_t c = row[i];
            uint8_t two = (c < 4) ? c : 0;
            prow[i >> 2] |= (uint8_t)(two << ((i & 3) * 2));
            if (c >= 4) mrow[i >> 3] |= (uint8_t)(1 << (i & 7));
        }
    }
}

/* ---- threaded drivers (reference runs its codec on worker threads;
 * these shard record ranges over pthreads) ---- */

#include <pthread.h>
#include <unistd.h>

/* MT newline scan (fileIO/ByteFile2's MT line reader role): pass 1
 * memchr-counts newlines per chunk, pass 2 fills (start, end) line
 * spans with \r stripping. Returns the number of lines found. */
typedef struct {
    const uint8_t *buf;
    long lo, hi;     /* byte range */
    long count;      /* pass-1 result */
    long base;       /* pass-2: output slot of this chunk's first line */
    long *starts, *ends;
} scan_job;

static void *scan_count_worker(void *arg) {
    scan_job *j = (scan_job *)arg;
    const uint8_t *p = j->buf + j->lo, *end = j->buf + j->hi;
    long c = 0;
    while (p < end) {
        const uint8_t *q = memchr(p, '\n', (size_t)(end - p));
        if (!q) break;
        c++;
        p = q + 1;
    }
    j->count = c;
    return 0;
}

static void *scan_fill_worker(void *arg) {
    scan_job *j = (scan_job *)arg;
    const uint8_t *buf = j->buf;
    const uint8_t *p = buf + j->lo, *end = buf + j->hi;
    long w = j->base;
    long line_start = j->lo; /* overwritten below from prev newline */
    while (p < end) {
        const uint8_t *q = memchr(p, '\n', (size_t)(end - p));
        if (!q) break;
        long nl = (long)(q - buf);
        long e = nl;
        if (e > line_start && buf[e - 1] == '\r') e--;
        j->starts[w] = line_start;
        j->ends[w] = e;
        w++;
        line_start = nl + 1;
        p = q + 1;
    }
    return 0;
}

long count_newlines_mt(const uint8_t *buf, long n, int nthreads) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if (n < (1 << 20)) nthreads = 1;
    scan_job jobs[16];
    pthread_t tids[16];
    long per = (n + nthreads - 1) / nthreads;
    int nt = 0;
    for (int t = 0; t < nthreads; t++) {
        long lo = t * per, hi = lo + per;
        if (lo >= n) break;
        if (hi > n) hi = n;
        jobs[t] = (scan_job){buf, lo, hi, 0, 0, 0, 0};
        nt++;
    }
    if (nt == 1) {
        scan_count_worker(&jobs[0]);
        return jobs[0].count;
    }
    for (int t = 0; t < nt; t++)
        pthread_create(&tids[t], 0, scan_count_worker, &jobs[t]);
    long total = 0;
    for (int t = 0; t < nt; t++) {
        pthread_join(tids[t], 0);
        total += jobs[t].count;
    }
    return total;
}

long scan_lines_mt(const uint8_t *buf, long n, long *starts, long *ends,
                   int nthreads) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if (n < (1 << 20)) nthreads = 1;
    scan_job jobs[16];
    pthread_t tids[16];
    long per = (n + nthreads - 1) / nthreads;
    int nt = 0;
    for (int t = 0; t < nthreads; t++) {
        long lo = t * per, hi = lo + per;
        if (lo >= n) break;
        if (hi > n) hi = n;
        jobs[t] = (scan_job){buf, lo, hi, 0, 0, starts, ends};
        nt++;
    }
    if (nt == 1) {
        scan_count_worker(&jobs[0]);
        jobs[0].base = 0;
        /* line_start of chunk 0 is 0 (set in fill via j->lo) */
        scan_fill_worker(&jobs[0]);
        return jobs[0].count;
    }
    for (int t = 0; t < nt; t++)
        pthread_create(&tids[t], 0, scan_count_worker, &jobs[t]);
    for (int t = 0; t < nt; t++) pthread_join(tids[t], 0);
    long total = 0;
    for (int t = 0; t < nt; t++) {
        jobs[t].base = total;
        total += jobs[t].count;
    }
    /* pass 2: each chunk needs the true start of its first line = one
     * past the previous chunk's last newline; chunk t's lines begin
     * after the newline that ended chunk t-1's last counted line. The
     * fill worker derives starts from its own newline walk, except the
     * FIRST line of each chunk, whose start lies in the previous chunk.
     * Fix up by walking backward from each chunk boundary. */
    for (int t = 0; t < nt; t++)
        pthread_create(&tids[t], 0, scan_fill_worker, &jobs[t]);
    for (int t = 0; t < nt; t++) pthread_join(tids[t], 0);
    /* repair first-line starts of chunks 1..nt-1 */
    for (int t = 1; t < nt; t++) {
        if (jobs[t].count == 0) continue;
        long slot = jobs[t].base;
        long s = jobs[t].lo;        /* chunk begin */
        long prev = s - 1;          /* last byte of previous chunk */
        /* previous newline is before s iff buf[s-1]=='\n'; otherwise the
         * line started inside the previous chunk: scan back to its \n */
        while (prev >= 0 && buf[prev] != '\n') prev--;
        long ls = prev + 1;
        long e = ends[slot];
        starts[slot] = ls;
        /* re-check \r for a \r\n straddling the chunk boundary (the
         * worker skipped the strip when the newline was its first byte) */
        if (e > ls && buf[e - 1] == '\r') ends[slot] = e - 1;
    }
    return total;
}

typedef struct {
    const uint8_t *buf;
    const long *line_starts;
    const long *line_ends;
    long r0, r1, pad;
    int qual_offset;
    uint8_t *bases, *quals, *ascii;
    int32_t *lengths;
    int rc;
} fill_job;

static void *fill_worker(void *arg) {
    fill_job *j = (fill_job *)arg;
    j->rc = fill_records(
        j->buf, j->line_starts + 4 * j->r0, j->line_ends + 4 * j->r0,
        j->r1 - j->r0, j->pad, j->qual_offset,
        j->bases + j->r0 * j->pad,
        j->quals ? j->quals + j->r0 * j->pad : 0,
        j->ascii ? j->ascii + j->r0 * j->pad : 0, j->lengths + j->r0);
    return 0;
}

int fill_records_mt(const uint8_t *buf,
                    const long *line_starts, const long *line_ends,
                    long nrec, long pad, int qual_offset,
                    uint8_t *bases, uint8_t *quals, uint8_t *ascii,
                    int32_t *lengths, int nthreads) {
    if (nthreads < 2 || nrec < 2048) {
        return fill_records(buf, line_starts, line_ends, nrec, pad,
                            qual_offset, bases, quals, ascii, lengths);
    }
    if (nthreads > 16) nthreads = 16;
    pthread_t tids[16];
    fill_job jobs[16];
    long per = (nrec + nthreads - 1) / nthreads;
    int nt = 0;
    for (int t = 0; t < nthreads; t++) {
        long r0 = t * per, r1 = r0 + per;
        if (r0 >= nrec) break;
        if (r1 > nrec) r1 = nrec;
        jobs[t] = (fill_job){buf, line_starts, line_ends, r0, r1, pad,
                             qual_offset, bases, quals, ascii, lengths, 0};
        pthread_create(&tids[t], 0, fill_worker, &jobs[t]);
        nt++;
    }
    int rc = 0;
    for (int t = 0; t < nt; t++) {
        pthread_join(tids[t], 0);
        if (jobs[t].rc) rc = jobs[t].rc;
    }
    return rc;
}

typedef struct {
    const uint8_t *bases;
    long r0, r1, pad;
    uint8_t *packed, *nmask;
} pack_job;

static void *pack_worker(void *arg) {
    pack_job *j = (pack_job *)arg;
    long pb = (j->pad + 3) / 4, nb = (j->pad + 7) / 8;
    pack_2bit(j->bases + j->r0 * j->pad, j->r1 - j->r0, j->pad,
              j->packed + j->r0 * pb, j->nmask + j->r0 * nb);
    return 0;
}

void pack_2bit_mt(const uint8_t *bases, long n, long pad,
                  uint8_t *packed, uint8_t *nmask, int nthreads) {
    if (nthreads < 2 || n < 2048) {
        pack_2bit(bases, n, pad, packed, nmask);
        return;
    }
    if (nthreads > 16) nthreads = 16;
    pthread_t tids[16];
    pack_job jobs[16];
    long per = (n + nthreads - 1) / nthreads;
    int nt = 0;
    for (int t = 0; t < nthreads; t++) {
        long r0 = t * per, r1 = r0 + per;
        if (r0 >= n) break;
        if (r1 > n) r1 = n;
        jobs[t] = (pack_job){bases, r0, r1, pad, packed, nmask};
        pthread_create(&tids[t], 0, pack_worker, &jobs[t]);
        nt++;
    }
    for (int t = 0; t < nt; t++) pthread_join(tids[t], 0);
}

/* Serialize kept records to FASTQ bytes: per record
 *   '@' id '\n' seq[0..len) '\n' '+' '\n' qual+qoff '\n'
 * idblob/idoff: concatenated id bytes with n+1 offsets.
 * Returns bytes written, or -1 if cap would overflow. */
long emit_fastq(const uint8_t *idblob, const long *idstart,
                const long *idend,
                const uint8_t *ascii, const uint8_t *quals,
                const int32_t *lengths, const uint8_t *keep,
                long n, long pad, int qoff, uint8_t *out, long cap) {
    long w = 0;
    for (long r = 0; r < n; r++) {
        if (keep && !keep[r]) continue;
        long idl = idend[r] - idstart[r];
        long m = lengths[r];
        if (m > pad) m = pad;
        long need = 1 + idl + 1 + m + 3 + m + 1;
        if (w + need > cap) return -1;
        out[w++] = '@';
        memcpy(out + w, idblob + idstart[r], (size_t)idl);
        w += idl;
        out[w++] = '\n';
        memcpy(out + w, ascii + r * pad, (size_t)m);
        w += m;
        out[w++] = '\n';
        out[w++] = '+';
        out[w++] = '\n';
        const uint8_t *qrow = quals + r * pad;
        for (long i = 0; i < m; i++) out[w + i] = (uint8_t)(qrow[i] + qoff);
        w += m;
        out[w++] = '\n';
    }
    return w;
}
