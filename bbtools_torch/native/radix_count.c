/* LSD radix sort + run-length count for 64-bit k-mer keys.
 *
 * The k-mer spectrum merge (ops/kmer_count.KmerSpectrum) needs sorted
 * (key, count) runs per batch. XLA's TPU sort on int64 measures ~7M
 * keys/s on a v5e (bitonic, emulated 64-bit); this host path does
 * 8-bit-digit LSD passes (skipping constant digits) at >100M keys/s,
 * mirroring the reference's C-accelerated hot loops (jni/ role).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* sorts keys in place (using scratch), returns number of unique runs;
 * out_vals/out_counts must have capacity n */
long radix_count(uint64_t *keys, long n, uint64_t *scratch,
                 uint64_t *out_vals, int64_t *out_counts) {
    if (n <= 0) return 0;
    uint64_t all_or = 0, all_and = ~0ULL;
    for (long i = 0; i < n; i++) { all_or |= keys[i]; all_and &= keys[i]; }
    uint64_t varying = all_or ^ all_and; /* digits where keys differ */
    uint64_t *src = keys, *dst = scratch;
    for (int pass = 0; pass < 8; pass++) {
        int shift = pass * 8;
        if (((varying >> shift) & 0xFF) == 0) continue; /* constant digit */
        long count[256] = {0};
        for (long i = 0; i < n; i++) count[(src[i] >> shift) & 0xFF]++;
        long pos[256];
        long acc = 0;
        for (int d = 0; d < 256; d++) { pos[d] = acc; acc += count[d]; }
        for (long i = 0; i < n; i++) dst[pos[(src[i] >> shift) & 0xFF]++] = src[i];
        uint64_t *t = src; src = dst; dst = t;
    }
    /* run-length count from src */
    long nu = 0;
    uint64_t cur = src[0];
    int64_t c = 1;
    for (long i = 1; i < n; i++) {
        if (src[i] == cur) { c++; }
        else { out_vals[nu] = cur; out_counts[nu] = c; nu++; cur = src[i]; c = 1; }
    }
    out_vals[nu] = cur; out_counts[nu] = c; nu++;
    return nu;
}

/* multi-word (W x int64 column-major rows) lexicographic sort + count:
 * rows are [n][W]; sorts by bytes of each word from least-significant
 * word up. Used by the exact big-k engine (ops/kmers2). Returns runs. */
long radix_count_w(uint64_t *rows, long n, int w, uint64_t *scratch,
                   uint64_t *out_vals, int64_t *out_counts) {
    if (n <= 0) return 0;
    uint64_t *src = rows, *dst = scratch;
    for (int word = w - 1; word >= 0; word--) {
        uint64_t all_or = 0, all_and = ~0ULL;
        for (long i = 0; i < n; i++) {
            uint64_t v = src[i * w + word];
            all_or |= v; all_and &= v;
        }
        uint64_t varying = all_or ^ all_and;
        for (int pass = 0; pass < 8; pass++) {
            int shift = pass * 8;
            if (((varying >> shift) & 0xFF) == 0) continue;
            long count[256] = {0};
            for (long i = 0; i < n; i++)
                count[(src[i * w + word] >> shift) & 0xFF]++;
            long pos[256];
            long acc = 0;
            for (int d = 0; d < 256; d++) { pos[d] = acc; acc += count[d]; }
            for (long i = 0; i < n; i++) {
                long p = pos[(src[i * w + word] >> shift) & 0xFF]++;
                memcpy(dst + p * w, src + i * w, w * sizeof(uint64_t));
            }
            uint64_t *t = src; src = dst; dst = t;
        }
    }
    long nu = 0;
    int64_t c = 1;
    const uint64_t *cur = src;
    for (long i = 1; i < n; i++) {
        if (memcmp(src + i * w, cur, w * sizeof(uint64_t)) == 0) { c++; }
        else {
            memcpy(out_vals + nu * w, cur, w * sizeof(uint64_t));
            out_counts[nu] = c; nu++;
            cur = src + i * w; c = 1;
        }
    }
    memcpy(out_vals + nu * w, cur, w * sizeof(uint64_t));
    out_counts[nu] = c; nu++;
    return nu;
}
