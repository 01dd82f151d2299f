/* Native random-crop sequence batcher (the framework's host data-loader hot
 * path); the port's own copy of rqvae_tpu/native/batcher.c, the same code,
 * so one seed gives the same crops in both packages.
 *
 * Semantics mirror rqvae_tpu_torch/data/dataset.py::SeqDataset._subsample_row,
 * which itself mirrors the reference's train-time subsampling
 * (reference data/processed.py:139-147):
 *   seq   = row's valid item ids ++ [fut]
 *   start = U[0, max(0, len-3)]
 *   end   = U[start+3, start+max_seq_len+1]   (exclusive slice end)
 *   crop  = seq[start:end]; ids = crop[:-1] padded to max_seq_len with -1;
 *   target = crop[-1]
 *
 * The Python implementation is a per-row interpreter loop; this C version
 * is loaded via ctypes (rqvae_tpu_torch/native/__init__.py), and the Python
 * path runs only when RQVAE_TPU_DISABLE_NATIVE=1 asks for it.
 *
 * RNG: SplitMix64 per batch, cheap and reproducible for a given seed. The
 * crop distribution matches the Python path; the exact draws differ (this is
 * training-time randomness, not a determinism contract).
 */
#include <stdint.h>
#include <stddef.h>

static inline uint64_t splitmix64(uint64_t *s) {
    uint64_t z = (*s += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

/* uniform integer in [lo, hi] inclusive */
static inline int64_t randint(uint64_t *s, int64_t lo, int64_t hi) {
    if (hi <= lo) return lo;
    return lo + (int64_t)(splitmix64(s) % (uint64_t)(hi - lo + 1));
}

/* item_ids: (n_rows, row_len) int32, -1 padded
 * fut:      (n_rows,) int32
 * idx:      (batch,) int64 row indices
 * out_ids:  (batch, max_seq_len) int32 (written)
 * out_fut:  (batch,) int32 (written)
 */
void subsample_batch(const int32_t *item_ids, const int32_t *fut,
                     int64_t n_rows, int64_t row_len,
                     const int64_t *idx, int64_t batch,
                     int64_t max_seq_len, uint64_t seed,
                     int32_t *out_ids, int32_t *out_fut) {
    uint64_t state = seed ^ 0xD1B54A32D192ED03ULL;
    (void)n_rows;
    for (int64_t b = 0; b < batch; ++b) {
        const int32_t *row = item_ids + idx[b] * row_len;
        /* count valid prefix (rows are -1 padded at the tail) */
        int64_t n = 0;
        while (n < row_len && row[n] >= 0) n++;
        int64_t len = n + 1; /* ++ [fut] */

        int64_t start = randint(&state, 0, len - 3 > 0 ? len - 3 : 0);
        int64_t end = randint(&state, start + 3, start + max_seq_len + 1);
        if (end > len) end = len;
        if (end < start + 1) end = start + 1; /* at least the target */

        int64_t n_hist = end - start - 1; /* crop[:-1] */
        if (n_hist > max_seq_len) n_hist = max_seq_len;
        int32_t *out_row = out_ids + b * max_seq_len;
        for (int64_t j = 0; j < n_hist; ++j) {
            int64_t p = start + j;
            out_row[j] = (p < n) ? row[p] : fut[idx[b]];
        }
        for (int64_t j = n_hist; j < max_seq_len; ++j) out_row[j] = -1;
        int64_t t = end - 1;
        out_fut[b] = (t < n) ? row[t] : fut[idx[b]];
    }
}
