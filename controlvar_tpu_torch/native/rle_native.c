/* Native host-side data-path kernels: COCO RLE decode + instance-mask
 * colorization.
 *
 * The per-sample CPU hotspot when feeding ControlVAR training is rendering
 * pseudo-label masks: decode N compressed RLEs, compute each instance's
 * centroid, and paint a (H, W, 3) color mask (reference semantics:
 * datasets/imagenetC.py:15-29). This C implementation fuses decode +
 * centroid + paint into one pass over the runs, avoiding materializing
 * per-instance binary masks.
 *
 * Build: cc -O3 -shared -fPIC rle_native.c -o librle_native.so (done at first
 * use into build/native/ at the repository root).
 * Python binding: ctypes (controlvar_tpu_torch/native/__init__.py).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* Parse COCO compressed-RLE counts (5-bit LEB128-style chars, delta-coded
 * from the 3rd count). Returns number of counts, or -1 on overflow. */
static int64_t parse_counts(const char *s, int64_t max_counts, int64_t *cnts) {
    int64_t n = 0;
    const unsigned char *p = (const unsigned char *)s;
    while (*p) {
        int64_t x = 0;
        int k = 0, more = 1;
        while (more) {
            int64_t c = (int64_t)(*p) - 48;
            if (*p == 0) return -1;
            x |= (c & 0x1f) << (5 * k);
            more = (int)(c & 0x20);
            p++;
            k++;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (n > 2) x += cnts[n - 2];
        if (n >= max_counts) return -1;
        cnts[n++] = x;
    }
    return n;
}

/* Decode a single RLE into a (h, w) row-major uint8 mask. */
int rle_decode(const char *counts, int64_t h, int64_t w, uint8_t *out) {
    int64_t total = h * w;
    int64_t *cnts = (int64_t *)malloc(sizeof(int64_t) * (size_t)(total + 2));
    if (!cnts) return -1;
    int64_t n = parse_counts(counts, total + 2, cnts);
    if (n < 0) { free(cnts); return -2; }
    memset(out, 0, (size_t)total);
    int64_t pos = 0;           /* column-major position */
    uint8_t val = 0;
    for (int64_t i = 0; i < n && pos < total; i++) {
        int64_t run = cnts[i];
        if (run < 0) run = 0;
        if (val) {
            int64_t end = pos + run;
            if (end > total) end = total;
            for (int64_t p2 = pos; p2 < end; p2++) {
                out[(p2 % h) * w + (p2 / h)] = 1;   /* col-major -> row-major */
            }
        }
        pos += run;
        val ^= 1;
    }
    free(cnts);
    return 0;
}

/* Fused render: decode N instance RLEs (all h x w), skip area < min_area,
 * color by centroid grid cell: color = colormap[(cx_cell * cy_cell) % ncolors]
 * where cx_cell = floor(mean_x / (w / 11)), cy_cell likewise.
 * out: (h, w, 3) uint8, zero-initialized by caller or here. */
int render_mask(const char **counts_list, const double *areas, int64_t n_anns,
                int64_t h, int64_t w, const uint8_t *colormap, int64_t ncolors,
                double min_area, uint8_t *out) {
    int64_t total = h * w;
    memset(out, 0, (size_t)(total * 3));
    uint8_t *m = (uint8_t *)malloc((size_t)total);
    if (!m) return -1;
    for (int64_t a = 0; a < n_anns; a++) {
        if (areas[a] < min_area) continue;
        if (rle_decode(counts_list[a], h, w, m) != 0) { free(m); return -2; }
        /* centroid of set pixels */
        int64_t count = 0;
        double sx = 0.0, sy = 0.0;
        for (int64_t y = 0; y < h; y++) {
            const uint8_t *row = m + y * w;
            for (int64_t x = 0; x < w; x++) {
                if (row[x]) { count++; sx += (double)x; sy += (double)y; }
            }
        }
        if (count == 0) continue;
        int64_t cx = (int64_t)((sx / (double)count) / ((double)w / 11.0));
        int64_t cy = (int64_t)((sy / (double)count) / ((double)h / 11.0));
        const uint8_t *color = colormap + ((cx * cy) % ncolors) * 3;
        for (int64_t y = 0; y < h; y++) {
            const uint8_t *row = m + y * w;
            uint8_t *orow = out + y * w * 3;
            for (int64_t x = 0; x < w; x++) {
                if (row[x]) {
                    orow[x * 3 + 0] = color[0];
                    orow[x * 3 + 1] = color[1];
                    orow[x * 3 + 2] = color[2];
                }
            }
        }
    }
    free(m);
    return 0;
}
