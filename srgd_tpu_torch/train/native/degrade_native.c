/* Native image ops for the training data pipeline's hot loop.
 *
 * The reference's data path is the (unreleased) torch DataLoader with
 * PIL/cv2-style transforms (SURVEY.md section 5.4, config.py:149-150); this is
 * the srgd-tpu native-runtime equivalent: plain C, no Python API, loaded via
 * ctypes (srgd_tpu/train/native/__init__.py builds it on demand with gcc).
 *
 * Ops operate on interleaved uint8 HWC buffers with float accumulation:
 *   - bicubic_resize: separable Keys cubic convolution (a = -0.5, the same
 *     kernel family PIL's BICUBIC uses)
 *   - gaussian_blur: separable exact Gaussian, radius = ceil(3*sigma),
 *     edge-clamped
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline float cubic_weight(float x) {
    /* Keys cubic convolution kernel, a = -0.5 */
    const float a = -0.5f;
    x = fabsf(x);
    if (x < 1.0f) {
        return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
    } else if (x < 2.0f) {
        return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
    }
    return 0.0f;
}

static inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static inline uint8_t clamp_u8(float v) {
    int i = (int)(v + 0.5f);
    return (uint8_t)(i < 0 ? 0 : (i > 255 ? 255 : i));
}

/* Resize one axis (rows) with the cubic kernel; src is (h, w, c) f32,
 * dst (out_h, w, c) f32. scale = h / out_h. */
static void cubic_resample_rows(const float *src, float *dst, int h, int w,
                                int c, int out_h) {
    double scale = (double)h / out_h;
    double support = scale > 1.0 ? 2.0 * scale : 2.0;
    int row_bytes = w * c;
    for (int oy = 0; oy < out_h; ++oy) {
        double center = (oy + 0.5) * scale - 0.5;
        int lo = (int)floor(center - support);
        int hi = (int)ceil(center + support);
        float wsum = 0.0f;
        /* accumulate into dst row */
        float *drow = dst + (size_t)oy * row_bytes;
        memset(drow, 0, sizeof(float) * row_bytes);
        for (int sy = lo; sy <= hi; ++sy) {
            float x = (float)((sy - center) / (scale > 1.0 ? scale : 1.0));
            float wt = cubic_weight(x);
            if (wt == 0.0f) continue;
            wsum += wt;
            const float *srow = src + (size_t)clampi(sy, 0, h - 1) * row_bytes;
            for (int i = 0; i < row_bytes; ++i) drow[i] += wt * srow[i];
        }
        if (wsum != 0.0f) {
            float inv = 1.0f / wsum;
            for (int i = 0; i < row_bytes; ++i) drow[i] *= inv;
        }
    }
}

/* Transpose (h, w, c) -> (w, h, c) */
static void transpose_hwc(const float *src, float *dst, int h, int w, int c) {
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            for (int k = 0; k < c; ++k)
                dst[((size_t)x * h + y) * c + k] = src[((size_t)y * w + x) * c + k];
}

void bicubic_resize(const uint8_t *src, int h, int w, int c,
                    uint8_t *dst, int out_h, int out_w) {
    size_t n_in = (size_t)h * w * c;
    float *f_in = (float *)malloc(sizeof(float) * n_in);
    float *f_rows = (float *)malloc(sizeof(float) * (size_t)out_h * w * c);
    float *f_t = (float *)malloc(sizeof(float) * (size_t)w * out_h * c);
    float *f_cols = (float *)malloc(sizeof(float) * (size_t)out_w * out_h * c);
    for (size_t i = 0; i < n_in; ++i) f_in[i] = (float)src[i];

    cubic_resample_rows(f_in, f_rows, h, w, c, out_h);        /* (out_h, w) */
    transpose_hwc(f_rows, f_t, out_h, w, c);                  /* (w, out_h) */
    cubic_resample_rows(f_t, f_cols, w, out_h, c, out_w);     /* (out_w, out_h) */

    /* transpose back to (out_h, out_w, c) and quantize */
    for (int y = 0; y < out_h; ++y)
        for (int x = 0; x < out_w; ++x)
            for (int k = 0; k < c; ++k)
                dst[((size_t)y * out_w + x) * c + k] =
                    clamp_u8(f_cols[((size_t)x * out_h + y) * c + k]);

    free(f_in); free(f_rows); free(f_t); free(f_cols);
}

void gaussian_blur(const uint8_t *src, int h, int w, int c, float sigma,
                   uint8_t *dst) {
    if (sigma <= 0.0f) { memcpy(dst, src, (size_t)h * w * c); return; }
    int radius = (int)ceilf(3.0f * sigma);
    int ksize = 2 * radius + 1;
    float *kern = (float *)malloc(sizeof(float) * ksize);
    float ksum = 0.0f;
    for (int i = 0; i < ksize; ++i) {
        float x = (float)(i - radius);
        kern[i] = expf(-(x * x) / (2.0f * sigma * sigma));
        ksum += kern[i];
    }
    for (int i = 0; i < ksize; ++i) kern[i] /= ksum;

    size_t n = (size_t)h * w * c;
    float *tmp = (float *)malloc(sizeof(float) * n);
    float *tmp2 = (float *)malloc(sizeof(float) * n);

    /* horizontal pass */
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            for (int k = 0; k < c; ++k) {
                float acc = 0.0f;
                for (int i = -radius; i <= radius; ++i) {
                    int xx = clampi(x + i, 0, w - 1);
                    acc += kern[i + radius] * (float)src[((size_t)y * w + xx) * c + k];
                }
                tmp[((size_t)y * w + x) * c + k] = acc;
            }
    /* vertical pass */
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            for (int k = 0; k < c; ++k) {
                float acc = 0.0f;
                for (int i = -radius; i <= radius; ++i) {
                    int yy = clampi(y + i, 0, h - 1);
                    acc += kern[i + radius] * tmp[((size_t)yy * w + x) * c + k];
                }
                tmp2[((size_t)y * w + x) * c + k] = acc;
            }
    for (size_t i = 0; i < n; ++i) dst[i] = clamp_u8(tmp2[i]);
    free(kern); free(tmp); free(tmp2);
}
