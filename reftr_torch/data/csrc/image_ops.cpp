// Native image pipeline ops for the data loader.
//
// Replaces the reference's host-side image work (cv2 + PIL + torchvision
// F.resize in the reference RefTR's datasets/transforms.py and
// resc_refer_dataset.py:134-140):
//
//   * rimg_resize_bilinear: separable triangle-filter (antialiased) resize,
//     the algorithm Pillow uses for Image.resize(BILINEAR) — the reference
//     resizes PIL images via torchvision (transforms.py:111), so eval-parity
//     preprocessing needs the antialiased filter, not cv2's INTER_LINEAR.
//   * rimg_hsv_jitter: saturation/value jitter in HSV space, mirroring
//     RandomIntensitySaturation (transforms.py:266-285).
//   * rimg_pack_canvas: paste a resized image into a fixed canvas
//     (top-left), emitting uint8 NHWC + the validity extent. Normalization
//     happens on-device (uint8 ships over PCIe/ICI at 1/4 the bytes).
//
// C ABI for ctypes; no external dependencies. All images are uint8 HWC RGB.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Filter {
  // for each output pixel: start index + normalized coefficients
  std::vector<int> bounds;
  std::vector<double> coeffs;
  int ksize;
};

// Pillow-style triangle (bilinear) filter with antialias support scaling.
static Filter make_filter(int in_size, int out_size) {
  Filter f;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // bilinear support = 1.0
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  f.ksize = ksize;
  f.bounds.resize(out_size * 2);
  f.coeffs.resize(static_cast<size_t>(out_size) * ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &f.coeffs[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      double arg = (x + xmin - center + 0.5) * ss;
      double w = arg < 0 ? arg + 1.0 : 1.0 - arg;  // triangle
      if (w < 0) w = 0;
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    for (int x = xmax; x < ksize; ++x) k[x] = 0.0;
    f.bounds[xx * 2] = xmin;
    f.bounds[xx * 2 + 1] = xmax;
  }
  return f;
}

static inline uint8_t clip8(double v) {
  if (v <= 0.0) return 0;
  if (v >= 255.0) return 255;
  return static_cast<uint8_t>(v + 0.5);
}

}  // namespace

extern "C" {

// src: [sh, sw, c] uint8; dst: [dh, dw, c] uint8 (caller-allocated)
void rimg_resize_bilinear(const uint8_t* src, int sh, int sw, int c,
                          uint8_t* dst, int dh, int dw) {
  Filter fh = make_filter(sw, dw);
  Filter fv = make_filter(sh, dh);
  // horizontal pass into a temp double buffer [sh, dw, c]
  std::vector<double> tmp(static_cast<size_t>(sh) * dw * c);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * c;
    double* trow = &tmp[static_cast<size_t>(y) * dw * c];
    for (int x = 0; x < dw; ++x) {
      int xmin = fh.bounds[x * 2], xmax = fh.bounds[x * 2 + 1];
      const double* k = &fh.coeffs[static_cast<size_t>(x) * fh.ksize];
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int i = 0; i < xmax; ++i)
          acc += row[(xmin + i) * c + ch] * k[i];
        trow[x * c + ch] = acc;
      }
    }
  }
  // vertical pass
  for (int y = 0; y < dh; ++y) {
    int ymin = fv.bounds[y * 2], ymax = fv.bounds[y * 2 + 1];
    const double* k = &fv.coeffs[static_cast<size_t>(y) * fv.ksize];
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * c;
    for (int x = 0; x < dw; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int i = 0; i < ymax; ++i)
          acc += tmp[(static_cast<size_t>(ymin + i) * dw + x) * c + ch] * k[i];
        drow[x * c + ch] = clip8(acc);
      }
    }
  }
}

// In-place S/V jitter on an RGB uint8 image, reproducing the reference's
// cv2 HSV round-trip semantics: S scaled by s_factor (clipped high only),
// V scaled by v_factor (clipped high only).
void rimg_hsv_jitter(uint8_t* img, int h, int w, float s_factor,
                     float v_factor) {
  for (int i = 0; i < h * w; ++i) {
    uint8_t* p = img + i * 3;
    float r = p[0], g = p[1], b = p[2];
    float v = std::max({r, g, b});
    float mn = std::min({r, g, b});
    float diff = v - mn;
    float s = v > 0 ? diff / v : 0.0f;
    float hh = 0.0f;
    if (diff > 0) {
      if (v == r)
        hh = 60.0f * (g - b) / diff;
      else if (v == g)
        hh = 120.0f + 60.0f * (b - r) / diff;
      else
        hh = 240.0f + 60.0f * (r - g) / diff;
      if (hh < 0) hh += 360.0f;
    }
    // jitter (clip only when amplifying, as the reference does)
    float s2 = std::min(s * s_factor, 1.0f);
    float v2 = std::min(v * v_factor, 255.0f);
    // HSV -> RGB
    float c = v2 * s2;
    float hp = hh / 60.0f;
    float xcomp = c * (1.0f - std::fabs(std::fmod(hp, 2.0f) - 1.0f));
    float m = v2 - c;
    float rr = 0, gg = 0, bb = 0;
    if (hp < 1) {
      rr = c; gg = xcomp;
    } else if (hp < 2) {
      rr = xcomp; gg = c;
    } else if (hp < 3) {
      gg = c; bb = xcomp;
    } else if (hp < 4) {
      gg = xcomp; bb = c;
    } else if (hp < 5) {
      rr = xcomp; bb = c;
    } else {
      rr = c; bb = xcomp;
    }
    p[0] = clip8(rr + m);
    p[1] = clip8(gg + m);
    p[2] = clip8(bb + m);
  }
}

// Paste src [sh, sw, 3] into canvas [ch_, cw, 3] at (0,0); zero the rest.
void rimg_pack_canvas(const uint8_t* src, int sh, int sw, uint8_t* canvas,
                      int ch_, int cw) {
  std::memset(canvas, 0, static_cast<size_t>(ch_) * cw * 3);
  for (int y = 0; y < sh; ++y)
    std::memcpy(canvas + static_cast<size_t>(y) * cw * 3,
                src + static_cast<size_t>(y) * sw * 3,
                static_cast<size_t>(sw) * 3);
}

}  // extern "C"
