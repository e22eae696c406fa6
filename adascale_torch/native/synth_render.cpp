// Native rasterizer for the port's synthetic-page generator
// (adascale_torch/data/synth.py); the port's own copy of
// adascale/native/synth_render.cpp, unchanged below this comment, so that
// both packages draw the same pixels from the same command buffer.
//
// It executes a whole page's ordered draw commands (glyph-quad blends from
// a pre-rasterized alpha atlas, thick line segments) in one call, and
// rasterizes the per-crop label maps (quad fills + gaussian heatmap) in
// another; per-char calls from Python would dominate page generation.
//
// Pure C++17, no dependencies; built by adascale_torch/native/__init__.py
// with g++ -O3 -march=native -shared -fPIC and bound via ctypes. All
// randomness stays in Python (numpy Generator): these functions are
// deterministic given their inputs, so a (seed, run_idx) pair still names
// one sample.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Mat3 {
  double m[9];
};

// Homography mapping the unit square (0,0),(1,0),(1,1),(0,1) onto the
// quad (x0,y0)..(x3,y3) given in order ul, ur, dr, dl.
bool unit_square_to_quad(const float* q, Mat3* out) {
  const double x0 = q[0], y0 = q[1], x1 = q[2], y1 = q[3];
  const double x2 = q[4], y2 = q[5], x3 = q[6], y3 = q[7];
  const double sx = x0 - x1 + x2 - x3;
  const double sy = y0 - y1 + y2 - y3;
  const double dx1 = x1 - x2, dx2 = x3 - x2;
  const double dy1 = y1 - y2, dy2 = y3 - y2;
  double g = 0.0, h = 0.0;
  if (std::abs(sx) > 1e-12 || std::abs(sy) > 1e-12) {
    const double den = dx1 * dy2 - dx2 * dy1;
    if (std::abs(den) < 1e-12) return false;
    g = (sx * dy2 - dx2 * sy) / den;
    h = (dx1 * sy - sx * dy1) / den;
  }
  out->m[0] = x1 - x0 + g * x1;
  out->m[1] = x3 - x0 + h * x3;
  out->m[2] = x0;
  out->m[3] = y1 - y0 + g * y1;
  out->m[4] = y3 - y0 + h * y3;
  out->m[5] = y0;
  out->m[6] = g;
  out->m[7] = h;
  out->m[8] = 1.0;
  return true;
}

bool invert3(const Mat3& a, Mat3* out) {
  const double* m = a.m;
  const double c0 = m[4] * m[8] - m[5] * m[7];
  const double c1 = m[5] * m[6] - m[3] * m[8];
  const double c2 = m[3] * m[7] - m[4] * m[6];
  const double det = m[0] * c0 + m[1] * c1 + m[2] * c2;
  if (std::abs(det) < 1e-14) return false;
  const double inv = 1.0 / det;
  out->m[0] = c0 * inv;
  out->m[1] = (m[2] * m[7] - m[1] * m[8]) * inv;
  out->m[2] = (m[1] * m[5] - m[2] * m[4]) * inv;
  out->m[3] = c1 * inv;
  out->m[4] = (m[0] * m[8] - m[2] * m[6]) * inv;
  out->m[5] = (m[2] * m[3] - m[0] * m[5]) * inv;
  out->m[6] = c2 * inv;
  out->m[7] = (m[1] * m[6] - m[0] * m[7]) * inv;
  out->m[8] = (m[0] * m[4] - m[1] * m[3]) * inv;
  return true;
}

inline uint8_t blend_px(uint8_t dst, double ink, double alpha) {
  const double v = dst * (1.0 - alpha) + ink * alpha;
  return static_cast<uint8_t>(std::clamp(v, 0.0, 255.0));
}

// Blend one glyph alpha tile into the RGB image through the quad
// homography (bilinear sampling of the tile, zero outside).
void blend_glyph(uint8_t* image, int h, int w, const float* quad,
                 const uint8_t* tile, int t, uint8_t ink) {
  Mat3 fwd, inv;
  if (!unit_square_to_quad(quad, &fwd)) return;
  if (!invert3(fwd, &inv)) return;

  float minx = quad[0], maxx = quad[0], miny = quad[1], maxy = quad[1];
  for (int i = 1; i < 4; ++i) {
    minx = std::min(minx, quad[2 * i]);
    maxx = std::max(maxx, quad[2 * i]);
    miny = std::min(miny, quad[2 * i + 1]);
    maxy = std::max(maxy, quad[2 * i + 1]);
  }
  const int x0 = std::max(0, static_cast<int>(std::floor(minx)));
  const int y0 = std::max(0, static_cast<int>(std::floor(miny)));
  const int x1 = std::min(w, static_cast<int>(std::ceil(maxx)) + 1);
  const int y1 = std::min(h, static_cast<int>(std::ceil(maxy)) + 1);
  if (x1 - x0 < 1 || y1 - y0 < 1) return;

  const double inkd = ink;
  for (int y = y0; y < y1; ++y) {
    uint8_t* row = image + (static_cast<size_t>(y) * w + x0) * 3;
    for (int x = x0; x < x1; ++x, row += 3) {
      const double dw = inv.m[6] * x + inv.m[7] * y + inv.m[8];
      if (std::abs(dw) < 1e-12) continue;
      const double u = (inv.m[0] * x + inv.m[1] * y + inv.m[2]) / dw;
      const double v = (inv.m[3] * x + inv.m[4] * y + inv.m[5]) / dw;
      // Unit-square coords -> tile pixel coords.
      const double su = u * t - 0.5;
      const double sv = v * t - 0.5;
      const int iu = static_cast<int>(std::floor(su));
      const int iv = static_cast<int>(std::floor(sv));
      if (iu < -1 || iu >= t || iv < -1 || iv >= t) continue;
      const double fu = su - iu, fv = sv - iv;
      auto at = [&](int yy, int xx) -> double {
        if (xx < 0 || xx >= t || yy < 0 || yy >= t) return 0.0;
        return tile[yy * t + xx];
      };
      const double a =
          (at(iv, iu) * (1 - fu) + at(iv, iu + 1) * fu) * (1 - fv) +
          (at(iv + 1, iu) * (1 - fu) + at(iv + 1, iu + 1) * fu) * fv;
      if (a <= 0.0) continue;
      const double alpha = a / 255.0;
      row[0] = blend_px(row[0], inkd, alpha);
      row[1] = blend_px(row[1], inkd, alpha);
      row[2] = blend_px(row[2], inkd, alpha);
    }
  }
}

// Solid thick line segment: paints pixels whose center is within
// thickness/2 of the segment.
void draw_line(uint8_t* image, int h, int w, float fx0, float fy0, float fx1,
               float fy1, int thickness, uint8_t ink) {
  const double r = std::max(0.5, thickness * 0.5);
  const int x0 = std::max(0, static_cast<int>(std::floor(std::min(fx0, fx1) - r)));
  const int y0 = std::max(0, static_cast<int>(std::floor(std::min(fy0, fy1) - r)));
  const int x1 = std::min(w, static_cast<int>(std::ceil(std::max(fx0, fx1) + r)) + 1);
  const int y1 = std::min(h, static_cast<int>(std::ceil(std::max(fy0, fy1) + r)) + 1);
  const double dx = fx1 - fx0, dy = fy1 - fy0;
  const double len2 = dx * dx + dy * dy;
  const double r2 = r * r;
  for (int y = y0; y < y1; ++y) {
    uint8_t* row = image + (static_cast<size_t>(y) * w + x0) * 3;
    for (int x = x0; x < x1; ++x, row += 3) {
      double px = x - fx0, py = y - fy0;
      double tproj = len2 > 1e-12 ? (px * dx + py * dy) / len2 : 0.0;
      tproj = std::clamp(tproj, 0.0, 1.0);
      const double ex = px - tproj * dx, ey = py - tproj * dy;
      if (ex * ex + ey * ey <= r2) {
        row[0] = ink;
        row[1] = ink;
        row[2] = ink;
      }
    }
  }
}

// Point-in-convex-quad via cross products (quad in consistent winding).
inline bool in_quad(const float* q, double x, double y) {
  bool neg = false, pos = false;
  for (int i = 0; i < 4; ++i) {
    const double ax = q[2 * i], ay = q[2 * i + 1];
    const double bx = q[2 * ((i + 1) % 4)], by = q[2 * ((i + 1) % 4) + 1];
    const double cross = (bx - ax) * (y - ay) - (by - ay) * (x - ax);
    if (cross < 0) neg = true;
    if (cross > 0) pos = true;
    if (neg && pos) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Execute an ordered draw-command buffer on an (h, w, 3) uint8 image.
//   types:  (n) int32 — 0 = glyph blend, 1 = line segment
//   aux:    (n) int32 — glyph: atlas tile index; line: thickness
//   inks:   (n) uint8 gray level
//   geo:    (n, 8) float32 — glyph: quad (x,y)*4 ul,ur,dr,dl;
//                            line: x0,y0,x1,y1,(ignored)*4
//   atlas:  (num_tiles, tile, tile) uint8 alpha
void asr_execute(uint8_t* image, int h, int w, const int32_t* types,
                 const int32_t* aux, const uint8_t* inks, const float* geo,
                 int n, const uint8_t* atlas, int num_tiles, int tile) {
  for (int i = 0; i < n; ++i) {
    const float* g = geo + 8 * i;
    if (types[i] == 0) {
      const int id = aux[i];
      if (id < 0 || id >= num_tiles) continue;
      blend_glyph(image, h, w, g, atlas + static_cast<size_t>(id) * tile * tile,
                  tile, inks[i]);
    } else {
      draw_line(image, h, w, g[0], g[1], g[2], g[3], aux[i], inks[i]);
    }
  }
}

// Rasterize label maps for n chars in downsampled-crop coordinates:
//   mask (h, w) uint8 <- 1 inside each quad (rounded like the python
//     path: quad corners rounded to the pixel grid before the fill);
//   height_map (h, w) float32 <- char height inside the quad;
//   gaussian (h, w) float32 <- max-composited blobs
//     exp(-(d^2)/(2 sigma^2)) around (cx, cy) within a 3-sigma window.
//   quads: (n, 8) float32, heights: (n), centers: (n, 2) (cx, cy),
//   sigmas: (n).
void asr_render_labels(uint8_t* mask, float* height_map, float* gaussian,
                       int h, int w, const float* quads, const float* heights,
                       const float* centers, const float* sigmas, int n) {
  for (int i = 0; i < n; ++i) {
    float q[8];
    for (int k = 0; k < 8; ++k) q[k] = std::round(quads[8 * i + k]);
    float minx = q[0], maxx = q[0], miny = q[1], maxy = q[1];
    for (int k = 1; k < 4; ++k) {
      minx = std::min(minx, q[2 * k]);
      maxx = std::max(maxx, q[2 * k]);
      miny = std::min(miny, q[2 * k + 1]);
      maxy = std::max(maxy, q[2 * k + 1]);
    }
    const int x0 = std::max(0, static_cast<int>(minx));
    const int y0 = std::max(0, static_cast<int>(miny));
    const int x1 = std::min(w - 1, static_cast<int>(maxx));
    const int y1 = std::min(h - 1, static_cast<int>(maxy));
    const float ht = heights[i];
    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        if (in_quad(q, x, y)) {
          mask[y * w + x] = 1;
          height_map[y * w + x] = ht;
        }
      }
    }

    const double cx = centers[2 * i], cy = centers[2 * i + 1];
    const double sig = sigmas[i];
    const int radius = static_cast<int>(std::ceil(3.0 * sig));
    const int gx0 = std::max(0, static_cast<int>(cx) - radius);
    const int gx1 = std::min(w, static_cast<int>(cx) + radius + 1);
    const int gy0 = std::max(0, static_cast<int>(cy) - radius);
    const int gy1 = std::min(h, static_cast<int>(cy) + radius + 1);
    const double inv2s2 = 1.0 / (2.0 * sig * sig);
    for (int y = gy0; y < gy1; ++y) {
      for (int x = gx0; x < gx1; ++x) {
        const double d2 = (x - cx) * (x - cx) + (y - cy) * (y - cy);
        const float val = static_cast<float>(std::exp(-d2 * inv2s2));
        float& cell = gaussian[y * w + x];
        if (val > cell) cell = val;
      }
    }
  }
}

}  // extern "C"
