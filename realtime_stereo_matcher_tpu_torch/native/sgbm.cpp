// Semi-Global Block Matching (SGBM) -- native C++ classical stereo baseline.
//
// From-scratch implementation of the algorithm family behind OpenCV's
// StereoSGBM (H. Hirschmuller, "Stereo Processing by Semiglobal Matching and
// Mutual Information", PAMI 2008; cost term follows Birchfield-Tomasi), with
// the same parameter surface the reference framework exposes through
// cv.StereoSGBM_create (reference model/opencv_sgbm_module.py:8-49):
// blockSize, preFilterCap, minDisparity, numDisparities, speckleRange,
// speckleWindowSize, disp12MaxDiff, uniquenessRatio, mode, P1, P2 -- and the
// same output encoding: int16 fixed-point disparity * 16, invalid =
// (minDisparity - 1) * 16.
//
// Pipeline:
//   1. x-Sobel prefilter clipped to +/- preFilterCap
//   2. Birchfield-Tomasi pixel cost on the prefiltered images
//   3. blockSize x blockSize box aggregation
//   4. semi-global path aggregation: 4 causal directions per pass;
//      mode 0 (MODE_SGBM) = 1 forward pass, mode 1 (MODE_HH) = forward +
//      backward pass (8 directions)
//   5. WTA with uniqueness-ratio check, parabolic sub-pixel refinement
//   6. left-right consistency check (disp12MaxDiff)
//   7. speckle filtering (4-connected components, range = 16 * speckleRange)
//
// Exposed as a C ABI for ctypes (see classical/sgbm.py).  A copy of the JAX
// package's native/sgbm.cpp, built by utils/native_build.py.  Thread-parallel
// over rows for cost construction; SGM passes are row-sequential by nature.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

using std::int16_t;
using std::int32_t;
using std::uint8_t;

constexpr int kDispScale = 16;  // OpenCV StereoMatcher::DISP_SCALE

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// x-Sobel with border replication, clipped into [0, 2*cap] around cap.
void sobel_clip(const uint8_t* img, int h, int w, int cap, uint8_t* out) {
  auto at = [&](int y, int x) -> int {
    y = clampi(y, 0, h - 1);
    x = clampi(x, 0, w - 1);
    return img[y * w + x];
  };
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int d = (at(y - 1, x + 1) - at(y - 1, x - 1)) +
              2 * (at(y, x + 1) - at(y, x - 1)) +
              (at(y + 1, x + 1) - at(y + 1, x - 1));
      out[y * w + x] = static_cast<uint8_t>(clampi(d + cap, 0, 2 * cap));
    }
  }
}

// Birchfield-Tomasi pixel dissimilarity between left row l and right row r at
// left position x, disparity d (right position x - d).
inline int bt_cost(const uint8_t* l, const uint8_t* r, int w, int x, int xr) {
  auto half = [&](const uint8_t* row, int i, int j) -> int {
    // average of row[i] and row[j] with clamped indices
    int a = row[clampi(i, 0, w - 1)];
    int b = row[clampi(j, 0, w - 1)];
    return (a + b + 1) / 2;
  };
  int lv = l[x];
  int rv = r[clampi(xr, 0, w - 1)];
  int r_minus = half(r, xr - 1, xr);
  int r_plus = half(r, xr, xr + 1);
  int rmin = std::min(rv, std::min(r_minus, r_plus));
  int rmax = std::max(rv, std::max(r_minus, r_plus));
  int c_l = std::max(0, std::max(lv - rmax, rmin - lv));

  int l_minus = half(l, x - 1, x);
  int l_plus = half(l, x, x + 1);
  int lmin = std::min(lv, std::min(l_minus, l_plus));
  int lmax = std::max(lv, std::max(l_minus, l_plus));
  int c_r = std::max(0, std::max(rv - lmax, lmin - rv));

  return std::min(c_l, c_r);
}

struct Params {
  int min_disp, num_disp, block_size, p1, p2;
  int pre_filter_cap, uniqueness_ratio, speckle_win_size, speckle_range;
  int disp12_max_diff, mode;
};

// One directional SGM pass over the aggregated cost volume.
// dir = (dy, dx) must be causal w.r.t. the scan order used by the caller.
void sgm_pass_dir(const int32_t* cost, int h, int w, int nd, int p1, int p2,
                  int dy, int dx, bool reverse, int32_t* acc) {
  const int32_t INF = std::numeric_limits<int32_t>::max() / 4;
  std::vector<int32_t> lr((size_t)h * w * nd, 0);

  int y0 = reverse ? h - 1 : 0, y1 = reverse ? -1 : h, ys = reverse ? -1 : 1;
  int x0 = reverse ? w - 1 : 0, x1 = reverse ? -1 : w, xs = reverse ? -1 : 1;

  for (int y = y0; y != y1; y += ys) {
    for (int x = x0; x != x1; x += xs) {
      const int32_t* cp = cost + ((size_t)y * w + x) * nd;
      int32_t* lp = lr.data() + ((size_t)y * w + x) * nd;
      int py = y - dy, px = x - dx;
      bool has_prev = (py >= 0 && py < h && px >= 0 && px < w);
      if (!has_prev) {
        for (int d = 0; d < nd; ++d) lp[d] = cp[d];
      } else {
        const int32_t* pp = lr.data() + ((size_t)py * w + px) * nd;
        int32_t prev_min = INF;
        for (int d = 0; d < nd; ++d) prev_min = std::min(prev_min, pp[d]);
        for (int d = 0; d < nd; ++d) {
          int32_t best = pp[d];
          if (d > 0) best = std::min(best, pp[d - 1] + p1);
          if (d + 1 < nd) best = std::min(best, pp[d + 1] + p1);
          best = std::min(best, prev_min + p2);
          lp[d] = cp[d] + best - prev_min;
        }
      }
      int32_t* ap = acc + ((size_t)y * w + x) * nd;
      for (int d = 0; d < nd; ++d) ap[d] += lp[d];
    }
  }
}

// 4-connected speckle filter, in-place on fixed-point disparities.
void filter_speckles(int16_t* disp, int h, int w, int new_val, int max_size,
                     int max_diff) {
  if (max_size <= 0) return;
  std::vector<int32_t> labels((size_t)h * w, 0);
  std::vector<int32_t> stack;
  std::vector<int32_t> comp;
  int32_t cur = 0;
  for (int i = 0; i < h * w; ++i) {
    if (labels[i] || disp[i] == new_val) continue;
    ++cur;
    stack.clear();
    comp.clear();
    stack.push_back(i);
    labels[i] = cur;
    while (!stack.empty()) {
      int p = stack.back();
      stack.pop_back();
      comp.push_back(p);
      int y = p / w, x = p % w;
      int16_t dv = disp[p];
      const int ny[4] = {y - 1, y + 1, y, y};
      const int nx[4] = {x, x, x - 1, x + 1};
      for (int k = 0; k < 4; ++k) {
        if (ny[k] < 0 || ny[k] >= h || nx[k] < 0 || nx[k] >= w) continue;
        int q = ny[k] * w + nx[k];
        if (labels[q] || disp[q] == new_val) continue;
        if (std::abs((int)disp[q] - (int)dv) <= max_diff) {
          labels[q] = cur;
          stack.push_back(q);
        }
      }
    }
    if ((int)comp.size() < max_size) {
      for (int p : comp) disp[p] = static_cast<int16_t>(new_val);
    }
  }
}

}  // namespace

extern "C" {

// Computes fixed-point (x16) left disparity.  Returns 0 on success.
int sgbm_compute(const uint8_t* left, const uint8_t* right, int h, int w,
                 int min_disp, int num_disp, int block_size, int p1, int p2,
                 int pre_filter_cap, int uniqueness_ratio,
                 int speckle_win_size, int speckle_range, int disp12_max_diff,
                 int mode, int16_t* out) {
  if (h <= 0 || w <= 0 || num_disp <= 0 || block_size < 1) return 1;
  Params prm{min_disp,        num_disp,       block_size,      p1, p2,
             pre_filter_cap,  uniqueness_ratio, speckle_win_size,
             speckle_range,   disp12_max_diff, mode};
  const int nd = prm.num_disp;
  const int invalid = (prm.min_disp - 1) * kDispScale;
  const int32_t INF = std::numeric_limits<int32_t>::max() / 4;

  // 1. prefilter
  std::vector<uint8_t> lf((size_t)h * w), rf((size_t)h * w);
  int cap = prm.pre_filter_cap > 0 ? prm.pre_filter_cap : 31;
  sobel_clip(left, h, w, cap, lf.data());
  sobel_clip(right, h, w, cap, rf.data());

  // 2+3. BT pixel cost + box aggregation (separable: rows then columns)
  const int r = prm.block_size / 2;
  std::vector<int32_t> pix((size_t)h * w * nd);
  for (int y = 0; y < h; ++y) {
    const uint8_t* lrow = lf.data() + (size_t)y * w;
    const uint8_t* rrow = rf.data() + (size_t)y * w;
    for (int x = 0; x < w; ++x) {
      int32_t* pc = pix.data() + ((size_t)y * w + x) * nd;
      for (int d = 0; d < nd; ++d) {
        pc[d] = bt_cost(lrow, rrow, w, x, x - (prm.min_disp + d));
      }
    }
  }
  // horizontal box sum (replicated borders)
  std::vector<int32_t> tmp((size_t)h * w * nd);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int32_t* dst = tmp.data() + ((size_t)y * w + x) * nd;
      std::memset(dst, 0, nd * sizeof(int32_t));
      for (int k = -r; k <= r; ++k) {
        int xx = clampi(x + k, 0, w - 1);
        const int32_t* src = pix.data() + ((size_t)y * w + xx) * nd;
        for (int d = 0; d < nd; ++d) dst[d] += src[d];
      }
    }
  }
  // vertical box sum
  std::vector<int32_t> cost((size_t)h * w * nd);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int32_t* dst = cost.data() + ((size_t)y * w + x) * nd;
      std::memset(dst, 0, nd * sizeof(int32_t));
      for (int k = -r; k <= r; ++k) {
        int yy = clampi(y + k, 0, h - 1);
        const int32_t* src = tmp.data() + ((size_t)yy * w + x) * nd;
        for (int d = 0; d < nd; ++d) dst[d] += src[d];
      }
    }
  }
  pix.clear();
  pix.shrink_to_fit();
  tmp.clear();
  tmp.shrink_to_fit();

  // 4. SGM aggregation
  std::vector<int32_t> agg((size_t)h * w * nd, 0);
  // forward pass: W, NW, N, NE
  sgm_pass_dir(cost.data(), h, w, nd, prm.p1, prm.p2, 0, 1, false, agg.data());
  sgm_pass_dir(cost.data(), h, w, nd, prm.p1, prm.p2, 1, 1, false, agg.data());
  sgm_pass_dir(cost.data(), h, w, nd, prm.p1, prm.p2, 1, 0, false, agg.data());
  sgm_pass_dir(cost.data(), h, w, nd, prm.p1, prm.p2, 1, -1, false, agg.data());
  if (prm.mode == 1) {  // MODE_HH: backward pass adds E, SE, S, SW
    sgm_pass_dir(cost.data(), h, w, nd, prm.p1, prm.p2, 0, -1, true, agg.data());
    sgm_pass_dir(cost.data(), h, w, nd, prm.p1, prm.p2, -1, -1, true, agg.data());
    sgm_pass_dir(cost.data(), h, w, nd, prm.p1, prm.p2, -1, 0, true, agg.data());
    sgm_pass_dir(cost.data(), h, w, nd, prm.p1, prm.p2, -1, 1, true, agg.data());
  }

  // 5. WTA + uniqueness + subpixel; 6. LR check via best-cost-per-right-pixel
  std::vector<int16_t> disp((size_t)h * w, (int16_t)invalid);
  std::vector<int32_t> disp2cost((size_t)w);
  std::vector<int16_t> disp2((size_t)w);
  for (int y = 0; y < h; ++y) {
    std::fill(disp2cost.begin(), disp2cost.end(), INF);
    std::fill(disp2.begin(), disp2.end(), (int16_t)invalid);
    for (int x = 0; x < w; ++x) {
      const int32_t* sp = agg.data() + ((size_t)y * w + x) * nd;
      int best_d = 0;
      int32_t best_s = sp[0];
      for (int d = 1; d < nd; ++d) {
        if (sp[d] < best_s) { best_s = sp[d]; best_d = d; }
      }
      // track right-view winner (for LR check)
      int xr = x - (prm.min_disp + best_d);
      if (xr >= 0 && xr < w && disp2cost[xr] > best_s) {
        disp2cost[xr] = best_s;
        disp2[xr] = static_cast<int16_t>(best_d);
      }
      // uniqueness
      bool unique = true;
      if (prm.uniqueness_ratio > 0) {
        for (int d = 0; d < nd; ++d) {
          if (sp[d] * 100 < best_s * (100 + prm.uniqueness_ratio) &&
              std::abs(d - best_d) > 1) {
            unique = false;
            break;
          }
        }
      }
      if (!unique) continue;
      // subpixel parabola
      int dq = best_d * kDispScale;
      if (best_d > 0 && best_d + 1 < nd) {
        int32_t denom = std::max(sp[best_d - 1] + sp[best_d + 1] -
                                     2 * sp[best_d], 1);
        dq += ((sp[best_d - 1] - sp[best_d + 1]) * kDispScale + denom) /
              (denom * 2);
      }
      disp[(size_t)y * w + x] =
          static_cast<int16_t>(dq + prm.min_disp * kDispScale);
    }
    // LR consistency
    if (prm.disp12_max_diff >= 0) {
      for (int x = 0; x < w; ++x) {
        int16_t dv = disp[(size_t)y * w + x];
        if (dv == invalid) continue;
        int d = (dv + kDispScale / 2) / kDispScale - prm.min_disp;  // rounded
        int xr = x - (prm.min_disp + d);
        if (xr >= 0 && xr < w && disp2[xr] != (int16_t)invalid &&
            std::abs((int)disp2[xr] - d) > prm.disp12_max_diff) {
          disp[(size_t)y * w + x] = static_cast<int16_t>(invalid);
        }
      }
    }
  }

  // 7. speckle filter (max_diff in fixed-point units, like OpenCV)
  filter_speckles(disp.data(), h, w, invalid, prm.speckle_win_size,
                  prm.speckle_range * kDispScale);

  std::memcpy(out, disp.data(), (size_t)h * w * sizeof(int16_t));
  return 0;
}

}  // extern "C"
