// Native host tails of the PyTorch/CUDA port: the sequential, pointer-
// chasing algorithms around the device work, with data-dependent frontiers
// that do not map to batched tensor ops.
//
//   suzuki_contours  Suzuki-Abe border following (imgproc/src/contours.cpp)
//   flood_fill_u8    4/8-connected flood fill (imgproc/src/floodfill.cpp)
//   maxflow_grid     Dinic's max-flow on GrabCut's 8-neighbour grid graph
//                    (the role of GCGraph<double>, imgproc/src/gcgraph.hpp)
//   watershed_u8c3   marker-controlled watershed (imgproc/src/segmentation.cpp)
//
// Built by opencv_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC
// -std=c++17) at the first call and loaded with ctypes.  The Python twins in
// opencv_tpu_torch/ops/contours.py, ops/segmentation.py and ops/grabcut.py
// are their plain versions, which the tests hold them to.

#include <cstdint>
#include <cstring>
#include <deque>
#include <queue>
#include <vector>

extern "C" {

// Moore neighborhood, clockwise from East (matches contours.py _NB)
static const int NBY[8] = {0, -1, -1, -1, 0, 1, 1, 1};
static const int NBX[8] = {1, 1, 0, -1, -1, -1, 0, 1};

// Suzuki-Abe border following on a binary image.
//   img:    H*W uint8 (nonzero = foreground)
//   pts:    output buffer for (x, y) pairs, capacity max_pts
//   starts: output contour start indices into pts (capacity max_ctrs+1);
//           starts[i]..starts[i+1] are contour i's points
//   parents,is_outer: per-contour metadata (capacity max_ctrs)
// Returns the number of contours, or -1 if a buffer was too small.
int suzuki_contours(const uint8_t* img, int H, int W,
                    int32_t* pts, int64_t max_pts,
                    int32_t* starts, int32_t* parents, uint8_t* is_outer,
                    int32_t max_ctrs) {
  const int PW = W + 2;
  const int PH = H + 2;
  std::vector<int32_t> F((size_t)PW * PH, 0);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++)
      F[(size_t)(y + 1) * PW + (x + 1)] = img[(size_t)y * W + x] ? 1 : 0;

  // border_of: NBD -> (contour index, type); NBD 1 = frame (hole type)
  std::vector<int32_t> border_ctr(2, -1);
  std::vector<uint8_t> border_hole(2, 1);

  int64_t npts = 0;
  int32_t nctr = 0;
  int nbd = 1;

  for (int y = 1; y <= H; y++) {
    int lnbd = 1;
    for (int x = 1; x <= W; x++) {
      int32_t v = F[(size_t)y * PW + x];
      if (v == 0) continue;
      bool outer = (v == 1 && F[(size_t)y * PW + x - 1] == 0);
      bool hole = (v >= 1 && F[(size_t)y * PW + x + 1] == 0);
      if (!(outer || hole)) {
        if (v != 1) lnbd = v < 0 ? -v : v;
        continue;
      }
      nbd++;
      if (nctr >= max_ctrs) return -1;
      uint8_t btype_outer = outer ? 1 : 0;
      // Suzuki decision table
      int pl = border_ctr[lnbd];
      uint8_t ptype_outer = border_hole[lnbd] ? 0 : 1;
      int parent;
      if (btype_outer != ptype_outer)
        parent = pl;
      else
        parent = (pl >= 0) ? parents[pl] : -1;

      starts[nctr] = (int32_t)npts;
      parents[nctr] = parent;
      is_outer[nctr] = btype_outer;

      // trace border starting at (y, x)
      int start_dir = outer ? 4 : 0;
      int d1 = -1;
      for (int i = 0; i < 8; i++) {
        int dd = ((start_dir - i) % 8 + 8) % 8;
        if (F[(size_t)(y + NBY[dd]) * PW + (x + NBX[dd])] != 0) {
          d1 = dd;
          break;
        }
      }
      if (d1 < 0) {
        // isolated pixel
        F[(size_t)y * PW + x] = -nbd;
        if (npts + 1 > max_pts) return -1;
        pts[2 * npts] = x - 1;
        pts[2 * npts + 1] = y - 1;
        npts++;
      } else {
        int cy = y, cx = x, d = d1;
        int f2y = y + NBY[d1], f2x = x + NBX[d1];
        while (true) {
          bool east_zero = false;
          int nd = -1;
          for (int i = 1; i <= 8; i++) {
            int dd = (d + i) % 8;
            int yy = cy + NBY[dd], xx = cx + NBX[dd];
            if (F[(size_t)yy * PW + xx] != 0) {
              nd = dd;
              break;
            }
            if (dd == 0) east_zero = true;
          }
          if (npts + 1 > max_pts) return -1;
          pts[2 * npts] = cx - 1;
          pts[2 * npts + 1] = cy - 1;
          npts++;
          int32_t& cell = F[(size_t)cy * PW + cx];
          if (east_zero)
            cell = -nbd;
          else if (cell == 1)
            cell = nbd;
          int ny = cy + NBY[nd], nx = cx + NBX[nd];
          if (ny == y && nx == x && cy == f2y && cx == f2x) break;
          cy = ny;
          cx = nx;
          d = (nd + 4) % 8;
          if (npts > (int64_t)4 * PW * PH) break;  // safety
        }
      }

      if ((int)border_ctr.size() <= nbd) {
        border_ctr.resize(nbd + 1, -1);
        border_hole.resize(nbd + 1, 1);
      }
      border_ctr[nbd] = nctr;
      border_hole[nbd] = btype_outer ? 0 : 1;
      nctr++;

      int32_t after = F[(size_t)y * PW + x];
      if (after != 1) lnbd = after < 0 ? -after : after;
    }
  }
  starts[nctr] = (int32_t)npts;
  return nctr;
}

// 4/8-connected flood fill with per-channel lo/up tolerances.
// img: H*W*C uint8 (modified in place unless mask_only), mask: (H+2)*(W+2).
// Returns the filled pixel count and writes rect[4] = x, y, w, h.

// 4/8-connected flood fill with per-channel lo/up tolerances.
// img: H*W*C uint8 (modified in place unless mask_only), mask: (H+2)*(W+2).
// Returns the filled pixel count and writes rect[4] = x, y, w, h.
int64_t flood_fill_u8(uint8_t* img, uint8_t* mask, int H, int W, int C,
                      int sx, int sy, const uint8_t* new_val,
                      const double* lo, const double* up, int conn,
                      int fixed_range, int mask_only, uint8_t mask_val,
                      int32_t* rect) {
  const int PW = W + 2;
  std::vector<uint8_t> filled((size_t)H * W, 0);
  std::vector<int32_t> stack;
  stack.reserve(1024);
  stack.push_back(sy * W + sx);
  filled[(size_t)sy * W + sx] = 1;

  std::vector<double> seed(C);
  for (int c = 0; c < C; c++) seed[c] = img[((size_t)sy * W + sx) * C + c];

  static const int O8Y[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
  static const int O8X[8] = {0, 0, -1, 1, -1, 1, -1, 1};
  int noffs = (conn == 8) ? 8 : 4;

  int64_t count = 0;
  int minx = sx, maxx = sx, miny = sy, maxy = sy;
  while (!stack.empty()) {
    int32_t p = stack.back();
    stack.pop_back();
    int y = p / W, x = p % W;
    count++;
    if (x < minx) minx = x;
    if (x > maxx) maxx = x;
    if (y < miny) miny = y;
    if (y > maxy) maxy = y;
    for (int k = 0; k < noffs; k++) {
      int ny = y + O8Y[k], nx = x + O8X[k];
      if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
      size_t q = (size_t)ny * W + nx;
      if (filled[q]) continue;
      if (mask[(size_t)(ny + 1) * PW + (nx + 1)]) continue;
      bool ok = true;
      for (int c = 0; c < C; c++) {
        double base = fixed_range ? seed[c] : (double)img[((size_t)y * W + x) * C + c];
        double d = (double)img[q * C + c] - base;
        if (d < -lo[c] || d > up[c]) {
          ok = false;
          break;
        }
      }
      if (ok) {
        filled[q] = 1;
        stack.push_back((int32_t)(ny * W + nx));
      }
    }
  }
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++)
      if (filled[(size_t)y * W + x]) {
        mask[(size_t)(y + 1) * PW + (x + 1)] = mask_val;
        if (!mask_only)
          for (int c = 0; c < C; c++)
            img[((size_t)y * W + x) * C + c] = new_val[c];
      }
  rect[0] = minx;
  rect[1] = miny;
  rect[2] = maxx - minx + 1;
  rect[3] = maxy - miny + 1;
  return count;
}

}  // extern "C"

// -------------------------------------------------------------- max-flow
// Dinic's algorithm on the GrabCut 8-neighbor grid graph
// (the role of GCGraph<double> in imgproc/src/gcgraph.hpp).
// srcw/snkw: terminal capacities; leftw/upleftw/upw/uprightw: symmetric
// n-link weights at each pixel (0 where the neighbor is out of range).
// out_fg[i] = 1 if node i is on the source (foreground) side.


namespace {
struct Arc { int to; double cap; int rev; };
struct Dinic {
    std::vector<std::vector<Arc>> g;
    std::vector<int> level, iter;
    explicit Dinic(int n) : g(n), level(n), iter(n) {}
    void add(int a, int b, double cab, double cba) {
        Arc e1{b, cab, (int)g[b].size()};
        Arc e2{a, cba, (int)g[a].size()};
        g[a].push_back(e1);
        g[b].push_back(e2);
    }
    bool bfs(int s, int t) {
        std::fill(level.begin(), level.end(), -1);
        std::queue<int> q;
        level[s] = 0; q.push(s);
        while (!q.empty()) {
            int v = q.front(); q.pop();
            for (auto& e : g[v])
                if (e.cap > 1e-12 && level[e.to] < 0) {
                    level[e.to] = level[v] + 1;
                    q.push(e.to);
                }
        }
        return level[t] >= 0;
    }
    double dfs(int v, int t, double f) {
        if (v == t) return f;
        for (int& i = iter[v]; i < (int)g[v].size(); i++) {
            Arc& e = g[v][i];
            if (e.cap > 1e-12 && level[v] < level[e.to]) {
                double d = dfs(e.to, t, f < e.cap ? f : e.cap);
                if (d > 0) {
                    e.cap -= d;
                    g[e.to][e.rev].cap += d;
                    return d;
                }
            }
        }
        return 0;
    }
    double run(int s, int t) {
        double flow = 0;
        while (bfs(s, t)) {
            std::fill(iter.begin(), iter.end(), 0);
            double f;
            while ((f = dfs(s, t, 1e300)) > 0) flow += f;
        }
        return flow;
    }
};
}  // namespace

extern "C" double maxflow_grid(int H, int W,
                               const double* srcw, const double* snkw,
                               const double* leftw, const double* upleftw,
                               const double* upw, const double* uprightw,
                               uint8_t* out_fg)
{
    const int N = H * W;
    Dinic d(N + 2);
    const int S = N, T = N + 1;
    for (int i = 0; i < N; i++) {
        if (srcw[i] > 0) d.add(S, i, srcw[i], 0.0);
        if (snkw[i] > 0) d.add(i, T, snkw[i], 0.0);
    }
    for (int y = 0; y < H; y++)
        for (int x = 0; x < W; x++) {
            int i = y * W + x;
            if (x > 0 && leftw[i] > 0) d.add(i, i - 1, leftw[i], leftw[i]);
            if (x > 0 && y > 0 && upleftw[i] > 0)
                d.add(i, i - W - 1, upleftw[i], upleftw[i]);
            if (y > 0 && upw[i] > 0) d.add(i, i - W, upw[i], upw[i]);
            if (x < W - 1 && y > 0 && uprightw[i] > 0)
                d.add(i, i - W + 1, uprightw[i], uprightw[i]);
        }
    double flow = d.run(S, T);
    // source side = reachable in residual graph
    std::vector<uint8_t> vis(N + 2, 0);
    std::queue<int> q;
    q.push(S); vis[S] = 1;
    while (!q.empty()) {
        int v = q.front(); q.pop();
        for (auto& e : d.g[v])
            if (e.cap > 1e-12 && !vis[e.to]) { vis[e.to] = 1; q.push(e.to); }
    }
    for (int i = 0; i < N; i++) out_fg[i] = vis[i];
    return flow;
}

/* ------------------------------------------------------------------------
 * Marker-controlled watershed flood, matching cv::watershed semantics
 * (imgproc/src/segmentation.cpp:88-325): 256 FIFO bucket queues keyed by
 * the max-channel gradient, raster-order seeding with the MIN diff to any
 * labeled 4-neighbor, L/R/T/B neighbor evaluation order, and an active
 * bucket index that drops back whenever a cheaper pixel is queued.  The
 * one-pixel image frame is forced to boundary (-1); unreachable zeros
 * stay 0.  Own implementation (std::deque buckets, flat indexing). */

extern "C" int watershed_u8c3(const uint8_t *img, int32_t *mask,
                              int H, int W) {
  const int IN_QUEUE = -2, WSHED = -1;
  if (H < 1 || W < 1) return 0;
  for (int j = 0; j < W; j++) {
    mask[j] = WSHED;
    mask[(int64_t)(H - 1) * W + j] = WSHED;
  }
  for (int i = 0; i < H; i++) {
    mask[(int64_t)i * W] = WSHED;
    mask[(int64_t)i * W + W - 1] = WSHED;
  }
  auto cdiff = [&](int64_t p, int64_t q) -> int {
    int d0 = img[3 * p] - img[3 * q];
    if (d0 < 0) d0 = -d0;
    int d1 = img[3 * p + 1] - img[3 * q + 1];
    if (d1 < 0) d1 = -d1;
    int d2 = img[3 * p + 2] - img[3 * q + 2];
    if (d2 < 0) d2 = -d2;
    int d = d0 > d1 ? d0 : d1;
    return d > d2 ? d : d2;
  };
  std::deque<int64_t> q[256];
  for (int i = 1; i < H - 1; i++) {
    for (int j = 1; j < W - 1; j++) {
      int64_t p = (int64_t)i * W + j;
      if (mask[p] < 0) mask[p] = 0;
      if (mask[p] == 0 && (mask[p - 1] > 0 || mask[p + 1] > 0 ||
                           mask[p - W] > 0 || mask[p + W] > 0)) {
        int idx = 256, t;
        if (mask[p - 1] > 0) idx = cdiff(p, p - 1);
        if (mask[p + 1] > 0) { t = cdiff(p, p + 1); if (t < idx) idx = t; }
        if (mask[p - W] > 0) { t = cdiff(p, p - W); if (t < idx) idx = t; }
        if (mask[p + W] > 0) { t = cdiff(p, p + W); if (t < idx) idx = t; }
        q[idx].push_back(p);
        mask[p] = IN_QUEUE;
      }
    }
  }
  int active = 0;
  while (active < 256 && q[active].empty()) active++;
  if (active == 256) return 0;
  for (;;) {
    if (q[active].empty()) {
      int i = active + 1;
      while (i < 256 && q[i].empty()) i++;
      if (i == 256) break;
      active = i;
    }
    int64_t p = q[active].front();
    q[active].pop_front();
    int lab = 0, t;
    t = mask[p - 1];
    if (t > 0) lab = t;
    t = mask[p + 1];
    if (t > 0) { if (!lab) lab = t; else if (t != lab) lab = WSHED; }
    t = mask[p - W];
    if (t > 0) { if (!lab) lab = t; else if (t != lab) lab = WSHED; }
    t = mask[p + W];
    if (t > 0) { if (!lab) lab = t; else if (t != lab) lab = WSHED; }
    mask[p] = lab;
    if (lab == WSHED) continue;
    if (mask[p - 1] == 0) {
      t = cdiff(p, p - 1); q[t].push_back(p - 1);
      if (t < active) active = t;
      mask[p - 1] = IN_QUEUE;
    }
    if (mask[p + 1] == 0) {
      t = cdiff(p, p + 1); q[t].push_back(p + 1);
      if (t < active) active = t;
      mask[p + 1] = IN_QUEUE;
    }
    if (mask[p - W] == 0) {
      t = cdiff(p, p - W); q[t].push_back(p - W);
      if (t < active) active = t;
      mask[p - W] = IN_QUEUE;
    }
    if (mask[p + W] == 0) {
      t = cdiff(p, p + W); q[t].push_back(p + W);
      if (t < active) active = t;
      mask[p + W] = IN_QUEUE;
    }
  }
  return 0;
}
