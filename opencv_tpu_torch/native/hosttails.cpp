// Native host tails of the PyTorch/CUDA port: the sequential, pointer-
// chasing algorithms around the device work, with data-dependent frontiers
// that do not map to batched tensor ops.
//
//   suzuki_contours  Suzuki-Abe border following (imgproc/src/contours.cpp)
//   flood_fill_u8    4/8-connected flood fill (imgproc/src/floodfill.cpp)
//   maxflow_grid     Dinic's max-flow on GrabCut's 8-neighbour grid graph
//                    (the role of GCGraph<double>, imgproc/src/gcgraph.hpp)
//   watershed_u8c3   marker-controlled watershed (imgproc/src/segmentation.cpp)
//   mser_detect      MSER's component tree and stability selection
//                    (features2d/src/mser.cpp)
//   filter_speckles_i32  small blobs of similar disparity set to a value
//                    (calib3d/src/stereosgbm.cpp filterSpecklesImpl)
//
// and the codecs' entropy loops, copied from the JAX package's
// native/hosttails.cpp as they are:
//
//   jpeg_decode_blocks, jpeg_encode_blocks  baseline JPEG's Huffman coder
//   ebcot_t1_decode, ebcot_t1_encode        JPEG 2000's EBCOT tier-1 (MQ coder)
//   hfyu_decode_syms, hfyu_encode_syms      HuffYUV's symbol coder
//   ffv1_decode_slice, ffv1_encode_slice    FFV1's Golomb-Rice slice coder
//   crc32_msb                               FFV1's CRC (polynomial 0x04C11DB7)
//
// Built by opencv_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC
// -std=c++17) at the first call and loaded with ctypes.  The Python twins in
// opencv_tpu_torch/ops/contours.py, ops/segmentation.py, ops/grabcut.py,
// features2d/mser.py, calib3d/misc3d.py and imgcodecs/ are their plain
// versions, which the tests hold them to.

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

// ------------------------------------------------------------------ MSER
// Union-find immersion over gray levels building the component tree
// (the role of the reference's linked-list flood in
// features2d/src/mser.cpp), then VLFeat-style stability selection:
//   var(n) = (size(ancestor at level <= n.level + delta) - size) / size
// A node is kept when var <= max_variation, it is a local minimum of
// var along its chain, and it differs from its nearest kept ancestor
// by at least min_diversity.
// Output: (seed_pixel, level) pairs; the caller floods to get pixels.

struct MserNode {
    int level;      // gray level of this snapshot
    int size;       // pixels at that level
    int parent;     // next snapshot upward (-1 = root)
    int seed;       // any pixel inside
    double var;
    bool stable;
};

extern "C" int mser_detect(const uint8_t* img, int H, int W,
                int delta, int min_area, int max_area,
                double max_variation, double min_diversity,
                int32_t* out_seeds, int32_t* out_levels, int max_out)
{
    const int N = H * W;
    std::vector<int> order(N);
    {   // counting sort by gray level
        int cnt[257] = {0};
        for (int i = 0; i < N; i++) cnt[img[i] + 1]++;
        for (int i = 0; i < 256; i++) cnt[i + 1] += cnt[i];
        for (int i = 0; i < N; i++) order[cnt[img[i]]++] = i;
    }

    std::vector<int> ufp(N, -1);        // union-find parent (-1 inactive)
    std::vector<int> comp_node(N, -1);  // root pixel -> node index
    std::vector<MserNode> nodes;
    nodes.reserve(N / 4 + 16);

    auto find = [&](int x) {
        int r = x;
        while (ufp[r] != r) r = ufp[r];
        while (ufp[x] != r) { int nx = ufp[x]; ufp[x] = r; x = nx; }
        return r;
    };

    const int dx[4] = {1, -1, 0, 0};
    const int dy[4] = {0, 0, 1, -1};

    for (int oi = 0; oi < N; oi++) {
        int p = order[oi];
        int g = img[p];
        ufp[p] = p;
        int node = (int)nodes.size();
        nodes.push_back({g, 1, -1, p, 0.0, false});
        comp_node[p] = node;
        int px = p % W, py = p / W;
        for (int k = 0; k < 4; k++) {
            int nxx = px + dx[k], nyy = py + dy[k];
            if (nxx < 0 || nxx >= W || nyy < 0 || nyy >= H) continue;
            int q = nyy * W + nxx;
            if (ufp[q] < 0) continue;
            int rp = find(p), rq = find(q);
            if (rp == rq) continue;
            int na = comp_node[rp], nb = comp_node[rq];
            // merge at level g: ensure both chains have a snapshot at g
            auto lift = [&](int n) {
                if (nodes[n].level == g) return n;
                int nn = (int)nodes.size();
                nodes.push_back({g, nodes[n].size, -1, nodes[n].seed,
                                 0.0, false});
                nodes[n].parent = nn;
                return nn;
            };
            int la = lift(na), lb = lift(nb);
            // attach smaller chain under larger
            int keep = la, drop = lb, rkeep = rp, rdrop = rq;
            if (nodes[lb].size > nodes[la].size) {
                keep = lb; drop = la; rkeep = rq; rdrop = rp;
            }
            nodes[keep].size += nodes[drop].size;
            // drop-node becomes an alias: link it upward into keep
            nodes[drop].parent = keep;
            ufp[rdrop] = rkeep;
            comp_node[rkeep] = keep;
        }
    }

    int M = (int)nodes.size();
    // compute var for every node: find ancestor at level <= level+delta
    for (int i = 0; i < M; i++) {
        int target = nodes[i].level + delta;
        int a = i;
        while (nodes[a].parent >= 0 && nodes[nodes[a].parent].level <= target)
            a = nodes[a].parent;
        nodes[i].var = (double)(nodes[a].size - nodes[i].size)
                       / (double)nodes[i].size;
    }
    // local-minimum test along parent chains: mark nodes whose var is
    // <= parent's var and <= any child's var (children via one sweep)
    std::vector<double> child_min(M, 1e30);
    for (int i = 0; i < M; i++) {
        int par = nodes[i].parent;
        if (par >= 0 && nodes[i].var < child_min[par])
            child_min[par] = nodes[i].var;
    }
    for (int i = 0; i < M; i++) {
        const MserNode& n = nodes[i];
        if (n.size < min_area || n.size > max_area) continue;
        if (n.var > max_variation) continue;
        double pv = n.parent >= 0 ? nodes[n.parent].var : 1e30;
        // skip alias snapshots (same level as parent)
        if (n.parent >= 0 && nodes[n.parent].level == n.level) continue;
        if (n.var <= pv && n.var <= child_min[i])
            nodes[i].stable = true;
    }
    // diversity pruning: walk up from each stable node; if a stable
    // ancestor is too similar, keep the one with smaller var
    for (int i = 0; i < M; i++) {
        if (!nodes[i].stable) continue;
        int a = nodes[i].parent;
        while (a >= 0) {
            if (nodes[a].stable) {
                double div = (double)(nodes[a].size - nodes[i].size)
                             / (double)nodes[a].size;
                if (div < min_diversity) {
                    if (nodes[a].var >= nodes[i].var)
                        nodes[a].stable = false;
                    else { nodes[i].stable = false; break; }
                } else break;
            }
            a = nodes[a].parent;
        }
    }

    int cnt = 0;
    for (int i = 0; i < M && cnt < max_out; i++) {
        if (!nodes[i].stable) continue;
        out_seeds[cnt] = nodes[i].seed;
        out_levels[cnt] = nodes[i].level;
        cnt++;
    }
    return cnt;
}

// filterSpeckles: every 4-connected blob of pixels that are not newVal and
// whose neighbours differ by at most max_diff is set to newVal when it has
// at most max_size pixels.  img: H*W int32, changed in place.  The blobs are
// the connected components of a symmetric relation, so the raster order of
// the seeds and the stack order of the flood (those of the Python twin,
// calib3d/misc3d.py::_filter_speckles_py) do not change the result.
// Returns the number of pixels set.
extern "C" int64_t filter_speckles_i32(int32_t* img, int H, int W, int32_t new_val,
                                       int64_t max_size, int64_t max_diff)
{
    const int64_t n = (int64_t)H * W;
    std::vector<uint8_t> seen(n, 0);
    std::vector<int64_t> stack, comp;
    int64_t set = 0;
    for (int64_t p0 = 0; p0 < n; ++p0) {
        if (img[p0] == new_val || seen[p0]) continue;
        seen[p0] = 1;
        stack.assign(1, p0);
        comp.clear();
        while (!stack.empty()) {
            const int64_t p = stack.back();
            stack.pop_back();
            comp.push_back(p);
            const int64_t v = img[p];
            const int y = (int)(p / W), x = (int)(p % W);
            const int64_t nb[4] = {y + 1 < H ? p + W : -1, y > 0 ? p - W : -1,
                                   x + 1 < W ? p + 1 : -1, x > 0 ? p - 1 : -1};
            for (int k = 0; k < 4; ++k) {
                const int64_t q = nb[k];
                if (q < 0 || seen[q] || img[q] == new_val) continue;
                const int64_t d = (int64_t)img[q] - v;
                if (d <= max_diff && -d <= max_diff) {
                    seen[q] = 1;
                    stack.push_back(q);
                }
            }
        }
        if ((int64_t)comp.size() <= max_size) {
            for (int64_t p : comp) img[p] = new_val;
            set += (int64_t)comp.size();
        }
    }
    return set;
}

// ===========================================================================
// JPEG baseline entropy codec (grfmt_jpeg analogue — the reference links
// libjpeg-turbo; this is the sequential Huffman hot loop the Python tier
// cannot do fast).  Semantics mirror imgcodecs/jpeg.py exactly:
//  - bit reader stops feeding at any non-stuffing marker, zero-pads reads
//  - coefficients are stored in ZIGZAG index order per 64-block
//  - restart intervals resync by scanning for FFD0..FFD7
// ===========================================================================

namespace jpegent {

struct HuffDec {
    // canonical decode: mincode/maxcode/valptr per code length 1..16
    int32_t mincode[17], maxcode[17], valptr[17];
    const uint8_t* vals;
    void build(const uint8_t* bits, const uint8_t* values) {
        vals = values;
        int code = 0, k = 0;
        for (int l = 1; l <= 16; l++) {
            valptr[l] = k;
            mincode[l] = code;
            code += bits[l - 1];
            k += bits[l - 1];
            maxcode[l] = code - 1;       // inclusive; -1 span if none
            code <<= 1;
        }
    }
};

struct BitReader {
    const uint8_t* data;
    long long n, pos;
    uint64_t buf;
    int nbits;
    BitReader(const uint8_t* d, long long nn)
        : data(d), n(nn), pos(0), buf(0), nbits(0) {}
    void fill() {
        while (nbits <= 24 && pos < n) {
            uint8_t b = data[pos++];
            if (b == 0xFF) {
                uint8_t nxt = pos < n ? data[pos] : 0;
                if (nxt == 0x00) {
                    pos++;
                } else {           // marker: stop feeding
                    pos--;
                    return;
                }
            }
            buf = (buf << 8) | b;
            nbits += 8;
        }
    }
    int read(int nb) {
        // nb comes from entropy-decoded symbols of untrusted files; a
        // crafted DHT can yield nb up to 255.  Clamp to the widest legal
        // JPEG bit-field (16) so shifts stay defined; callers validate
        // the symbol and fail the decode before using such values.
        if (nb <= 0) return 0;
        if (nb > 16) nb = 16;
        fill();
        if (nbits < nb) {          // zero-pad past the end (python parity)
            buf <<= (nb - nbits);
            nbits = nb;
        }
        int v = (int)((buf >> (nbits - nb)) & (((uint64_t)1 << nb) - 1));
        nbits -= nb;
        buf &= (nbits >= 64) ? ~0ull : ((1ull << nbits) - 1);
        return v;
    }
    int decode(const HuffDec& h) {
        int code = 0;
        for (int l = 1; l <= 16; l++) {
            code = (code << 1) | read(1);
            if (h.maxcode[l] >= h.mincode[l] && code >= h.mincode[l]
                && code <= h.maxcode[l])
                return h.vals[h.valptr[l] + (code - h.mincode[l])];
        }
        return -1;                 // bad code
    }
    void resync() {                // skip to just past the next RST marker
        nbits = 0;
        buf = 0;
        while (pos < n - 1) {
            if (data[pos] == 0xFF && data[pos + 1] >= 0xD0
                && data[pos + 1] <= 0xD7) {
                pos += 2;
                return;
            }
            pos++;
        }
        pos = n;
    }
};

static inline int extend(int v, int t) {
    return (t > 0 && v < (1 << (t - 1))) ? v - (1 << t) + 1 : v;
}

}  // namespace jpegent

extern "C" long long jpeg_decode_blocks(
    const uint8_t* data, long long nbytes,
    int ncomp, const int* comp_h, const int* comp_v,
    const int* scan_ci, const int* scan_td, const int* scan_ta, int nscan,
    int mcux, int mcuy, int dri,
    const uint8_t* dcb, const uint8_t* dcv,   // (4,16) and (4,256)
    const uint8_t* acb, const uint8_t* acv,
    int32_t* coeff, const long long* comp_off) {
    using namespace jpegent;
    HuffDec dc[4], ac[4];
    for (int t = 0; t < 4; t++) {
        dc[t].build(dcb + 16 * t, dcv + 256 * t);
        ac[t].build(acb + 16 * t, acv + 256 * t);
    }
    BitReader rd(data, nbytes);
    int pred[4] = {0, 0, 0, 0};
    long long nmcu = 0;
    for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
            if (dri && nmcu && nmcu % dri == 0) {
                rd.resync();
                for (int c = 0; c < 4; c++) pred[c] = 0;
            }
            for (int si = 0; si < nscan; si++) {
                int ci = scan_ci[si];
                const HuffDec& hd = dc[scan_td[si]];
                const HuffDec& ha = ac[scan_ta[si]];
                int bw = mcux * comp_h[ci];
                for (int v = 0; v < comp_v[ci]; v++)
                    for (int h = 0; h < comp_h[ci]; h++) {
                        int32_t* blk = coeff + comp_off[ci]
                            + ((long long)(my * comp_v[ci] + v) * bw
                               + (mx * comp_h[ci] + h)) * 64;
                        int t = rd.decode(hd);
                        // DC categories are 0..15 (0..11 for 8-bit); a
                        // larger symbol means a corrupt/crafted DHT —
                        // fail the decode cleanly instead of hitting UB.
                        if (t < 0 || t > 15) return -1;
                        pred[ci] += extend(rd.read(t), t);
                        blk[0] = pred[ci];
                        int k = 1;
                        while (k < 64) {
                            int rs = rd.decode(ha);
                            if (rs < 0) return -1;
                            int r = rs >> 4, s = rs & 15;
                            if (s == 0) {
                                if (r == 15) { k += 16; continue; }
                                break;
                            }
                            k += r;
                            if (k > 63) return -1;
                            blk[k] = extend(rd.read(s), s);
                            k++;
                        }
                    }
            }
            nmcu++;
        }
    return 0;
}

namespace jpegent {

struct HuffEnc {
    uint16_t code[256];
    uint8_t len[256];
    void build(const uint8_t* bits, const uint8_t* values) {
        for (int i = 0; i < 256; i++) len[i] = 0;
        int c = 0, k = 0;
        for (int l = 1; l <= 16; l++) {
            for (int i = 0; i < bits[l - 1]; i++) {
                code[values[k]] = (uint16_t)c;
                len[values[k]] = (uint8_t)l;
                c++;
                k++;
            }
            c <<= 1;
        }
    }
};

struct BitWriter {
    uint8_t* out;
    long long cap, n;
    uint64_t acc;
    int nb;
    bool overflow;
    BitWriter(uint8_t* o, long long c)
        : out(o), cap(c), n(0), acc(0), nb(0), overflow(false) {}
    void put(uint32_t code, int length) {
        acc = (acc << length) | (code & ((1u << length) - 1));
        nb += length;
        while (nb >= 8) {
            uint8_t b = (uint8_t)((acc >> (nb - 8)) & 0xFF);
            if (n >= cap) { overflow = true; return; }
            out[n++] = b;
            if (b == 0xFF) {
                if (n >= cap) { overflow = true; return; }
                out[n++] = 0x00;
            }
            nb -= 8;
            acc &= (1ull << nb) - 1;
        }
    }
    void flush() {
        if (nb) {
            int pad = 8 - nb;
            put((1u << pad) - 1, pad);
        }
    }
};

}  // namespace jpegent

extern "C" long long jpeg_encode_blocks(
    const int32_t* coeff, const long long* comp_off,
    int ncomp, const int* comp_h, const int* comp_v, const int* comp_tq,
    int mcux, int mcuy,
    const uint8_t* dcb, const uint8_t* dcv,   // (2,16), (2,256)
    const uint8_t* acb, const uint8_t* acv,
    uint8_t* out, long long cap) {
    using namespace jpegent;
    HuffEnc dc[2], ac[2];
    for (int t = 0; t < 2; t++) {
        dc[t].build(dcb + 16 * t, dcv + 256 * t);
        ac[t].build(acb + 16 * t, acv + 256 * t);
    }
    BitWriter wr(out, cap);
    int pred[4] = {0, 0, 0, 0};
    for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++)
            for (int ci = 0; ci < ncomp; ci++) {
                int tq = comp_tq[ci];
                const HuffEnc& hd = dc[tq];
                const HuffEnc& ha = ac[tq];
                int bw = mcux * comp_h[ci];
                for (int dv = 0; dv < comp_v[ci]; dv++)
                    for (int dh = 0; dh < comp_h[ci]; dh++) {
                        const int32_t* blk = coeff + comp_off[ci]
                            + ((long long)(my * comp_v[ci] + dv) * bw
                               + (mx * comp_h[ci] + dh)) * 64;
                        int diff = blk[0] - pred[ci];
                        pred[ci] = blk[0];
                        int a = diff < 0 ? -diff : diff;
                        int t = 0;
                        while (a >> t) t++;
                        int bitsv = diff < 0 ? diff + (1 << t) - 1 : diff;
                        wr.put(hd.code[t], hd.len[t]);
                        if (t) wr.put((uint32_t)bitsv & ((1u << t) - 1), t);
                        int last = 0;
                        for (int k = 63; k >= 1; k--)
                            if (blk[k]) { last = k; break; }
                        int run = 0;
                        for (int k = 1; k <= last; k++) {
                            int val = blk[k];
                            if (!val) { run++; continue; }
                            while (run >= 16) {
                                wr.put(ha.code[0xF0], ha.len[0xF0]);
                                run -= 16;
                            }
                            a = val < 0 ? -val : val;
                            t = 0;
                            while (a >> t) t++;
                            bitsv = val < 0 ? val + (1 << t) - 1 : val;
                            wr.put(ha.code[(run << 4) | t],
                                   ha.len[(run << 4) | t]);
                            wr.put((uint32_t)bitsv & ((1u << t) - 1), t);
                            run = 0;
                        }
                        if (last < 63) wr.put(ha.code[0], ha.len[0]);
                        if (wr.overflow) return -1;
                    }
            }
    wr.flush();
    return wr.overflow ? -1 : wr.n;
}

#include <cstdlib>
#include <cstring>

/* ============================================================= JPEG 2000
   EBCOT Tier-1 + MQ coder (ISO 15444-1 C.2/C.3, D.1-D.4) — the
   sequential per-codeblock hot loop behind imgcodecs/jpeg2000.py.
   Mirrors the Python implementation bit-for-bit. */

static const uint16_t MQ_QE[47] = {
  0x5601,0x3401,0x1801,0x0AC1,0x0521,0x0221,0x5601,0x5401,0x4801,0x3801,
  0x3001,0x2401,0x1C01,0x1601,0x5601,0x5401,0x5101,0x4801,0x3801,0x3401,
  0x3001,0x2801,0x2401,0x2201,0x1C01,0x1801,0x1601,0x1401,0x1201,0x1101,
  0x0AC1,0x09C1,0x08A1,0x0521,0x0441,0x02A1,0x0221,0x0141,0x0111,0x0085,
  0x0049,0x0025,0x0015,0x0009,0x0005,0x0001,0x5601};
static const uint8_t MQ_NMPS[47] = {
  1,2,3,4,5,38,7,8,9,10,11,12,13,29,15,16,17,18,19,20,21,22,23,24,25,26,
  27,28,29,30,31,32,33,34,35,36,37,38,39,40,41,42,43,44,45,45,46};
static const uint8_t MQ_NLPS[47] = {
  1,6,9,12,29,33,6,14,14,14,17,18,20,21,14,14,15,16,17,18,19,19,20,21,22,
  23,24,25,26,27,28,29,30,31,32,33,34,35,36,37,38,39,40,41,42,43,46};
static const uint8_t MQ_SW[47] = {
  1,0,0,0,0,0,1,0,0,0,0,0,0,0,1,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
  0,0,0,0,0,0,0,0,0,0,0,0};

struct MqDec {
  const uint8_t* d; int len; int bp;
  uint32_t c, a; int ct;
  uint8_t idx[19], mps[19];
};

static void mqd_bytein(MqDec* m) {
  uint8_t b0 = (m->bp < m->len) ? m->d[m->bp] : 0xFF;
  uint8_t b1 = (m->bp + 1 < m->len) ? m->d[m->bp + 1] : 0xFF;
  if (b0 == 0xFF) {
    if (b1 > 0x8F) { m->c += 0xFF00; m->ct = 8; }
    else { m->bp++; m->c += (uint32_t)b1 << 9; m->ct = 7; }
  } else { m->bp++; m->c += (uint32_t)b1 << 8; m->ct = 8; }
}

static void mqd_init(MqDec* m, const uint8_t* d, int len) {
  m->d = d; m->len = len; m->bp = 0;
  for (int i = 0; i < 19; i++) { m->idx[i] = 0; m->mps[i] = 0; }
  m->idx[18] = 46; m->idx[17] = 3; m->idx[0] = 4;
  m->c = (uint32_t)(len ? d[0] : 0xFF) << 16;
  m->ct = 0;
  mqd_bytein(m);
  m->c <<= 7; m->ct -= 7; m->a = 0x8000;
}

static int mqd_decode(MqDec* m, int cx) {
  uint32_t qe = MQ_QE[m->idx[cx]];
  int d;
  m->a -= qe;
  if ((m->c >> 16) < qe) {
    if (m->a < qe) { d = m->mps[cx]; m->idx[cx] = MQ_NMPS[m->idx[cx]]; }
    else {
      d = 1 - m->mps[cx];
      if (MQ_SW[m->idx[cx]]) m->mps[cx] = 1 - m->mps[cx];
      m->idx[cx] = MQ_NLPS[m->idx[cx]];
    }
    m->a = qe;
    do {
      if (m->ct == 0) mqd_bytein(m);
      m->a <<= 1; m->c <<= 1; m->ct--;
    } while (!(m->a & 0x8000));
  } else {
    m->c -= qe << 16;
    if ((m->a & 0x8000) == 0) {
      if (m->a < qe) {
        d = 1 - m->mps[cx];
        if (MQ_SW[m->idx[cx]]) m->mps[cx] = 1 - m->mps[cx];
        m->idx[cx] = MQ_NLPS[m->idx[cx]];
      } else { d = m->mps[cx]; m->idx[cx] = MQ_NMPS[m->idx[cx]]; }
      do {
        if (m->ct == 0) mqd_bytein(m);
        m->a <<= 1; m->c <<= 1; m->ct--;
      } while (!(m->a & 0x8000));
    } else d = m->mps[cx];
  }
  return d;
}

static inline int zc_ctx(const uint8_t* sig, int stride, int y, int x,
                         int orient) {
  const uint8_t* p = sig + y * stride + x;
  int h = p[-1] + p[1];
  int v = p[-stride] + p[stride];
  int dg = p[-stride-1] + p[-stride+1] + p[stride-1] + p[stride+1];
  if (orient == 1) { int t = h; h = v; v = t; }
  if (orient != 3) {
    if (h == 2) return 8;
    if (h == 1) { if (v >= 1) return 7; return dg >= 1 ? 6 : 5; }
    if (v == 2) return 4;
    if (v == 1) return 3;
    return dg >= 2 ? 2 : (dg == 1 ? 1 : 0);
  }
  int hv = h + v;
  if (dg >= 3) return 8;
  if (dg == 2) return hv >= 1 ? 7 : 6;
  if (dg == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
  return hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
}

static inline void sc_ctx(const uint8_t* sig, const uint8_t* sgn,
                          int stride, int y, int x, int* cx, int* xorbit) {
  const uint8_t* ps = sig + y * stride + x;
  const uint8_t* pg = sgn + y * stride + x;
  int h = (ps[-1] ? (pg[-1] ? -1 : 1) : 0)
        + (ps[1] ? (pg[1] ? -1 : 1) : 0);
  int v = (ps[-stride] ? (pg[-stride] ? -1 : 1) : 0)
        + (ps[stride] ? (pg[stride] ? -1 : 1) : 0);
  if (h > 1) h = 1; if (h < -1) h = -1;
  if (v > 1) v = 1; if (v < -1) v = -1;
  if (h == 1)      { *cx = v == 1 ? 13 : (v == 0 ? 12 : 11); *xorbit = 0; }
  else if (h == 0) {
    if (v == 1) { *cx = 10; *xorbit = 0; }
    else if (v == 0) { *cx = 9; *xorbit = 0; }
    else { *cx = 10; *xorbit = 1; }
  } else           { *cx = v == 1 ? 11 : (v == 0 ? 12 : 13); *xorbit = 1; }
}

static inline int any_nb(const uint8_t* sig, int stride, int y, int x) {
  const uint8_t* p = sig + y * stride + x;
  return p[-stride-1] | p[-stride] | p[-stride+1] | p[-1] | p[1]
       | p[stride-1] | p[stride] | p[stride+1];
}

extern "C" int ebcot_t1_decode(const uint8_t* data, int len, int w, int h,
                    int numbps, int orient, int num_passes,
                    int64_t* out) {
  int stride = w + 2;
  int cells = (h + 2) * stride;
  uint8_t* sig = (uint8_t*)calloc(cells, 1);
  uint8_t* sgn = (uint8_t*)calloc(cells, 1);
  uint8_t* refined = (uint8_t*)calloc(h * w, 1);
  uint8_t* visited = (uint8_t*)calloc(h * w, 1);
  if (!sig || !sgn || !refined || !visited) {
    /* codeblock dims come from the untrusted codestream; fail cleanly */
    free(sig); free(sgn); free(refined); free(visited);
    return -1;
  }
  for (int i = 0; i < h * w; i++) out[i] = 0;
  MqDec mq; mqd_init(&mq, data, len);
  int bpno = numbps, passtype = 2;
  for (int p = 0; p < num_passes && bpno >= 1; p++) {
    int64_t one = (int64_t)1 << bpno;
    int64_t half = one >> 1;
    int64_t oph = one | half;
    if (passtype == 0) {
      for (int k = 0; k < h; k += 4) {
        int kend = k + 4 < h ? k + 4 : h;
        for (int i = 0; i < w; i++) {
          int x = i + 1;
          for (int j = k; j < kend; j++) {
            int y = j + 1;
            if (sig[y*stride + x]) continue;
            if (!any_nb(sig, stride, y, x)) continue;
            visited[j*w + i] = 1;
            if (mqd_decode(&mq, zc_ctx(sig, stride, y, x, orient))) {
              int cx, xb; sc_ctx(sig, sgn, stride, y, x, &cx, &xb);
              int s = mqd_decode(&mq, cx) ^ xb;
              sig[y*stride + x] = 1; sgn[y*stride + x] = (uint8_t)s;
              out[j*w + i] = s ? -oph : oph;
            }
          }
        }
      }
    } else if (passtype == 1) {
      for (int k = 0; k < h; k += 4) {
        int kend = k + 4 < h ? k + 4 : h;
        for (int i = 0; i < w; i++) {
          int x = i + 1;
          for (int j = k; j < kend; j++) {
            int y = j + 1;
            if (!sig[y*stride + x] || visited[j*w + i]) continue;
            int cx;
            if (!refined[j*w + i])
              cx = any_nb(sig, stride, y, x) ? 15 : 14;
            else cx = 16;
            int v = mqd_decode(&mq, cx);
            int neg = out[j*w + i] < 0;
            out[j*w + i] += (v ^ neg) ? half : -half;
            refined[j*w + i] = 1;
          }
        }
      }
    } else {
      for (int k = 0; k < h; k += 4) {
        int kend = k + 4 < h ? k + 4 : h;
        for (int i = 0; i < w; i++) {
          int x = i + 1;
          int j = k;
          int agg = (kend - k == 4);
          if (agg) {
            for (int jj = k; jj < kend; jj++) {
              int y = jj + 1;
              if (sig[y*stride + x] || visited[jj*w + i]
                  || any_nb(sig, stride, y, x)) { agg = 0; break; }
            }
          }
          int runlen = 0, first_agg = 0;
          if (agg) {
            if (!mqd_decode(&mq, 17)) continue;
            runlen = (mqd_decode(&mq, 18) << 1) | mqd_decode(&mq, 18);
            j = k + runlen; first_agg = 1;
          }
          for (int jj = j; jj < kend; jj++) {
            int y = jj + 1;
            if (sig[y*stride + x] || visited[jj*w + i]) continue;
            if (first_agg && jj == k + runlen) {
              first_agg = 0;
              int cx, xb; sc_ctx(sig, sgn, stride, y, x, &cx, &xb);
              int s = mqd_decode(&mq, cx) ^ xb;
              sig[y*stride + x] = 1; sgn[y*stride + x] = (uint8_t)s;
              out[jj*w + i] = s ? -oph : oph;
              continue;
            }
            if (mqd_decode(&mq, zc_ctx(sig, stride, y, x, orient))) {
              int cx, xb; sc_ctx(sig, sgn, stride, y, x, &cx, &xb);
              int s = mqd_decode(&mq, cx) ^ xb;
              sig[y*stride + x] = 1; sgn[y*stride + x] = (uint8_t)s;
              out[jj*w + i] = s ? -oph : oph;
            }
          }
        }
      }
      memset(visited, 0, h * w);
    }
    if (++passtype == 3) { passtype = 0; bpno--; }
  }
  free(sig); free(sgn); free(refined); free(visited);
  return 0;
}

struct MqEnc {
  uint32_t a, c; int ct;
  uint8_t* out; int pos, cap;
  int overflow;
  uint8_t idx[19], mps[19];
};

static void mqe_byteout(MqEnc* m) {
  if (m->pos + 1 >= m->cap) { m->overflow = 1; return; }
  if (m->out[m->pos] == 0xFF) {
    m->pos++; m->out[m->pos] = (uint8_t)(m->c >> 20);
    m->c &= 0xFFFFF; m->ct = 7;
  } else {
    if ((m->c & 0x8000000) == 0) {
      m->pos++; m->out[m->pos] = (uint8_t)(m->c >> 19);
      m->c &= 0x7FFFF; m->ct = 8;
    } else {
      m->out[m->pos]++;
      if (m->out[m->pos] == 0xFF) {
        m->c &= 0x7FFFFFF;
        m->pos++; m->out[m->pos] = (uint8_t)(m->c >> 20);
        m->c &= 0xFFFFF; m->ct = 7;
      } else {
        m->pos++; m->out[m->pos] = (uint8_t)(m->c >> 19);
        m->c &= 0x7FFFF; m->ct = 8;
      }
    }
  }
}

static void mqe_renorm(MqEnc* m) {
  do {
    m->a <<= 1; m->c <<= 1; m->ct--;
    if (m->ct == 0) mqe_byteout(m);
  } while (!(m->a & 0x8000));
}

static void mqe_encode(MqEnc* m, int d, int cx) {
  uint32_t qe = MQ_QE[m->idx[cx]];
  if (m->mps[cx] == d) {
    m->a -= qe;
    if ((m->a & 0x8000) == 0) {
      if (m->a < qe) m->a = qe; else m->c += qe;
      m->idx[cx] = MQ_NMPS[m->idx[cx]];
      mqe_renorm(m);
    } else m->c += qe;
  } else {
    m->a -= qe;
    if (m->a < qe) m->c += qe; else m->a = qe;
    if (MQ_SW[m->idx[cx]]) m->mps[cx] = 1 - m->mps[cx];
    m->idx[cx] = MQ_NLPS[m->idx[cx]];
    mqe_renorm(m);
  }
}

extern "C" int ebcot_t1_encode(const int64_t* coeffs, int w, int h, int orient,
                    uint8_t* outbuf, int cap, int* out_numbps,
                    int* out_len) {
  int stride = w + 2;
  int cells = (h + 2) * stride;
  int64_t maxmag = 0;
  for (int i = 0; i < h * w; i++) {
    int64_t m = coeffs[i] < 0 ? -coeffs[i] : coeffs[i];
    if (m > maxmag) maxmag = m;
  }
  if (maxmag == 0) { *out_numbps = 0; *out_len = 0; return 0; }
  int numbps = 0;
  while ((maxmag >> numbps) != 0) numbps++;
  uint8_t* sig = (uint8_t*)calloc(cells, 1);
  uint8_t* sgn = (uint8_t*)calloc(cells, 1);
  uint8_t* refined = (uint8_t*)calloc(h * w, 1);
  uint8_t* visited = (uint8_t*)calloc(h * w, 1);
  if (!sig || !sgn || !refined || !visited) {
    free(sig); free(sgn); free(refined); free(visited);
    return -1;
  }
  MqEnc mq;
  mq.a = 0x8000; mq.c = 0; mq.ct = 12;
  mq.out = outbuf; mq.pos = 0; mq.cap = cap; mq.overflow = 0;
  outbuf[0] = 0;   /* fake byte before start */
  for (int i = 0; i < 19; i++) { mq.idx[i] = 0; mq.mps[i] = 0; }
  mq.idx[18] = 46; mq.idx[17] = 3; mq.idx[0] = 4;

  int npasses = 1 + 3 * (numbps - 1);
  int passtype = 2, bpno = numbps - 1;
  for (int p = 0; p < npasses; p++) {
    if (passtype == 0) {
      for (int k = 0; k < h; k += 4) {
        int kend = k + 4 < h ? k + 4 : h;
        for (int i = 0; i < w; i++) {
          int x = i + 1;
          for (int j = k; j < kend; j++) {
            int y = j + 1;
            if (sig[y*stride + x]) continue;
            if (!any_nb(sig, stride, y, x)) continue;
            visited[j*w + i] = 1;
            int64_t mg = coeffs[j*w + i] < 0 ? -coeffs[j*w + i]
                                             : coeffs[j*w + i];
            int bit = (int)((mg >> bpno) & 1);
            mqe_encode(&mq, bit, zc_ctx(sig, stride, y, x, orient));
            if (bit) {
              int cx, xb; sc_ctx(sig, sgn, stride, y, x, &cx, &xb);
              int neg = coeffs[j*w + i] < 0;
              mqe_encode(&mq, neg ^ xb, cx);
              sig[y*stride + x] = 1; sgn[y*stride + x] = (uint8_t)neg;
            }
          }
        }
      }
    } else if (passtype == 1) {
      for (int k = 0; k < h; k += 4) {
        int kend = k + 4 < h ? k + 4 : h;
        for (int i = 0; i < w; i++) {
          int x = i + 1;
          for (int j = k; j < kend; j++) {
            int y = j + 1;
            if (!sig[y*stride + x] || visited[j*w + i]) continue;
            int cx;
            if (!refined[j*w + i])
              cx = any_nb(sig, stride, y, x) ? 15 : 14;
            else cx = 16;
            int64_t mg = coeffs[j*w + i] < 0 ? -coeffs[j*w + i]
                                             : coeffs[j*w + i];
            mqe_encode(&mq, (int)((mg >> bpno) & 1), cx);
            refined[j*w + i] = 1;
          }
        }
      }
    } else {
      for (int k = 0; k < h; k += 4) {
        int kend = k + 4 < h ? k + 4 : h;
        for (int i = 0; i < w; i++) {
          int x = i + 1;
          int start = k;
          int agg = (kend - k == 4);
          if (agg) {
            for (int jj = k; jj < kend; jj++) {
              int y = jj + 1;
              if (sig[y*stride + x] || visited[jj*w + i]
                  || any_nb(sig, stride, y, x)) { agg = 0; break; }
            }
          }
          if (agg) {
            int runlen = -1;
            for (int jj = k; jj < kend; jj++) {
              int64_t mg = coeffs[jj*w + i] < 0 ? -coeffs[jj*w + i]
                                                : coeffs[jj*w + i];
              if ((mg >> bpno) & 1) { runlen = jj - k; break; }
            }
            if (runlen < 0) { mqe_encode(&mq, 0, 17); continue; }
            mqe_encode(&mq, 1, 17);
            mqe_encode(&mq, (runlen >> 1) & 1, 18);
            mqe_encode(&mq, runlen & 1, 18);
            int jj = k + runlen, y = jj + 1;
            int cx, xb; sc_ctx(sig, sgn, stride, y, x, &cx, &xb);
            int neg = coeffs[jj*w + i] < 0;
            mqe_encode(&mq, neg ^ xb, cx);
            sig[y*stride + x] = 1; sgn[y*stride + x] = (uint8_t)neg;
            start = jj + 1;
          }
          for (int jj = start; jj < kend; jj++) {
            int y = jj + 1;
            if (sig[y*stride + x] || visited[jj*w + i]) continue;
            int64_t mg = coeffs[jj*w + i] < 0 ? -coeffs[jj*w + i]
                                              : coeffs[jj*w + i];
            int bit = (int)((mg >> bpno) & 1);
            mqe_encode(&mq, bit, zc_ctx(sig, stride, y, x, orient));
            if (bit) {
              int cx, xb; sc_ctx(sig, sgn, stride, y, x, &cx, &xb);
              int neg = coeffs[jj*w + i] < 0;
              mqe_encode(&mq, neg ^ xb, cx);
              sig[y*stride + x] = 1; sgn[y*stride + x] = (uint8_t)neg;
            }
          }
        }
      }
      memset(visited, 0, h * w);
    }
    if (++passtype == 3) { passtype = 0; bpno--; }
  }
  /* flush (SETBITS + 2 byteouts) */
  {
    uint32_t tempc = mq.c + mq.a;
    mq.c |= 0xFFFF;
    if (mq.c >= tempc) mq.c -= 0x8000;
    mq.c <<= mq.ct; mqe_byteout(&mq);
    mq.c <<= mq.ct; mqe_byteout(&mq);
    int end = mq.pos;            /* index of last written byte */
    if (mq.out[end] == 0xFF) end--;
    *out_len = end;              /* bytes after the fake first byte */
  }
  *out_numbps = numbps;
  free(sig); free(sgn); free(refined); free(visited);
  return mq.overflow ? -1 : 0;  /* caller falls back / fails cleanly */
}


/* ------------------------------------------------------------------ */
/* HuffYUV symbol decoder (imgcodecs/huffyuv.py drives this).         */
/* Input is the already-bswapped bitstream (MSB-first bits); codes    */
/* are classic-huffyuv canonical (longest length first, symbol order, */
/* bits >>= 1 on each length decrease).  Single-level LUT: classic    */
/* tables max out at 15 bits; lengths up to 16 are supported.        */
/* ------------------------------------------------------------------ */

extern "C" int hfyu_decode_syms(const uint8_t* buf, long nbytes,
                                const uint8_t* lens, long n_syms,
                                uint8_t* out) {
  /* build canonical codes */
  uint32_t codes[256];
  int maxlen = 0;
  {
    uint32_t bits = 0;
    for (int ln = 32; ln > 0; ln--) {
      for (int sym = 0; sym < 256; sym++) {
        if (lens[sym] == ln) {
          codes[sym] = bits++;
          if (ln > maxlen) maxlen = ln;
        }
      }
      bits >>= 1;
    }
  }
  if (maxlen > 16 || maxlen == 0) return -2;
  /* LUT over 16-bit prefixes: (sym << 8) | len, 0 = invalid */
  static_assert(sizeof(uint32_t) == 4, "u32");
  uint32_t* lut = (uint32_t*)calloc(1 << 16, 4);
  if (!lut) return -1;
  for (int sym = 0; sym < 256; sym++) {
    int ln = lens[sym];
    if (!ln) continue;
    uint32_t base = codes[sym] << (16 - ln);
    uint32_t cnt = 1u << (16 - ln);
    uint32_t val = ((uint32_t)sym << 8) | (uint32_t)ln;
    for (uint32_t k = 0; k < cnt; k++) lut[base + k] = val;
  }
  /* bit reader: 64-bit window refilled byte-wise */
  uint64_t window = 0;
  int have = 0;          /* bits in window */
  long pos = 0;          /* next byte */
  long produced = 0;
  while (produced < n_syms) {
    while (have <= 48 && pos < nbytes) {
      window = (window << 8) | buf[pos++];
      have += 8;
    }
    if (have < maxlen && pos >= nbytes) {
      /* may still decode short codes from the tail */
      if (have <= 0) { free(lut); return -3; }
    }
    uint32_t peek;
    if (have >= 16) {
      peek = (uint32_t)((window >> (have - 16)) & 0xFFFF);
    } else {
      peek = (uint32_t)((window << (16 - have)) & 0xFFFF);
    }
    uint32_t e = lut[peek];
    int ln = (int)(e & 0xFF);
    if (ln == 0 || ln > have) { free(lut); return -3; }
    out[produced++] = (uint8_t)(e >> 8);
    have -= ln;
  }
  free(lut);
  return 0;
}

/* HuffYUV symbol encoder: MSB-first bit packing of canonical codes.
   Output is the UNswapped big-endian bitstream, padded with zero bits
   to a 4-byte boundary; the caller does the 32-bit LE word swap.
   Returns the byte length, or -1 if cap is too small. */
extern "C" long hfyu_encode_syms(const uint8_t* syms, long n_syms,
                                 const uint8_t* lens, uint8_t* out,
                                 long cap) {
  uint32_t codes[256];
  {
    uint32_t bits = 0;
    for (int ln = 32; ln > 0; ln--) {
      for (int sym = 0; sym < 256; sym++)
        if (lens[sym] == ln) codes[sym] = bits++;
      bits >>= 1;
    }
  }
  uint64_t acc = 0;
  int have = 0;
  long pos = 0;
  for (long i = 0; i < n_syms; i++) {
    int sym = syms[i];
    int ln = lens[sym];
    acc = (acc << ln) | codes[sym];
    have += ln;
    while (have >= 8) {
      if (pos >= cap) return -1;
      out[pos++] = (uint8_t)(acc >> (have - 8));
      have -= 8;
    }
  }
  if (have > 0) {
    if (pos >= cap) return -1;
    out[pos++] = (uint8_t)(acc << (8 - have));
  }
  while (pos & 3) {
    if (pos >= cap) return -1;
    out[pos++] = 0;
  }
  return pos;
}

/* ========================================================================
 * FFV1 slice residual coder (Golomb-Rice / coder_type 0), 8..16 bpp.
 *
 * Native port of the validated Python reference in imgcodecs/ffv1.py
 * (RFC 9043 bitstream; the reference reads/writes FFV1 through FFmpeg,
 * modules/videoio/src/cap_ffmpeg.cpp).  The range-coded parts (config
 * record, slice headers) stay in Python — they are tiny; this is the
 * per-pixel line loop.
 *
 * VlcState layout (int32[4]): {drift, error_sum, bias, count} — owned by
 * the caller as a numpy array so contexts persist across frames.
 * ===================================================================== */

static const uint8_t ffv1_log2_run[41] = {
    0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 5, 5,
    6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24};

/* 64-bit-cached MSB-first bit IO (left-aligned cache; bit 63 = next). */
struct FBitR {
  const uint8_t *p;
  int64_t len;     /* bytes */
  int64_t bytepos;
  uint64_t cache;
  int ncache;
};

static inline void f_refill(FBitR &b) {
  while (b.ncache <= 56) {
    uint64_t byte = b.bytepos < b.len ? b.p[b.bytepos] : 0;
    b.bytepos++;
    b.cache |= byte << (56 - b.ncache);
    b.ncache += 8;
  }
}

static inline int f_get_bit(FBitR &b) {
  if (b.ncache == 0) f_refill(b);
  int v = (int)(b.cache >> 63);
  b.cache <<= 1;
  b.ncache--;
  return v;
}

static inline uint32_t f_get_bits(FBitR &b, int n) {
  if (n == 0) return 0;
  if (b.ncache < n) f_refill(b);
  uint32_t v = (uint32_t)(b.cache >> (64 - n));
  b.cache <<= n;
  b.ncache -= n;
  return v;
}

static inline int64_t f_bits_consumed(const FBitR &b) {
  return b.bytepos * 8 - b.ncache;
}

struct FBitW {
  uint8_t *p;
  int64_t cap;     /* bytes */
  int64_t bytepos;
  uint64_t cache;
  int ncache;
};

static inline int f_put_bits(FBitW &b, uint32_t v, int n) {
  b.cache |= ((uint64_t)v & ((n < 64 ? (1ull << n) : 0) - 1))
             << (64 - b.ncache - n);
  b.ncache += n;
  while (b.ncache >= 8) {
    if (b.bytepos >= b.cap) return -1;
    b.p[b.bytepos++] = (uint8_t)(b.cache >> 56);
    b.cache <<= 8;
    b.ncache -= 8;
  }
  return 0;
}

static inline int64_t f_bw_flush(FBitW &b) {
  while (b.ncache > 0) {
    if (b.bytepos >= b.cap) return -1;
    b.p[b.bytepos++] = (uint8_t)(b.cache >> 56);
    b.cache <<= 8;
    b.ncache -= 8;
  }
  return b.bytepos;
}

static inline int f_vlc_k(const int32_t *s) {
  int i = s[3], k = 0;
  while (i < s[1]) { k++; i += i; }
  return k;
}

static inline void f_vlc_update(int32_t *s, int v) {
  int drift = s[0] + v;
  s[1] += v < 0 ? -v : v;
  int count = s[3];
  if (count == 128) { count >>= 1; drift >>= 1; s[1] >>= 1; }
  count++;
  if (drift <= -count) {
    s[2] = s[2] - 1 < -128 ? -128 : s[2] - 1;
    drift += count;
    if (drift < -count + 1) drift = -count + 1;
  } else if (drift > 0) {
    s[2] = s[2] + 1 > 127 ? 127 : s[2] + 1;
    drift -= count;
    if (drift > 0) drift = 0;
  }
  s[0] = drift;
  s[3] = count;
}

static inline int f_fold(int diff, int bits) {
  diff &= (1 << bits) - 1;
  if (diff & (1 << (bits - 1))) diff -= 1 << bits;
  return diff;
}

static inline int f_get_ur(FBitR &b, int k, int limit, int esc) {
  /* whole-symbol read off the 64-bit cache: refill guarantees >= 57
     bits, and q(<=limit=12) + 1 + k(<=16) fits comfortably */
  f_refill(b);
  uint64_t c = b.cache;
  int q = c ? __builtin_clzll(c) : 64;
  if (q >= limit) {
    b.cache <<= limit;
    b.ncache -= limit;
    return (int)f_get_bits(b, esc) + limit - 1;
  }
  uint32_t suffix = k ? (uint32_t)((c << (q + 1)) >> (64 - k)) : 0;
  b.cache <<= (q + 1 + k);
  b.ncache -= (q + 1 + k);
  return (q << k) | (int)suffix;
}

static inline int f_put_ur(FBitW &b, int v, int k, int limit, int esc) {
  int q = v >> k;
  if (q < limit)  /* q leading zeros are implicit in the n-bit value */
    return f_put_bits(b, (1u << k) | ((uint32_t)v & ((1u << k) - 1)),
                      q + 1 + k);
  if (f_put_bits(b, 0, limit)) return -1;
  return f_put_bits(b, (uint32_t)(v - limit + 1), esc);
}

static inline int f_get_vlc(FBitR &b, int32_t *s, int bits) {
  int k = f_vlc_k(s);
  unsigned uv = (unsigned)f_get_ur(b, k, 12, bits);
  int v = (int)(uv >> 1) ^ -(int)(uv & 1);
  if (2 * s[0] + s[3] < 0) v = -1 - v;
  int ret = f_fold(v + s[2], bits);
  f_vlc_update(s, v);
  return ret;
}

static inline int f_put_vlc(FBitW &b, int32_t *s, int v, int bits) {
  int k = f_vlc_k(s);
  int res = f_fold(v - s[2], bits);
  int code = res;
  if (2 * s[0] + s[3] < 0) code = -1 - code;
  unsigned uv = code >= 0 ? (unsigned)(code << 1)
                          : (unsigned)(((-code) << 1) - 1);
  if (f_put_ur(b, (int)uv, k, 12, bits)) return -1;
  f_vlc_update(s, res);
  return 0;
}

static inline int f_mid_pred(int a, int b, int c) {
  if (a > b) { int t = a; a = b; b = t; }
  return c < a ? a : (c > b ? b : c);
}

/* Decode one slice's residual section.
 * gb_buf/gb_len : Golomb section bytes
 * w,h,nplanes   : slice geometry and coded plane count (3 or 4 for RGB)
 * bits          : sample bits (9 for 8-bit RGB)
 * qts           : [nqt][5][256] int32 quant tables
 * plane_ctx     : [nplanes] plane-context index per coded plane
 * ctx_qt        : [nctx] quant-table index per plane context
 * vlc           : [nctx][max_cc][4] persistent VlcStates
 * run_index_io  : in/out run index
 * out           : [h][nplanes][w] decoded samples
 * returns bits consumed, or -1 on error. */
extern "C" int64_t ffv1_decode_slice(
    const uint8_t *gb_buf, int64_t gb_len, int w, int h, int nplanes,
    int bits, const int32_t *qts, const int32_t *plane_ctx,
    const int32_t *ctx_qt, int32_t *vlc, int32_t max_cc,
    int32_t *run_index_io, int32_t *out) {
  FBitR b{gb_buf, gb_len, 0, 0, 0};
  int stride = w + 5;
  int32_t *bufv = (int32_t *)calloc((size_t)nplanes * 3 * stride, 4);
  if (!bufv) return -1;
  int run_index = *run_index_io;
  int mask = (1 << bits) - 1;
  for (int y = 0; y < h; y++) {
    for (int p = 0; p < nplanes; p++) {
      int pc = plane_ctx[p];
      const int32_t *qt = qts + (size_t)ctx_qt[pc] * 5 * 256;
      const int32_t *q0 = qt, *q1 = qt + 256, *q2 = qt + 512,
                    *q3 = qt + 768, *q4 = qt + 1024;
      int five = q3[127] || q4[127];
      int32_t *base = bufv + (size_t)p * 3 * stride;
      int32_t *prev2 = base + (size_t)(y % 3) * stride;
      int32_t *prev = base + (size_t)((y + 1) % 3) * stride;
      int32_t *cur = base + (size_t)((y + 2) % 3) * stride;
      cur[1] = prev[2];
      cur[0] = prev[2];
      prev[w + 2] = prev[w + 1];
      prev[w + 3] = prev[w + 1];
      int32_t *stb = vlc + (size_t)pc * max_cc * 4;
      int run_mode = 0, run_count = 0;
      int32_t *orow = out + ((size_t)y * nplanes + p) * w;
      for (int x = 0; x < w; x++) {
        int i2 = x + 2;
        int l = cur[i2 - 1], t = prev[i2], lt = prev[i2 - 1],
            rt = prev[i2 + 1];
        int ctx = q0[(l - lt) & 0xFF] + q1[(lt - t) & 0xFF] +
                  q2[(t - rt) & 0xFF];
        if (five)
          ctx += q3[(cur[i2 - 2] - l) & 0xFF] + q4[(prev2[i2] - t) & 0xFF];
        int sign = 0;
        if (ctx < 0) { ctx = -ctx; sign = 1; }
        if (ctx >= max_cc) { free(bufv); return -1; }
        int diff;
        if (ctx == 0 && run_mode == 0) run_mode = 1;
        if (run_mode) {
          if (run_count == 0 && run_mode == 1) {
            if (f_get_bit(b)) {
              run_count = 1 << ffv1_log2_run[run_index];
              if (x + run_count <= w) run_index++;
            } else {
              run_count = ffv1_log2_run[run_index]
                              ? (int)f_get_bits(b, ffv1_log2_run[run_index])
                              : 0;
              if (run_index) run_index--;
              run_mode = 2;
            }
          }
          run_count--;
          if (run_count < 0) {
            run_mode = 0;
            run_count = 0;
            diff = f_get_vlc(b, stb + (size_t)ctx * 4, bits);
            if (diff >= 0) diff++;
          } else {
            diff = 0;
          }
        } else {
          diff = f_get_vlc(b, stb + (size_t)ctx * 4, bits);
        }
        if (sign) diff = -diff;
        cur[i2] = (f_mid_pred(l, t, l + t - lt) + diff) & mask;
        orow[x] = cur[i2];
      }
      if (f_bits_consumed(b) > (gb_len + 8) * 8) { free(bufv); return -1; }
    }
  }
  free(bufv);
  *run_index_io = run_index;
  return f_bits_consumed(b);
}

/* Encode one slice's residual section; returns byte count or -1. */
extern "C" int64_t ffv1_encode_slice(
    const int32_t *in, int w, int h, int nplanes, int bits,
    const int32_t *qts, const int32_t *plane_ctx, const int32_t *ctx_qt,
    int32_t *vlc, int32_t max_cc, int32_t *run_index_io, uint8_t *outb,
    int64_t out_cap) {
  FBitW b{outb, out_cap, 0, 0, 0};
  int stride = w + 5;
  int32_t *bufv = (int32_t *)calloc((size_t)nplanes * 3 * stride, 4);
  if (!bufv) return -1;
  int run_index = *run_index_io;
  for (int y = 0; y < h; y++) {
    for (int p = 0; p < nplanes; p++) {
      int pc = plane_ctx[p];
      const int32_t *qt = qts + (size_t)ctx_qt[pc] * 5 * 256;
      const int32_t *q0 = qt, *q1 = qt + 256, *q2 = qt + 512,
                    *q3 = qt + 768, *q4 = qt + 1024;
      int five = q3[127] || q4[127];
      int32_t *base = bufv + (size_t)p * 3 * stride;
      int32_t *prev2 = base + (size_t)(y % 3) * stride;
      int32_t *prev = base + (size_t)((y + 1) % 3) * stride;
      int32_t *cur = base + (size_t)((y + 2) % 3) * stride;
      const int32_t *irow = in + ((size_t)y * nplanes + p) * w;
      for (int x = 0; x < w; x++) cur[x + 2] = irow[x];
      cur[1] = prev[2];
      cur[0] = prev[2];
      prev[w + 2] = prev[w + 1];
      prev[w + 3] = prev[w + 1];
      int32_t *stb = vlc + (size_t)pc * max_cc * 4;
      int run_mode = 0, run_count = 0;
      for (int x = 0; x < w; x++) {
        int i2 = x + 2;
        int l = cur[i2 - 1], t = prev[i2], lt = prev[i2 - 1],
            rt = prev[i2 + 1];
        int ctx = q0[(l - lt) & 0xFF] + q1[(lt - t) & 0xFF] +
                  q2[(t - rt) & 0xFF];
        if (five)
          ctx += q3[(cur[i2 - 2] - l) & 0xFF] + q4[(prev2[i2] - t) & 0xFF];
        int sign = 0;
        if (ctx < 0) { ctx = -ctx; sign = 1; }
        if (ctx >= max_cc) { free(bufv); return -1; }
        int diff = cur[i2] - f_mid_pred(l, t, l + t - lt);
        if (sign) diff = -diff;
        diff = f_fold(diff, bits);
        if (ctx == 0 && run_mode == 0) run_mode = 1;
        if (run_mode) {
          if (diff) {
            while (run_count >= 1 << ffv1_log2_run[run_index]) {
              run_count -= 1 << ffv1_log2_run[run_index];
              run_index++;
              if (f_put_bits(b, 1, 1)) { free(bufv); return -1; }
            }
            if (f_put_bits(b, (uint32_t)run_count,
                           1 + ffv1_log2_run[run_index])) {
              free(bufv); return -1;
            }
            if (run_index) run_index--;
            run_count = 0;
            run_mode = 0;
            if (diff > 0) diff--;
          } else {
            run_count++;
          }
        }
        if (run_mode == 0 &&
            f_put_vlc(b, stb + (size_t)ctx * 4, diff, bits)) {
          free(bufv); return -1;
        }
      }
      if (run_mode) {
        while (run_count >= 1 << ffv1_log2_run[run_index]) {
          run_count -= 1 << ffv1_log2_run[run_index];
          run_index++;
          if (f_put_bits(b, 1, 1)) { free(bufv); return -1; }
        }
        if (run_count && f_put_bits(b, 1, 1)) { free(bufv); return -1; }
      }
    }
  }
  free(bufv);
  *run_index_io = run_index;
  return f_bw_flush(b);
}

/* CRC-32 poly 0x04C11DB7, MSB-first, init/xorout 0 (FFV1's record CRC). */
extern "C" uint32_t crc32_msb(const uint8_t *data, int64_t len,
                              uint32_t crc) {
  static uint32_t tbl[256];
  static int init = 0;
  if (!init) {
    for (int i = 0; i < 256; i++) {
      uint32_t c = (uint32_t)i << 24;
      for (int j = 0; j < 8; j++)
        c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : (c << 1);
      tbl[i] = c;
    }
    init = 1;
  }
  for (int64_t i = 0; i < len; i++)
    crc = (crc << 8) ^ tbl[((crc >> 24) ^ data[i]) & 0xFF];
  return crc;
}
