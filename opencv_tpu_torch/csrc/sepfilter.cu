// Separable integer correlation over u8 NHWC with OpenCV's finishing chain.
//
// Replaces the Pallas kernel opencv_tpu/kernels/sepfilter.py::sep_filter_int
// (and its sep_filter_u8 front end, both launched through _pallas_tiled).
// What it computes, per output pixel-channel (channels folded into the row,
// horizontal taps stride C):
//
//   acc = sum_j ky[j] * sum_i kx[i] * x[y - ay + j][x - ax + i]   (int32)
//   shift > 0 -> acc = (acc + 2^(shift-1)) >> shift
//   acc += delta
//   has_scale -> acc = rint((float)acc * (float)scale)
//   saturate to u8 or i16
//
// Bound.  Each input byte is read once and each output written once: at
// (8, 1080, 1920, 1) 16.6 MB in and 16.6 MB (u8) or 33.2 MB (i16) out, 9.9 us
// and 14.9 us at 3.35 TB/s.  The MACs are kw + kh per output, integer
// multiply-adds on 64 lanes per SM (132 SMs at ~1.9 GHz, about 16 T a
// second): 166 M at k = 5, about 10 us, and 232 M at k = 7, about 14 us.  The
// arithmetic costs as much as the bytes or more, so the design spends its
// instructions on it and little else.  On the H100 the k = 5 kernel reaches
// 23% (u8) and the k = 3 Sobel 42% (i16) of the memory bound (PERF.md, from
// perf/sweep_stencil_tiles.py, whose schedule probe shows warps that wait on
// neither memory nor barriers): what remains is instruction issue.
//
// Routes.  The host picks one per launch (kernels/sepfilter.py::
// sep_filter_route) and the entry refuses taps that do not meet it:
//  - K = 3, 5 or 7: kw == kh == K and sum |kx| * 255 < 2^16 (every
//    Gaussian, Sobel and small box filter of the main paths, ORB's 7x7 blur
//    and ArUco's 3x3 box included), the template below, fully unrolled on
//    the tap count, the channel count and the output type;
//  - 1, the box: the other taps whose kx are all one value a and whose ky
//    are all one value b (boxFilter, blur and adaptiveThreshold MEAN_C at
//    windows over 7, or kw != kh): acc = a * b * S, S the window's sum from
//    running sums (sep_box_kernel);
//  - 0: any other taps (kw != kh, k up to 31, large taps), a multiply-add
//    per tap (sep_generic_kernel).
//
// The template.  Each warp owns a strip of kStrip output rows by 512 output
// bytes (16 per thread) and walks down it.
//  - Staging, at any row width and any base alignment: lane 0 asks the copy
//    engine for the bytes [xs - 16, xs + 528) of each input row, widened to
//    16-byte granules and clamped to the granules of the input tensor, with
//    one cp.async.bulk into a ring of kStages stages of kStage bytes in
//    shared memory, completing on one mbarrier per stage; no register and no
//    per-byte instruction is spent on the copy, and kStages - 1 rows are in
//    flight.  A row that starts off = addr & 15 bytes into its granule lands
//    off bytes into its stage; off is the same for the whole warp (lane 0
//    keeps it beside the stage), and a lane reads its words at byte off with
//    word loads and a funnel shift (one 16-byte load when off = 0, the case
//    of rows of W*C % 16 == 0 on an aligned base).  The bytes of the window outside the row (the
//    neighbouring rows, or stale bytes where the tensor ends) feed only
//    outputs the edge blocks compute; a granule that holds a byte of the
//    tensor lies on a mapped page, so the copy cannot fault.  The words of
//    row r + 1 are read while row r computes (two register buffers, the loop
//    unrolled by two).  BORDER_CONSTANT rows are not staged: they are in
//    registers.
//  - The horizontal halo (up to 12 bytes at K = 7, C = 4) comes from the
//    neighbour lanes by shuffle (lanes 0 and 31 read the 16 staged bytes
//    past the warp's).  The horizontal pass runs on two lanes per register
//    in 16-bit halves (one byte_perm, a mask and a multiply-add per tap and
//    pair); a negative tap takes 255 - x by a xor, and the bias is taken off
//    each output once.  The last K horizontal sums stay in registers packed
//    as they were computed, two per word (K * 8 registers).
//  - The vertical pass runs on the packed words: per pair, T = sum ky[j] *
//    word[j] and the high half's sum Hi = sum ky[j] * (word[j] >> 16); the
//    low half's sum is T - (Hi << 16), exact modulo 2^32 as the int32
//    accumulator is.
//  - No division and no per-byte border work in the loop: the border is
//    resolved once per input row (its source row).  An output whose window
//    crosses the left or right edge of the image (the first and last K/2
//    pixels of a row) is not stored by the main blocks: one extra column of
//    blocks in the same launch computes those outputs one by one, from a row
//    table and the edge tables of common.cuh, built once per block.
//  - Output rows of W*C % 16 == 0 on an aligned base are stored in 16-byte
//    words, other rows one element at a time.
//
// The tile kernels (routes 1 and 0).  They replace the same Pallas kernel
// as the template.  Bound at ArUco's 13 x 13 box on (1, 1080, 1920, 1):
// 4.1 MB in and out, 0.0012 ms at 3.35 TB/s; the MAC's operations, 2 (kw +
// kh) a pixel at the f32 rate, 0.0016 ms.  The box's running sums take a
// few operations a pixel, so the bytes bound it; at that size the launch
// and the latency of one block's staging are most of its time, so the
// design fills the card with warps and keeps each one's chain short.
//  - Tiling: a block of kTileWarps warps owns kTileOut output bytes of
//    kTileRows rows (a 1080p plane: 272 blocks of 8 warps, two an SM).
//    Each warp owns kTileRowsPerWarp of the rows, each lane kTileCols
//    consecutive bytes of the staged window and 8 outputs of a row (lane +
//    32 q), so every shared-memory access of a warp is free of conflicts.
//  - Staging, once a block: the kTileRows + kh - 1 input rows of the strip,
//    bytes [x0 - kEdge, x0 + kTileOut + kEdge) of each (kEdge = 64 is over
//    the widest halo, 15 * 4), in 16-byte chunks: cp.async for rows of W*C
//    % 16 == 0 on an aligned base, else word loads at the row's own
//    alignment and a funnel shift, clamped to the tensor's granules.  A row
//    outside the image is its border_map source row (a BORDER_CONSTANT row
//    is written from the constant); the bytes outside [0, W*C) that a valid
//    output reads come from common.cuh's edge tables (fill_edges) in the
//    blocks whose window crosses an edge.  So every border is resolved once
//    per row and column, at any C, N, row width and base alignment.
//  - The box, O(1) a pixel: each lane keeps its 12 column sums of the kh
//    rows as 16-bit halves of 6 registers (kh * 255 < 2^16) and moves down
//    a row by adding the row that enters and subtracting the one that
//    leaves; a prefix sum of the column sums at stride C (within the lane,
//    then a warp scan of each lane's last C) goes to shared memory, and S =
//    P[m + hr] - P[m - hl - C] adds the kw columns of the output's channel.
//    uint32 arithmetic: its wrap is the int32 MAC's, bit for bit.
//  - Route 0, O(kw + kh) a pixel: the vertical multiply-add first, on the
//    window's bytes (three word loads a row, unpacked by __byte_perm), into
//    12 column sums a lane stored to shared memory; then the horizontal
//    multiply-add of each output over that row, the taps read from the
//    parameter space.  The sum of products is the same modulo 2^32 in
//    either order.
#include "common.cuh"

namespace {

using ocvt::EdgeMaps;

constexpr int kMaxTaps = 31;
constexpr int kLanes = 16;               // output lanes per thread
constexpr int kWarpLanes = 32 * kLanes;  // output lanes per warp
constexpr int kWarps = 4;                // warps per block, stacked in rows
constexpr int kStrip = 8;                // output rows per warp
constexpr int kStages = 8;               // staged rows per warp (a power of 2)
constexpr int kSeg = 16 + kWarpLanes + 16;  // a warp's window of a row: 16 halo bytes each side
constexpr int kStage = kSeg + 16;  // one stage: the window, from its row's offset in a granule
constexpr unsigned kFull = 0xffffffffu;

// the tile kernels (the box and generic routes)
constexpr int kTileWarps = 8;        // warps per block
constexpr int kTileRowsPerWarp = 4;  // output rows per warp
constexpr int kTileRows = kTileWarps * kTileRowsPerWarp;  // output rows per block
constexpr int kTileOut = 256;                             // output bytes of a block's row
constexpr int kTileWin = ocvt::kEdge + kTileOut + ocvt::kEdge;  // staged bytes of a row
constexpr int kTileIn = kTileRows + kMaxTaps - 1;               // staged rows, at most
constexpr int kTileCols = kTileWin / 32;                        // window bytes per lane
constexpr int kTileOutPerLane = kTileOut / 32;
static_assert(kTileCols % 3 == 0 && kTileCols % 4 == 0, "a lane's bytes hold whole pixels");

struct Taps {
  int kx[kMaxTaps];
  int ky[kMaxTaps];
};

struct Params {
  int H, W, C;
  int kw, kh;
  int shift, delta;
  int has_scale;
  float scale;
  int border;
  int bval[4];
  // 16-byte aligned rows (W*C % 16 == 0 and an aligned base) of the output,
  // for the template, or of the input, for the tile kernels
  int vec;
  uintptr_t glo, ghi;  // the input tensor's granules: [glo, ghi), 16-byte aligned
};

template <typename OutT>
__device__ __forceinline__ OutT finish(int v, const Params& p) {
  constexpr int lo = sizeof(OutT) == 1 ? 0 : -32768;
  constexpr int hi = sizeof(OutT) == 1 ? 255 : 32767;
  if (p.shift > 0) v = (v + (1 << (p.shift - 1))) >> p.shift;
  v += p.delta;
  if (p.has_scale) {
    float f = rintf((float)v * p.scale);  // f32 multiply, as the reference's jnp
    f = fminf(fmaxf(f, (float)lo), (float)hi);
    v = (int)f;
  }
  return (OutT)min(max(v, lo), hi);
}

// The outputs whose window crosses the left or right image edge: lanes
// [0, HL) and [L - HL, L) of every row in [y0, y0 + kWarps * kStrip).  One
// output per thread and step; rows and columns through tables built once.
template <int K, int C, typename OutT>
__device__ void sep_edges(const uint8_t* img, OutT* out, const Taps& taps, const Params& p,
                          int y0) {
  constexpr int HL = (K / 2) * C;
  constexpr int kRows = kWarps * kStrip + K - 1;
  __shared__ EdgeMaps maps;
  __shared__ const uint8_t* rows[kRows];  // source row of input row y0 - K/2 + i
  const int H = p.H, L = p.W * C;
  ocvt::build_edge_maps(&maps, p.W, C, p.border, p.bval);
  for (int i = threadIdx.y * 32 + threadIdx.x; i < kRows; i += 32 * kWarps) {
    const int y = y0 - K / 2 + i;
    const int sy = (y >= 0 && y < H) ? y : ocvt::border_map(y, H, p.border);
    rows[i] = sy < 0 ? nullptr : img + (size_t)sy * L;
  }
  __syncthreads();
  // (row, edge lane) items spread over the whole block
  const int nl = min(HL, L), nr = L - max(L - HL, nl), nedge = nl + nr;
  const int nrows = min(kWarps * kStrip, H - y0);
  for (int it = threadIdx.y * 32 + threadIdx.x; it < nrows * nedge; it += 32 * kWarps) {
    const int r = it / nedge, e = it - r * nedge;
    const int l = e < nl ? e : L - nr + (e - nl);
    const int ch = l % C;
    int b[K][K];
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int i = 0; i < K; ++i)
        b[j][i] = ocvt::mapped_byte(rows[r + j], l + (i - K / 2) * C, L, ch, &maps);
    int acc = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      int h = 0;
#pragma unroll
      for (int i = 0; i < K; ++i) h += taps.kx[i] * b[j][i];
      acc += taps.ky[j] * h;
    }
    out[(size_t)(y0 + r) * L + l] = finish<OutT>(acc, p);
  }
}

// The template: kw == kh == K in {3, 5, 7}, C channels.  The last column of
// blocks computes the edge outputs.
template <int K, int C, typename OutT>
__global__ void __launch_bounds__(32 * kWarps)
    sep_filter_kernel(const uint8_t* __restrict__ src, OutT* __restrict__ dst, const Taps taps,
                      const Params p) {
  constexpr int HL = (K / 2) * C;   // halo bytes each side
  constexpr int HW = (HL + 3) / 4;  // halo words each side
  constexpr int NW = 4 + 2 * HW;
  const int H = p.H, L = p.W * C;
  const uint8_t* img = src + blockIdx.z * (size_t)H * L;
  OutT* out = dst + blockIdx.z * (size_t)H * L;
  if (blockIdx.x == gridDim.x - 1) {
    sep_edges<K, C, OutT>(img, out, taps, p, blockIdx.y * kWarps * kStrip);
    return;
  }

  const int lane = threadIdx.x;
  const int xs = blockIdx.x * kWarpLanes;
  const int q = xs + kLanes * lane;  // the thread's first byte of a row
  const int y0 = (blockIdx.y * kWarps + threadIdx.y) * kStrip;
  if (y0 >= H) return;
  const int nin = min(kStrip, H - y0) + K - 1;
  const bool vec = p.vec;

  // a BORDER_CONSTANT row as this thread sees it
  uint32_t cm[4], cl[HW], cr[HW];
  const bool cst = p.border == ocvt::kBorderConstant;
  if (cst) {
    ocvt::const_words(cm, q, C, p.bval);
    ocvt::const_words(cl, xs - 4 * HW, C, p.bval);
    ocvt::const_words(cr, xs + kWarpLanes, C, p.bval);
  }

  // the warp's ring of staged rows, input row r in stage r % kStages, each
  // with its mbarrier and its offset: byte xs of the row is stage byte
  // 16 + off (-1: a constant row, not staged)
  __shared__ __align__(16) uint8_t ring[kWarps][kStages][kStage];
  __shared__ uint64_t bars[kWarps][kStages];
  __shared__ int offs[kWarps][kStages];
  uint8_t (*stage)[kStage] = ring[threadIdx.y];
  uint64_t* bar = bars[threadIdx.y];
  int* off_of = offs[threadIdx.y];
  if (lane == 0)
    for (int i = 0; i < kStages; ++i) ocvt::mbar_init(&bar[i]);
  __syncwarp();

  // input row r of the strip is image row y0 - K/2 + r; -1: a constant row
  auto source = [&](int r) {
    const int y = y0 - K / 2 + r;
    return (y >= 0 && y < H) ? y : ocvt::border_map(y, H, p.border);
  };
  // stage row r: lane 0 copies the granules that hold row bytes
  // [xs - 16, xs + 528), within the tensor's, to the stage; stage byte 0 is
  // the granule 16 bytes before the one that holds byte xs.  A constant row
  // is not copied (it is in registers).  The offset is written before the
  // arrive, which releases it to the lanes that wait on the stage.
  auto issue = [&](int r) {
    if (lane != 0) return;
    const int i = r & (kStages - 1);
    const int sy = source(r);
    if (sy < 0) {
      off_of[i] = -1;
      ocvt::mbar_arrive(&bar[i]);
      return;
    }
    const uintptr_t a = reinterpret_cast<uintptr_t>(img + (size_t)sy * L + xs);
    const uintptr_t g = (a & ~uintptr_t(15)) - 16, e = (a + kWarpLanes + 16 + 15) & ~uintptr_t(15);
    const uintptr_t from = g < p.glo ? p.glo : g, to = e > p.ghi ? p.ghi : e;
    off_of[i] = (int)(a & 15);
    ocvt::bulk_copy(stage[i] + (from - g), reinterpret_cast<const void*>(from), (int)(to - from),
                    &bar[i]);
  };

  // outputs [lo, hi) of the thread's 16 are stored here; the rest cross an
  // image edge (the edge blocks) or lie past the row
  const int lo = min(max(HL - q, 0), kLanes), hi = max(min(L - HL - q, kLanes), lo);

  // the horizontal pass runs on two lanes per register in 16-bit halves
  // (the host sends only taps with sum |kx| * 255 < 2^16 here); a negative
  // tap takes 255 - x (a xor), and the bias that adds, 255 * sum of the
  // negative |kx| per horizontal sum, comes off each output once
  uint32_t kxa[K], kxm[K];
  int ky[K], bias = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    kxa[i] = abs(taps.kx[i]);
    kxm[i] = taps.kx[i] < 0 ? 0x00ff00ffu : 0u;
    bias += taps.kx[i] < 0 ? -255 * taps.kx[i] : 0;
  }
  int corr = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ky[j] = taps.ky[j];
    corr += bias * ky[j];
  }
  // horizontal sums of the last K rows (biased), oldest first: lanes 2v and
  // 2v + 1 in the low and high half of hs[.][v]
  uint32_t hs[K][kLanes / 2];

  // wait for row r and read the thread's 16 bytes (lanes 0 and 31 also the
  // words past the warp's); a constant row comes from registers
  auto read = [&](int r, uint32_t (&m)[4], uint32_t (&wl)[HW], uint32_t (&wr)[HW]) {
    ocvt::mbar_wait(&bar[r & (kStages - 1)], (r / kStages) & 1);
    const int off = off_of[r & (kStages - 1)];
    if (off < 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = cm[i];
#pragma unroll
      for (int i = 0; i < HW; ++i) {
        wl[i] = cl[i];
        wr[i] = cr[i];
      }
      return;
    }
    const uint8_t* s = stage[r & (kStages - 1)];
    if (off == 0) {
      const uint4 v = *reinterpret_cast<const uint4*>(s + 16 + kLanes * lane);
      m[0] = v.x;
      m[1] = v.y;
      m[2] = v.z;
      m[3] = v.w;
#pragma unroll
      for (int i = 0; i < HW; ++i) {
        wl[i] = reinterpret_cast<const uint32_t*>(s + 16)[i - HW];
        wr[i] = reinterpret_cast<const uint32_t*>(s + 16 + kWarpLanes)[i];
      }
    } else {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(s);
      ocvt::shifted_words(m, w, 16 + off + kLanes * lane);
      ocvt::shifted_words(wl, w, 16 + off - 4 * HW);
      ocvt::shifted_words(wr, w, 16 + off + kWarpLanes);
    }
  };

  // the finishing chain's first step folded into the accumulator's start:
  // (acc - corr + 2^(shift-1)) >> shift; the packed sums start at acc0 in
  // both halves
  const int acc0 = (p.shift > 0 ? 1 << (p.shift - 1) : 0) - corr;
  const uint32_t acc0x = (uint32_t)acc0 * 0x10001u;
  // row r: the halo from the neighbour lanes, the horizontal pass, and once
  // K rows are in, the vertical pass, the finishing chain and the store
  auto step = [&](int r, const uint32_t (&m)[4], const uint32_t (&wl)[HW],
                  const uint32_t (&wr)[HW]) {
    uint32_t w[NW];  // HL bytes left, the thread's 16, HL bytes right
#pragma unroll
    for (int i = 0; i < 4; ++i) w[HW + i] = m[i];
#pragma unroll
    for (int i = 0; i < HW; ++i) {
      const uint32_t a = __shfl_up_sync(kFull, m[4 - HW + i], 1);
      const uint32_t b = __shfl_down_sync(kFull, m[i], 1);
      w[i] = lane == 0 ? wl[i] : a;
      w[HW + 4 + i] = lane == 31 ? wr[i] : b;
    }
#pragma unroll
    for (int j = 0; j < K - 1; ++j)
#pragma unroll
      for (int v = 0; v < kLanes / 2; ++v) hs[j][v] = hs[j + 1][v];
#pragma unroll
    for (int v = 0; v < kLanes / 2; ++v) {
      uint32_t a = 0;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int o = 4 * HW - HL + 2 * v + i * C;
        a += kxa[i] * (ocvt::byte_pair(w, o, o + 1) ^ kxm[i]);
      }
      hs[K - 1][v] = a;
    }
    if (r < K - 1 || lo >= hi) return;
    int acc[kLanes];
#pragma unroll
    for (int v = 0; v < kLanes / 2; ++v) {
      uint32_t t = acc0x, h = acc0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        t += (uint32_t)ky[j] * hs[j][v];
        h += (uint32_t)ky[j] * (hs[j][v] >> 16);
      }
      acc[2 * v] = ((int)(t - (h << 16)) >> p.shift) + p.delta;
      acc[2 * v + 1] = ((int)h >> p.shift) + p.delta;
    }
    constexpr int lo_v = sizeof(OutT) == 1 ? 0 : -32768;
    constexpr int hi_v = sizeof(OutT) == 1 ? 255 : 32767;
    OutT o[kLanes];
    if (p.has_scale) {
#pragma unroll
      for (int v = 0; v < kLanes; ++v) {
        // f32 multiply, as the reference's jnp
        const float f = fminf(fmaxf(rintf((float)acc[v] * p.scale), (float)lo_v), (float)hi_v);
        o[v] = (OutT)(int)f;
      }
    } else {
#pragma unroll
      for (int v = 0; v < kLanes; ++v) o[v] = (OutT)min(max(acc[v], lo_v), hi_v);
    }
    ocvt::store_range(out + (size_t)(y0 + r - (K - 1)) * L + q, o, lo, hi, vec);
  };

#pragma unroll 1
  for (int r = 0; r < kStages - 1 && r < nin; ++r) issue(r);
  // two register buffers, A and B: the words of row r + 1 are read while
  // row r computes; the loop is unrolled by two so no register still
  // waiting for its read is ever copied
  uint32_t mA[4], lA[HW], rA[HW], mB[4], lB[HW], rB[HW];
  read(0, mA, lA, rA);
#pragma unroll 1
  for (int r = 0; r < nin; r += 2) {
    __syncwarp();  // every lane has read row r - 1: its stage may be refilled
    if (r + kStages - 1 < nin) issue(r + kStages - 1);
    if (r + 1 < nin) read(r + 1, mB, lB, rB);
    step(r, mA, lA, rA);
    if (r + 1 >= nin) break;
    __syncwarp();
    if (r + kStages < nin) issue(r + kStages);
    if (r + 2 < nin) read(r + 2, mA, lA, rA);
    step(r + 1, mB, lB, rB);
  }
}

// The shared memory of a tile kernel's block.
struct TileSmem {
  EdgeMaps maps;
  const uint8_t* rows[kTileIn];  // source row of staged row r (nullptr: constant)
  alignas(16) uint8_t strip[kTileIn][kTileWin];       // the staged rows
  alignas(16) uint32_t sums[kTileWarps][kTileWin];    // a warp's row of sums
};

// Bytes [q, q + 16) of a row into dst (16-byte aligned shared memory): from
// the constant where row == nullptr, by cp.async where the rows are 16-byte
// aligned (p.vec), else by word loads at the row's alignment and a funnel
// shift.  A chunk's bytes outside [0, L) are left to fill_edges; words
// outside the tensor's granules are not loaded, so nothing faults.
__device__ __forceinline__ void stage16(uint8_t* dst, const uint8_t* row, int q, int L,
                                        const Params& p, const EdgeMaps* m) {
  if (row == nullptr) {
    uint32_t w[4];
    ocvt::const_words(w, q, p.C, m->bval);
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (p.vec) {
    if (q >= 0 && q < L) ocvt::cp_async16_n(dst, row + q, 16);
  } else if (q < L + ocvt::kEdge) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row) + (intptr_t)q;
    const uintptr_t b = a & ~uintptr_t(3);
    uint32_t v[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const uintptr_t w = b + 4 * i;
      v[i] = (w >= p.glo && w < p.ghi) ? __ldg(reinterpret_cast<const uint32_t*>(w)) : 0u;
    }
    const unsigned sh = 8 * (unsigned)(a & 3);
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(__funnelshift_r(v[0], v[1], sh), __funnelshift_r(v[1], v[2], sh),
                   __funnelshift_r(v[2], v[3], sh), __funnelshift_r(v[3], v[4], sh));
  }
}

// Stage the nin input rows of the block's strip: staged row r is image row
// y0 - kh/2 + r, its bytes [x0 - kEdge, x0 - kEdge + kTileWin).  Every
// thread of the block takes part; on return every byte that a valid output
// reads is in place.
__device__ __forceinline__ void stage_tile(TileSmem& sm, const uint8_t* img, const Params& p,
                                           int x0, int y0, int nin) {
  constexpr int kThreads = 32 * kTileWarps, kChunks = kTileWin / 16;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int H = p.H, L = p.W * p.C, xw = x0 - ocvt::kEdge;
  ocvt::build_edge_maps(&sm.maps, p.W, p.C, p.border, p.bval);
  for (int r = tid; r < nin; r += kThreads) {
    const int y = y0 - p.kh / 2 + r;
    const int sy = (y >= 0 && y < H) ? y : ocvt::border_map(y, H, p.border);
    sm.rows[r] = sy < 0 ? nullptr : img + (size_t)sy * L;
  }
  __syncthreads();
#pragma unroll 4
  for (int it = tid; it < nin * kChunks; it += kThreads) {
    const int r = it / kChunks, c = it - r * kChunks;
    stage16(sm.strip[r] + 16 * c, sm.rows[r], xw + 16 * c, L, p, &sm.maps);
  }
  ocvt::cp_async_commit();
  ocvt::cp_async_wait<0>();
  __syncthreads();
  if (xw < 0 || xw + kTileWin > L) {  // the window crosses an image edge
    for (int r = threadIdx.y; r < nin; r += kTileWarps)
      if (sm.rows[r] != nullptr)
        ocvt::fill_edges(sm.strip[r], xw, xw + kTileWin, sm.rows[r], L, &sm.maps, threadIdx.x);
    __syncthreads();
  }
}

// The lane's 12 bytes of staged row r, as three words.
__device__ __forceinline__ void lane_words(const TileSmem& sm, int r, uint32_t (&w)[3]) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(sm.strip[r]) + 3 * threadIdx.x;
  w[0] = s[0];
  w[1] = s[1];
  w[2] = s[2];
}

// The lane's 12 sums to its slots of the warp's row in shared memory.
__device__ __forceinline__ void put_sums(uint32_t* row, const uint32_t (&v)[kTileCols]) {
  uint4* d = reinterpret_cast<uint4*>(row + kTileCols * threadIdx.x);
#pragma unroll
  for (int i = 0; i < kTileCols / 4; ++i)
    d[i] = make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// Route 1, the box: kx all a, ky all b; C channels.
template <int C, typename OutT>
__global__ void __launch_bounds__(32 * kTileWarps)
    sep_box_kernel(const uint8_t* __restrict__ src, OutT* __restrict__ dst, const Taps taps,
                   const Params p) {
  __shared__ TileSmem sm;
  const int H = p.H, L = p.W * C, kh = p.kh;
  const int x0 = blockIdx.x * kTileOut, y0 = blockIdx.y * kTileRows;
  const int nout = min(kTileRows, H - y0);
  const uint8_t* img = src + blockIdx.z * (size_t)H * L;
  stage_tile(sm, img, p, x0, y0, nout + kh - 1);

  const int lane = threadIdx.x, t0 = threadIdx.y * kTileRowsPerWarp;
  const int t1 = min(t0 + kTileRowsPerWarp, nout);
  if (t0 >= t1) return;
  const int hl = (p.kw / 2) * C, hr = (p.kw - 1 - p.kw / 2) * C;
  const uint32_t ab = (uint32_t)taps.kx[0] * (uint32_t)taps.ky[0];
  uint32_t* sum = sm.sums[threadIdx.y];
  OutT* out = dst + blockIdx.z * (size_t)H * L + x0;

  // the column sums of the lane's 12 bytes over the window's kh rows, bytes
  // 0 and 2 of each word in the halves of ev, bytes 1 and 3 in od
  constexpr uint32_t kHalves = 0x00ff00ffu;
  uint32_t ev[3] = {0u, 0u, 0u}, od[3] = {0u, 0u, 0u};
#pragma unroll 4
  for (int j = 0; j < kh; ++j) {
    uint32_t w[3];
    lane_words(sm, t0 + j, w);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ev[i] += w[i] & kHalves;
      od[i] += (w[i] >> 8) & kHalves;
    }
  }
#pragma unroll 1
  for (int t = t0;;) {
    // the prefix sum at stride C: within the lane, then each residue's
    // carry from the lanes before (12 is a multiple of C)
    uint32_t s[kTileCols];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s[4 * i] = ev[i] & 0xffffu;
      s[4 * i + 1] = od[i] & 0xffffu;
      s[4 * i + 2] = ev[i] >> 16;
      s[4 * i + 3] = od[i] >> 16;
    }
#pragma unroll
    for (int k = C; k < kTileCols; ++k) s[k] += s[k - C];
    uint32_t carry[C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const uint32_t tot = s[kTileCols - C + r];
      uint32_t inc = tot;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t u = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc += u;
      }
      carry[r] = inc - tot;
    }
#pragma unroll
    for (int k = 0; k < kTileCols; ++k) s[k] += carry[k % C];
    put_sums(sum, s);
    __syncwarp();
    OutT* orow = out + (size_t)(y0 + t) * L;
#pragma unroll
    for (int q = 0; q < kTileOutPerLane; ++q) {
      const int o = lane + 32 * q, m = ocvt::kEdge + o;
      if (x0 + o < L) orow[o] = finish<OutT>((int)(ab * (sum[m + hr] - sum[m - hl - C])), p);
    }
    if (++t >= t1) break;
    __syncwarp();  // every lane has read the row of sums
    // down a row: add row t + kh - 1, take off row t - 1 (each half stays a
    // true column sum, so no half carries into the other)
    uint32_t a[3], b[3];
    lane_words(sm, t + kh - 1, a);
    lane_words(sm, t - 1, b);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ev[i] += (a[i] & kHalves) - (b[i] & kHalves);
      od[i] += ((a[i] >> 8) & kHalves) - ((b[i] >> 8) & kHalves);
    }
  }
}

// Route 0: any taps, runtime C.
template <typename OutT>
__global__ void __launch_bounds__(32 * kTileWarps)
    sep_generic_kernel(const uint8_t* __restrict__ src, OutT* __restrict__ dst, const Taps taps,
                       const Params p) {
  __shared__ TileSmem sm;
  const int H = p.H, C = p.C, L = p.W * C, kw = p.kw, kh = p.kh;
  const int x0 = blockIdx.x * kTileOut, y0 = blockIdx.y * kTileRows;
  const int nout = min(kTileRows, H - y0);
  const uint8_t* img = src + blockIdx.z * (size_t)H * L;
  stage_tile(sm, img, p, x0, y0, nout + kh - 1);

  const int lane = threadIdx.x, t0 = threadIdx.y * kTileRowsPerWarp;
  const int t1 = min(t0 + kTileRowsPerWarp, nout);
  if (t0 >= t1) return;
  uint32_t* sum = sm.sums[threadIdx.y];
  OutT* out = dst + blockIdx.z * (size_t)H * L + x0;
  // the lane's first horizontal tap of output lane + 32 q is h[32 q]
  const uint32_t* h = sum + ocvt::kEdge - (kw / 2) * C + lane;
#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    uint32_t v[kTileCols] = {};
#pragma unroll 2
    for (int j = 0; j < kh; ++j) {
      uint32_t w[3];
      lane_words(sm, t + j, w);
      const uint32_t ky = (uint32_t)taps.ky[j];
#pragma unroll
      for (int k = 0; k < kTileCols; ++k) v[k] += ky * __byte_perm(w[k >> 2], 0, 0x4440 | (k & 3));
    }
    put_sums(sum, v);
    __syncwarp();
    uint32_t acc[kTileOutPerLane] = {};
#pragma unroll 2
    for (int i = 0; i < kw; ++i) {
      const uint32_t kx = (uint32_t)taps.kx[i];
      const uint32_t* hi = h + i * C;
#pragma unroll
      for (int q = 0; q < kTileOutPerLane; ++q) acc[q] += kx * hi[32 * q];
    }
    OutT* orow = out + (size_t)(y0 + t) * L;
#pragma unroll
    for (int q = 0; q < kTileOutPerLane; ++q)
      if (x0 + lane + 32 * q < L) orow[lane + 32 * q] = finish<OutT>((int)acc[q], p);
    __syncwarp();  // every lane has read the row of sums
  }
}

template <int K, int C, typename OutT>
cudaError_t launch(const uint8_t* src, void* dst, int N, const Taps& taps, const Params& p,
                   cudaStream_t stream) {
  // one more column of blocks for the edge outputs
  const dim3 grid(ocvt::ceil_div(p.W * C, kWarpLanes) + 1, ocvt::ceil_div(p.H, kWarps * kStrip),
                  N);
  sep_filter_kernel<K, C, OutT><<<grid, dim3(32, kWarps), 0, stream>>>(
      src, static_cast<OutT*>(dst), taps, p);
  return cudaGetLastError();
}

// route 1 (C > 0: the box kernel at C channels) or 0 (C == 0: the generic)
template <int C, typename OutT>
cudaError_t launch_tile(const uint8_t* src, void* dst, int N, const Taps& taps, const Params& p,
                        cudaStream_t stream) {
  const dim3 grid(ocvt::ceil_div(p.W * p.C, kTileOut), ocvt::ceil_div(p.H, kTileRows), N);
  const dim3 block(32, kTileWarps);
  OutT* out = static_cast<OutT*>(dst);
  if constexpr (C > 0)
    sep_box_kernel<C, OutT><<<grid, block, 0, stream>>>(src, out, taps, p);
  else
    sep_generic_kernel<OutT><<<grid, block, 0, stream>>>(src, out, taps, p);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(const uint8_t* src, void* dst, int N, const Taps& taps, const Params& p,
                     int route, cudaStream_t st) {
  switch (route * 8 + p.C) {
    case 3 * 8 + 1: return launch<3, 1, OutT>(src, dst, N, taps, p, st);
    case 3 * 8 + 2: return launch<3, 2, OutT>(src, dst, N, taps, p, st);
    case 3 * 8 + 3: return launch<3, 3, OutT>(src, dst, N, taps, p, st);
    case 3 * 8 + 4: return launch<3, 4, OutT>(src, dst, N, taps, p, st);
    case 5 * 8 + 1: return launch<5, 1, OutT>(src, dst, N, taps, p, st);
    case 5 * 8 + 2: return launch<5, 2, OutT>(src, dst, N, taps, p, st);
    case 5 * 8 + 3: return launch<5, 3, OutT>(src, dst, N, taps, p, st);
    case 5 * 8 + 4: return launch<5, 4, OutT>(src, dst, N, taps, p, st);
    case 7 * 8 + 1: return launch<7, 1, OutT>(src, dst, N, taps, p, st);
    case 7 * 8 + 2: return launch<7, 2, OutT>(src, dst, N, taps, p, st);
    case 7 * 8 + 3: return launch<7, 3, OutT>(src, dst, N, taps, p, st);
    case 7 * 8 + 4: return launch<7, 4, OutT>(src, dst, N, taps, p, st);
    case 1 * 8 + 1: return launch_tile<1, OutT>(src, dst, N, taps, p, st);
    case 1 * 8 + 2: return launch_tile<2, OutT>(src, dst, N, taps, p, st);
    case 1 * 8 + 3: return launch_tile<3, OutT>(src, dst, N, taps, p, st);
    case 1 * 8 + 4: return launch_tile<4, OutT>(src, dst, N, taps, p, st);
    default: return launch_tile<0, OutT>(src, dst, N, taps, p, st);
  }
}

// The condition of each route (kernels/sepfilter.py::sep_filter_route).
// Route K in {3, 5, 7}, the template: kw == kh == K and sum |kx| * 255 <
// 2^16, so the 16-bit horizontal sums cannot carry.  Route 1, the box: kx
// all one value and ky all one value.  Route 0, the generic kernel, takes
// any taps.
bool route_takes(int route, const int* kx, int kw, const int* ky, int kh) {
  if (route == 0) return true;
  if (route == 1) {
    for (int i = 1; i < kw; ++i)
      if (kx[i] != kx[0]) return false;
    for (int j = 1; j < kh; ++j)
      if (ky[j] != ky[0]) return false;
    return true;
  }
  if ((route != 3 && route != 5 && route != 7) || kw != route || kh != route) return false;
  int sum = 0;
  for (int i = 0; i < kw; ++i) sum += abs(kx[i]);
  return sum * 255 < 65536;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// src: (N, H, W, C) u8 contiguous; dst: (N, H, W, C) u8 (out_i16 = 0) or
// i16 (out_i16 = 1).  kx/ky and bval are host arrays.  route: 3, 5 or 7 for
// the template, 1 for the box kernel, 0 for the generic kernel; taps that the
// route does not take are refused, never sent to another route.  Returns a
// cudaError_t.
extern "C" int opencv_sep_filter(const void* src, void* dst, int N, int H, int W, int C,
                                 const int* kx, int kw, const int* ky, int kh, int shift,
                                 int delta, int has_scale, float scale, int border,
                                 const int* bval, int out_i16, int route, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 || C > 4 || kw < 1 || kw > kMaxTaps ||
      kh < 1 || kh > kMaxTaps || shift < 0 || shift > 30 || border < 0 || border > 4 ||
      (long long)W * C > (1 << 30) || ocvt::ceil_div(H, kTileRows) > 65535 ||
      !route_takes(route, kx, kw, ky, kh))
    return cudaErrorInvalidValue;
  Taps taps{};
  for (int i = 0; i < kw; ++i) taps.kx[i] = kx[i];
  for (int i = 0; i < kh; ++i) taps.ky[i] = ky[i];
  Params p{};
  p.H = H;
  p.W = W;
  p.C = C;
  p.kw = kw;
  p.kh = kh;
  p.shift = shift;
  p.delta = delta;
  p.has_scale = has_scale;
  p.scale = scale;
  p.border = border;
  for (int c = 0; c < 4; ++c) p.bval[c] = bval[c];
  // the template stores 16-byte words; the tile kernels stage them
  p.vec = (W * C) % 16 == 0 && (route >= 3 ? aligned16(dst) : aligned16(src));
  const uintptr_t s0 = reinterpret_cast<uintptr_t>(src);
  p.glo = s0 & ~uintptr_t(15);
  p.ghi = (s0 + (size_t)N * H * W * C + 15) & ~uintptr_t(15);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_i16 ? dispatch<int16_t>(s, dst, N, taps, p, route, st)
                 : dispatch<uint8_t>(s, dst, N, taps, p, route, st);
}
