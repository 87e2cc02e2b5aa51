// Fused BGR->GRAY + GaussianBlur 5x5 (Q8) + 2x2 AREA downsample on u8.
//
// Replaces the Pallas kernels of opencv_tpu/kernels/fused_preproc.py:
// gauss5_down2_u8, gauss5_down2_u8_db (same contract, TPU double buffering)
// and, with BGR input, fused_gray_gauss5_down2, whose gray conversion ran in
// XLA in front of the Pallas kernel and is folded in here.  Per output pixel
// (oy, ox) of an (N, H/2, W/2) image:
//
//   gray   = (r*9798 + g*19235 + b*3735 + 2^14) >> 15          (Q15, cvtColor)
//   blur   = (sum_j k[j] sum_i k[i] gray[y-2+j][x-2+i] + 2^15) >> 16
//            with REFLECT_101 borders                            (Q8 x Q8)
//   out    = (blur[2oy][2ox] + blur[2oy][2ox+1] + blur[2oy+1][2ox]
//             + blur[2oy+1][2ox+1] + 2) >> 2                     (AREA-fast)
//
// The taps are symmetric, non-negative and sum to 256 (the entry refuses
// others), so every partial sum of a pass is at most 256 * 255 and a blur at
// most 255: the saturate of the composed ops never acts.
//
// Bound.  3 B read (1 B for gray input) and 0.25 B written per input pixel:
// 53.9 MB, 0.0161 ms at 3.35 TB/s for (8, 1080, 1920, 3).  The first version
// (a gray tile and an int32 row-sum tile in shared memory, two block barriers
// per 16 x 64 outputs) had 115-163 instructions per input pixel in its
// loops as written (perf/sass_count.py; each gray-tile loop holds both gray
// paths): index division, per-pixel border calls, byte loads and
// shared-memory traffic.  It took 0.075 ms (21.6% of the bytes bound).
//
// Design: a register-rolling strip.
//  - Each lane owns PX consecutive pixels of a row (8 BGR pixels, 24 bytes
//    in three 8-byte loads; 16 gray pixels, one 16-byte load), neighbouring
//    lanes neighbouring strips; a warp walks down a run of output rows of
//    its 32 * PX columns.  (BGR strips of 16 spill at 128 registers.)
//  - Gray once per input pixel, in registers: two __dp2a per pixel on the
//    loaded words (the Q15 weights doubled, so the gray value is byte 2 of
//    the sum), one byte_perm per pair of pixels.
//  - The vertical pass first, on pairs of pixels in the 16-bit halves of one
//    register (sums <= 65280: no carry): five operations per pair.  The six
//    gray rows it reads (2oy-2 .. 2oy+3) roll through registers; the loop is
//    unrolled three times so the ring never moves a register.
//  - The horizontal pass reads the packed vertical sums as they are: three
//    __dp2a a pixel (a pair of sums times a pair of byte taps, accumulated
//    in 32 bits from the round), no unpacking.  The two-pixel halo comes
//    from the neighbour lanes by shuffle; only lane 0 and lane 31 load two
//    pixels past the warp's columns, and the image's left and right edges
//    are one byte_perm.  The 2x2 mean is summed in registers and stored as
//    one 4- or 8-byte word per lane and output row.
//  - Rows are resolved by border_map once per row.  The next two input rows'
//    loads are issued before an output row is computed and converted after
//    it; a run's first six rows are loaded at once.
//  - The grid is one wave (the plan of kernels/fused_preproc.py::_plan): the
//    N * column groups * H/2 output-row units are split evenly over all
//    warps, so a (2, 1080, 1920, 3) launch fills the card as an (8, ...) one.
// The unaligned path (base or row pitch not 16-byte aligned, W % 16 != 0)
// reads aligned words and funnel-shifts them, and stores byte by byte.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; perf/sweep_gauss5.py and
// perf/ab_forward.py --path gauss5, PERF.md §6): BGR (8, 1080, 1920, 3)
// 0.0367 ms (43.9% of the bytes bound; the first version 0.0753), BGR
// (2, 1080, 1920, 3) 0.0148 ms (27.2%; 0.0242), gray (8, 1080, 1920)
// 0.0197 ms (31.5%; 0.0632).  The row loop as written is 21.5 (BGR) and
// 13.2 (gray) instructions per input pixel: ~11 M warp instructions at
// (8, 1080, 1920, 3), a third of what 528 schedulers issue in 0.0367 ms at
// 1.755 GHz, so issue does not bound it, nor do the bytes (a clone of the
// batch reaches 76% of the rate); more resident warps (which spill) and a
// shorter load window were slower.  What stalls the warps is not measured.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr unsigned kFull = 0xffffffffu;
// Pixels of a lane's strip: 8 BGR pixels (24 bytes) and 16 gray ones were
// the fastest of perf/sweep_gauss5.py's (BGR strips of 16 spill at 128
// registers; gray strips of 8 were slower), PERF.md §6.
constexpr int kStripBgr = 8;
constexpr int kStripGray = 16;

// The Q15 gray weights doubled (B 7470, G 38470, R 19596: they sum to
// 2^16), as the 16-bit pairs __dp2a multiplies with a pixel's bytes: the
// four byte phases of a BGR pixel in a word.  2 * (sum + 2^14) < 2^24, so
// the gray value is byte 2 of the doubled sum.
constexpr unsigned kBG = 7470u | 38470u << 16;
constexpr unsigned kR0 = 19596u;
constexpr unsigned k0B = 7470u << 16;
constexpr unsigned kGR = 38470u | 19596u << 16;
constexpr unsigned kGrayRound = 1u << 15;

// The vertical pass multiplies packed pairs by k0, k1, k2 (k[0] = k[4],
// k[1] = k[3], k[2]).  The horizontal pass is three __dp2a a pixel, a pair
// of vertical sums times a pair of byte taps, from c = the round: h0..h2 are
// the taps there, at most 255.  Taps (0, 0, 256) (sigma <= 0.25, the
// identity) take h2 = 255 and c = 65280: 255 * 256 g + 65280 = 65280 (g + 1),
// whose >> 16 is g, as (65536 g + 2^15) >> 16 is.
struct Taps {
  unsigned k0, k1, k2;
  unsigned t1, t2, t3;  // bytes (h0 h1 h2 h1), (h0 0 0 h0), (h1 h2 h1 h0)
  unsigned c;           // 2^15, or 65280 for the identity
};

template <int PX, bool BGR>
struct Strip {
  static constexpr int CB = BGR ? 3 : 1;  // bytes per pixel
  static constexpr int NW = PX * CB / 4;  // words of a strip's row
  static constexpr int P = PX / 2;        // pixel pairs (and outputs) of a strip
};

// Bytes [q, q + 4 NW) of a row as little-endian words, where `on` (else
// zeros).  VEC: row + q is 16-byte aligned when NW % 4 == 0, else 8-byte
// aligned.  Otherwise NW + 1 aligned words are loaded (each only if it starts
// before the row's end: an aligned word that holds a byte of the row never
// leaves its allocation) and funnel-shifted.
template <int NW, bool VEC>
__device__ __forceinline__ void load_words(uint32_t (&w)[NW], const uint8_t* row, int q, int len,
                                           bool on) {
  if constexpr (VEC) {
    if constexpr (NW % 4 == 0) {
      const uint4* p = reinterpret_cast<const uint4*>(row + q);
#pragma unroll
      for (int i = 0; i < NW / 4; ++i) {
        const uint4 v = on ? __ldg(p + i) : make_uint4(0, 0, 0, 0);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    } else {
      static_assert(NW % 2 == 0, "an 8-byte multiple");
      const uint2* p = reinterpret_cast<const uint2*>(row + q);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) {
        const uint2 v = on ? __ldg(p + i) : make_uint2(0, 0);
        w[2 * i] = v.x;
        w[2 * i + 1] = v.y;
      }
    }
  } else {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row) + q;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const unsigned sh = 8 * (unsigned)(a & 3);
    const uintptr_t end = reinterpret_cast<uintptr_t>(row) + len;
    uint32_t v[NW + 1];
#pragma unroll
    for (int i = 0; i <= NW; ++i)
      v[i] = (on && reinterpret_cast<uintptr_t>(p + i) < end) ? __ldg(p + i) : 0u;
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = __funnelshift_r(v[i], v[i + 1], sh);
  }
}

// Doubled gray sums (gray = byte 2) of the 4 BGR pixels in the 12 bytes of
// words a, b, c: [b0 g0 r0 b1] [g1 r1 b2 g2] [r2 b3 g3 r3].
__device__ __forceinline__ void gray4(uint32_t (&s)[4], uint32_t a, uint32_t b, uint32_t c) {
  s[0] = __dp2a_hi(kR0, a, __dp2a_lo(kBG, a, kGrayRound));
  s[1] = __dp2a_lo(kGR, b, __dp2a_hi(k0B, a, kGrayRound));
  s[2] = __dp2a_lo(kR0, c, __dp2a_hi(kBG, b, kGrayRound));
  s[3] = __dp2a_hi(kGR, c, __dp2a_lo(k0B, c, kGrayRound));
}

// Two gray values (< 256) as the 16-bit halves of one register, from two
// doubled sums (byte 3 of each is 0).
__device__ __forceinline__ uint32_t gray_pair(uint32_t s0, uint32_t s1) {
  return __byte_perm(s0, s1, 0x7632);
}

// One row of a strip as gray pairs: g[0 .. P) from the strip's words w,
// g[P] the two halo pixels from the 8 bytes h (lane 0: bytes 8 - 2 CB .. 7,
// the pixels left of the strip; lane 31: bytes 0 .. 2 CB - 1, right of it).
template <int PX, bool BGR>
__device__ __forceinline__ void gray_row(uint32_t (&g)[PX / 2 + 1],
                                         const uint32_t (&w)[Strip<PX, BGR>::NW],
                                         const uint32_t (&h)[2], bool lane0) {
  constexpr int P = PX / 2;
  if constexpr (BGR) {
#pragma unroll
    for (int k = 0; k < PX / 4; ++k) {
      uint32_t s[4];
      gray4(s, w[3 * k], w[3 * k + 1], w[3 * k + 2]);
      g[2 * k] = gray_pair(s[0], s[1]);
      g[2 * k + 1] = gray_pair(s[2], s[3]);
    }
    // lane 0's pixels start at byte 2: shift them to byte 0
    const unsigned sh = lane0 ? 16 : 0;
    const uint32_t a = __funnelshift_r(h[0], h[1], sh), b = h[1] >> sh;
    const uint32_t s0 = __dp2a_hi(kR0, a, __dp2a_lo(kBG, a, kGrayRound));
    const uint32_t s1 = __dp2a_lo(kGR, b, __dp2a_hi(k0B, a, kGrayRound));
    g[P] = gray_pair(s0, s1);
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) g[j] = __byte_perm(w[j >> 1], 0, (j & 1) ? 0x4342 : 0x4140);
    g[P] = __byte_perm(lane0 ? h[1] >> 16 : h[0], 0, 0x4140);
  }
}

// One warp's run of output rows in one column group of one image.
template <int PX, bool BGR, bool VEC>
struct Band {
  using S = Strip<PX, BGR>;
  static constexpr int P = S::P, NW = S::NW, CB = S::CB;

  const uint8_t* img;
  uint8_t* out;
  int H, W, Wo, len, lane, x0, q, hq;
  bool on, hon;
  Taps t;
  uint32_t g[6][P + 1];        // gray pairs of six rows, a ring
  uint32_t w[2][NW], h[2][2];  // the words of the next two rows, in flight

  // The words of input row y (REFLECT_101) for this lane's strip and halo.
  __device__ __forceinline__ void load(uint32_t (&wy)[NW], uint32_t (&hy)[2], int y) const {
    const uint8_t* row =
        img + (size_t)ocvt::border_map(y, H, ocvt::kBorderReflect101) * len;
    load_words<NW, VEC>(wy, row, q, len, on);
    load_words<2, VEC>(hy, row, hq, len, hon);
  }

  template <int R>
  __device__ __forceinline__ void convert(const uint32_t (&wy)[NW], const uint32_t (&hy)[2]) {
    gray_row<PX, BGR>(g[R % 6], wy, hy, lane == 0);
  }

  // Blur row 2 oy + A (the rows of the ring from slot A), each pixel pair's
  // rounded blurs added into s.
  template <int A>
  __device__ __forceinline__ void blur_row(uint32_t (&s)[P]) {
    const uint32_t(&r0)[P + 1] = g[A % 6];
    const uint32_t(&r1)[P + 1] = g[(A + 1) % 6];
    const uint32_t(&r2)[P + 1] = g[(A + 2) % 6];
    const uint32_t(&r3)[P + 1] = g[(A + 3) % 6];
    const uint32_t(&r4)[P + 1] = g[(A + 4) % 6];
    // pw[j]: the vertical sums of pixels x0 + 2j - 2 and x0 + 2j - 1
    uint32_t pw[P + 2], halo;
#pragma unroll
    for (int j = 0; j <= P; ++j) {
      const uint32_t v = t.k0 * (r0[j] + r4[j]) + t.k1 * (r1[j] + r3[j]) + t.k2 * r2[j];
      if (j < P)
        pw[j + 1] = v;
      else
        halo = v;
    }
    const uint32_t left = __shfl_up_sync(kFull, pw[P], 1);
    const uint32_t right = __shfl_down_sync(kFull, pw[1], 1);
    pw[0] = lane == 0 ? halo : left;
    pw[P + 1] = lane == 31 ? halo : right;
    // REFLECT_101 at the image's edges: x = -2, -1 -> 2, 1 and x = W, W + 1
    // -> W - 2, W - 3, where W - 1 is the high half of pw[(W - x0) / 2]
    if (x0 == 0) pw[0] = __byte_perm(pw[2], pw[1], 0x7610);
    if constexpr (VEC) {
      if (x0 + PX == W) pw[P + 1] = __byte_perm(pw[P], pw[P - 1], 0x7610);
    } else {
      const int m = (W - x0) >> 1;
#pragma unroll
      for (int k = 1; k <= P; ++k)
        if (m == k) pw[k + 1] = __byte_perm(pw[k], pw[k - 1], 0x7610);
      if (x0 == 0) pw[0] = __byte_perm(pw[2], pw[1], 0x7610);  // W == 2 reads pw[2]
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      // pixel x0 + 2i: pairs (x - 2, x - 1) (x, x + 1) (x + 2, x + 3) by
      // (h0, h1) (h2, h1) (h0, 0); pixel x0 + 2i + 1: by (0, h0) (h1, h2) (h1, h0)
      const uint32_t v0 =
          __dp2a_lo(pw[i + 2], t.t2, __dp2a_hi(pw[i + 1], t.t1, __dp2a_lo(pw[i], t.t1, t.c)));
      const uint32_t v1 =
          __dp2a_hi(pw[i + 2], t.t3, __dp2a_lo(pw[i + 1], t.t3, __dp2a_hi(pw[i], t.t2, t.c)));
      s[i] += (v0 >> 16) + (v1 >> 16);
    }
  }

  __device__ __forceinline__ void store(const uint32_t (&s)[P], int oy) {
    if (!on) return;
    uint8_t* o = out + (size_t)oy * Wo + (x0 >> 1);
    if constexpr (VEC) {
      uint32_t v[P / 4];
#pragma unroll
      for (int k = 0; k < P / 4; ++k)
        v[k] = (s[4 * k] >> 2) | (s[4 * k + 1] >> 2) << 8 | (s[4 * k + 2] >> 2) << 16 |
               (s[4 * k + 3] >> 2) << 24;
      if constexpr (P == 8)
        *reinterpret_cast<uint2*>(o) = make_uint2(v[0], v[1]);
      else
        *reinterpret_cast<uint32_t*>(o) = v[0];
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i)
        if ((x0 >> 1) + i < Wo) o[i] = (uint8_t)(s[i] >> 2);
    }
  }

  // Output row oy from ring slots R .. R + 5 (input rows 2 oy - 2 ..
  // 2 oy + 3); slots R and R + 1 then take rows 2 oy + 4 and 2 oy + 5,
  // whose loads were issued before the row was computed.
  template <int R>
  __device__ __forceinline__ void step(int oy, bool more) {
    if (more) {
      load(w[0], h[0], 2 * oy + 4);
      load(w[1], h[1], 2 * oy + 5);
    }
    uint32_t s[P];
#pragma unroll
    for (int i = 0; i < P; ++i) s[i] = 2;  // the mean's round
    blur_row<R>(s);
    blur_row<R + 1>(s);
    store(s, oy);
    if (more) {
      convert<R>(w[0], h[0]);
      convert<R + 1>(w[1], h[1]);
    }
  }

  __device__ __forceinline__ void run(int oy0, int rows) {
    // the first six rows' loads all in flight at once
    uint32_t w6[6][NW], h6[6][2];
#pragma unroll
    for (int r = 0; r < 6; ++r) load(w6[r], h6[r], 2 * oy0 - 2 + r);
    convert<0>(w6[0], h6[0]);
    convert<1>(w6[1], h6[1]);
    convert<2>(w6[2], h6[2]);
    convert<3>(w6[3], h6[3]);
    convert<4>(w6[4], h6[4]);
    convert<5>(w6[5], h6[5]);
    const int end = oy0 + rows;
    for (int oy = oy0;;) {
      step<0>(oy, oy + 1 < end);
      if (++oy == end) break;
      step<2>(oy, oy + 1 < end);
      if (++oy == end) break;
      step<4>(oy, oy + 1 < end);
      if (++oy == end) break;
    }
  }
};

// The units (one output row of one column group of one image, ordered by
// image, column group, row) are split evenly over the grid's warps:
// warp i takes [i * units / warps, (i + 1) * units / warps), as
// kernels/fused_preproc.py::_warp_units does, one run per column group.
template <int PX, bool BGR, bool VEC>
__global__ void __launch_bounds__(32 * kWarps, 4)
    gauss5_down2_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int H, int W,
                        int gx, long long units, Taps t) {
  using B = Band<PX, BGR, VEC>;
  const int Ho = H / 2;
  const long long warps = (long long)gridDim.x * kWarps;
  const long long wid = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  long long u = wid * units / warps;
  const long long u1 = (wid + 1) * units / warps;
  B b;
  b.H = H;
  b.W = W;
  b.Wo = W / 2;
  b.len = W * B::CB;
  b.lane = threadIdx.x & 31;
  b.t = t;
  while (u < u1) {
    const long long col = u / Ho;
    const int oy0 = (int)(u - col * Ho);
    const int rows = (int)min(u1 - u, (long long)(Ho - oy0));
    const int n = (int)(col / gx), cx = (int)(col - (long long)n * gx);
    b.img = src + (size_t)n * H * b.len;
    b.out = dst + (size_t)n * Ho * b.Wo;
    b.x0 = (cx * 32 + b.lane) * PX;
    b.q = b.x0 * B::CB;
    b.on = b.x0 < W;
    // the halo: lane 0 the 8 bytes left of its strip, lane 31 those right of it
    b.hq = b.lane == 0 ? b.q - 8 : b.q + PX * B::CB;
    b.hon = b.lane == 0 ? b.on && b.x0 > 0 : b.lane == 31 && b.x0 + PX < W;
    b.run(oy0, rows);
    u += rows;
  }
}

template <bool BGR>
int launch(const uint8_t* src, uint8_t* dst, int H, int W, bool vec, int blocks, int gx,
           long long units, Taps t, cudaStream_t stream) {
  constexpr int PX = BGR ? kStripBgr : kStripGray;
  const dim3 grid(blocks), block(32 * kWarps);
  if (vec)
    gauss5_down2_kernel<PX, BGR, true><<<grid, block, 0, stream>>>(src, dst, H, W, gx, units, t);
  else
    gauss5_down2_kernel<PX, BGR, false><<<grid, block, 0, stream>>>(src, dst, H, W, gx, units, t);
  return cudaGetLastError();
}

}  // namespace

// src: (N, H, W, 3) BGR u8 (has_bgr = 1) or (N, H, W) gray u8, contiguous,
// H and W even; dst: (N, H/2, W/2) u8.  args: the 5 Q8 taps (symmetric,
// non-negative, sum 256), then the plan of kernels/fused_preproc.py::_plan:
// strip pixels (kStripBgr or kStripGray), blocks, column groups
// (ceil(W / (32 * strip))) and the aligned path (1: src, dst and the row
// pitch 16-byte aligned).
// Returns a cudaError_t; cudaErrorInvalidValue for arguments it does not take.
extern "C" int opencv_gauss5_down2(const void* src, void* dst, int N, int H, int W, int has_bgr,
                                   const int* args, void* stream) {
  const int* k = args;
  const int px = args[5], blocks = args[6], gx = args[7], vec = args[8];
  if (N < 1 || N > 65535 || H < 2 || W < 2 || (H & 1) || (W & 1)) return cudaErrorInvalidValue;
  if (k[0] != k[4] || k[1] != k[3] || k[0] < 0 || k[1] < 0 || k[2] < 0 ||
      2 * k[0] + 2 * k[1] + k[2] != 256)
    return cudaErrorInvalidValue;
  if (px != (has_bgr ? kStripBgr : kStripGray) || blocks < 1 || gx != ocvt::ceil_div(W, 32 * px))
    return cudaErrorInvalidValue;
  const long long pitch = (long long)W * (has_bgr ? 3 : 1);
  if (vec && ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % 16 ||
              pitch % 16))
    return cudaErrorInvalidValue;
  const unsigned k0 = k[0], k1 = k[1], k2 = k[2], h2 = k2 == 256 ? 255 : k2;
  const Taps t{k0, k1, k2,
               k0 | k1 << 8 | h2 << 16 | k1 << 24,
               k0 | k0 << 24,
               k1 | h2 << 8 | k1 << 16 | k0 << 24,
               k2 == 256 ? 65280u : 1u << 15};
  const long long units = (long long)N * gx * (H / 2);
  const auto s = static_cast<const uint8_t*>(src);
  const auto d = static_cast<uint8_t*>(dst);
  const auto st = static_cast<cudaStream_t>(stream);
  return has_bgr ? launch<true>(s, d, H, W, vec, blocks, gx, units, t, st)
                 : launch<false>(s, d, H, W, vec, blocks, gx, units, t, st);
}
