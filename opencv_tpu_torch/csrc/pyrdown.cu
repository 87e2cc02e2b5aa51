// cv::pyrDown on u8 NHWC: 5x5 Gaussian {1,4,6,4,1} x {1,4,6,4,1}, 2:1
// decimation, one final round (v + 128) >> 8.
//
// Replaces the Pallas kernel opencv_tpu/kernels/sepfilter.py::pyr_down_u8.
// What it computes, per output pixel-channel (oy, ox, c) of an
// (N, (H+1)/2, (W+1)/2, C) image:
//
//   v   = sum_j k[j] sum_i k[i] x[2oy - 2 + j][2ox - 2 + i][c]   (int32, k = 1 4 6 4 1)
//   out = min((v + 128) >> 8, 255)
//
// with the source coordinates resolved by borderInterpolate (REPLICATE,
// REFLECT, WRAP or REFLECT_101; cv::pyrDown refuses BORDER_CONSTANT, and so
// does this entry).  The TPU kernel expressed the stride-2 taps as two
// tap-folded selection matmuls on the MXU (strided lane access is slow
// there); here they are register arithmetic.
//
// Bound.  Each input byte is read once and each output byte written once:
// at (8, 1080, 1920, 1) 16.6 MB in and 4.1 MB out, 6.2 us at 3.35 TB/s.  The
// taps are 10 MACs per output (41 M at that shape).  Budget: about 25
// thread instructions per output.  On the H100 the kernel reaches 27% of its
// memory bound (PERF.md, from perf/sweep_stencil_tiles.py, whose schedule
// probe shows warps that wait on neither memory nor barriers): what remains
// is instruction issue.
//
// Design.  Each warp owns a strip of kStrip output rows by 32 * OPX output
// pixels (OPX pixels per thread: 16 / C, and 4 for C = 3, so a thread stores
// 16 or 12 bytes) and walks down its 2 kStrip + 3 input rows.
//  - Staging: lane 0 asks the copy engine for each input row's aligned
//    bytes (cp.async.bulk) into a ring of kStages rows in shared memory,
//    completing on one mbarrier per stage; kStages - 1 rows are in flight.
//    The words of row r + 1 are read while row r computes.
//  - The 2-pixel left and 1-pixel right halo comes from the neighbour lanes
//    by shuffle (lanes 0 and 31 read the staged bytes past the warp's).
//  - Two output lanes share a register in 16-bit halves: every sum of
//    pyrDown is at most 255 * 256 + 128, so no half carries into the other.
//    A tap of a pair is one byte_perm and a mask; the horizontal pass at the
//    even columns, the vertical pass carried in two register rows (c =
//    h[2o-2] + 4 h[2o-1], e = h[2o]) and the rounding (v + 128) >> 8 all run
//    on pairs, and one byte_perm packs two pairs into an output word.
//  - No division and no per-byte border work in the loop: the border is
//    resolved once per input row.  The outputs whose window crosses the
//    left or right image edge (pixel 0 and the last one or two) are not
//    stored by the main blocks: one extra column of blocks in the same
//    launch computes them one by one, from a row table and the edge tables
//    of common.cuh built once per block.
//
// The scalar path: an input row whose length W*C is not a multiple of 16 or
// an input base that is not 16-byte aligned is staged byte by byte by all
// lanes; an output row that is not a multiple of the thread's store width
// (16 bytes, or 4 for C = 3) or an unaligned output is stored byte by byte.
// Both inside this kernel.
#include "common.cuh"

namespace {

using ocvt::EdgeMaps;

constexpr int kWarps = 4;  // warps per block, stacked in rows
constexpr int kStrip = 4;  // output rows per warp
constexpr int kStages = 4;  // staged rows per warp (a power of 2)
constexpr unsigned kFull = 0xffffffffu;

template <int C>
struct Shape {
  static constexpr int OPX = C == 3 ? 4 : 16 / C;  // output pixels per thread
  static constexpr int OB = OPX * C;               // output bytes per thread
  static constexpr int NM = 2 * OB / 4;            // input words per thread
  static constexpr int MAIN = 32 * 4 * NM;         // input bytes per warp
  static constexpr int HL = (2 * C + 3) / 4;       // left halo words (2 pixels)
  static constexpr int HR = (C + 3) / 4;           // right halo words (1 pixel)
};

__device__ __forceinline__ int tap(int i) { return i == 2 ? 6 : (i & 1) ? 4 : 1; }

// Tap k (input pixel 2 px - 2 + k) of output lanes j and j + 1 (lane j =
// pixel px = j / C, channel j % C) as two 16-bit halves.  w holds the
// thread's input row from byte -4 HL.
template <int C, int NW>
__device__ __forceinline__ uint32_t tap_pair(const uint32_t (&w)[NW], int j, int k) {
  constexpr int base = 4 * Shape<C>::HL;
  return ocvt::byte_pair(w, base + (2 * (j / C) - 2 + k) * C + j % C,
                         base + (2 * ((j + 1) / C) - 2 + k) * C + (j + 1) % C);
}

// The outputs whose window crosses the left or right image edge: pixel 0
// and pixels [(W - 1) / 2, Wo) of every row in [oy0, oy0 + kWarps * kStrip).
template <int C>
__device__ void pyr_edges(const uint8_t* img, uint8_t* out, int H, int W, int border, int oy0) {
  constexpr int kRows = 2 * kWarps * kStrip + 3;
  __shared__ EdgeMaps maps;
  __shared__ const uint8_t* rows[kRows];  // source row of input row 2 oy0 - 2 + i
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2, L = W * C, Lo = Wo * C;
  ocvt::build_edge_maps(&maps, W, C, border, nullptr);
  for (int i = threadIdx.y * 32 + threadIdx.x; i < kRows; i += 32 * kWarps) {
    const int y = 2 * oy0 - 2 + i;
    rows[i] = img + (size_t)((y >= 0 && y < H) ? y : ocvt::border_map(y, H, border)) * L;
  }
  __syncthreads();
  const int first_right = max((W - 1) / 2, 1);  // pixels from here on cross the right edge
  const int npx = 1 + max(Wo - first_right, 0);
  // (row, edge pixel) items spread over the whole block
  const int nrows = min(kWarps * kStrip, Ho - oy0);
  for (int it = threadIdx.y * 32 + threadIdx.x; it < nrows * npx; it += 32 * kWarps) {
    const int r = it / npx, e = it - r * npx;
    const int ox = e == 0 ? 0 : first_right + e - 1;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      int b[5][5];
#pragma unroll
      for (int j = 0; j < 5; ++j)
#pragma unroll
        for (int i = 0; i < 5; ++i)
          b[j][i] = ocvt::mapped_byte(rows[2 * r + j], (2 * ox - 2 + i) * C + c, L, c, &maps);
      int v = 0;
#pragma unroll
      for (int j = 0; j < 5; ++j)
        v += tap(j) * (b[j][0] + b[j][4] + 4 * (b[j][1] + b[j][3]) + 6 * b[j][2]);
      out[(size_t)(oy0 + r) * Lo + ox * C + c] = (uint8_t)min((v + 128) >> 8, 255);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(32 * kWarps)
    pyr_down_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int H, int W,
                    int border, int vec_in, int vec_out) {
  using S = Shape<C>;
  constexpr int NW = S::HL + S::NM + S::HR;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int L = W * C, Lo = Wo * C;
  const uint8_t* img = src + blockIdx.z * (size_t)H * L;
  uint8_t* out = dst + blockIdx.z * (size_t)Ho * Lo;
  if (blockIdx.x == gridDim.x - 1) {
    pyr_edges<C>(img, out, H, W, border, blockIdx.y * kWarps * kStrip);
    return;
  }

  const int lane = threadIdx.x;
  const int oy0 = (blockIdx.y * kWarps + threadIdx.y) * kStrip;
  if (oy0 >= Ho) return;
  const int nin = 2 * min(kStrip, Ho - oy0) + 3;  // input rows 2 oy0 - 2 .. 2 (oy0 + nrows - 1) + 2
  const int qw = blockIdx.x * S::MAIN;  // first input byte of the warp
  const int ob0 = blockIdx.x * 32 * S::OB + lane * S::OB;  // first output byte of the thread
  // outputs [lo, hi) of the thread's OB bytes are stored here; pixel 0 and
  // the pixels from (W - 1) / 2 on cross an image edge (the edge blocks)
  const int lo = min(max(C - ob0, 0), S::OB);
  const int hi = max(min(((W - 1) / 2) * C - ob0, S::OB), lo);

  // the warp's ring of staged rows: row bytes [qw - 16, qw + MAIN + 16),
  // input row r in stage r % kStages, each with its mbarrier
  constexpr int kSeg = 16 + S::MAIN + 16;
  __shared__ __align__(16) uint8_t ring[kWarps][kStages][kSeg];
  __shared__ uint64_t bars[kWarps][kStages];
  uint8_t (*stage)[kSeg] = ring[threadIdx.y];
  uint64_t* bar = bars[threadIdx.y];
  if (lane == 0)
    for (int i = 0; i < kStages; ++i) ocvt::mbar_init(&bar[i]);
  __syncwarp();

  // stage input row r of the strip (image row 2 oy0 - 2 + r): one bulk
  // copy of its aligned bytes in [0, L) by lane 0, or, for an unaligned
  // row, byte by byte by every lane (the scalar path)
  auto issue = [&](int r) {
    uint8_t* b = stage[r & (kStages - 1)];
    const int y = 2 * oy0 - 2 + r;
    const uint8_t* row =
        img + (size_t)((y >= 0 && y < H) ? y : ocvt::border_map(y, H, border)) * L;
    if (vec_in) {
      if (lane == 0) {
        const int a = max(qw - 16, 0), e = min(qw + S::MAIN + 16, L);
        ocvt::bulk_copy(b + a - (qw - 16), row + a, e - a, &bar[r & (kStages - 1)]);
      }
      return;
    }
    for (int ch = lane; ch < kSeg / 16; ch += 32) {
      uint32_t w[4];
      ocvt::row_words(w, row, qw - 16 + 16 * ch, L);
      *reinterpret_cast<uint4*>(b + 16 * ch) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    if (lane == 0) ocvt::mbar_arrive(&bar[r & (kStages - 1)]);
  };

  constexpr int NP = S::OB / 2;  // pairs of output lanes
  uint32_t ca[NP], ea[NP], pa[NP];  // c, e, and c + 6e + 4h[2o+1], two lanes each

  // wait for row r and read the thread's words (lanes 0 and 31 also the
  // words past the warp's)
  auto read = [&](int r, uint32_t (&m)[S::NM], uint32_t (&wl)[S::HL], uint32_t (&wr)[S::HR]) {
    ocvt::mbar_wait(&bar[r & (kStages - 1)], (r / kStages) & 1);
    const uint8_t* b = stage[r & (kStages - 1)] + 16;
    if constexpr (S::NM % 4 == 0) {
#pragma unroll
      for (int i = 0; i < S::NM / 4; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(b + 4 * S::NM * lane)[i];
        m[4 * i] = v.x;
        m[4 * i + 1] = v.y;
        m[4 * i + 2] = v.z;
        m[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < S::NM / 2; ++i) {
        const uint2 v = reinterpret_cast<const uint2*>(b + 4 * S::NM * lane)[i];
        m[2 * i] = v.x;
        m[2 * i + 1] = v.y;
      }
    }
#pragma unroll
    for (int i = 0; i < S::HL; ++i) wl[i] = reinterpret_cast<const uint32_t*>(b)[i - S::HL];
#pragma unroll
    for (int i = 0; i < S::HR; ++i) wr[i] = reinterpret_cast<const uint32_t*>(b + S::MAIN)[i];
  };

  // row r: the halo from the neighbour lanes, the horizontal pass at the
  // even columns, the vertical pass, and the store of a completed output row
  auto step = [&](int r, const uint32_t (&m)[S::NM], const uint32_t (&wl)[S::HL],
                  const uint32_t (&wr)[S::HR]) {
    uint32_t w[NW];  // the thread's words with 2 pixels left and 1 right
#pragma unroll
    for (int i = 0; i < S::NM; ++i) w[S::HL + i] = m[i];
#pragma unroll
    for (int i = 0; i < S::HL; ++i) {
      const uint32_t a = __shfl_up_sync(kFull, m[S::NM - S::HL + i], 1);
      w[i] = lane == 0 ? wl[i] : a;
    }
#pragma unroll
    for (int i = 0; i < S::HR; ++i) {
      const uint32_t c = __shfl_down_sync(kFull, m[i], 1);
      w[S::HL + S::NM + i] = lane == 31 ? wr[i] : c;
    }
    // two output lanes (j = 2i, 2i + 1) per register in 16-bit halves: every
    // sum of pyrDown is at most 255 * 256 + 128, so no half carries over
    uint32_t h[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      uint32_t t[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) t[k] = tap_pair<C>(w, 2 * i, k);
      h[i] = t[0] + t[4] + 4 * (t[1] + t[3]) + 6 * t[2];
    }
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < NP; ++i) ca[i] = h[i];
    } else if (r == 1) {
#pragma unroll
      for (int i = 0; i < NP; ++i) ca[i] += 4 * h[i];
    } else if (r == 2) {
#pragma unroll
      for (int i = 0; i < NP; ++i) ea[i] = h[i];
    } else if (r & 1) {  // input row 2o + 1 of output row o = (r - 3) / 2
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        pa[i] = ca[i] + 6 * ea[i] + 4 * h[i];
        ca[i] = ea[i] + 4 * h[i];
      }
    } else {  // input row 2o + 2: output row o is complete
      // (v + 128) >> 8 in each half; bytes 0 and 2 of two pairs make a word
      uint32_t v[NP], o[NP / 2];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        v[i] = (pa[i] + h[i] + 0x00800080u) >> 8;
        ea[i] = h[i];
      }
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) o[i] = __byte_perm(v[2 * i], v[2 * i + 1], 0x6420);
      if (lo < hi)
        ocvt::store_words(out + (size_t)(oy0 + (r - 4) / 2) * Lo + ob0, o, lo, hi, vec_out);
    }
  };

#pragma unroll 1
  for (int r = 0; r < kStages - 1 && r < nin; ++r) issue(r);
  __syncwarp();  // rows staged byte by byte are visible to the warp
  // two register buffers, A and B: the words of row r + 1 are read while
  // row r computes; the loop is unrolled by two so no register still
  // waiting for its read is ever copied
  uint32_t mA[S::NM], lA[S::HL], rA[S::HR], mB[S::NM], lB[S::HL], rB[S::HR];
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

template <int C>
cudaError_t launch(const uint8_t* src, uint8_t* dst, int N, int H, int W, int border,
                   cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Lo = ((W + 1) / 2) * C;
  const int vec_in = (W * C) % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int width = Shape<C>::OB % 16 == 0 ? 16 : 4;  // the thread's store words
  const int vec_out = Lo % width == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  // one more column of blocks for the edge outputs
  const dim3 grid(ocvt::ceil_div((W + 1) / 2, 32 * Shape<C>::OPX) + 1,
                  ocvt::ceil_div(Ho, kWarps * kStrip), N);
  pyr_down_kernel<C><<<grid, dim3(32, kWarps), 0, stream>>>(src, dst, H, W, border, vec_in,
                                                             vec_out);
  return cudaGetLastError();
}

}  // namespace

// src: (N, H, W, C) u8 contiguous; dst: (N, (H+1)/2, (W+1)/2, C) u8.
// border: REPLICATE, REFLECT, WRAP or REFLECT_101 (constants.py values).
// Returns a cudaError_t.
extern "C" int opencv_pyr_down(const void* src, void* dst, int N, int H, int W, int C, int border,
                               void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 || C > 4 ||
      border < ocvt::kBorderReplicate || border > ocvt::kBorderReflect101 ||
      (long long)W * C > (1 << 30) || ocvt::ceil_div((H + 1) / 2, kWarps * kStrip) > 65535)
    return cudaErrorInvalidValue;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(s, d, N, H, W, border, st);
    case 2: return launch<2>(s, d, N, H, W, border, st);
    case 3: return launch<3>(s, d, N, H, W, border, st);
    default: return launch<4>(s, d, N, H, W, border, st);
  }
}
