// Fused BGR->GRAY + GaussianBlur 5x5 (Q8) + 2x2 AREA downsample on u8.
//
// Replaces the Pallas kernels of opencv_tpu/kernels/fused_preproc.py:
// gauss5_down2_u8, gauss5_down2_u8_db (same contract, TPU double buffering)
// and, with has_bgr = 1, fused_gray_gauss5_down2, whose gray conversion ran
// in XLA in front of the Pallas kernel and is folded in here.  Per output
// pixel (oy, ox) of an (N, H/2, W/2) image:
//
//   gray   = (r*9798 + g*19235 + b*3735 + 2^14) >> 15          (Q15, cvtColor)
//   blur   = clip((sum_j k[j] sum_i k[i] gray[y-2+j][x-2+i] + 2^15) >> 16)
//            with REFLECT_101 borders                            (Q8 x Q8)
//   out    = (blur[2oy][2ox] + blur[2oy][2ox+1] + blur[2oy+1][2ox]
//             + blur[2oy+1][2ox+1] + 2) >> 2                     (AREA-fast)
//
// A block converts its (2*16 + 4) x (2*64 + 4) input tile (2-pixel halo) to
// gray in shared memory, runs the horizontal 5-tap pass into int32 shared
// memory, then the vertical pass, the round and the 2x2 mean per output.
//
// Bound: memory.  3 B read (1 B for gray input) and 0.25 B written per input
// pixel, ~10 integer MACs per input pixel; the TPU version's MXU selection
// matmuls and rolls were a workaround for strided access and are plain
// strided shared-memory reads here.
#include "common.cuh"

namespace {

constexpr int kOutRows = 16;
constexpr int kOutCols = 64;
constexpr int kInRows = 2 * kOutRows + 4;
constexpr int kInCols = 2 * kOutCols + 4;
constexpr int kBlurCols = 2 * kOutCols;
constexpr int kThreads = 256;

struct Taps5 {
  int k[5];
};

__global__ void __launch_bounds__(kThreads)
    gauss5_down2_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int H, int W,
                        int has_bgr, const Taps5 t) {
  __shared__ uint8_t gray[kInRows][kInCols];
  __shared__ int hsum[kInRows][kBlurCols];

  const int oy0 = blockIdx.y * kOutRows;
  const int ox0 = blockIdx.x * kOutCols;
  const int iy0 = 2 * oy0 - 2;
  const int ix0 = 2 * ox0 - 2;
  const size_t plane = (size_t)H * W;
  const uint8_t* img = src + blockIdx.z * plane * (has_bgr ? 3 : 1);

  // 1. gray tile + REFLECT_101 halo
  for (int i = threadIdx.x; i < kInRows * kInCols; i += kThreads) {
    const int r = i / kInCols;
    const int c = i - r * kInCols;
    const int sy = ocvt::border_map(iy0 + r, H, ocvt::kBorderReflect101);
    const int sx = ocvt::border_map(ix0 + c, W, ocvt::kBorderReflect101);
    const size_t off = (size_t)sy * W + sx;
    int g;
    if (has_bgr) {
      const uint8_t* px = img + off * 3;
      g = (px[2] * 9798 + px[1] * 19235 + px[0] * 3735 + (1 << 14)) >> 15;
    } else {
      g = img[off];
    }
    gray[r][c] = (uint8_t)g;
  }
  __syncthreads();

  // 2. horizontal 5-tap pass, int32, no intermediate rounding
  for (int i = threadIdx.x; i < kInRows * kBlurCols; i += kThreads) {
    const int r = i / kBlurCols;
    const int c = i - r * kBlurCols;
    const uint8_t* g = &gray[r][c];
    hsum[r][c] = t.k[0] * g[0] + t.k[1] * g[1] + t.k[2] * g[2] + t.k[3] * g[3] + t.k[4] * g[4];
  }
  __syncthreads();

  // 3. vertical pass, Q16 round + saturate, 2x2 mean; ragged edge masked
  const int Ho = H / 2, Wo = W / 2;
  for (int i = threadIdx.x; i < kOutRows * kOutCols; i += kThreads) {
    const int r = i / kOutCols;
    const int c = i - r * kOutCols;
    const int oy = oy0 + r;
    const int ox = ox0 + c;
    if (oy >= Ho || ox >= Wo) continue;
    int s = 0;
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        const int rr = 2 * r + dy;
        const int cc = 2 * c + dx;
        int v = t.k[0] * hsum[rr][cc] + t.k[1] * hsum[rr + 1][cc] + t.k[2] * hsum[rr + 2][cc] +
                t.k[3] * hsum[rr + 3][cc] + t.k[4] * hsum[rr + 4][cc];
        v = (v + (1 << 15)) >> 16;
        s += min(max(v, 0), 255);
      }
    }
    dst[blockIdx.z * (size_t)Ho * Wo + (size_t)oy * Wo + ox] = (uint8_t)((s + 2) >> 2);
  }
}

}  // namespace

// src: (N, H, W, 3) BGR u8 (has_bgr = 1) or (N, H, W) gray u8, contiguous,
// H and W even; dst: (N, H/2, W/2) u8.  taps: 5 host ints (Q8, sum 256).
// Returns a cudaError_t.
extern "C" int opencv_gauss5_down2(const void* src, void* dst, int N, int H, int W, int has_bgr,
                                   const int* taps, void* stream) {
  if (N < 1 || N > 65535 || H < 2 || W < 2 || (H & 1) || (W & 1) ||
      ocvt::ceil_div(H / 2, kOutRows) > 65535)
    return cudaErrorInvalidValue;
  Taps5 t{};
  for (int i = 0; i < 5; ++i) t.k[i] = taps[i];
  const dim3 grid(ocvt::ceil_div(W / 2, kOutCols), ocvt::ceil_div(H / 2, kOutRows), N);
  gauss5_down2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), H, W, has_bgr, t);
  return cudaGetLastError();
}
