// Separable integer correlation over u8 NHWC with OpenCV's finishing chain.
//
// Replaces the Pallas kernel opencv_tpu/kernels/sepfilter.py::sep_filter_int
// (and its sep_filter_u8 front end).  What it computes, per output
// pixel-channel (channels folded into the row, horizontal taps stride C):
//
//   acc = sum_j ky[j] * sum_i kx[i] * x[y - ay + j][x - ax + i]   (int32)
//   shift > 0 -> acc = (acc + 2^(shift-1)) >> shift
//   acc += delta
//   has_scale -> acc = rint((float)acc * (float)scale)
//   saturate to u8 or i16
//
// The border is resolved inside the kernel with the closed-form
// borderInterpolate for all five modes (constant value per channel), so the
// host pads nothing.  A block stages its (rows + kh-1) x ((pixels + kw-1)*C)
// input tile in shared memory, runs the horizontal pass into an int32 tile in
// shared memory, then the vertical pass and the finishing chain.
//
// Bound: memory.  Each pixel-channel is read once as 1 B (plus the halo) and
// written once as 1-2 B; at k = 5 the kernel does ~10 integer MACs per byte,
// far under the H100's compute roofline.  The design keeps every intermediate
// on chip, so device memory sees only the input and the output.
//
// Shared memory at the largest case (k = 31, C = 4): 46 x 632 u8 + 46 x 512
// int32 = 123,280 B, above the 48 KB static limit, so the tile is dynamic
// shared memory and the launch raises the kernel's limit first.
#include "common.cuh"

namespace {

constexpr int kMaxTaps = 31;
constexpr int kTileRows = 16;     // output rows per block
constexpr int kTilePixels = 128;  // output pixels per block row
constexpr int kThreads = 256;

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
  int lo, hi;
};

size_t smem_bytes(int kw, int kh, int C) {
  const size_t in_rows = kTileRows + kh - 1;
  const size_t in_lanes = (size_t)(kTilePixels + kw - 1) * C;
  return ((in_rows * in_lanes + 15) & ~size_t(15)) + in_rows * kTilePixels * C * sizeof(int);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    sep_filter_kernel(const uint8_t* __restrict__ src, OutT* __restrict__ dst, const Taps taps,
                      const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C;
  const int in_rows = kTileRows + p.kh - 1;
  const int in_lanes = (kTilePixels + p.kw - 1) * C;
  const int lanes = kTilePixels * C;
  uint8_t* tile = smem;
  int* hsum = reinterpret_cast<int*>(smem + ((in_rows * in_lanes + 15) & ~15));

  const int y0 = blockIdx.y * kTileRows;
  const int x0 = blockIdx.x * kTilePixels;
  const size_t plane = (size_t)p.H * p.W * C;
  const uint8_t* img = src + blockIdx.z * plane;
  OutT* out = dst + blockIdx.z * plane;
  const int ax = p.kw / 2, ay = p.kh / 2;

  // 1. input tile + halo, border resolved per element
  for (int i = threadIdx.x; i < in_rows * in_lanes; i += kThreads) {
    const int r = i / in_lanes;
    const int l = i - r * in_lanes;
    const int px = l / C;
    const int ch = l - px * C;
    const int sy = ocvt::border_map(y0 - ay + r, p.H, p.border);
    const int sx = ocvt::border_map(x0 - ax + px, p.W, p.border);
    tile[i] = (sy < 0 || sx < 0) ? (uint8_t)p.bval[ch]
                                 : img[((size_t)sy * p.W + sx) * C + ch];
  }
  __syncthreads();

  // 2. horizontal pass into int32 (no intermediate rounding)
  for (int i = threadIdx.x; i < in_rows * lanes; i += kThreads) {
    const int r = i / lanes;
    const int l = i - r * lanes;
    const uint8_t* t = tile + r * in_lanes + l;
    int acc = 0;
    for (int k = 0; k < p.kw; ++k) acc += taps.kx[k] * (int)t[k * C];
    hsum[i] = acc;
  }
  __syncthreads();

  // 3. vertical pass + finishing chain; the ragged edge is masked here
  const int row_lanes = p.W * C;
  for (int i = threadIdx.x; i < kTileRows * lanes; i += kThreads) {
    const int r = i / lanes;
    const int l = i - r * lanes;
    const int oy = y0 + r;
    const int ol = x0 * C + l;
    if (oy >= p.H || ol >= row_lanes) continue;
    int v = 0;
    for (int k = 0; k < p.kh; ++k) v += taps.ky[k] * hsum[(r + k) * lanes + l];
    if (p.shift > 0) v = (v + (1 << (p.shift - 1))) >> p.shift;
    v += p.delta;
    if (p.has_scale) {
      float f = rintf((float)v * p.scale);  // f32 multiply, as the reference's jnp
      f = fminf(fmaxf(f, (float)p.lo), (float)p.hi);
      v = (int)f;
    }
    v = min(max(v, p.lo), p.hi);
    out[(size_t)oy * row_lanes + ol] = (OutT)v;
  }
}

template <typename OutT>
cudaError_t launch(const uint8_t* src, void* dst, int N, const Taps& taps, const Params& p,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(p.kw, p.kh, p.C);
  cudaError_t err = cudaFuncSetAttribute(sep_filter_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ocvt::ceil_div(p.W, kTilePixels), ocvt::ceil_div(p.H, kTileRows), N);
  sep_filter_kernel<OutT><<<grid, kThreads, smem, stream>>>(src, static_cast<OutT*>(dst), taps, p);
  return cudaGetLastError();
}

}  // namespace

// src: (N, H, W, C) u8 contiguous; dst: (N, H, W, C) u8 (out_i16 = 0) or
// i16 (out_i16 = 1).  kx/ky and bval are host arrays.  Returns a cudaError_t.
extern "C" int opencv_sep_filter(const void* src, void* dst, int N, int H, int W, int C,
                                 const int* kx, int kw, const int* ky, int kh, int shift,
                                 int delta, int has_scale, float scale, int border,
                                 const int* bval, int out_i16, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 || C > 4 || kw < 1 || kw > kMaxTaps ||
      kh < 1 || kh > kMaxTaps || shift < 0 || shift > 30 || border < 0 || border > 4 ||
      ocvt::ceil_div(H, kTileRows) > 65535)
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
  p.lo = out_i16 ? -32768 : 0;
  p.hi = out_i16 ? 32767 : 255;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_i16 ? launch<int16_t>(s, dst, N, taps, p, st) : launch<uint8_t>(s, dst, N, taps, p, st);
}
