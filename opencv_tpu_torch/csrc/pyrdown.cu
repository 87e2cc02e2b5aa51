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
// there), which forced a HIGHEST-precision second dot to stay exact.  Here
// the stride-2 stencil is plain strided shared-memory reads: a block stages
// its (2*16 + 3) x ((2*64 + 3) * C) input tile with the border resolved per
// element, runs the horizontal 5-tap pass at the even columns into an int32
// tile, then the vertical pass at the even rows with the round and saturate.
//
// Bound: memory.  Each input byte is read about once (plus a 3-row, 3-pixel
// halo per block) and a quarter byte is written; at (8, 1080, 1920, 1) that
// is 16.6 MB in and 4.1 MB out, against ~12 integer MACs per output.  All
// intermediates stay in shared memory.
//
// Shared memory at C = 4: 35 x 524 u8 + 35 x 256 int32 = 54,192 B, above the
// 48 KB static limit, so the tile is dynamic shared memory and the launch
// raises the kernel's limit first.
#include "common.cuh"

namespace {

constexpr int kOutRows = 16;    // output rows per block
constexpr int kOutPixels = 64;  // output pixels per block row
constexpr int kInRows = 2 * kOutRows + 3;
constexpr int kInPixels = 2 * kOutPixels + 3;
constexpr int kThreads = 256;

__host__ __device__ inline size_t tile_bytes(int C) {
  return ((size_t)kInRows * kInPixels * C + 15) & ~size_t(15);
}

size_t smem_bytes(int C) { return tile_bytes(C) + (size_t)kInRows * kOutPixels * C * sizeof(int); }

__global__ void __launch_bounds__(kThreads)
    pyr_down_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int H, int W, int C,
                    int border) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int in_lanes = kInPixels * C;
  const int lanes = kOutPixels * C;
  uint8_t* tile = smem;
  int* hsum = reinterpret_cast<int*>(smem + tile_bytes(C));

  const int oy0 = blockIdx.y * kOutRows;
  const int ox0 = blockIdx.x * kOutPixels;
  const int iy0 = 2 * oy0 - 2;
  const int ix0 = 2 * ox0 - 2;
  const uint8_t* img = src + blockIdx.z * (size_t)H * W * C;

  // 1. input tile + halo, border resolved per element
  for (int i = threadIdx.x; i < kInRows * in_lanes; i += kThreads) {
    const int r = i / in_lanes;
    const int l = i - r * in_lanes;
    const int px = l / C;
    const int ch = l - px * C;
    const int sy = ocvt::border_map(iy0 + r, H, border);
    const int sx = ocvt::border_map(ix0 + px, W, border);
    tile[i] = img[((size_t)sy * W + sx) * C + ch];
  }
  __syncthreads();

  // 2. horizontal pass at the even columns: output pixel p reads tile
  //    pixels 2p .. 2p+4
  for (int i = threadIdx.x; i < kInRows * lanes; i += kThreads) {
    const int r = i / lanes;
    const int l = i - r * lanes;
    const int p = l / C;
    const uint8_t* t = tile + r * in_lanes + 2 * p * C + (l - p * C);
    hsum[i] = t[0] + 4 * t[C] + 6 * t[2 * C] + 4 * t[3 * C] + t[4 * C];
  }
  __syncthreads();

  // 3. vertical pass at the even rows, round, saturate; ragged edge masked
  const int Ho = (H + 1) / 2;
  const int row_lanes = ((W + 1) / 2) * C;
  uint8_t* out = dst + blockIdx.z * (size_t)Ho * row_lanes;
  for (int i = threadIdx.x; i < kOutRows * lanes; i += kThreads) {
    const int r = i / lanes;
    const int l = i - r * lanes;
    const int oy = oy0 + r;
    const int ol = ox0 * C + l;
    if (oy >= Ho || ol >= row_lanes) continue;
    const int* h = hsum + 2 * r * lanes + l;
    const int v = h[0] + 4 * h[lanes] + 6 * h[2 * lanes] + 4 * h[3 * lanes] + h[4 * lanes];
    out[(size_t)oy * row_lanes + ol] = (uint8_t)min((v + 128) >> 8, 255);
  }
}

}  // namespace

// src: (N, H, W, C) u8 contiguous; dst: (N, (H+1)/2, (W+1)/2, C) u8.
// border: REPLICATE, REFLECT, WRAP or REFLECT_101 (constants.py values).
// Returns a cudaError_t.
extern "C" int opencv_pyr_down(const void* src, void* dst, int N, int H, int W, int C, int border,
                               void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 || C > 4 ||
      border < ocvt::kBorderReplicate || border > ocvt::kBorderReflect101 ||
      ocvt::ceil_div((H + 1) / 2, kOutRows) > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(pyr_down_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ocvt::ceil_div((W + 1) / 2, kOutPixels), ocvt::ceil_div((H + 1) / 2, kOutRows), N);
  pyr_down_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), H, W, C, border);
  return cudaGetLastError();
}
