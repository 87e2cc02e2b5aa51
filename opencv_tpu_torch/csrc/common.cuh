// Shared device helpers of the opencv_tpu_torch kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ocvt {

// cv::BorderTypes values (constants.py)
enum : int {
  kBorderConstant = 0,
  kBorderReplicate = 1,
  kBorderReflect = 2,
  kBorderWrap = 3,
  kBorderReflect101 = 4,
};

__device__ __forceinline__ int pos_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// Closed-form cv::borderInterpolate (core/src/copy.cpp:748): the source
// coordinate of p in [0, len), or -1 where BORDER_CONSTANT fills.  Valid for
// any p, so tiles that overhang the image never read out of bounds.
__device__ __forceinline__ int border_map(int p, int len, int border) {
  if (p >= 0 && p < len) return p;
  switch (border) {
    case kBorderConstant:
      return -1;
    case kBorderReplicate:
      return p < 0 ? 0 : len - 1;
    case kBorderWrap:
      return pos_mod(p, len);
    case kBorderReflect: {  // period 2L: ...210|012...L-1|L-1...
      if (len == 1) return 0;
      int q = pos_mod(p, 2 * len);
      return q < len ? q : 2 * len - 1 - q;
    }
    default: {  // kBorderReflect101, period 2L-2: ...21|012...L-1|L-2...
      if (len == 1) return 0;
      int q = pos_mod(p, 2 * len - 2);
      return q < len ? q : 2 * len - 2 - q;
    }
  }
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace ocvt
