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

// ---------------------------------------------------------------------------
// Edge tables.  A row of an (H, W, C) u8 image is L = W*C bytes.  The bytes
// within kEdge of either end of a row, outside [0, L), are resolved once per
// block into two small tables, so no border is resolved per byte.
// ---------------------------------------------------------------------------

constexpr int kEdge = 64;  // reach of the tables either side of a row, in bytes

// lmap[i] is byte i - kEdge of a row and rmap[i] byte L + i: the source byte
// in the row (>= 0) or -(ch + 1) where the constant of channel ch fills.
struct EdgeMaps {
  int lmap[kEdge];
  int rmap[kEdge];
  int bval[4];
};

// Every thread of the block takes part; a __syncthreads() must follow.
__device__ __forceinline__ void build_edge_maps(EdgeMaps* m, int W, int C, int border,
                                                const int* bval) {
  const int L = W * C;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < 2 * kEdge + 4; i += nthreads) {
    if (i >= 2 * kEdge) {
      m->bval[i - 2 * kEdge] = bval ? bval[i - 2 * kEdge] : 0;
      continue;
    }
    const int p = i < kEdge ? i - kEdge : L + i - kEdge;
    const int px = p >= 0 ? p / C : -((C - 1 - p) / C);  // floor(p / C)
    const int ch = p - px * C;
    const int sx = border_map(px, W, border);
    (i < kEdge ? m->lmap[i] : m->rmap[i - kEdge]) = sx < 0 ? -(ch + 1) : sx * C + ch;
  }
}

// Byte p of a row (p within kEdge of [0, L)) for the edge blocks; row ==
// nullptr is a BORDER_CONSTANT row, ch the channel of p.  No branch: the
// table reads and the (predicated) loads of all taps can be in flight at once.
__device__ __forceinline__ int mapped_byte(const uint8_t* row, int p, int L, int ch,
                                           const EdgeMaps* m) {
  const int t = p < 0 ? m->lmap[max(p + kEdge, 0)] : p >= L ? m->rmap[min(p - L, kEdge - 1)] : p;
  const int fill = m->bval[t < 0 ? -t - 1 : ch];
  return (row != nullptr && t >= 0) ? (int)__ldg(row + t) : fill;
}

// ---------------------------------------------------------------------------
// The staging of sep_filter's tile kernels: 16-byte chunks of a row copied
// into shared memory with cp.async, and the bytes outside [0, L) filled
// from the edge tables once the row has landed.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The first n (1..16) bytes from gmem, zeros after them.
__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// After the chunks of a row have landed in win (the staged bytes [lo, hi)
// of the row): fill the bytes of the window outside [0, L) from the
// edge tables, reading the source bytes from the window itself where it
// holds them (every border but WRAP and windows that end near an edge take
// no global load).  One warp's pass over one row, between two barriers of
// its caller.  Out of line, as only the blocks at a row's ends run it.
static __device__ __noinline__ void fill_edges(uint8_t* win, int lo, int hi, const uint8_t* row,
                                               int L, const EdgeMaps* m, int lane) {
  const int a0 = max(lo, -kEdge), a1 = min(hi, 0);
  const int b0 = max(lo, L), b1 = min(hi, L + kEdge);
  const int na = max(a1 - a0, 0);
  for (int i = lane; i < na + max(b1 - b0, 0); i += 32) {
    const int p = i < na ? a0 + i : b0 + i - na;
    const int t = p < 0 ? m->lmap[p + kEdge] : m->rmap[p - L];
    win[p - lo] = t < 0 ? (uint8_t)m->bval[-t - 1] : (t >= lo && t < hi) ? win[t - lo] : row[t];
  }
}

// ---------------------------------------------------------------------------
// Bulk row copies (the main paths of sep_filter and pyr_down): one lane of a
// warp asks the copy engine (cp.async.bulk, Hopper's TMA path) for a whole
// 16-byte aligned run of a row; the copy completes on an mbarrier in shared
// memory, which the warp waits on.  No register and no instruction per byte
// is spent on the copy, so many rows can be in flight.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One mbarrier per stage, expecting one arrival (the copying lane) a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on bar and copy bytes (a multiple of 16, both ends 16-byte aligned)
// from global src to shared dst; the phase completes when they have landed.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Arrive on bar with nothing to copy (a row staged another way).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of bar with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// Words of a row in registers, and the stores.
// ---------------------------------------------------------------------------

// The NW little-endian words of a row from byte q, by byte loads, zeros
// outside [0, L): pyr_down's staging of an unaligned row.
template <int NW>
__device__ __forceinline__ void row_words(uint32_t (&w)[NW], const uint8_t* row, int q, int L) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int p = q + 4 * i + b;
      if (p >= 0 && p < L) v |= (uint32_t)row[p] << (8 * b);
    }
    w[i] = v;
  }
}

// The NW little-endian words from byte i of the 4-byte aligned words s (in
// shared memory), at any i: NW + 1 word loads and a funnel shift each.
template <int NW>
__device__ __forceinline__ void shifted_words(uint32_t (&w)[NW], const uint32_t* s, int i) {
  const uint32_t* a = s + (i >> 2);
  const unsigned sh = 8 * (i & 3);
  uint32_t v[NW + 1];
#pragma unroll
  for (int k = 0; k <= NW; ++k) v[k] = a[k];
#pragma unroll
  for (int k = 0; k < NW; ++k) w[k] = __funnelshift_r(v[k], v[k + 1], sh);
}

// The NW words of a BORDER_CONSTANT row from byte q (a % per byte: once per
// thread, at its start).
template <int NW>
__device__ __forceinline__ void const_words(uint32_t (&w)[NW], int q, int C, const int* bval) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      int ch = (q + 4 * i + b) % C;
      v |= (uint32_t)(uint8_t)bval[ch < 0 ? ch + C : ch] << (8 * b);
    }
    w[i] = v;
  }
}

// Bytes a and b of a run of 32-bit words as the two 16-bit halves of one
// register (a, b compile-time constants after unrolling): one byte_perm and
// a mask.
template <int NW>
__device__ __forceinline__ uint32_t byte_pair(const uint32_t (&w)[NW], int a, int b) {
  return __byte_perm(w[a >> 2], w[b >> 2], (a & 3) | ((4 + (b & 3)) << 8)) & 0x00ff00ffu;
}

// Store bytes [lo, hi) of the NW little-endian words w at dst[lo, hi);
// whole words when vec and [lo, hi) is all of them (dst then aligned to 16
// bytes when NW is a multiple of 4, else to 4).
template <int NW>
__device__ __forceinline__ void store_words(uint8_t* dst, const uint32_t (&w)[NW], int lo, int hi,
                                            bool vec) {
  if (vec && lo == 0 && hi == 4 * NW) {
    if constexpr (NW % 4 == 0) {
#pragma unroll
      for (int i = 0; i < NW; i += 4)
        *reinterpret_cast<uint4*>(dst + 4 * i) = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i) reinterpret_cast<uint32_t*>(dst)[i] = w[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * NW; ++i)
      if (i >= lo && i < hi) dst[i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
  }
}

// Store v[lo, hi) at dst[lo, hi), as store_words.
template <int N>
__device__ __forceinline__ void store_range(uint8_t* dst, const uint8_t (&v)[N], int lo, int hi,
                                            bool vec) {
  uint32_t w[N / 4];
#pragma unroll
  for (int i = 0; i < N; i += 4)
    w[i / 4] = v[i] | v[i + 1] << 8 | v[i + 2] << 16 | (uint32_t)v[i + 3] << 24;
  store_words(dst, w, lo, hi, vec);
}

// The same for int16 lanes (N a multiple of 8; dst aligned to 16 bytes).
template <int N>
__device__ __forceinline__ void store_range(int16_t* dst, const int16_t (&v)[N], int lo, int hi,
                                            bool vec) {
  if (vec && lo == 0 && hi == N) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      uint4 w;
      w.x = (uint16_t)v[i] | (uint32_t)(uint16_t)v[i + 1] << 16;
      w.y = (uint16_t)v[i + 2] | (uint32_t)(uint16_t)v[i + 3] << 16;
      w.z = (uint16_t)v[i + 4] | (uint32_t)(uint16_t)v[i + 5] << 16;
      w.w = (uint16_t)v[i + 6] | (uint32_t)(uint16_t)v[i + 7] << 16;
      *reinterpret_cast<uint4*>(dst + i) = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i >= lo && i < hi) dst[i] = v[i];
  }
}

}  // namespace ocvt
