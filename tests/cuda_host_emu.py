"""A host build of a kernel source of ``opencv_tpu_torch/csrc``, so that its
indexing can be held to the plain version on the CPU: the source is
compiled with g++ against an emulation of the CUDA features the sources
use, its launches call the emulation's, and ``common.cuh``'s functions
whose bodies are inline PTX are replaced by their emulations.

- The blocks of the grid run one after another, a block's threads are host
  threads.
- A warp's shuffles and ``__syncwarp`` meet at the warp's barrier,
  ``__syncthreads`` at the block's; ``__shared__`` is a static, shared by
  the block's threads.
- A ``cp.async`` is queued by its thread and copied at its wait; a bulk
  copy is a memcpy.
- The integer intrinsics follow the PTX ISA's definitions (prmt,
  shf.r.wrap, dp2a).
"""

import ctypes
import re
import subprocess
from pathlib import Path

CUDA_EMU = r"""#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <math.h>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
thread_local dim3 threadIdx, blockIdx;
dim3 gridDim, blockDim;

template <class T>
inline T __ldg(const T* p) {
  T v;
  memcpy(&v, p, sizeof(T));
  return v;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t sh) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (sh & 31));
}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
inline uint32_t __dp2a_lo(uint32_t a, uint32_t b, uint32_t c) {
  return c + (a & 0xffff) * (b & 0xff) + (a >> 16) * ((b >> 8) & 0xff);
}
inline uint32_t __dp2a_hi(uint32_t a, uint32_t b, uint32_t c) {
  return c + (a & 0xffff) * ((b >> 16) & 0xff) + (a >> 16) * (b >> 24);
}
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

struct Warp {
  std::barrier<> bar{32};
  uint32_t buf[2][32];
};
thread_local Warp* tl_warp;
thread_local std::barrier<>* tl_block;
inline void __syncwarp() { tl_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { tl_block->arrive_and_wait(); }
// a warp's shuffle: every lane writes its value, meets the others, then
// reads its neighbour's; shuffles alternate between two buffers, so a lane
// writes one only after every lane has read it (they met since)
thread_local int tl_phase;
inline uint32_t shfl(uint32_t v, int delta) {
  const int lane = threadIdx.x & 31, src = lane + delta;
  uint32_t* buf = tl_warp->buf[tl_phase ^= 1];
  buf[lane] = v;
  tl_warp->bar.arrive_and_wait();
  return (src >= 0 && src < 32) ? buf[src] : v;
}
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int d) { return shfl(v, -d); }
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, int d) { return shfl(v, d); }

// cp.async: each thread's copies, in commit groups, land at the wait
struct EmuCopy { void* dst; const void* src; int n; };
thread_local std::vector<EmuCopy> tl_open;
thread_local std::vector<std::vector<EmuCopy>> tl_groups;
inline void emu_cp_async(void* dst, const void* src, int n) { tl_open.push_back({dst, src, n}); }
inline void emu_cp_commit() {
  tl_groups.push_back(tl_open);
  tl_open.clear();
}
inline void emu_cp_wait(int pending) {
  while ((int)tl_groups.size() > pending) {
    for (const EmuCopy& c : tl_groups.front()) {
      memcpy(c.dst, c.src, c.n);
      memset((char*)c.dst + c.n, 0, 16 - c.n);
    }
    tl_groups.erase(tl_groups.begin());
  }
}

// the blocks of the grid one after another, each on the same host threads,
// which meet at the end of each block
inline void emu_launch(dim3 grid, dim3 block, std::function<void()> body) {
  gridDim = grid;
  blockDim = block;
  const int nt = block.x * block.y * block.z;
  std::barrier<> bar(nt);
  std::vector<Warp> warps((nt + 31) / 32);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t % block.x, t / block.x % block.y, t / (block.x * block.y));
      tl_warp = &warps[t / 32];
      tl_block = &bar;
      for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
          for (unsigned bx = 0; bx < grid.x; ++bx) {
            blockIdx = dim3(bx, by, bz);
            body();
            bar.arrive_and_wait();
          }
    });
  for (auto& th : threads) th.join();
}
"""
# common.cuh's functions whose bodies are inline PTX, and their emulations
EMULATED = {
    "cp_async_commit": "emu_cp_commit();",
    "cp_async_wait": "emu_cp_wait(N);",
    "cp_async16_n": "emu_cp_async(smem, gmem, n);",
    "mbar_init": "",
    "bulk_copy": "memcpy(dst, src, bytes);",
    "mbar_arrive": "",
    "mbar_wait": "",
}
LAUNCH = re.compile(r"(\w+<[^<>;]*>)<<<(.+?)>>>\((.*?)\);", re.S)


def _launch_args(config: str) -> tuple:
    """The grid and block of a launch configuration (commas inside
    parentheses are not separators)."""
    parts, depth, cur = [], 0, ""
    for ch in config:
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts[0], parts[1]


def build(src: Path, out_dir: Path, symbol: str, launches: int):
    """`src` (a ``.cu`` file beside ``common.cuh``) built for the host in
    `out_dir`; returns its C entry `symbol` from the shared library.
    `launches` is the number of kernel launches the source holds."""
    text, n = LAUNCH.subn(lambda m: "emu_launch({}, {}, [&] {{ {}({}); }});".format(
        *_launch_args(m[2]), m[1], m[3]), src.read_text())
    assert n == launches, n
    common = (src.parent / "common.cuh").read_text().replace("#include <cuda_runtime.h>", "")
    for name, body in EMULATED.items():
        common, n = re.subn(rf"(__device__ __forceinline__ void {name}\([^)]*\)) \{{.*?\}}\n",
                            lambda m: f"{m[1]} {{ {body} }}\n", common, flags=re.S)
        assert n == 1, name
    (out_dir / "common.cuh").write_text(common)
    (out_dir / "k.cpp").write_text(text)
    emu = out_dir / "cuda_emu.h"
    emu.write_text(CUDA_EMU)
    so = out_dir / f"lib{src.stem}_host.so"
    res = subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-include",
                          str(emu), "-I", str(out_dir), "-o", str(so), str(out_dir / "k.cpp")],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return getattr(ctypes.CDLL(str(so)), symbol)
