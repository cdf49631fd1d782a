// A host stand-in for the CUDA runtime subset csrc/passa.cu uses, so that
// tests/test_torch_passa_emulated.py can compile the kernel with g++ and
// run it on the CPU: a block is 32 threads (a lane each), run one block
// after another over one shared-memory buffer; every warp intrinsic
// (__syncwarp, __syncthreads, __ballot_sync, __shfl_sync) is a barrier
// round of the 32, so a lane that reads what another wrote without such
// a barrier between them may see the other's old or new value, as on the
// card, where lockstep is not promised.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
inline int2 make_int2(int x, int y) { return {x, y}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T>
cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
using std::max;
using std::min;
inline thread_local int emu_lane, emu_block;
struct EmuDim { int x; };
#define threadIdx (EmuDim{emu_lane})
#define blockIdx (EmuDim{emu_block})
template <class T> T __ldg(const T* p) { return *p; }
inline int __clz(int x) {
  return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x));
}
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned sh) {
  sh &= 31;
  return sh ? (hi << sh) | (lo >> (32 - sh)) : hi;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  sh &= 31;
  return sh ? (lo >> sh) | (hi << (32 - sh)) : lo;
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n)
    r |= static_cast<unsigned>((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff)
         << (8 * n);
  return r;
}
inline long long clock64() { return 0; }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline std::barrier<>* emu_barrier;
inline long long emu_vals[32];
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_barrier->arrive_and_wait();
}
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline unsigned __ballot_sync(unsigned, int p) {
  emu_barrier->arrive_and_wait();
  emu_vals[emu_lane] = p != 0;
  emu_barrier->arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= static_cast<unsigned>(emu_vals[i]) << i;
  emu_barrier->arrive_and_wait();
  return m;
}
inline int __shfl_sync(unsigned, int v, int src) {
  emu_barrier->arrive_and_wait();
  emu_vals[emu_lane] = v;
  emu_barrier->arrive_and_wait();
  const int r = static_cast<int>(emu_vals[src]);
  emu_barrier->arrive_and_wait();
  return r;
}
namespace {
// the dynamic shared memory, filled with a pattern before each block
alignas(16) unsigned char smem_raw[1 << 18];
}
// a launch: blocks one after another, each 32 threads
template <class F, class... A>
void emulate(int blocks, F kernel, A... args) {
  for (int b = 0; b < blocks; ++b) {
    std::memset(smem_raw, 0xa5, sizeof(smem_raw));
    std::barrier<> bar(32);
    emu_barrier = &bar;
    std::vector<std::thread> lanes;
    for (int l = 0; l < 32; ++l)
      lanes.emplace_back([=]() {
        emu_lane = l;
        emu_block = b;
        kernel(args...);
      });
    for (auto& t : lanes) t.join();
  }
}
