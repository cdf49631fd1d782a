// The transfer-free plane digest for Hopper (sm_90a): two mod-2^32
// weighted sums over a cropped int32 plane, so that a plane on the card
// can be held to one on the host with two words crossing between them.
// The CUDA counterpart of the JAX package's _make_digest
// (ffmpeg_hybrid_tpu/utils/digest.py:68-82), a jitted XLA program there,
// not a Pallas kernel; the port's plain version is
// utils/digest.py:plane_digest_plain.
//
//   plane_digest  (d1, d2) of plane[:ph, :pw], one launch
//
// Semantics, in uint32 arithmetic (every sum and product mod 2^32):
//   W(y, x) = y * 0x9E3779B1 + x * 0x85EBCA77 + 0xC2B2AE3D
//   d1 = sum P(y, x) * W(y, x)
//   d2 = sum P(y, x) * ((W(y, x) ^ 0xA5A5A5A5) * 0x27D4EB2F)
// with P the int32 value taken as uint32.
//
// Design. Blocks stride over the rows, the threads of a block over the
// columns of a row, so a warp's loads are 128 contiguous bytes; a
// thread issues kUnroll loads, a block width apart, before it uses one
// (one load a thread in flight left the first version at 3.8 times its
// bound on an H100: 0.0282 ms on the frame below). Each thread keeps its two
// partial sums in registers, each warp reduces them by shuffles, and
// lane 0 adds one word a sum into the output with atomicAdd on unsigned
// int. Addition mod 2^32 does not depend on its order, so the result is
// the same whatever the blocks' order. The entry zeroes the two output
// words on the stream before the launch.
//
// What bounds it. Bytes: the cropped plane is read once (4 bytes a
// pixel; a 1080p 4:4:4 frame's three planes are 24.9 MB, 7.4 us at
// 3.35 TB/s); the arithmetic is some ten integer operations a pixel,
// a third of that time at the int32 rate. The grid is capped at a few
// blocks an SM, so the atomics are a few thousand a launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;     // loads in flight a thread
constexpr int kBlocksPerSm = 4;
constexpr uint32_t kC1 = 0x9E3779B1u, kC2 = 0x85EBCA77u, kC3 = 0xC2B2AE3Du,
                   kCx = 0xA5A5A5A5u, kC4 = 0x27D4EB2Fu;

__global__ void __launch_bounds__(kThreads)
    plane_digest_kernel(const int32_t* __restrict__ plane, long long stride,
                        int ph, int pw, unsigned int* __restrict__ out) {
  uint32_t d1 = 0, d2 = 0;
  for (int y = blockIdx.x; y < ph; y += gridDim.x) {
    const int32_t* row = plane + static_cast<long long>(y) * stride;
    const uint32_t wy = static_cast<uint32_t>(y) * kC1 + kC3;
    for (int x0 = threadIdx.x; x0 < pw; x0 += kThreads * kUnroll) {
      // kUnroll independent loads in flight before any is used
      uint32_t p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int x = x0 + u * kThreads;
        p[u] = x < pw ? static_cast<uint32_t>(__ldg(row + x)) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t w =
            wy + static_cast<uint32_t>(x0 + u * kThreads) * kC2;
        d1 += p[u] * w;
        d2 += p[u] * ((w ^ kCx) * kC4);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    d1 += __shfl_down_sync(0xffffffffu, d1, off);
    d2 += __shfl_down_sync(0xffffffffu, d2, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(out, d1);
    atomicAdd(out + 1, d2);
  }
}

}  // namespace

extern "C" {

// (d1, d2) of plane[:ph, :pw] into out[0], out[1] (uint32 words): plane
// is int32 with `stride` elements between rows; one launch on `stream`.
int plane_digest(const int32_t* plane, long long stride, int ph, int pw,
                 unsigned int* out, cudaStream_t stream) {
  if (ph < 0 || pw < 0 || stride < pw)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(unsigned int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ph == 0 || pw == 0) return 0;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int blocks = ph < sms * kBlocksPerSm ? ph : sms * kBlocksPerSm;
  plane_digest_kernel<<<blocks, kThreads, 0, stream>>>(plane, stride, ph, pw,
                                                        out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
