// The transfer-free plane digest for Hopper (sm_90a): two mod-2^32
// weighted sums over a cropped int32 plane, so that a plane on the card
// can be held to one on the host with two words crossing between them.
// The CUDA counterpart of the JAX package's _make_digest
// (ffmpeg_hybrid_tpu/utils/digest.py:68-82), a jitted XLA program there,
// not a Pallas kernel; the port's plain version is
// utils/digest.py:plane_digest_plain.
//
//   plane_digest  (d1, d2) of plane[:ph, :pw], one launch
//   frame_digest  the same of up to three planes, one launch
//
// Semantics, in uint32 arithmetic (every sum and product mod 2^32):
//   W(y, x) = y * 0x9E3779B1 + x * 0x85EBCA77 + 0xC2B2AE3D
//   d1 = sum P(y, x) * W(y, x)
//   d2 = sum P(y, x) * ((W(y, x) ^ 0xA5A5A5A5) * 0x27D4EB2F)
// with P the int32 value taken as uint32.
//
// Design. One launch, no memset: a grid of at most kBlocksPerSm blocks
// an SM, each warp a row at a time (rows dealt round-robin over the
// grid's warps, the planes one after another). A row splits at its first
// 16-byte aligned sample: a scalar head of up to 3 samples, a body of
// int4 loads, kUnroll of them a lane in flight before any is used, and a
// scalar tail (row_split in tests/test_torch_digest.py is the host's
// model of the split). Each warp reduces its sums by shuffles, each block
// through shared memory into a partial of its own in a scratch (a few KB
// that the wrapper keeps for the stream); the last block to finish,
// found by an atomic ticket that it resets to zero, adds the partials,
// every one in flight at once, and writes the two words of each plane.
// Addition mod 2^32 does not depend on its order, so the result is the
// same whatever the blocks' order. The first design (a memset of the
// words, then a launch a plane, 4-byte loads, 4 in flight, an atomicAdd a
// warp) took 0.02584 ms on the three planes of a 12-bit 4:4:4 1080p
// frame on an H100, 3.5 times its bound.
//
// What bounds it. Bytes: the cropped plane is read once (4 bytes a
// pixel; a 1080p 4:4:4 frame's three planes are 24.9 MB, 7.4 us at
// 3.35 TB/s); the arithmetic is some ten integer operations a pixel,
// a third of that time at the int32 rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // int4 loads in flight a lane
constexpr int kBlocksPerSm = 3;
constexpr int kMaxPlanes = 3;
constexpr uint32_t kC1 = 0x9E3779B1u, kC2 = 0x85EBCA77u, kC3 = 0xC2B2AE3Du,
                   kCx = 0xA5A5A5A5u, kC4 = 0x27D4EB2Fu;

struct Plane {
  const int32_t* p;
  long long stride;
  int ph, pw;
};

struct Args {
  Plane pl[kMaxPlanes];
  int np;
  unsigned* part;  // [np][2][gridDim.x]
  unsigned* ticket;
  unsigned* out;   // [np][2]
};

__device__ __forceinline__ void add_px(uint32_t p, uint32_t w, uint32_t& d1,
                                       uint32_t& d2) {
  d1 += p * w;
  d2 += p * ((w ^ kCx) * kC4);
}

// The sums of one row (y of the plane) by one warp.
__device__ __forceinline__ void row_sums(const Plane& P, int y, int lane,
                                         uint32_t& d1, uint32_t& d2) {
  const int32_t* row = P.p + static_cast<long long>(y) * P.stride;
  const uint32_t wy = static_cast<uint32_t>(y) * kC1 + kC3;
  // the head: samples before the first 16-byte aligned one
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) &
                              15) >> 2;
  if (head > P.pw) head = P.pw;
  const int nq = (P.pw - head) >> 2;
  const int tail0 = head + 4 * nq;
  if (lane < head)
    add_px(static_cast<uint32_t>(__ldg(row + lane)),
           wy + static_cast<uint32_t>(lane) * kC2, d1, d2);
  if (lane < P.pw - tail0)
    add_px(static_cast<uint32_t>(__ldg(row + tail0 + lane)),
           wy + static_cast<uint32_t>(tail0 + lane) * kC2, d1, d2);
  const int4* body = reinterpret_cast<const int4*>(row + head);
  for (int q0 = lane; q0 < nq; q0 += 32 * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + 32 * u;
      v[u] = q < nq ? __ldg(body + q) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t w =
          wy + static_cast<uint32_t>(head + 4 * (q0 + 32 * u)) * kC2;
      add_px(static_cast<uint32_t>(v[u].x), w, d1, d2);
      add_px(static_cast<uint32_t>(v[u].y), w + kC2, d1, d2);
      add_px(static_cast<uint32_t>(v[u].z), w + 2 * kC2, d1, d2);
      add_px(static_cast<uint32_t>(v[u].w), w + 3 * kC2, d1, d2);
    }
  }
}

// The arguments stay in the parameter space (__grid_constant__): the
// planes are indexed at run time without a copy to the stack.
__global__ void __launch_bounds__(kThreads)
    digest_kernel(const __grid_constant__ Args a) {
  __shared__ uint32_t s[kWarps][kMaxPlanes][2];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + warp, nw = gridDim.x * kWarps;
  int skew = 0;  // rows dealt before this plane, so planes share warps
  for (int p = 0; p < a.np; ++p) {
    const Plane P = a.pl[p];
    uint32_t d1 = 0, d2 = 0;
    int y = (gw - skew % nw + nw) % nw;
    for (; y < P.ph; y += nw) row_sums(P, y, lane, d1, d2);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      d1 += __shfl_down_sync(0xffffffffu, d1, off);
      d2 += __shfl_down_sync(0xffffffffu, d2, off);
    }
    if (lane == 0) {
      s[warp][p][0] = d1;
      s[warp][p][1] = d2;
    }
    skew += P.ph;
  }
  __syncthreads();
  const int grid = gridDim.x;
  if (threadIdx.x < 2 * a.np) {
    const int p = threadIdx.x >> 1, k = threadIdx.x & 1;
    uint32_t v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s[w][p][k];
    a.part[threadIdx.x * grid + blockIdx.x] = v;
  }
  // the last block to finish adds the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == grid - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every word of every partial in flight at once: the grid is at most
  // 2 kThreads blocks (grid_size), words j-major
  uint32_t v[2 * kMaxPlanes];
#pragma unroll
  for (int j = 0; j < 2 * kMaxPlanes; ++j) {
    v[j] = 0;
    if (j < 2 * a.np) {
      const int b0 = threadIdx.x, b1 = threadIdx.x + kThreads;
      const uint32_t x0 = b0 < grid ? __ldcg(a.part + j * grid + b0) : 0u;
      const uint32_t x1 = b1 < grid ? __ldcg(a.part + j * grid + b1) : 0u;
      v[j] = x0 + x1;
    }
  }
#pragma unroll
  for (int j = 0; j < 2 * kMaxPlanes; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[j] += __shfl_down_sync(0xffffffffu, v[j], off);
  }
  __syncthreads();  // the block's sums in s are read: reuse it
  uint32_t* t = &s[0][0][0];  // [kWarps][2 kMaxPlanes]
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 2 * kMaxPlanes; ++j)
      t[warp * 2 * kMaxPlanes + j] = v[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * a.np) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += t[w * 2 * kMaxPlanes + threadIdx.x];
    a.out[threadIdx.x] = sum;
  }
  if (threadIdx.x == 0) *a.ticket = 0;
}

int grid_size(int rows) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  // a block for each kWarps rows, at most kBlocksPerSm an SM and 2
  // kThreads in all (the last block reads a partial a thread twice)
  const int blocks = (rows + kWarps - 1) / kWarps;
  int most = sms * kBlocksPerSm;
  if (most > 2 * kThreads) most = 2 * kThreads;
  return blocks < 1 ? 1 : blocks < most ? blocks : most;
}

}  // namespace

extern "C" {

// The scratch words a launch of up to np planes needs (the partials of
// the largest grid and the ticket), for the wrapper to keep per stream.
int digest_scratch_words(int np) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return sms * kBlocksPerSm * np * 2 + 1;
}

// (d1, d2) of each plane j < np (1-3), planes[j][:ph[j], :pw[j]] (int32,
// stride[j] elements between rows, host arrays of np each), into
// out[2j], out[2j + 1] (uint32 words): one launch on `stream`. scratch:
// digest_scratch_words(np) words, zero before the first call (the
// kernel leaves its ticket at zero).
int frame_digest(const int32_t* const* planes, const long long* stride,
                 const int* ph, const int* pw, int np, unsigned int* scratch,
                 unsigned int* out, cudaStream_t stream) {
  if (np < 1 || np > kMaxPlanes || !planes || !stride || !ph || !pw ||
      !scratch || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  int rows = 0;
  for (int j = 0; j < np; ++j) {
    // an empty crop may come with a null pointer (an empty view)
    const bool empty = ph[j] == 0 || pw[j] == 0;
    if (ph[j] < 0 || pw[j] < 0 || stride[j] < pw[j] ||
        (!empty && (!planes[j] || reinterpret_cast<uintptr_t>(planes[j]) % 4)))
      return static_cast<int>(cudaErrorInvalidValue);
    a.pl[j] = Plane{planes[j], stride[j], empty ? 0 : ph[j], pw[j]};
    rows += pw[j] ? ph[j] : 0;
  }
  const int need = digest_scratch_words(np);
  const int grid = grid_size(rows);
  if (need < 0 || grid < 0) return static_cast<int>(cudaErrorUnknown);
  a.np = np;
  a.ticket = scratch;
  a.part = scratch + 1;
  a.out = out;
  digest_kernel<<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// (d1, d2) of plane[:ph, :pw] into out[0], out[1]: frame_digest of one.
int plane_digest(const int32_t* plane, long long stride, int ph, int pw,
                 unsigned int* scratch, unsigned int* out,
                 cudaStream_t stream) {
  return frame_digest(&plane, &stride, &ph, &pw, 1, scratch, out, stream);
}

}  // extern "C"
