// VP9 inverse transforms for Hopper (sm_90a): the residuals of a frame's
// planes and the coefficient scatter before them, the CUDA counterparts
// of the JAX package's residual_plane and _residual_for_size
// (ffmpeg_hybrid_tpu/ops/recon_tpu.py:55-124, over the 1-D butterflies of
// ops/itxfm.py) and of _scatter_pairs16/_scatter_pairs32 with
// _slice_plane (1037-1058, 1143-1148). Those are XLA programs, not
// Pallas kernels; they are the residual stage of the main path.
//
//   scatter_pairs    the dense coefficient and eob buffers of a frame's
//                    pair rows: one launch into buffers that read zero
//                    (a memset pair first when the caller asks for it)
//   residual_planes  the residuals of up to three planes, one launch;
//                    with `consume`, it also clears what it read
//   residual_planes_hbd  the same for 10/12-bit planes: float64
//                    butterflies, int32 coefficients
//
// Semantics. Pair rows carry a position (pos-hi << 16 | pos-lo) and a
// value; a row whose position is negative (a pad row) or past the
// buffer is dropped, every other position is 0. A plane is tiled by
// transform blocks. A 4x4 cell (y, x) is the root of a block of size
// 4 << t when t = txsz4[y, x] is 0..3 and y and x are multiples of
// 1 << t; the block contributes when its root's eob is > 0, and every
// pixel no block covers is 0 (the plain version sums its per-size
// planes, so a pixel two roots cover gets both). A block runs two 1-D
// passes: pass a over each column c of the coefficient tile gives row c
// of a temporary, pass b over each column k of the temporary gives
// column k of the residual. Each pass is a DCT or an ADST by the root's
// txtype4 (1 and 3: ADST in pass a; 2 and 3: ADST in pass b; 32x32 is
// DCT only), and its outputs wrap to the store type dctcoef: int16 at 8
// bpp, int32 at 10/12 bpp. Then (int)(v + (1U << (s - 1))) >> s with s =
// 4, 5, 6, 6 by size. eob == 1 with DCT_DCT (any type at 32x32) takes the
// DC shortcut instead: _rs(_rs(dc * 11585) * 11585), then the same
// rounding, over the whole block. Lossless frames use the 4x4
// Walsh-Hadamard transform (inputs >> 2 in pass a, no final shift) on
// every root with txsz4 == 0.
//
// Consuming. FFmpeg's inverse transforms clear a block's coefficients
// after the add, so the buffer is zero again for the next block. With
// `consume`, residual_planes does the same for the dense buffers, which
// then stay zero from frame to frame and need no memset before the next
// scatter: every nonzero eob cell is set to 0 by the thread that reads
// it; pass a flags in shared memory each 4-pixel quad in which it reads
// a nonzero (it reads every coefficient of a root that is not DC-only),
// a DC-only root flags the quad of its DC (which it reads alone), and
// after the last size each thread writes zeros to its quad if flagged.
// This rests on a precondition: every nonzero the scatter writes lies in
// the tile of a root that the residual transforms, and a DC-only root
// holds no nonzero but its DC. Pass A's rows meet it by construction:
// the native packer ships the nonzeros of the tiles of roots with eob >
// 0 (vp9_pack_pairs), whose blocks the decoder zeroes before their
// coefficients (a DC-only block then holds its DC alone), and the
// pure-Python pass A writes fresh zeroed planes; roots are aligned,
// inside the superblock-padded planes, of sizes 0-3, and 4x4 on
// lossless frames. Where an eob cell breaks it, the kernel tells: a
// nonzero eob cell that is not a transformed root (misaligned, past the
// plane's edge, a size past 3, a size past 0 on a lossless frame) sets
// its plane's `strays` flag to 1, and the caller zero-fills the buffers
// before its next scatter (ops/recon.py CoefBuffers). A frame that
// raises between the scatter and the residual leaves them unconsumed,
// and the caller zero-fills them too. Not detected: a nonzero
// coefficient outside the tile of every root with eob > 0, or one past
// the DC of a DC-only root. It is neither cleared nor flagged and stays
// in the buffer for the later frames of that geometry; the tests hold
// both pass A packers to the precondition on the repository's clips
// (tests/test_torch_residual_pairs.py).
//
// Arithmetic. At 8 bpp the butterflies are int32 arithmetic that wraps
// modulo 2^32 (JAX's and PyTorch's int32, and C's int on the reference's
// targets); signed overflow is undefined in C++, so they run on
// uint32_t, and _rs, (v + 8192) >> 14, is an arithmetic shift of the
// wrapped value. At 10/12 bpp the reference's dctint is int64_t and its
// dctcoef int32_t, and each pass's outputs keep their low 32 bits
// (ops/itxfm.py _wrap32). On int32 inputs no intermediate of any 1-D
// kernel reaches 2^51 (kPeakBits), so the int64 arithmetic never wraps,
// and a double holds each value exactly: the same butterflies run on
// float64 words (f64: each + - * exact, the floors of _rs and the shifts
// exact by kMagic), in about half the instructions of uint64 ones. One
// source carries every word: the 1-D kernels are templates of it. The
// butterflies below were transcribed from
// ffmpeg_hybrid_tpu_torch/ops/itxfm.py line by line: every constant and
// every input permutation and negated output is that file's.
//
// Design. The scatter: a thread per row (coefficient rows, then eob
// rows) in one launch. The rows come in an order unrelated to the
// planes' regions (raster order of block roots, or decode order), so
// they land in dense buffers that the residual reads; on the main path
// those buffers are kept from frame to frame and read zero, because the
// residual before consumed them, so the launch is the scatter's only
// device operation. The residual: one thread block of 256 threads per
// aligned 32x32 region, the regions of the three planes in one grid;
// every transform block lies inside exactly one region. The region's
// first two warps read its 64 cells once into shared memory and vote on
// the sizes present and on whether a size has a block that is not
// DC-only; a region with no coded block writes zeros and leaves. Each
// size present runs as two passes through shared memory (pass a, and
// its barrier, only where some block of the size needs it): one thread
// per 1-D transform holds its column in registers, and at 32x32 two
// lanes share each column, one the even inputs (idct16), one the odd
// (idct32_odd), joined by one exchange of 16 values, so 64 threads work
// the one block. The residual accumulates in shared memory and is
// written once, an int4 a thread, zeros included. The clear comes after
// the last size's barrier, a quad a thread, so no thread of the region
// reads a coefficient after it is cleared, and a region's roots lie in
// the region, so no other block reads them. At 10/12 bpp the region's
// kHbdThreads (128) take the same work items in rounds (4x4's 256 in two),
// so that more regions are in flight on an SM (kHbdMinBlocks, 48
// registers): a region of one 32x32 root keeps 64 threads busy however
// wide its block, and waits on its chains of dependent operations.
//
// What bounds it. Bytes: the scatter reads the pair rows and writes the
// positions they name, some 2 MB for a 1080p frame (with the memset
// pair, the two dense buffers too: some 8 MB, 2.4 us at 3.35 TB/s); the
// residual reads the grids and the first eob coefficients of each coded
// block and writes the int32 residual once, some 16 MB (4.8 us), and,
// consuming, clears what it read. The butterflies are a few tens of
// integer operations per pixel, below that. At 10/12 bpp the
// coefficients are int32 (twice the bytes read and cleared) and the
// butterflies float64, 1-3 instructions an operation (ptxas's register
// and spill counts of both kernels are in PERF.md). The first 10/12-bit
// design ran them on uint64 words, 2-4 instructions an operation, in
// 256-thread blocks at 64 registers: 4.6-4.9 times the bytes bound.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

typedef uint32_t u32;
typedef uint64_t u64;

// _rs: (v + (1 << 13)) >> 14, arithmetic, on the wrapped int32 (8 bpp)
// or int64 (dctint, 10/12 bpp)
__device__ __forceinline__ u32 rs(u32 v) {
  return static_cast<u32>(static_cast<int32_t>(v + 8192u) >> 14);
}

__device__ __forceinline__ u64 rs(u64 v) {
  return static_cast<u64>(static_cast<int64_t>(v + 8192u) >> 14);
}

__device__ __forceinline__ u32 asr(u32 v, int s) {
  return static_cast<u32>(static_cast<int32_t>(v) >> s);
}

__device__ __forceinline__ u64 asr(u64 v, int s) {
  return static_cast<u64>(static_cast<int64_t>(v) >> s);
}

// A float64 word for dctint at 10/12 bpp: the butterflies' values are
// integers, and with int32 inputs every intermediate stays below 2^49.6 in
// magnitude (interval arithmetic over ops/itxfm.py; the port's tests hold
// it), so below 2^51: each +, - and * by a constant is exact, a * b + c
// too (fused or not), and the floors of _rs and the WHT's shifts are exact
// by adding kMagic (1.5 * 2^52) rounded toward -inf, where a double's unit
// is 1: the int64 (dctint) arithmetic bit for bit, in about half the
// instructions of uint64 words (a DFMA a product and sum, three for _rs).
struct f64 {
  double v;
};
constexpr double kMagic = 6755399441055744.0;

__device__ __forceinline__ f64 operator+(f64 a, f64 b) { return {a.v + b.v}; }
__device__ __forceinline__ f64 operator-(f64 a, f64 b) { return {a.v - b.v}; }
// 0u - x, the butterflies' negation
__device__ __forceinline__ f64 operator-(unsigned, f64 a) { return {-a.v}; }
__device__ __forceinline__ f64 operator*(f64 a, int c) { return {a.v * c}; }
__device__ __forceinline__ f64 operator*(int c, f64 a) { return {a.v * c}; }
__device__ __forceinline__ f64 operator*(f64 a, unsigned c) {
  return {a.v * c};
}

__device__ __forceinline__ f64 floor_exact(double v) {
  return {__dadd_rd(v, kMagic) - kMagic};
}

__device__ __forceinline__ f64 rs(f64 a) {
  return floor_exact(fma(a.v, 1.0 / 16384, 0.5));
}

__device__ __forceinline__ f64 asr(f64 a, int s) {
  return floor_exact(a.v * (1.0 / (1 << s)));
}

// _wrap16: the low 16 bits, sign-extended
__device__ __forceinline__ int32_t wrap16(u32 v) {
  return static_cast<int16_t>(static_cast<uint16_t>(v & 0xffffu));
}

__device__ __forceinline__ int32_t lo32(u32 v) {
  return static_cast<int32_t>(v);
}

__device__ __forceinline__ int32_t lo32(u64 v) {
  return static_cast<int32_t>(static_cast<u32>(v));
}

// an integer below 2^51 plus kMagic holds it in its low mantissa bits
__device__ __forceinline__ int32_t lo32(f64 v) {
  return __double2loint(v.v + kMagic);
}

// A value as the butterflies' word, sign-extended
template <typename T>
__device__ __forceinline__ T word(int32_t v);

template <>
__device__ __forceinline__ u32 word<u32>(int32_t v) {
  return static_cast<u32>(v);
}

template <>
__device__ __forceinline__ u64 word<u64>(int32_t v) {
  return static_cast<u64>(static_cast<int64_t>(v));
}

template <>
__device__ __forceinline__ f64 word<f64>(int32_t v) {
  return {static_cast<double>(v)};
}

// ---------------------------------------------------------------------
// 1-D kernels (ops/itxfm.py idct4_1d ... idct32_1d): I -> O, length N

template <typename T>
__device__ __forceinline__ void idct4(const T* I, T* O) {
  const T i0 = I[0];
  const T i1 = I[1];
  const T i2 = I[2];
  const T i3 = I[3];
  T t0 = rs((i0 + i2) * 11585);
  T t1 = rs((i0 - i2) * 11585);
  T t2 = rs(i1 * 6270 - i3 * 15137);
  T t3 = rs(i1 * 15137 + i3 * 6270);
  O[0] = t0 + t3;
  O[1] = t1 + t2;
  O[2] = t1 - t2;
  O[3] = t0 - t3;
}

template <typename T>
__device__ __forceinline__ void iadst4(const T* I, T* O) {
  const T i0 = I[0];
  const T i1 = I[1];
  const T i2 = I[2];
  const T i3 = I[3];
  T t0 = 5283 * i0 + 15212 * i2 + 9929 * i3;
  T t1 = 9929 * i0 - 5283 * i2 - 15212 * i3;
  T t2 = 13377 * (i0 - i2 + i3);
  T t3 = 13377 * i1;
  O[0] = rs(t0 + t3);
  O[1] = rs(t1 + t3);
  O[2] = rs(t2);
  O[3] = rs(t0 + t1 - t3);
}

template <typename T>
__device__ __forceinline__ void idct8(const T* I, T* O) {
  T t0a = rs((I[0] + I[4]) * 11585);
  T t1a = rs((I[0] - I[4]) * 11585);
  T t2a = rs(I[2] * 6270 - I[6] * 15137);
  T t3a = rs(I[2] * 15137 + I[6] * 6270);
  T t4a = rs(I[1] * 3196 - I[7] * 16069);
  T t5a = rs(I[5] * 13623 - I[3] * 9102);
  T t6a = rs(I[5] * 9102 + I[3] * 13623);
  T t7a = rs(I[1] * 16069 + I[7] * 3196);
  T t0 = t0a + t3a;
  T t1 = t1a + t2a;
  T t2 = t1a - t2a;
  T t3 = t0a - t3a;
  T t4 = t4a + t5a;
  T t5a2 = t4a - t5a;
  T t7 = t7a + t6a;
  T t6a2 = t7a - t6a;
  T t5 = rs((t6a2 - t5a2) * 11585);
  T t6 = rs((t6a2 + t5a2) * 11585);
  O[0] = t0 + t7;
  O[1] = t1 + t6;
  O[2] = t2 + t5;
  O[3] = t3 + t4;
  O[4] = t3 - t4;
  O[5] = t2 - t5;
  O[6] = t1 - t6;
  O[7] = t0 - t7;
}

template <typename T>
__device__ __forceinline__ void iadst8(const T* I, T* O) {
  T t0a = 16305 * I[7] + 1606 * I[0];
  T t1a = 1606 * I[7] - 16305 * I[0];
  T t2a = 14449 * I[5] + 7723 * I[2];
  T t3a = 7723 * I[5] - 14449 * I[2];
  T t4a = 10394 * I[3] + 12665 * I[4];
  T t5a = 12665 * I[3] - 10394 * I[4];
  T t6a = 4756 * I[1] + 15679 * I[6];
  T t7a = 15679 * I[1] - 4756 * I[6];
  T t0 = rs(t0a + t4a);
  T t1 = rs(t1a + t5a);
  T t2 = rs(t2a + t6a);
  T t3 = rs(t3a + t7a);
  T t4 = rs(t0a - t4a);
  T t5 = rs(t1a - t5a);
  T t6 = rs(t2a - t6a);
  T t7 = rs(t3a - t7a);
  t4a = 15137 * t4 + 6270 * t5;
  t5a = 6270 * t4 - 15137 * t5;
  t6a = 15137 * t7 - 6270 * t6;
  t7a = 6270 * t7 + 15137 * t6;
  T o0 = t0 + t2;
  T o7 = (0u - (t1 + t3));
  t2 = t0 - t2;
  t3 = t1 - t3;
  T o1 = (0u - rs(t4a + t6a));
  T o6 = rs(t5a + t7a);
  t6 = rs(t4a - t6a);
  t7 = rs(t5a - t7a);
  T o3 = (0u - rs((t2 + t3) * 11585));
  T o4 = rs((t2 - t3) * 11585);
  T o2 = rs((t6 + t7) * 11585);
  T o5 = (0u - rs((t6 - t7) * 11585));
  O[0] = o0;
  O[1] = o1;
  O[2] = o2;
  O[3] = o3;
  O[4] = o4;
  O[5] = o5;
  O[6] = o6;
  O[7] = o7;
}

template <typename T>
__device__ __forceinline__ void idct16(const T* I, T* O) {
  T t0a = rs((I[0] + I[8]) * 11585);
  T t1a = rs((I[0] - I[8]) * 11585);
  T t2a = rs(I[4] * 6270 - I[12] * 15137);
  T t3a = rs(I[4] * 15137 + I[12] * 6270);
  T t4a = rs(I[2] * 3196 - I[14] * 16069);
  T t7a = rs(I[2] * 16069 + I[14] * 3196);
  T t5a = rs(I[10] * 13623 - I[6] * 9102);
  T t6a = rs(I[10] * 9102 + I[6] * 13623);
  T t8a = rs(I[1] * 1606 - I[15] * 16305);
  T t15a = rs(I[1] * 16305 + I[15] * 1606);
  T t9a = rs(I[9] * 12665 - I[7] * 10394);
  T t14a = rs(I[9] * 10394 + I[7] * 12665);
  T t10a = rs(I[5] * 7723 - I[11] * 14449);
  T t13a = rs(I[5] * 14449 + I[11] * 7723);
  T t11a = rs(I[13] * 15679 - I[3] * 4756);
  T t12a = rs(I[13] * 4756 + I[3] * 15679);
  T t0 = t0a + t3a;
  T t1 = t1a + t2a;
  T t2 = t1a - t2a;
  T t3 = t0a - t3a;
  T t4 = t4a + t5a;
  T t5 = t4a - t5a;
  T t6 = t7a - t6a;
  T t7 = t7a + t6a;
  T t8 = t8a + t9a;
  T t9 = t8a - t9a;
  T t10 = t11a - t10a;
  T t11 = t11a + t10a;
  T t12 = t12a + t13a;
  T t13 = t12a - t13a;
  T t14 = t15a - t14a;
  T t15 = t15a + t14a;
  t5a = rs((t6 - t5) * 11585);
  t6a = rs((t6 + t5) * 11585);
  t9a = rs(t14 * 6270 - t9 * 15137);
  t14a = rs(t14 * 15137 + t9 * 6270);
  t10a = rs((0u - (t13 * 15137 + t10 * 6270)));
  t13a = rs(t13 * 6270 - t10 * 15137);
  t0a = t0 + t7;
  t1a = t1 + t6a;
  t2a = t2 + t5a;
  t3a = t3 + t4;
  t4 = t3 - t4;
  t5 = t2 - t5a;
  t6 = t1 - t6a;
  t7 = t0 - t7;
  t8a = t8 + t11;
  t9 = t9a + t10a;
  t10 = t9a - t10a;
  t11a = t8 - t11;
  t12a = t15 - t12;
  t13 = t14a - t13a;
  t14 = t14a + t13a;
  t15a = t15 + t12;
  t10a = rs((t13 - t10) * 11585);
  t13a = rs((t13 + t10) * 11585);
  t11 = rs((t12a - t11a) * 11585);
  t12 = rs((t12a + t11a) * 11585);
  O[0] = t0a + t15a;
  O[1] = t1a + t14;
  O[2] = t2a + t13a;
  O[3] = t3a + t12;
  O[4] = t4 + t11;
  O[5] = t5 + t10a;
  O[6] = t6 + t9;
  O[7] = t7 + t8a;
  O[8] = t7 - t8a;
  O[9] = t6 - t9;
  O[10] = t5 - t10a;
  O[11] = t4 - t11;
  O[12] = t3a - t12;
  O[13] = t2a - t13a;
  O[14] = t1a - t14;
  O[15] = t0a - t15a;
}

template <typename T>
__device__ __forceinline__ void iadst16(const T* I, T* O) {
  T t0 = I[15] * 16364 + I[0] * 804;
  T t1 = I[15] * 804 - I[0] * 16364;
  T t2 = I[13] * 15893 + I[2] * 3981;
  T t3 = I[13] * 3981 - I[2] * 15893;
  T t4 = I[11] * 14811 + I[4] * 7005;
  T t5 = I[11] * 7005 - I[4] * 14811;
  T t6 = I[9] * 13160 + I[6] * 9760;
  T t7 = I[9] * 9760 - I[6] * 13160;
  T t8 = I[7] * 11003 + I[8] * 12140;
  T t9 = I[7] * 12140 - I[8] * 11003;
  T t10 = I[5] * 8423 + I[10] * 14053;
  T t11 = I[5] * 14053 - I[10] * 8423;
  T t12 = I[3] * 5520 + I[12] * 15426;
  T t13 = I[3] * 15426 - I[12] * 5520;
  T t14 = I[1] * 2404 + I[14] * 16207;
  T t15 = I[1] * 16207 - I[14] * 2404;
  T t0a = rs(t0 + t8);
  T t1a = rs(t1 + t9);
  T t2a = rs(t2 + t10);
  T t3a = rs(t3 + t11);
  T t4a = rs(t4 + t12);
  T t5a = rs(t5 + t13);
  T t6a = rs(t6 + t14);
  T t7a = rs(t7 + t15);
  T t8a = rs(t0 - t8);
  T t9a = rs(t1 - t9);
  T t10a = rs(t2 - t10);
  T t11a = rs(t3 - t11);
  T t12a = rs(t4 - t12);
  T t13a = rs(t5 - t13);
  T t14a = rs(t6 - t14);
  T t15a = rs(t7 - t15);
  t8 = t8a * 16069 + t9a * 3196;
  t9 = t8a * 3196 - t9a * 16069;
  t10 = t10a * 9102 + t11a * 13623;
  t11 = t10a * 13623 - t11a * 9102;
  t12 = t13a * 16069 - t12a * 3196;
  t13 = t13a * 3196 + t12a * 16069;
  t14 = t15a * 9102 - t14a * 13623;
  t15 = t15a * 13623 + t14a * 9102;
  t0 = t0a + t4a;
  t1 = t1a + t5a;
  t2 = t2a + t6a;
  t3 = t3a + t7a;
  t4 = t0a - t4a;
  t5 = t1a - t5a;
  t6 = t2a - t6a;
  t7 = t3a - t7a;
  t8a = rs(t8 + t12);
  t9a = rs(t9 + t13);
  t10a = rs(t10 + t14);
  t11a = rs(t11 + t15);
  t12a = rs(t8 - t12);
  t13a = rs(t9 - t13);
  t14a = rs(t10 - t14);
  t15a = rs(t11 - t15);
  t4a = t4 * 15137 + t5 * 6270;
  t5a = t4 * 6270 - t5 * 15137;
  t6a = t7 * 15137 - t6 * 6270;
  t7a = t7 * 6270 + t6 * 15137;
  t12 = t12a * 15137 + t13a * 6270;
  t13 = t12a * 6270 - t13a * 15137;
  t14 = t15a * 15137 - t14a * 6270;
  t15 = t15a * 6270 + t14a * 15137;
  T o0 = t0 + t2;
  T o15 = (0u - (t1 + t3));
  t2a = t0 - t2;
  t3a = t1 - t3;
  T o3 = (0u - rs(t4a + t6a));
  T o12 = rs(t5a + t7a);
  t6 = rs(t4a - t6a);
  t7 = rs(t5a - t7a);
  T o1 = (0u - (t8a + t10a));
  T o14 = t9a + t11a;
  t10 = t8a - t10a;
  t11 = t9a - t11a;
  T o2 = rs(t12 + t14);
  T o13 = (0u - rs(t13 + t15));
  t14a = rs(t12 - t14);
  t15a = rs(t13 - t15);
  T o7 = rs((0u - (t2a + t3a)) * 11585);
  T o8 = rs((t2a - t3a) * 11585);
  T o4 = rs((t7 + t6) * 11585);
  T o11 = rs((t7 - t6) * 11585);
  T o6 = rs((t11 + t10) * 11585);
  T o9 = rs((t11 - t10) * 11585);
  T o5 = rs((0u - (t14a + t15a)) * 11585);
  T o10 = rs((t14a - t15a) * 11585);
  O[0] = o0;
  O[1] = o1;
  O[2] = o2;
  O[3] = o3;
  O[4] = o4;
  O[5] = o5;
  O[6] = o6;
  O[7] = o7;
  O[8] = o8;
  O[9] = o9;
  O[10] = o10;
  O[11] = o11;
  O[12] = o12;
  O[13] = o13;
  O[14] = o14;
  O[15] = o15;
}

// The odd half of idct32: I holds its odd inputs (I[k] is input 2k +
// 1), D gets Y[0..15], with which idct32's outputs are O[k] = E[k] +
// Y[k] and O[31 - k] = E[k] - Y[k] for k < 16, E being idct16 of the
// even inputs. These are the odd-input lines of ops/itxfm.py's
// idct32_1d, which uses no even value before that last step.
template <typename T>
__device__ __forceinline__ void idct32_odd(const T* I, T* D) {
  T t16a = rs(I[0] * 804 - I[15] * 16364);
  T t31a = rs(I[0] * 16364 + I[15] * 804);
  T t17a = rs(I[8] * 12140 - I[7] * 11003);
  T t30a = rs(I[8] * 11003 + I[7] * 12140);
  T t18a = rs(I[4] * 7005 - I[11] * 14811);
  T t29a = rs(I[4] * 14811 + I[11] * 7005);
  T t19a = rs(I[12] * 15426 - I[3] * 5520);
  T t28a = rs(I[12] * 5520 + I[3] * 15426);
  T t20a = rs(I[2] * 3981 - I[13] * 15893);
  T t27a = rs(I[2] * 15893 + I[13] * 3981);
  T t21a = rs(I[10] * 14053 - I[5] * 8423);
  T t26a = rs(I[10] * 8423 + I[5] * 14053);
  T t22a = rs(I[6] * 9760 - I[9] * 13160);
  T t25a = rs(I[6] * 13160 + I[9] * 9760);
  T t23a = rs(I[14] * 16207 - I[1] * 2404);
  T t24a = rs(I[14] * 2404 + I[1] * 16207);
  T t16 = t16a + t17a;
  T t17 = t16a - t17a;
  T t18 = t19a - t18a;
  T t19 = t19a + t18a;
  T t20 = t20a + t21a;
  T t21 = t20a - t21a;
  T t22 = t23a - t22a;
  T t23 = t23a + t22a;
  T t24 = t24a + t25a;
  T t25 = t24a - t25a;
  T t26 = t27a - t26a;
  T t27 = t27a + t26a;
  T t28 = t28a + t29a;
  T t29 = t28a - t29a;
  T t30 = t31a - t30a;
  T t31 = t31a + t30a;
  t17a = rs(t30 * 3196 - t17 * 16069);
  t30a = rs(t30 * 16069 + t17 * 3196);
  t18a = rs((0u - (t29 * 16069 + t18 * 3196)));
  t29a = rs(t29 * 3196 - t18 * 16069);
  t21a = rs(t26 * 13623 - t21 * 9102);
  t26a = rs(t26 * 9102 + t21 * 13623);
  t22a = rs((0u - (t25 * 9102 + t22 * 13623)));
  t25a = rs(t25 * 13623 - t22 * 9102);
  t16a = t16 + t19;
  t17 = t17a + t18a;
  t18 = t17a - t18a;
  t19a = t16 - t19;
  t20a = t23 - t20;
  t21 = t22a - t21a;
  t22 = t22a + t21a;
  t23a = t23 + t20;
  t24a = t24 + t27;
  t25 = t25a + t26a;
  t26 = t25a - t26a;
  t27a = t24 - t27;
  t28a = t31 - t28;
  t29 = t30a - t29a;
  t30 = t30a + t29a;
  t31a = t31 + t28;
  t18a = rs(t29 * 6270 - t18 * 15137);
  t29a = rs(t29 * 15137 + t18 * 6270);
  t19 = rs(t28a * 6270 - t19a * 15137);
  t28 = rs(t28a * 15137 + t19a * 6270);
  t20 = rs((0u - (t27a * 15137 + t20a * 6270)));
  t27 = rs(t27a * 6270 - t20a * 15137);
  t21a = rs((0u - (t26 * 15137 + t21 * 6270)));
  t26a = rs(t26 * 6270 - t21 * 15137);
  t16 = t16a + t23a;
  t17a = t17 + t22;
  t18 = t18a + t21a;
  t19a = t19 + t20;
  t20a = t19 - t20;
  t21 = t18a - t21a;
  t22a = t17 - t22;
  t23 = t16a - t23a;
  t24 = t31a - t24a;
  t25a = t30 - t25;
  t26 = t29a - t26a;
  t27a = t28 - t27;
  t28a = t28 + t27;
  t29 = t29a + t26a;
  t30a = t30 + t25;
  t31 = t31a + t24a;
  t20 = rs((t27a - t20a) * 11585);
  t27 = rs((t27a + t20a) * 11585);
  t21a = rs((t26 - t21) * 11585);
  t26a = rs((t26 + t21) * 11585);
  t22 = rs((t25a - t22a) * 11585);
  t25 = rs((t25a + t22a) * 11585);
  t23a = rs((t24 - t23) * 11585);
  t24a = rs((t24 + t23) * 11585);
  D[0] = t31;
  D[1] = t30a;
  D[2] = t29;
  D[3] = t28a;
  D[4] = t27;
  D[5] = t26a;
  D[6] = t25;
  D[7] = t24a;
  D[8] = t23a;
  D[9] = t22;
  D[10] = t21a;
  D[11] = t20;
  D[12] = t19a;
  D[13] = t18;
  D[14] = t17a;
  D[15] = t16;
}

// iwht4_1d: inputs read as (0, 3, 1, 2), >> 2 in the first pass
template <typename T>
__device__ __forceinline__ void iwht4(const T* X, T* O, bool first) {
  T i0 = X[0], i1 = X[3], i2 = X[1], i3 = X[2];
  if (first) {
    i0 = asr(i0, 2);
    i1 = asr(i1, 2);
    i2 = asr(i2, 2);
    i3 = asr(i3, 2);
  }
  T t0 = i0 + i2;
  T t3 = i3 - i1;
  const T t4 = asr(t0 - t3, 1);
  const T t1 = t4 - i1;
  const T t2 = t4 - i2;
  t0 = t0 - t1;
  t3 = t3 + t2;
  O[0] = t0;
  O[1] = t1;
  O[2] = t2;
  O[3] = t3;
}

// One 1-D pass of size 4 << TX (TX < 3): DCT or ADST (the WHT when WHT).
template <int TX, bool WHT, typename T>
__device__ __forceinline__ void pass1d(const T* I, T* O, bool adst,
                                       bool first) {
  if constexpr (WHT) {
    iwht4(I, O, first);
  } else if constexpr (TX == 0) {
    if (adst) iadst4(I, O); else idct4(I, O);
  } else if constexpr (TX == 1) {
    if (adst) iadst8(I, O); else idct8(I, O);
  } else {
    if (adst) iadst16(I, O); else idct16(I, O);
  }
}

__device__ __forceinline__ int ld_grid(const void* p, int esz, size_t i) {
  if (esz == 1) return static_cast<const int8_t*>(p)[i];
  if (esz == 2) return static_cast<const int16_t*>(p)[i];
  return static_cast<const int32_t*>(p)[i];
}

constexpr int kMaxPlanes = 3;
constexpr int kThreads = 256;
constexpr int kRegion = 32;
constexpr int kRegionCells = kRegion / 4;   // cells a side of a region

struct Plane {
  const void* coef;     // [H, W] int16 (coef16) or int32
  const void* eob;      // [H/4, W/4], 1/2/4-byte signed integers
  const void* txsz;
  const void* txtype;
  int32_t* out;         // [H, W] int32
  int* strays;          // consuming: set to 1 on an untransformed eob cell
  int coef16, eob_sz, txsz_sz, txtype_sz;
  int H, W;
  int regions_x;        // regions a row
  int region0;          // the plane's first block in the grid
};

struct Args {
  Plane p[kMaxPlanes];
  int n;
  int lossless;
  int consume;          // clear the eob cells and coefficients read
};

// A region's 64 cells, as its first two warps read them; consuming, nz
// flags each 4-pixel quad of coefficients that the launch read nonzero
// (or that holds a DC-only root's DC).
struct Cells {
  int eob[kRegionCells * kRegionCells];
  int tx[kRegionCells * kRegionCells];
  int type[kRegionCells * kRegionCells];
  unsigned char nz[kRegion][kRegion / 4];
};

// The butterflies' word at 10/12 bpp (dctint): float64, exact (f64)
using Word = f64;
// The 10/12-bit kernel's threads a block (a region) and its
// __launch_bounds__ minimum of blocks an SM
constexpr int kHbdThreads = 128;
constexpr int kHbdMinBlocks = 10;

// The 1-D kernels, in the order of kPeakBits' columns
enum { kIdct4, kIadst4, kIdct8, kIadst8, kIdct16, kIadst16, kIdct32, kIwht4,
       kKernels };

// kPeakBits[pass][kernel]: the bits of the largest magnitude any
// intermediate or output of the kernel's butterflies (ops/itxfm.py, line by
// line) can reach on int32 inputs (pass 0 reads the coefficients, pass 1
// the first pass's int32 outputs; only iwht4 differs, its first pass
// shifting its inputs right by 2), by interval arithmetic over those lines;
// the port's tests derive it and hold this table to it. Every entry is
// below 51, where f64 is exact (its header).
constexpr int kPeakBits[2][kKernels] = {{46, 48, 47, 49, 49, 50, 50, 32},
                                        {46, 48, 47, 49, 49, 50, 50, 34}};
constexpr bool peaks_fit_f64() {
  for (int p = 0; p < 2; ++p)
    for (int k = 0; k < kKernels; ++k)
      if (kPeakBits[p][k] > 50) return false;
  return true;
}
static_assert(peaks_fit_f64(), "a kernel's values outgrow the f64 word");

// A coefficient, sign-extended: int16 (coef16) or int32 at 8 bpp, int32
// at 10/12 bpp (HBD)
template <bool HBD>
__device__ __forceinline__ int32_t ld_coef(const Plane& p, int y, int x) {
  const size_t i = static_cast<size_t>(y) * p.W + x;
  if (!HBD && p.coef16) return static_cast<const int16_t*>(p.coef)[i];
  return static_cast<const int32_t*>(p.coef)[i];
}

// The dctcoef store of a pass's output from its low 32 bits v: _wrap16 at
// 8 bpp, _wrap32 (v itself) at 10/12 bpp
template <bool HBD>
__device__ __forceinline__ int32_t wrapc(int32_t v) {
  return HBD ? v : wrap16(static_cast<u32>(v));
}

// The final rounding of a pass-b output v (its dctcoef value, or the DC
// shortcut's): (int)(v + (1U << (SHIFT - 1))) >> SHIFT, as the
// reference's itxfm wrapper computes it
template <int SHIFT>
__device__ __forceinline__ int32_t round_out(int32_t v) {
  constexpr u32 RND = SHIFT ? 1u << (SHIFT - 1) : 0u;
  return static_cast<int32_t>(static_cast<u32>(v) + RND) >> SHIFT;
}

// Half `half` of a 32-point DCT by a pair of neighbouring lanes, on word
// T: lane half 0 takes the even inputs x (idct16), lane half 1 the odd
// ones (idct32_odd); one exchange of the low 32 bits of their 16 values
// (the outputs keep only theirs) gives lane 0 outputs 0-15 and lane 1
// outputs 31 down to 16: y[j] is output j for lane 0 and output 31 - j
// for lane 1. Both lanes of every pair of a warp call it.
template <typename T>
__device__ __forceinline__ void idct32_pair(const int32_t* x, int32_t* y,
                                            int half) {
  T in[16], mine[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) in[k] = word<T>(x[k]);
  if (half) idct32_odd(in, mine); else idct16(in, mine);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const u32 m = static_cast<u32>(lo32(mine[j]));
    const u32 o = __shfl_xor_sync(0xffffffffu, m, 1);
    y[j] = static_cast<int32_t>(half ? o - m : m + o);
  }
}

// One 1-D pass of size 4 << TX (the WHT when WHT; at 32x32 half of a lane
// pair's) on word T: int32 inputs x, the low 32 bits of its outputs into y
template <int TX, bool WHT, typename T>
__device__ __forceinline__ void run1d(const int32_t* x, int32_t* y,
                                      bool adst, bool first, int half) {
  if constexpr (TX == 3) {
    idct32_pair<T>(x, y, half);
  } else {
    constexpr int SZ = 4 << TX;
    T in[SZ], o[SZ];
#pragma unroll
    for (int k = 0; k < SZ; ++k) in[k] = word<T>(x[k]);
    pass1d<TX, WHT>(in, o, adst, first);
#pragma unroll
    for (int k = 0; k < SZ; ++k) y[k] = lo32(o[k]);
  }
}

// The DC shortcut on a DC-only root's coefficient, its _rs chain on word D
// (u32 at 8 bpp, u64 at 10/12): |t| < 2^31 however wide the coefficient,
// so its low 32 bits
template <int SHIFT, typename D>
__device__ __forceinline__ int32_t dc_out(int32_t dc) {
  const D t = rs(rs(word<D>(dc) * 11585u) * 11585u);
  return round_out<SHIFT>(lo32(t));
}

// A work item of region_size: line `line` (half `half` of it at 32x32) of
// the root at (ry, rx) of the region, and what the root's cell says
struct Item {
  int line, half, ry, rx;
  bool act, dconly, adst_a, adst_b;
};

// Work item i of the blocks of size 4 << TX in the region at (ry0, rx0)
// (region_size)
template <int TX, bool WHT>
__device__ __forceinline__ Item item_of(const Plane& p, const Cells& cl,
                                        int ry0, int rx0, int i) {
  constexpr int SZ = 4 << TX;
  constexpr int NR = kRegion / SZ;
  constexpr bool PAIR = TX == 3;
  constexpr int ITEMS = PAIR ? 2 * SZ : NR * NR * SZ;
  Item w;
  const int root = PAIR ? i / (2 * SZ) : i / SZ;
  w.line = PAIR ? (i >> 1) % SZ : i % SZ;
  w.half = PAIR ? i & 1 : 0;
  w.ry = (root / NR) * SZ;
  w.rx = (root % NR) * SZ;
  w.act = w.dconly = w.adst_a = w.adst_b = false;
  if (i < ITEMS && ry0 + w.ry + SZ <= p.H && rx0 + w.rx + SZ <= p.W) {
    const int c = (w.ry >> 2) * kRegionCells + (w.rx >> 2);
    w.act = cl.tx[c] == TX && cl.eob[c] > 0;
    if (!WHT) {
      w.dconly = cl.eob[c] == 1 && (TX == 3 || cl.type[c] == 0);
      w.adst_a = TX < 3 && (cl.type[c] == 1 || cl.type[c] == 3);
      w.adst_b = TX < 3 && (cl.type[c] == 2 || cl.type[c] == 3);
    }
  }
  return w;
}

// The blocks of size 4 << TX in the region at (ry0, rx0), whose roots the
// vote found. Work item i takes line i % SZ of root i / SZ ((32 / SZ)^2
// roots, 1024 / SZ lines); at 32x32 the one root's 32 lines take two
// lanes each (idct32_pair), 64 items. The block's threads take the items
// in rounds: at 8 bpp its kThreads every size in one, at 10/12 bpp its
// kHbdThreads 4x4's 256 in two. Pass a runs only when some root of the
// size is not DC-only (`full`), with its barrier. The butterflies run on
// u32 words at 8 bpp and on Word (dctint) at 10/12 (HBD).
template <int TX, bool WHT, bool HBD>
__device__ __forceinline__ void region_size(const Plane& p, Cells& cl,
                                            int ry0, int rx0, bool full,
                                            int consume,
                                            int32_t (*tmp)[kRegion + 1],
                                            int32_t (*acc)[kRegion + 1]) {
  using T = std::conditional_t<HBD, Word, u32>;
  using D = std::conditional_t<HBD, u64, u32>;
  constexpr int NT = HBD ? kHbdThreads : kThreads;
  constexpr int SZ = 4 << TX;
  constexpr int NR = kRegion / SZ;
  constexpr int SHIFT = WHT ? 0 : (TX == 0 ? 4 : (TX == 1 ? 5 : 6));
  constexpr bool PAIR = TX == 3;
  constexpr int NIN = PAIR ? SZ / 2 : SZ;   // inputs a thread holds
  constexpr int ITEMS = PAIR ? 2 * SZ : NR * NR * SZ;
  constexpr int ROUNDS = (ITEMS + NT - 1) / NT;
  const int tid = threadIdx.x;
  Item it[ROUNDS];
#pragma unroll
  for (int rd = 0; rd < ROUNDS; ++rd)
    it[rd] = item_of<TX, WHT>(p, cl, ry0, rx0, rd * NT + tid);
  int32_t x[NIN], y[NIN];
  // pass a: column `line` of the coefficients -> row `line` of tmp
  if (full) {
#pragma unroll
    for (int rd = 0; rd < ROUNDS; ++rd) {
      const Item w = it[rd];
      if (w.act && !w.dconly) {
#pragma unroll
        for (int r = 0; r < NIN; ++r)
          x[r] = ld_coef<HBD>(p, ry0 + w.ry + (PAIR ? 2 * r + w.half : r),
                              rx0 + w.rx + w.line);
        if (consume) {   // after every load is issued
#pragma unroll
          for (int r = 0; r < NIN; ++r)
            if (x[r])
              cl.nz[w.ry + (PAIR ? 2 * r + w.half : r)]
                   [(w.rx + w.line) >> 2] = 1;
        }
        run1d<TX, WHT, T>(x, y, w.adst_a, true, w.half);
#pragma unroll
        for (int k = 0; k < NIN; ++k)
          tmp[w.ry + w.line][w.rx + (w.half ? SZ - 1 - k : k)] =
              wrapc<HBD>(y[k]);
      }
    }
    __syncthreads();
  }
  // pass b: column `line` of tmp -> column `line` of the residual
#pragma unroll
  for (int rd = 0; rd < ROUNDS; ++rd) {
    const Item w = it[rd];
    if (w.act && !w.dconly) {
#pragma unroll
      for (int c = 0; c < NIN; ++c)
        x[c] = tmp[w.ry + (PAIR ? 2 * c + w.half : c)][w.rx + w.line];
      run1d<TX, WHT, T>(x, y, w.adst_b, false, w.half);
    }
    // then the residual (this order keeps both kernels at 48 registers)
    if (w.act) {
      if (w.dconly) {
        if (consume && w.line == 0 && w.half == 0)
          cl.nz[w.ry][w.rx >> 2] = 1;
        const int32_t v =
            dc_out<SHIFT, D>(ld_coef<HBD>(p, ry0 + w.ry, rx0 + w.rx));
#pragma unroll
        for (int c = 0; c < NIN; ++c)
          acc[w.ry + c + w.half * NIN][w.rx + w.line] += v;
      } else {
#pragma unroll
        for (int k = 0; k < NIN; ++k)
          acc[w.ry + (w.half ? SZ - 1 - k : k)][w.rx + w.line] +=
              round_out<SHIFT>(wrapc<HBD>(y[k]));
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void st_grid_zero(const void* p, int esz,
                                             size_t i) {
  void* q = const_cast<void*>(p);
  if (esz == 1) static_cast<int8_t*>(q)[i] = 0;
  else if (esz == 2) static_cast<int16_t*>(q)[i] = 0;
  else static_cast<int32_t*>(q)[i] = 0;
}

// The vote's bits: size t present at bit t, some root of size t not
// DC-only at bit 4 + t. Consuming, a nonzero eob cell is cleared here,
// and one that is no transformed root counts as a stray.
__device__ __forceinline__ unsigned cell_vote(const Plane& p, Cells& cl,
                                              int ry0, int rx0, int lossless,
                                              int consume, int c) {
  const int cy = c / kRegionCells, cx = c % kRegionCells;
  const int gy = ry0 + 4 * cy, gx = rx0 + 4 * cx;
  int eob = 0, tx = -1, typ = 0;
  if (gy < p.H && gx < p.W) {
    const size_t g = static_cast<size_t>(gy >> 2) * (p.W >> 2) + (gx >> 2);
    eob = ld_grid(p.eob, p.eob_sz, g);
    tx = ld_grid(p.txsz, p.txsz_sz, g);
    typ = ld_grid(p.txtype, p.txtype_sz, g);
    if (consume && eob) st_grid_zero(p.eob, p.eob_sz, g);
  }
  cl.eob[c] = eob;
  cl.tx[c] = tx;
  cl.type[c] = typ;
  bool root = eob > 0 && tx >= 0 && tx <= (lossless ? 0 : 3);
  const int k = root ? 1 << tx : 1;
  root = root && !(cy % k || cx % k || gy + 4 * k > p.H || gx + 4 * k > p.W);
  if (!root) {
    if (consume && eob) *p.strays = 1;
    return 0;
  }
  const bool dconly = !lossless && eob == 1 && (tx == 3 || typ == 0);
  return (1u << tx) | (dconly ? 0u : 16u << tx);
}

// Consuming: the quad (oy, ox..ox+3) of the region's coefficients
// reads 0 from here on where the launch read a nonzero in it (pass a
// reads every coefficient of a root that is not DC-only) or where it
// holds a DC-only root's DC; the flags say which (Cells::nz).
__device__ __forceinline__ void clear_quad(const Plane& p, const Cells& cl,
                                           int ry0, int rx0, int oy, int ox) {
  const int y = ry0 + oy, x = rx0 + ox;
  if (!cl.nz[oy][ox >> 2] || y >= p.H || x >= p.W) return;
  const size_t i = static_cast<size_t>(y) * p.W + x;
  void* c = const_cast<void*>(p.coef);
  if (p.coef16)
    *reinterpret_cast<uint2*>(static_cast<int16_t*>(c) + i) = make_uint2(0, 0);
  else
    *reinterpret_cast<int4*>(static_cast<int32_t*>(c) + i) =
        make_int4(0, 0, 0, 0);
}

template <bool HBD>
__device__ __forceinline__ void residual_region(const Args& a) {
  __shared__ int32_t tmp[kRegion][kRegion + 1];
  __shared__ int32_t acc[kRegion][kRegion + 1];
  __shared__ Cells cl;
  __shared__ unsigned votes[2];
  int pi = 0;
  while (pi + 1 < a.n && static_cast<int>(blockIdx.x) >= a.p[pi + 1].region0)
    ++pi;
  const Plane& p = a.p[pi];
  const int region = blockIdx.x - p.region0;
  const int ry0 = (region / p.regions_x) * kRegion;
  const int rx0 = (region % p.regions_x) * kRegion;
  const int tid = threadIdx.x;
  // a thread owns QUADS quads of 4 neighbouring pixels of the region (an
  // int4 store each): quad tid + NT q, at (oy, ox)
  constexpr int NT = HBD ? kHbdThreads : kThreads;
  constexpr int QUADS = kRegion * kRegion / 4 / NT;
  static_assert(QUADS * NT == kRegion * kRegion / 4 &&
                NT >= kRegionCells * kRegionCells, "threads a region");
  const auto quad = [&](int q, int& oy, int& ox) {
    oy = (tid + NT * q) / (kRegion / 4);
    ox = ((tid + NT * q) % (kRegion / 4)) * 4;
  };
  if (tid < kRegionCells * kRegionCells) {
    const unsigned v = __reduce_or_sync(
        0xffffffffu, cell_vote(p, cl, ry0, rx0, a.lossless, a.consume, tid));
    if ((tid & 31) == 0) votes[tid >> 5] = v;
  }
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    int oy, ox;
    quad(q, oy, ox);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[oy][ox + k] = 0;
    cl.nz[oy][ox >> 2] = 0;
  }
  __syncthreads();
  const unsigned vote = votes[0] | votes[1];
  if (vote) {
    if (a.lossless) {
      region_size<0, true, HBD>(p, cl, ry0, rx0, true, a.consume, tmp,
                                acc);
    } else {
      if (vote & 1u)
        region_size<0, false, HBD>(p, cl, ry0, rx0, vote & 16u,
                                   a.consume, tmp, acc);
      if (vote & 2u)
        region_size<1, false, HBD>(p, cl, ry0, rx0, vote & 32u,
                                   a.consume, tmp, acc);
      if (vote & 4u)
        region_size<2, false, HBD>(p, cl, ry0, rx0, vote & 64u,
                                   a.consume, tmp, acc);
      if (vote & 8u)
        region_size<3, false, HBD>(p, cl, ry0, rx0, vote & 128u,
                                   a.consume, tmp, acc);
    }
    if (a.consume) {
#pragma unroll
      for (int q = 0; q < QUADS; ++q) {
        int oy, ox;
        quad(q, oy, ox);
        clear_quad(p, cl, ry0, rx0, oy, ox);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    int oy, ox;
    quad(q, oy, ox);
    const int y = ry0 + oy, x = rx0 + ox;
    if (y < p.H && x < p.W)
      *reinterpret_cast<int4*>(p.out + static_cast<size_t>(y) * p.W + x) =
          make_int4(acc[oy][ox], acc[oy][ox + 1], acc[oy][ox + 2],
                    acc[oy][ox + 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
    residual_kernel(const __grid_constant__ Args a) {
  residual_region<false>(a);
}

__global__ void __launch_bounds__(kHbdThreads, kHbdMinBlocks)
    residual_kernel_hbd(const __grid_constant__ Args a) {
  residual_region<true>(a);
}

// The coefficient and eob scatter: a thread per row of cp, then of ep.
// Position (pos-hi << 16) | (pos-lo & 0xffff); rows whose position is
// negative (pad rows) or past the buffer are dropped.
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int16_t* __restrict__ cp, int ncp, int wide,
                   const int16_t* __restrict__ ep, int nep, void* flat_c,
                   int nc, int16_t* __restrict__ flat_e, int ne) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const auto pos_of = [](const int16_t* r) {
    return static_cast<int32_t>(
        (static_cast<uint32_t>(static_cast<int32_t>(r[0])) << 16) |
        static_cast<uint16_t>(r[1]));
  };
  if (i < ncp) {
    const int16_t* r = cp + static_cast<size_t>(i) * (wide ? 4 : 3);
    const int32_t pos = pos_of(r);
    if (pos < 0 || pos >= nc) return;
    if (wide)
      static_cast<int32_t*>(flat_c)[pos] = static_cast<int32_t>(
          (static_cast<uint32_t>(static_cast<int32_t>(r[2])) << 16) |
          static_cast<uint16_t>(r[3]));
    else
      static_cast<int16_t*>(flat_c)[pos] = r[2];
  } else if (i - ncp < nep) {
    const int16_t* r = ep + static_cast<size_t>(i - ncp) * 3;
    const int32_t pos = pos_of(r);
    if (pos >= 0 && pos < ne) flat_e[pos] = r[2];
  }
}

// residual_planes and residual_planes_hbd: hbd selects the 10/12-bit
// kernel (dctint on Word, int32 coefficients)
int launch_residual(const void* const* ptrs, const int* dims, int n,
                    int lossless, int* const* strays, bool hbd,
                    cudaStream_t stream) {
  const auto esz_ok = [](int s) { return s == 1 || s == 2 || s == 4; };
  if (n < 1 || n > kMaxPlanes || !ptrs || !dims)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.n = n;
  a.lossless = lossless != 0;
  a.consume = strays != nullptr;
  int regions = 0;
  for (int i = 0; i < n; ++i) {
    const void* const* q = ptrs + 5 * i;
    const int* d = dims + 6 * i;
    Plane& p = a.p[i];
    p.coef = q[0];
    p.eob = q[1];
    p.txsz = q[2];
    p.txtype = q[3];
    p.out = static_cast<int32_t*>(const_cast<void*>(q[4]));
    p.strays = strays ? strays[i] : nullptr;
    p.H = d[0];
    p.W = d[1];
    p.coef16 = d[2] != 0;
    p.eob_sz = d[3];
    p.txsz_sz = d[4];
    p.txtype_sz = d[5];
    if (p.H <= 0 || p.W <= 0 || p.H % 4 || p.W % 4 ||
        (!lossless && (p.H % kRegion || p.W % kRegion)) ||
        !esz_ok(p.eob_sz) || !esz_ok(p.txsz_sz) || !esz_ok(p.txtype_sz) ||
        (a.consume && !p.strays) || (hbd && p.coef16))
      return static_cast<int>(cudaErrorInvalidValue);
    p.regions_x = (p.W + kRegion - 1) / kRegion;
    p.region0 = regions;
    regions += p.regions_x * ((p.H + kRegion - 1) / kRegion);
  }
  if (hbd)
    residual_kernel_hbd<<<regions, kHbdThreads, 0, stream>>>(a);
  else
    residual_kernel<<<regions, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The residuals of n (1-3) 8-bit planes in one launch on `stream`. ptrs:
// 5 device pointers a plane: coef (int16 or int32 [H, W]), eob, txsz,
// txtype ([H/4, W/4] signed integers of 1, 2 or 4 bytes), out (int32
// [H, W]). dims: 6 ints a plane: H, W (multiples of 4, of 32 unless
// lossless), coef16, and the byte sizes of eob, txsz and txtype.
// strays: null, or a host array of n pointers to int flags that the
// device can write (pinned host memory); then the launch consumes (see
// the header): it clears the eob cells and coefficients it reads and
// sets a plane's flag to 1 where it finds a stray.
int residual_planes(const void* const* ptrs, const int* dims, int n,
                    int lossless, int* const* strays, cudaStream_t stream) {
  return launch_residual(ptrs, dims, n, lossless, strays, false, stream);
}

// residual_planes for 10/12-bit planes: the butterflies of dctint (int64)
// on float64 words, exact (the header), the int32 wrap between passes;
// coef must be int32 (coef16 0).
int residual_planes_hbd(const void* const* ptrs, const int* dims, int n,
                        int lossless, int* const* strays,
                        cudaStream_t stream) {
  return launch_residual(ptrs, dims, n, lossless, strays, true, stream);
}

// The dense coefficient and eob buffers of pair rows, on `stream`: with
// zero_fill both are zero-filled first (a memset pair), else they must
// read zero already (a consuming residual_planes left them so); then one
// launch scatters cp ([ncp, 3] int16 rows (pos-hi, pos-lo, value) into
// int16 flat_c, or [ncp, 4] rows (pos-hi, pos-lo, value-hi, value-lo)
// into int32 flat_c when cp_cols is 4) and ep ([nep, 3] int16 rows into
// int16 flat_e). nc and ne: the buffers' lengths.
int scatter_pairs(const int16_t* cp, int ncp, int cp_cols, const int16_t* ep,
                  int nep, void* flat_c, int nc, int16_t* flat_e, int ne,
                  int zero_fill, cudaStream_t stream) {
  if (ncp < 0 || nep < 0 || nc < 0 || ne < 0 || (cp_cols != 3 && cp_cols != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int wide = cp_cols == 4;
  if (zero_fill) {
    cudaError_t err = cudaMemsetAsync(
        flat_c, 0, static_cast<size_t>(nc) * (wide ? 4 : 2), stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(flat_e, 0, static_cast<size_t>(ne) * 2, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rows = static_cast<long long>(ncp) + nep;
  if (rows)
    scatter_kernel<<<static_cast<unsigned>((rows + kThreads - 1) / kThreads),
                     kThreads, 0, stream>>>(cp, ncp, wide, ep, nep, flat_c, nc,
                                            flat_e, ne);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
