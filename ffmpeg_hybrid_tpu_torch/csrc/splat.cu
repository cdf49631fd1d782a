// The block-record splat for Hopper (sm_90a): a frame's compact block
// records become the dense per-4x4-cell grids that pass B reads. The
// CUDA counterpart of the JAX package's _grids_from_records, with
// _rdiv2_jnp/_rdiv4_jnp (ffmpeg_hybrid_tpu/ops/recon_tpu.py:863-997), an
// XLA program there, not a Pallas kernel; the port's plain version is
// ops/recon.py:_grids_from_records_plain.
//
//   splat  the 14 grids of one frame: a memset and two launches
//
// Semantics. recs is [N, 36] int16, one row per leaf block: row, col
// (8 px units), tile, bs, seg, skip, intra, tx, uvtx, four modes, uv
// mode, comp, ref[2], filter, then mv[4 quadrants][2 refs][x, y]. A row
// with bs < 0 is a pad row and covers nothing; the last row is always
// one. A record covers the h4 x w4 cells (4 px) of its block, at most
// 16 a side, from (row * 2, col * 2); cells at or past r4/c4 are
// dropped. Each cell takes the highest record index that covers it;
// a cell no record covers reads the last row (JAX's recs[-1]).
//
// Y cell (i, j) of record b: inter4 = !intra && bs >= 0, txsz4 = tx,
// txtype4 = INTRA_TXFM_TYPE[clip(mode[q'], 0, 13)] for intra cells and
// 0 otherwise, comp4 = comp && inter4, filter4, refsel = (clip(ref0,
// 0, 2), clip(comp4 ? ref1 : 0, 0, 2)), mv16 = mv[q''], where q =
// ((i - row*2) & 1) * 2 + ((j - col*2) & 1) is the cell's quadrant in
// its record, q' = q for sub-8x8 blocks (bs > 9) with tx 0, else 0, and
// q'' = q for sub-8x8 blocks, else 0.
// Chroma cell (i, j) reads the record of luma cell (i << ss_v, j <<
// ss_h): its uvtx, the same inter/comp/filter/refsel rules, txtype 0,
// and its MV pair from the record's 2x2 table of chroma MVs (the
// sub-8x8 averaging of vp9_mc_template.c:24-230 with libvpx's 4:2:2
// bug; averages round half away from zero) at (clip(i - (row*2 >>
// ss_v), 0, 1), clip(j - (col*2 >> ss_h), 0, 1)).
//
// Design. (a) The index pass: cudaMemsetAsync sets the [r4 * c4] int32
// index grid to -1, then a warp per record walks its cells, a lane per
// cell, with atomicMax of the record index (leaves do not overlap, so
// the atomics do not collide; max keeps JAX's .at[].max on records
// that would). (b) The gather pass: a thread per luma cell and a
// thread per chroma cell, in one launch; each reads its cell's record
// index, the few int16 fields it needs of that record (neighbouring
// cells share a record, so most reads hit L1), computes its fields in
// registers and writes each grid once (int4 for an MV quad, int2 for
// a refsel pair). The tables (block sizes, intra transform types) come
// from the port's tables.py by value in the kernel's parameters.
//
// What bounds it. Bytes: at 1080p the 14 grids are about 7 MB (some 38
// B per luma cell over 130,560 cells, plus the chroma quarter) and the
// records a few hundred KB, about 2.4 us at 3.35 TB/s. There is no
// arithmetic to speak of, so the kernel is memory-bound: each output
// byte is written once, by coalesced stores, and the index grid is the
// only intermediate that goes through memory (0.5 MB, in L2).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRecLen = 36;
constexpr int kNumBs = 13;
constexpr int kNumModes = 14;
constexpr int kMaxCells = 16;  // cells a side of the largest block
constexpr int kThreads = 256;

// record fields
enum { kRow = 0, kCol = 1, kBs = 3, kIntra = 6, kTx = 7, kUvTx = 8,
       kMode = 9, kComp = 14, kRef0 = 15, kRef1 = 16, kFilter = 17,
       kMv = 18 };

struct Tables {
  int bwh[kNumBs][2];  // BWH_TAB[1]: block width, height (8 px units)
  int itt[kNumModes];  // INTRA_TXFM_TYPE by intra mode
};

// the 14 outputs, in _grids_from_records' order; bool grids are bytes
struct Grids {
  uint8_t* inter4;
  int32_t* txsz4;
  int32_t* txtype4;
  uint8_t* comp4;
  int32_t* filter4;
  int32_t* refsel;     // [r4, c4, 2]
  int32_t* mv16;       // [r4, c4, 2, 2]
  uint8_t* inter4uv;
  int32_t* uvtx4;
  int32_t* txtypeuv;   // zeros
  uint8_t* comp_uv;
  int32_t* filt_uv;
  int32_t* refsel_uv;  // [r4u, c4u, 2]
  int32_t* uvmv;       // [r4u, c4u, 2, 2]
};

__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// ROUNDED_DIV by 2 and 4, half away from zero (C's / truncates, so
// the negative side negates around it, as _rdiv2/_rdiv4 do)
__device__ __forceinline__ int rdiv2(int s) {
  return s >= 0 ? (s + 1) / 2 : -((-s + 1) / 2);
}
__device__ __forceinline__ int rdiv4(int s) {
  return s >= 0 ? (s + 2) / 4 : -((-s + 2) / 4);
}

__global__ void __launch_bounds__(kThreads)
splat_index_kernel(const int16_t* __restrict__ recs, int N,
                   int32_t* __restrict__ bidx, int r4, int c4, Tables t) {
  const int b = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= N) return;
  const int16_t* rec = recs + static_cast<size_t>(b) * kRecLen;
  const int bs = rec[kBs];
  if (bs < 0) return;
  const int bsc = min(bs, kNumBs - 1);
  const int w4 = min(t.bwh[bsc][0] * 2, kMaxCells);
  const int h4 = min(t.bwh[bsc][1] * 2, kMaxCells);
  const int r0 = rec[kRow] * 2, c0 = rec[kCol] * 2;
  for (int k = lane; k < w4 * h4; k += 32) {
    const int y = r0 + k / w4, x = c0 + k % w4;
    if (y >= 0 && y < r4 && x >= 0 && x < c4)
      atomicMax(&bidx[y * c4 + x], b);
  }
}

// the record of a cell: its index, or the last row where none covers it
__device__ __forceinline__ const int16_t* cell_record(
    const int16_t* recs, int N, const int32_t* bidx, int cell) {
  int b = bidx[cell];
  if (b < 0) b = N - 1;
  return recs + static_cast<size_t>(b) * kRecLen;
}

// the chroma MV (x or y) at (udy, udx) of a record's 2x2 chroma cells,
// from the four quadrant MVs m0..m3 of one ref
__device__ int uv_mv(int bs, int m0, int m1, int m2, int m3, int udy,
                     int udx, int ss_h, int ss_v) {
  if (ss_v) {  // both rows alike
    if (udx == 0) {
      if (bs == 10) return rdiv2(m0 + m2);
      if (bs == 11) return ss_h ? rdiv2(m0 + m1) : m0;
      if (bs == 12) return ss_h ? rdiv4(m0 + m1 + m2 + m3) : rdiv2(m0 + m2);
      return m0;
    }
    if (bs == 10) return rdiv2(m0 + m2);
    if (bs == 11) return m1;
    if (bs == 12) return rdiv2(m1 + m3);
    return m0;
  }
  if (ss_h) {  // 4:2:2, both columns alike; BS_4x4's bottom is libvpx's
    if (udy == 0) {
      if (bs == 11 || bs == 12) return rdiv2(m0 + m1);
      return m0;
    }
    if (bs == 10) return rdiv2(m0 + m2);
    if (bs == 11) return rdiv2(m0 + m1);
    if (bs == 12) return rdiv2(m1 + m2);
    return m0;
  }
  if (udy == 0) {  // 4:4:4
    if (udx == 0) return m0;
    return (bs == 11 || bs == 12) ? m1 : m0;
  }
  if (udx == 0) return (bs == 10 || bs == 12) ? m2 : m0;
  if (bs == 10) return m2;
  if (bs == 11) return m1;
  if (bs == 12) return m3;
  return m0;
}

__global__ void __launch_bounds__(kThreads)
splat_gather_kernel(const int16_t* __restrict__ recs, int N,
                    const int32_t* __restrict__ bidx, int r4, int c4,
                    int ss_h, int ss_v, Tables t, Grids g) {
  int idx = blockIdx.x * kThreads + threadIdx.x;
  const int ny = r4 * c4;
  if (idx < ny) {
    const int i = idx / c4, j = idx - (idx / c4) * c4;
    const int16_t* rec = cell_record(recs, N, bidx, idx);
    const int bs = rec[kBs];
    const bool covered = bs >= 0;
    const bool intra = rec[kIntra] != 0 && covered;
    const bool inter = rec[kIntra] == 0 && covered;
    const int tx = rec[kTx];
    const int q = ((i - rec[kRow] * 2) & 1) * 2 + ((j - rec[kCol] * 2) & 1);
    const bool sub8 = bs > 9;
    const int mode = rec[kMode + ((sub8 && tx == 0) ? q : 0)];
    const bool comp = rec[kComp] != 0 && inter;
    g.inter4[idx] = inter;
    g.txsz4[idx] = tx;
    g.txtype4[idx] = intra ? t.itt[clip(mode, 0, kNumModes - 1)] : 0;
    g.comp4[idx] = comp;
    g.filter4[idx] = rec[kFilter];
    reinterpret_cast<int2*>(g.refsel)[idx] =
        make_int2(clip(rec[kRef0], 0, 2), clip(comp ? rec[kRef1] : 0, 0, 2));
    const int16_t* mv = rec + kMv + (sub8 ? q : 0) * 4;
    reinterpret_cast<int4*>(g.mv16)[idx] =
        make_int4(mv[0], mv[1], mv[2], mv[3]);
    return;
  }
  idx -= ny;
  const int c4u = c4 >> ss_h;
  if (idx >= (r4 >> ss_v) * c4u) return;
  const int i = idx / c4u, j = idx - (idx / c4u) * c4u;
  const int16_t* rec =
      cell_record(recs, N, bidx, (i << ss_v) * c4 + (j << ss_h));
  const int bs = rec[kBs];
  const bool inter = rec[kIntra] == 0 && bs >= 0;
  const bool comp = rec[kComp] != 0 && inter;
  g.inter4uv[idx] = inter;
  g.uvtx4[idx] = rec[kUvTx];
  g.txtypeuv[idx] = 0;
  g.comp_uv[idx] = comp;
  g.filt_uv[idx] = rec[kFilter];
  reinterpret_cast<int2*>(g.refsel_uv)[idx] =
      make_int2(clip(rec[kRef0], 0, 2), clip(comp ? rec[kRef1] : 0, 0, 2));
  const int udy = clip(i - ((rec[kRow] * 2) >> ss_v), 0, 1);
  const int udx = clip(j - ((rec[kCol] * 2) >> ss_h), 0, 1);
  int v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // (ref, xy)
    const int16_t* m = rec + kMv + c;
    v[c] = uv_mv(bs, m[0], m[4], m[8], m[12], udy, udx, ss_h, ss_v);
  }
  reinterpret_cast<int4*>(g.uvmv)[idx] = make_int4(v[0], v[1], v[2], v[3]);
}

}  // namespace

extern "C" {

// The 14 grids of one frame from its records recs [N, 36] int16 (the
// last row a pad row), on `stream`: the index grid bidx [r4 * c4] int32
// (scratch) is set to -1, the index pass and the gather pass follow.
// out: the 14 output pointers in _grids_from_records' order (bool
// grids as bytes; Y grids [r4, c4], chroma [r4 >> ss_v, c4 >> ss_h],
// with trailing dimensions 2 for the refsel pairs and 2 x 2 for the
// MVs). bwh: the 13 x 2 int32 block sizes (host); itt: the 14 int32
// intra transform types (host).
int splat(const int16_t* recs, int N, int32_t* bidx, void* inter4,
          void* txsz4, void* txtype4, void* comp4, void* filter4,
          void* refsel, void* mv16, void* inter4uv, void* uvtx4,
          void* txtypeuv, void* comp_uv, void* filt_uv, void* refsel_uv,
          void* uvmv, int r4, int c4, int ss_h, int ss_v, const int* bwh,
          const int* itt, cudaStream_t stream) {
  if (N < 1 || r4 < 1 || c4 < 1 || (ss_h | ss_v) & ~1 ||
      r4 % (1 << ss_v) || c4 % (1 << ss_h) || !bwh || !itt)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables t;
  for (int k = 0; k < kNumBs; ++k) {
    t.bwh[k][0] = bwh[2 * k];
    t.bwh[k][1] = bwh[2 * k + 1];
  }
  for (int k = 0; k < kNumModes; ++k) t.itt[k] = itt[k];
  Grids g{static_cast<uint8_t*>(inter4),   static_cast<int32_t*>(txsz4),
          static_cast<int32_t*>(txtype4),  static_cast<uint8_t*>(comp4),
          static_cast<int32_t*>(filter4),  static_cast<int32_t*>(refsel),
          static_cast<int32_t*>(mv16),     static_cast<uint8_t*>(inter4uv),
          static_cast<int32_t*>(uvtx4),    static_cast<int32_t*>(txtypeuv),
          static_cast<uint8_t*>(comp_uv),  static_cast<int32_t*>(filt_uv),
          static_cast<int32_t*>(refsel_uv), static_cast<int32_t*>(uvmv)};
  cudaError_t err = cudaMemsetAsync(
      bidx, 0xff, static_cast<size_t>(r4) * c4 * sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long index_threads = static_cast<long long>(N) * 32;
  splat_index_kernel<<<static_cast<unsigned>((index_threads + kThreads - 1) /
                                             kThreads),
                       kThreads, 0, stream>>>(recs, N, bidx, r4, c4, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cells = r4 * c4 + (r4 >> ss_v) * (c4 >> ss_h);
  splat_gather_kernel<<<(cells + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(recs, N, bidx, r4, c4, ss_h, ss_v, t, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
