// The block-record splat for Hopper (sm_90a): a frame's compact block
// records become the dense per-4x4-cell grids that pass B reads. The
// CUDA counterpart of the JAX package's _grids_from_records, with
// _rdiv2_jnp/_rdiv4_jnp (ffmpeg_hybrid_tpu/ops/recon_tpu.py:863-997), an
// XLA program there, not a Pallas kernel; the port's plain version is
// ops/recon.py:_grids_from_records_plain.
//
//   splat  the 14 grids of one frame: an index launch and a gather
//          launch that starts while the index launch runs
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
// Design. Records sit on the 8 px grid and cover whole 8x8 units, so
// the four cells of a unit share their record, and the index is kept a
// unit: a grid [r8 * c8] of 64-bit entries (epoch << 32) | b that lives
// on the device from frame to frame (the caller's state, zero at
// first). A frame takes a new epoch, and the index phase writes its
// units with atomicMax of (epoch << 32) | b, so a newer frame's entry
// beats any older one and the highest record index wins within a frame
// (JAX's .at[].max); the gather reads an entry of another epoch as no
// record (the last row). So the grid needs no clearing between frames:
// only a wrapped epoch clears it, on the host's side. (a) The index
// phase: the records are dealt to the blocks in turn, a group of kGroup
// lanes per record, so every SM raises its share of the units (an 8x8
// leaf is one unit, a 64x64 one 64). (b) The gather phase: a thread per
// luma cell and a thread per chroma cell; each reads its unit's entry,
// then, in one round trip, the whole 72-byte record as nine 8-byte
// loads issued together (neighbouring cells share a record, so most of
// them hit L1), computes its fields in registers and writes each grid
// once (int4 for an MV quad, int2 for a refsel pair). The gather is a
// second launch that Hopper's programmatic dependent launch starts
// while the index phase runs; it waits on it (griddepcontrol) before
// its first read, so the two launches cost one launch's latency and no
// memset. The tables (block sizes, intra transform types) come from the
// port's tables.py by value in the kernel's parameters.
//
// What bounds it. Bytes: at 1080p the 14 grids are about 7 MB (some 38
// B per luma cell over 130,560 cells, plus the chroma quarter) and the
// records a few hundred KB, about 2 us at 3.35 TB/s. There is no
// arithmetic to speak of, so the kernel is memory-bound: each output
// byte is written once, by coalesced stores, and the index grid is the
// only intermediate that goes through memory (0.26 MB, in L2).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRecLen = 36;
constexpr int kRecWords = kRecLen / 4;  // 8-byte words a record
constexpr int kNumBs = 13;
constexpr int kNumModes = 14;
constexpr int kMaxUnits = 8;   // 8x8 units a side of the largest block
constexpr int kThreads = 256;
constexpr int kGroup = 8;      // lanes a record in the index phase

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

struct Args {
  const int16_t* recs;
  int N;
  unsigned long long* bidx;  // [r8 * c8] (epoch << 32) | record
  unsigned epoch;
  int r4, c4, ss_h, ss_v;
  int r8, c8;  // rows and columns of 8x8 units: r4, c4 halved, rounded up
  Tables t;
  Grids g;
};

// int16 field f of a record from the 8-byte word that holds it (fields
// 4k..4k+3 are word k, little-endian)
__device__ __forceinline__ int field(unsigned long long w, int f) {
  return static_cast<int16_t>(static_cast<uint16_t>(w >> ((f & 3) * 16)));
}

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

// (a) this block's records, blockIdx.x + gridDim.x * (g + G * n) for
// its groups g of kGroup lanes (G of them): each unit (8x8) of a record
// in the frame takes (epoch << 32) | b by atomicMax, lane k the record's
// units k, k + kGroup, ... in row-major order
__device__ __forceinline__ void index_phase(const Args& a) {
  const int lane = threadIdx.x % kGroup;
  const int stride = gridDim.x * (kThreads / kGroup);
  const unsigned long long tag = static_cast<unsigned long long>(a.epoch)
                                 << 32;
  for (int b = blockIdx.x + gridDim.x * (threadIdx.x / kGroup); b < a.N;
       b += stride) {
    // fields 0-3 (row, col, tile, bs): the record's first word
    const unsigned long long w0 = __ldg(
        reinterpret_cast<const unsigned long long*>(a.recs) +
        static_cast<size_t>(b) * kRecWords);
    const int bs = field(w0, kBs);
    if (bs < 0) continue;
    const int bsc = min(bs, kNumBs - 1);
    const int row = field(w0, kRow), col = field(w0, kCol);
    const int y0 = max(row, 0),
              y1 = min(row + min(a.t.bwh[bsc][1], kMaxUnits), a.r8);
    const int x0 = max(col, 0),
              x1 = min(col + min(a.t.bwh[bsc][0], kMaxUnits), a.c8);
    const int nx = x1 - x0;
    if (y0 >= y1 || nx <= 0) continue;
    for (int k = lane; k < (y1 - y0) * nx; k += kGroup)
      atomicMax(a.bidx + (y0 + k / nx) * a.c8 + x0 + k % nx, tag | b);
  }
}

// the record of luma cell (i, j), all its fields at once: its unit's
// entry's, or the last row where no record of this epoch covers it.
// The entry is read from L2, where the index launch's atomics landed.
struct Rec {
  unsigned long long w[kRecWords];
  __device__ __forceinline__ int operator[](int f) const {
    return field(w[f >> 2], f);
  }
};

__device__ __forceinline__ Rec cell_record(const Args& a, int i, int j) {
  const unsigned long long e = __ldcg(a.bidx + (i >> 1) * a.c8 + (j >> 1));
  const int b = static_cast<unsigned>(e >> 32) == a.epoch
                    ? static_cast<int>(static_cast<unsigned>(e))
                    : a.N - 1;
  const unsigned long long* p =
      reinterpret_cast<const unsigned long long*>(a.recs) +
      static_cast<size_t>(b) * kRecWords;
  Rec r;
#pragma unroll
  for (int k = 0; k < kRecWords; ++k) r.w[k] = __ldg(p + k);
  return r;
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

// (b) one luma cell (idx < r4 * c4) or chroma cell
__device__ __forceinline__ void gather_cell(const Args& a, int idx) {
  const Grids& g = a.g;
  const int r4 = a.r4, c4 = a.c4, ss_h = a.ss_h, ss_v = a.ss_v;
  const int ny = r4 * c4;
  if (idx < ny) {
    const int i = idx / c4, j = idx - (idx / c4) * c4;
    const Rec rec = cell_record(a, i, j);
    const int bs = rec[kBs];
    const bool covered = bs >= 0;
    const bool intra = rec[kIntra] != 0 && covered;
    const bool inter = rec[kIntra] == 0 && covered;
    const int tx = rec[kTx];
    const int q = ((i - rec[kRow] * 2) & 1) * 2 + ((j - rec[kCol] * 2) & 1);
    const bool sub8 = bs > 9;
    const int qm = (sub8 && tx == 0) ? q : 0;
    const int mode = qm == 0 ? rec[kMode] : qm == 1 ? rec[kMode + 1]
                   : qm == 2 ? rec[kMode + 2] : rec[kMode + 3];
    const bool comp = rec[kComp] != 0 && inter;
    g.inter4[idx] = inter;
    g.txsz4[idx] = tx;
    g.txtype4[idx] = intra ? a.t.itt[clip(mode, 0, kNumModes - 1)] : 0;
    g.comp4[idx] = comp;
    g.filter4[idx] = rec[kFilter];
    reinterpret_cast<int2*>(g.refsel)[idx] =
        make_int2(clip(rec[kRef0], 0, 2), clip(comp ? rec[kRef1] : 0, 0, 2));
    // quadrant qv's four MV fields are word 4 + qv's last two and word
    // 5 + qv's first two
    const int qv = sub8 ? q : 0;
    const unsigned long long lo = qv == 0 ? rec.w[4] : qv == 1 ? rec.w[5]
                                : qv == 2 ? rec.w[6] : rec.w[7];
    const unsigned long long hi = qv == 0 ? rec.w[5] : qv == 1 ? rec.w[6]
                                : qv == 2 ? rec.w[7] : rec.w[8];
    reinterpret_cast<int4*>(g.mv16)[idx] =
        make_int4(field(lo, 2), field(lo, 3), field(hi, 0), field(hi, 1));
    return;
  }
  idx -= ny;
  const int c4u = c4 >> ss_h;
  const int i = idx / c4u, j = idx - (idx / c4u) * c4u;
  const Rec rec = cell_record(a, i << ss_v, j << ss_h);
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
  for (int c = 0; c < 4; ++c)  // (ref, xy)
    v[c] = uv_mv(bs, rec[kMv + c], rec[kMv + 4 + c], rec[kMv + 8 + c],
                 rec[kMv + 12 + c], udy, udx, ss_h, ss_v);
  reinterpret_cast<int4*>(g.uvmv)[idx] = make_int4(v[0], v[1], v[2], v[3]);
}

// (a) the index launch: it lets the gather launch start at once, and
// its records' units take their entries
__global__ void __launch_bounds__(kThreads) splat_index_kernel(Args a) {
  asm volatile("griddepcontrol.launch_dependents;");
  index_phase(a);
}

// (b) the gather launch: a thread a cell, once the index launch has
// completed and its atomics are visible (griddepcontrol.wait)
__global__ void __launch_bounds__(kThreads) splat_gather_kernel(Args a) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx < a.r4 * a.c4 + (a.r4 >> a.ss_v) * (a.c4 >> a.ss_h))
    gather_cell(a, idx);
}

int blocks_for(long long threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// The 14 grids of one frame from its records recs [N, 36] int16 (the
// last row a pad row; 8-byte aligned), on `stream`. bidx [((r4 + 1) /
// 2) * ((c4 + 1) / 2)] uint64, an entry an 8x8 unit, is the caller's
// state for this geometry, zero before the first call and kept between
// calls; epoch (>= 1) is this call's, above that of every earlier call
// on the state since it was zeroed. Two launches, the second a
// programmatic dependent launch of the first.
// out: the 14 output pointers in _grids_from_records' order (bool
// grids as bytes; Y grids [r4, c4], chroma [r4 >> ss_v, c4 >> ss_h],
// with trailing dimensions 2 for the refsel pairs and 2 x 2 for the
// MVs). bwh: the 13 x 2 int32 block sizes (host); itt: the 14 int32
// intra transform types (host).
int splat(const int16_t* recs, int N, void* bidx, unsigned epoch,
          void* inter4, void* txsz4, void* txtype4, void* comp4,
          void* filter4, void* refsel, void* mv16, void* inter4uv,
          void* uvtx4, void* txtypeuv, void* comp_uv, void* filt_uv,
          void* refsel_uv, void* uvmv, int r4, int c4, int ss_h, int ss_v,
          const int* bwh, const int* itt, cudaStream_t stream) {
  if (N < 1 || r4 < 1 || c4 < 1 || (ss_h | ss_v) & ~1 || epoch == 0 ||
      reinterpret_cast<uintptr_t>(recs) % 8 ||
      r4 % (1 << ss_v) || c4 % (1 << ss_h) || !bwh || !itt)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{recs, N, static_cast<unsigned long long*>(bidx), epoch, r4, c4,
         ss_h, ss_v, (r4 + 1) / 2, (c4 + 1) / 2, {}, {}};
  for (int k = 0; k < kNumBs; ++k) {
    a.t.bwh[k][0] = bwh[2 * k];
    a.t.bwh[k][1] = bwh[2 * k + 1];
  }
  for (int k = 0; k < kNumModes; ++k) a.t.itt[k] = itt[k];
  a.g = Grids{static_cast<uint8_t*>(inter4),   static_cast<int32_t*>(txsz4),
              static_cast<int32_t*>(txtype4),  static_cast<uint8_t*>(comp4),
              static_cast<int32_t*>(filter4),  static_cast<int32_t*>(refsel),
              static_cast<int32_t*>(mv16),     static_cast<uint8_t*>(inter4uv),
              static_cast<int32_t*>(uvtx4),    static_cast<int32_t*>(txtypeuv),
              static_cast<uint8_t*>(comp_uv),  static_cast<int32_t*>(filt_uv),
              static_cast<int32_t*>(refsel_uv), static_cast<int32_t*>(uvmv)};
  const long long cells =
      static_cast<long long>(r4) * c4 + (r4 >> ss_v) * (c4 >> ss_h);
  splat_index_kernel<<<blocks_for(static_cast<long long>(N) * kGroup),
                       kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_for(cells));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, splat_gather_kernel, a));
}

}  // extern "C"
