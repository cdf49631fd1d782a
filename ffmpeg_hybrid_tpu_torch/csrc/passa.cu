// The on-device pass A on Hopper (sm_90a): the block-syntax walk of every
// tile of a frame in one launch, keyframes, intra-only and inter frames.
//
//   passa_walk  replaces _decode_jit (ffmpeg_hybrid_tpu/ops/
//               passa_device.py:620-2420, inter=0 and inter=1), a jnp
//               program with no Pallas kernel of its own
//
// Design. The JAX walk runs S tile streams in lockstep on the TPU's
// vector unit, one bounded quantum a lane per step of a while loop, every
// branch a predication mask; its docstring names the GPU form: one lane
// a tile stream with sequential loops. Here each lane (one VP9 tile,
// vp9.c:1342) is a block of one warp whose thread 0 walks the tile alone:
// the phase machine of the JAX walk (PART, MODE, COEF, DONE, MV), a
// quantum a turn of its loop, where a COEF quantum walks every transform
// block of a block and an MV quantum one (sub-block, reference) of an
// inter block. The other 31 threads stage the frame's probability tables
// and zero the contexts in shared memory before the walk, and write the
// lane's counts out after it. The above contexts of the tile's columns,
// the left contexts, the partition stack, the coefficient cache, the
// probability tables and the symbol counts all sit in shared memory
// (about 43 KB with the inter contexts); the scan and neighbour tables
// and the previous frame's grids are read through the read-only cache.
// Bools come from rac_window.cuh's Window (the byte-fed decoder of the
// stream kernels, a fill before every bool), started at the tile's first
// byte; the lane reads the marker bool itself. A tree symbol walks its
// tree table in constant memory, a bool a node: the walk's trees change
// their probabilities symbol by symbol (the context-coupled mode trees),
// so TreeWalk's staged transition tables do not fit them.
//
// Inter frames. The frame's MV and reference grid (find_ref_mvs' spatial
// candidates, vp9mvs.c:37-234, and the next frame's temporal ones) lives
// in global memory in the host decoder's layout (Frame.mv, Frame.refs),
// which the host fills with 0 and -1 before the launch and copies back
// whole after it. Lanes share it without a race: a frame the walk takes
// has one tile row, a lane writes the cells of its own blocks alone, and
// every spatial candidate a lane reads lies in its own tile column (in
// the block's columns or left of them, at or right of tile_col_start:
// MV_REF_BLK_OFF's column offsets stay inside the block, and the scan
// drops a column left of the tile), in a cell its own thread wrote
// earlier. The previous frame's grids and segmentation map are read-only
// inputs. MVs are int16 in the grid and the above/left contexts, as the
// reference's VP9mv.
//
// What bounds it. Every bool depends on the one before it (range and
// value carry), and so does every context decision: a lane is one serial
// chain, and the launch takes as long as its longest lane. The bytes
// moved (the tile bytes read, the records, pairs, counts and grids
// written) are far below what the card moves in that time, and so are
// the operations. Only more lanes than tiles would shorten it (later
// work). On inter frames of few bools the per-block work (the mode
// bundle, the 32-slot candidate scan over the grid in global memory)
// shows: the lane's MV quanta are timed apart (stats).
//
// Outputs as the plain version's (ops/passa_device.py decode_frame_plain):
// records in the native 34-column layout, coefficient and eob pairs with
// their plane bases, counts in CNT_OFF's layout, the grids, and an err
// word per lane (1 an output full, 2 the stream's end before a
// superblock, 4 the marker bool set), after which the lane stops.
#include <cstdint>
#include <cuda_runtime.h>

#include "rac_window.cuh"

namespace {

constexpr int kPart = 0, kMode = 1, kCoef = 2, kDone = 3, kMv = 4;
constexpr int kErrOverflow = 1, kErrEnd = 2, kErrMarker = 4;

// the widest tile (VP9: 64 superblocks) in 8x8 columns, and the above
// context arrays' entries
constexpr int kMaxTileB8 = 512;
constexpr int kAbove = kMaxTileB8 + 16;

// ops/passa_device.py CNT_OFF (checked by tests/test_torch_passa_device.py)
constexpr int kCntTotal = 3302;
constexpr int kCntYMode = 0, kCntUvMode = 40, kCntFilter = 140,
              kCntMvMode = 152, kCntIntra = 180, kCntComp = 188,
              kCntSingleRef = 198, kCntCompRef = 218, kCntTx32 = 228,
              kCntTx16 = 236, kCntTx8 = 242, kCntSkip = 246,
              kCntMvJoint = 252, kCntPartition = 256, kCntCoef = 320,
              kCntEob = 2048, kCntMvSign = 3200, kCntMvClasses = 3204,
              kCntMvClass0 = 3226, kCntMvBits = 3230, kCntMvClass0Fp = 3270,
              kCntMvFp = 3286, kCntMvClass0Hp = 3294, kCntMvHp = 3298;

// ops/passa_device.py probs8: the offsets of its tables; an inter frame's
// follow the intra frame's
constexpr int kPSkip = 0, kPTx8 = 3, kPTx16 = 5, kPTx32 = 9, kPSeg = 15,
              kPSkipSeg = 22, kPKfPart = 30, kPKfY = 78, kPKfUv = 978,
              kPCoef = 1068, kProbBytes = 4236;
constexpr int kPCoefI = 4236, kPPartI = 7404, kPIntra = 7452, kPComp = 7456,
              kPCompRef = 7461, kPSingleRef = 7466, kPYMode = 7476,
              kPUvMode = 7512, kPMvMode = 7602, kPFilter = 7623,
              kPMvJoint = 7631, kPMvSign = 7634, kPMvClasses = 7636,
              kPMvClass0 = 7656, kPMvBits = 7658, kPMvC0Fp = 7678,
              kPMvFp = 7690, kPMvC0Hp = 7696, kPMvHp = 7698,
              kPSegPred = 7700, kPRefSegEn = 7703, kPRefSegVal = 7711,
              kProbBytesInter = 7719;

// codecs/vp9/tables.py BWH_TAB [2][13][2]: block sizes in 4px units, then
// in 8x8 units
__constant__ uint8_t kBwh[2][13][2] = {
    {{16, 16}, {16, 8}, {8, 16}, {8, 8}, {8, 4}, {4, 8}, {4, 4}, {4, 2},
     {2, 4}, {2, 2}, {2, 1}, {1, 2}, {1, 1}},
    {{8, 8}, {8, 4}, {4, 8}, {4, 4}, {4, 2}, {2, 4}, {2, 2}, {2, 1},
     {1, 2}, {1, 1}, {1, 1}, {1, 1}, {1, 1}}};
// blockdec.py MAX_TX_FOR_BL_BP, ABOVE_CTX, LEFT_CTX; tables.py
// INTRA_TXFM_TYPE
__constant__ uint8_t kMaxTx[13] = {3, 3, 3, 3, 2, 2, 2, 1, 1, 1, 0, 0, 0};
__constant__ uint8_t kActx[13] = {0, 0, 8, 8, 8, 12, 12, 12, 14, 14, 14,
                                  15, 15};
__constant__ uint8_t kLctx[13] = {0, 8, 0, 8, 12, 8, 12, 14, 12, 14, 15,
                                  14, 15};
__constant__ uint8_t kItx[14] = {2, 1, 0, 0, 3, 2, 1, 2, 1, 3, 0, 0, 0, 0};
// tables.py PARTITION_TREE, INTRAMODE_TREE, SEGMENTATION_TREE,
// INTER_MODE_TREE, FILTER_TREE, MV_JOINT_TREE, MV_CLASS_TREE, MV_FP_TREE:
// an entry <= 0 is the leaf -entry
__constant__ int8_t kPartTree[3][2] = {{0, 1}, {-1, 2}, {-2, -3}};
__constant__ int8_t kModeTree[9][2] = {{-2, 1}, {-9, 2}, {0, 3}, {4, 6},
                                       {-1, 5}, {-4, -5}, {-3, 7}, {-7, 8},
                                       {-6, -8}};
__constant__ int8_t kSegTree[7][2] = {{1, 2}, {3, 4}, {5, 6}, {0, -1},
                                      {-2, -3}, {-4, -5}, {-6, -7}};
__constant__ int8_t kInterModeTree[3][2] = {{-12, 1}, {-10, 2}, {-11, -13}};
__constant__ int8_t kFilterTree[2][2] = {{0, 1}, {-1, -2}};
__constant__ int8_t kMvJointTree[3][2] = {{0, 1}, {-1, 2}, {-2, -3}};
__constant__ int8_t kMvClassTree[10][2] = {{0, 1},   {-1, 2}, {3, 4},
                                           {-2, -3}, {5, 6},  {-4, -5},
                                           {-6, 7},  {8, 9},  {-7, -8},
                                           {-9, -10}};
__constant__ int8_t kMvFpTree[3][2] = {{0, 1}, {-1, 2}, {-2, -3}};
// tables.py FILTER_LUT (filter symbol -> type); an inter frame's y-mode
// size groups; blockdec.py SUB8X8_OFF (how far into a 64x64 or 32x32
// block the inter-mode context reads, vp9block.c:584)
__constant__ uint8_t kFilterLut[3] = {1, 0, 2};
__constant__ uint8_t kSzGroup[13] = {3, 3, 3, 3, 2, 2, 2, 1, 1, 1, 0, 0, 0};
__constant__ uint8_t kModeOff[13] = {3, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0};
// blockdec.py INTER_MODE_CTX_LUT [above mode][left mode]
__constant__ uint8_t kInterModeCtx[14][14] = {
    {6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5},
    {6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5},
    {6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5},
    {6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5},
    {6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5},
    {6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5},
    {6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5},
    {6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5},
    {6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5},
    {6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5, 5, 5, 5},
    {5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 2, 2, 1, 3},
    {5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 2, 2, 1, 3},
    {5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 1, 1, 0, 3},
    {5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 3, 3, 3, 4}};
// the mv and mode slot each sub-block takes after the MV phase
// (vp9block.c:732-766)
__constant__ uint8_t kSubSrc[13][4] = {
    {0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0},
    {0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0},
    {0, 0, 2, 2}, {0, 1, 0, 1}, {0, 1, 2, 3}};
// mvs.py MV_REF_BLK_OFF [bs][8][(col, row)]
__constant__ int8_t kMvRef[13][8][2] = {
    {{3, -1}, {-1, 3}, {4, -1}, {-1, 4},
     {-1, -1}, {0, -1}, {-1, 0}, {6, -1}},
    {{0, -1}, {-1, 0}, {4, -1}, {-1, 2},
     {-1, -1}, {0, -3}, {-3, 0}, {2, -1}},
    {{-1, 0}, {0, -1}, {-1, 4}, {2, -1},
     {-1, -1}, {-3, 0}, {0, -3}, {-1, 2}},
    {{1, -1}, {-1, 1}, {2, -1}, {-1, 2},
     {-1, -1}, {0, -3}, {-3, 0}, {-3, -3}},
    {{0, -1}, {-1, 0}, {2, -1}, {-1, -1},
     {-1, 1}, {0, -3}, {-3, 0}, {-3, -3}},
    {{-1, 0}, {0, -1}, {-1, 2}, {-1, -1},
     {1, -1}, {-3, 0}, {0, -3}, {-3, -3}},
    {{0, -1}, {-1, 0}, {1, -1}, {-1, 1},
     {-1, -1}, {0, -3}, {-3, 0}, {-3, -3}},
    {{0, -1}, {-1, 0}, {1, -1}, {-1, -1},
     {0, -2}, {-2, 0}, {-2, -1}, {-1, -2}},
    {{-1, 0}, {0, -1}, {-1, 1}, {-1, -1},
     {-2, 0}, {0, -2}, {-1, -2}, {-2, -1}},
    {{0, -1}, {-1, 0}, {-1, -1}, {0, -2},
     {-2, 0}, {-1, -2}, {-2, -1}, {-2, -2}},
    {{0, -1}, {-1, 0}, {-1, -1}, {0, -2},
     {-2, 0}, {-1, -2}, {-2, -1}, {-2, -2}},
    {{0, -1}, {-1, 0}, {-1, -1}, {0, -2},
     {-2, 0}, {-1, -2}, {-2, -1}, {-2, -2}},
    {{0, -1}, {-1, 0}, {-1, -1}, {0, -2},
     {-2, 0}, {-1, -2}, {-2, -1}, {-2, -2}}};
// find_ref_mvs' candidates as 32 slots walked in order
// (ops/passa_device.py _SLOT_KIND, _SLOT_PAR): kind 0 a direct sub-block
// mv, 1/2 the above/left mv context, 3 a spatial neighbour with the same
// reference, 4 the previous frame's, 5/6 a spatial neighbour's first/
// second mv with another reference, 7/8 the previous frame's
__constant__ uint8_t kSlotKind[32] = {0, 0, 0, 1, 2, 3, 3, 3, 3, 3, 3,
                                      3, 3, 4, 5, 6, 5, 6, 5, 6, 5, 6,
                                      5, 6, 5, 6, 5, 6, 5, 6, 7, 8};
__constant__ uint8_t kSlotPar[32] = {2, 1, 0, 0, 0, 0, 1, 2, 3, 4, 5,
                                     6, 7, 0, 0, 0, 1, 1, 2, 2, 3, 3,
                                     4, 4, 5, 5, 6, 6, 7, 7, 0, 0};
// extra-bit ladders of cat1..cat5 and cat6's at 12 bits (vp9block.c
// 839-899; at 10 and 8 bits cat6 takes its last 16 and 14), bases
__constant__ uint8_t kCatProbs[6][5] = {{0, 0, 0, 0, 0},
                                        {159, 0, 0, 0, 0},
                                        {165, 145, 0, 0, 0},
                                        {173, 148, 140, 0, 0},
                                        {176, 155, 140, 135, 0},
                                        {180, 157, 141, 134, 130}};
__constant__ uint8_t kCat6[18] = {255, 255, 255, 255, 254, 254, 254, 252,
                                  249, 243, 230, 196, 177, 153, 140, 133,
                                  130, 129};
__constant__ int kCatBase[7] = {0, 5, 7, 11, 19, 35, 67};

// the inter header's flags (ops/passa_device.py prep_inter's hflags)
enum HFlag {
  kSegEn, kSegUpd, kSegTmp, kHavePseg, kCompPred, kFixRef, kVarRef0,
  kVarRef1, kSignBias0, kSignBias1, kSignBias2, kFilterMode, kHighPrec,
  kUsePrev, kNumHFlags
};

struct Params {
  int rows, cols, sb_cols, sb_rows, txfmmode, seg, lossless, bpp, ss_h,
      ss_v, want_counts, inter;
  int hf[kNumHFlags];
};

// A lane's decoder: a Window over its tile, a fill before every bool,
// and the bools it read.
struct Bools {
  Window w;
  long long n;

  __device__ __forceinline__ int get(int prob) {
    w.fill();
    ++n;
    return w.get(prob, 256 - prob);
  }
  // vp89_rac_get_tree over a tree table in constant memory
  template <int N>
  __device__ __forceinline__ int tree(const int8_t (&t)[N][2],
                                      const uint8_t* probs) {
    int i = 0;
    for (;;) {
      const int nxt = t[i][get(probs[i])];
      if (nxt <= 0) return -nxt;
      i = nxt;
    }
  }
  // bits consumed into the value since the tile's first byte
  __device__ __forceinline__ long long consumed() const {
    return 32ll * w.k - w.count;
  }
};

// the lane's state in shared memory: above contexts (tile-relative
// columns), left contexts (the superblock row's), the partition stack
// (a node a level: bl, row, col, bp, items emitted) and the coefficient
// block's cache; an inter frame's contexts (its mode context takes one
// entry an 8x8 column, the keyframe's two), and its mv contexts, a
// [reference][x, y] pair a 4x4 column or row
struct Ctx {
  uint8_t a_part[kAbove], a_skip[kAbove], a_txfm[kAbove];
  uint8_t a_mode[2 * kAbove], a_nnz[3][2 * kAbove];
  uint8_t a_intra[kAbove], a_comp[kAbove], a_ref[kAbove], a_filter[kAbove],
      a_segpred[kAbove];
  uint8_t l_part[8], l_skip[8], l_txfm[8], l_mode[16], l_nnz[3][16];
  uint8_t l_intra[8], l_comp[8], l_ref[8], l_filter[8], l_segpred[8];
  int stk_bl[4], stk_r[4], stk_c[4], stk_bp[4], stk_em[4];
  int16_t a_mv[2 * kAbove][2][2], l_mv[16][2][2];
  __align__(16) uint8_t cache[1024];
};

// an inter frame's grids, all in the host layout (C8 cells a row): its
// own and the previous frame's (read-only; null where the frame reads
// none)
struct Grids {
  int16_t* mv;   // [R8 * C8][2][2]
  int8_t* ref;   // [R8 * C8][2]
  const int16_t* __restrict__ pmv;   // [R8 * C8][2][2]
  const int8_t* __restrict__ pref;   // [R8 * C8][2]
  const uint8_t* __restrict__ pseg;  // [R8 * C8]
  int C8;
};

// -x as a wrapping int32
__device__ __forceinline__ int neg32(int x) {
  return static_cast<int>(0u - static_cast<uint32_t>(x));
}

__device__ __forceinline__ void fill8(uint8_t* p, int v, int n) {
  for (int k = 0; k < n; ++k) p[k] = static_cast<uint8_t>(v);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// the compound reference's context (vp9block.c:414-477)
__device__ int comp_ref_ctx(bool have_a, bool have_l, int a_in, int l_in,
                            int a_cm, int l_cm, int a_rf, int l_rf,
                            int fixref, int var0, int var1) {
  if (have_a && have_l) {
    if (a_in) return l_in ? 2 : 1 + 2 * (l_rf != var1);
    if (l_in) return 1 + 2 * (a_rf != var1);
    if (l_rf == a_rf && a_rf == var1) return 0;
    if (!l_cm && !a_cm) {
      if ((a_rf == fixref && l_rf == var0) || (l_rf == fixref && a_rf == var0))
        return 4;
      return a_rf == l_rf ? 3 : 1;
    }
    if (!l_cm) {
      if (a_rf == var1 && l_rf != var1) return 1;
      return l_rf == var1 && a_rf != var1 ? 2 : 4;
    }
    if (!a_cm) {
      if (l_rf == var1 && a_rf != var1) return 1;
      return a_rf == var1 && l_rf != var1 ? 2 : 4;
    }
    return l_rf == a_rf ? 4 : 2;
  }
  if (have_a || have_l) {
    const int in = have_a ? a_in : l_in, cm = have_a ? a_cm : l_cm;
    const int rf = have_a ? a_rf : l_rf;
    if (in) return 2;
    return (cm ? 4 : 3) * (rf != var1);
  }
  return 2;
}

// the first single-reference bit's context (vp9block.c:479-520)
__device__ int single_ref_ctx1(bool have_a, bool have_l, int a_in, int l_in,
                               int a_cm, int l_cm, int a_rf, int l_rf,
                               int fixref) {
  const int nf = fixref == 0, nlr = l_rf == 0, nar = a_rf == 0;
  const bool a_ok = have_a && !a_in, l_ok = have_l && !l_in;
  if (a_ok && l_ok) {
    if (l_cm) return a_cm ? 1 + (nf | nlr | nar) : 3 * nar + (nf | nlr);
    return a_cm ? 3 * nlr + (nf | nar) : 2 * nlr + 2 * nar;
  }
  if (a_ok) return a_cm ? 1 + (nf | nar) : 4 * nar;
  if (l_ok) return l_cm ? 1 + (nf | nlr) : 4 * nlr;
  return 2;
}

// the second single-reference bit's context (vp9block.c:522-572), with
// the reference's dead arms
__device__ int single_ref_ctx2(bool have_a, bool have_l, int a_in, int l_in,
                               int a_cm, int l_cm, int a_rf, int l_rf,
                               int fixref) {
  const int f1 = fixref == 1, ar1 = a_rf == 1, lr1 = l_rf == 1;
  const int nar = a_rf == 0, nlr = l_rf == 0;
  if (have_a && have_l) {
    if (l_in) {
      if (a_in) return 2;
      if (a_cm) return 1 + 2 * (f1 | ar1);
      return nar ? 3 : 4 * ar1;
    }
    if (a_in) {
      if (l_cm) return 1 + 2 * (f1 | lr1);
      return nlr ? 3 : 4 * lr1;
    }
    if (a_cm) {
      if (l_cm) return l_rf == a_rf ? 3 * (f1 | lr1) : 2;
      return nlr ? 1 + 2 * (f1 | ar1) : 3 * lr1 + (f1 | ar1);
    }
    if (l_cm) return nar ? 1 + 2 * (f1 | lr1) : 3 * ar1 + (f1 | lr1);
    if (nar) return nlr ? 3 : 4 * lr1;
    return nlr ? 4 * ar1 : 2 * lr1 + 2 * ar1;
  }
  if (have_a || have_l) {
    const int in = have_a ? a_in : l_in, cm = have_a ? a_cm : l_cm;
    const int n0 = have_a ? nar : nlr, r1 = have_a ? ar1 : lr1;
    if (in || (!cm && n0)) return 2;
    return cm ? 3 * (f1 | r1) : 4 * r1;
  }
  return 2;
}

// One MV component (vp9mvs.c:236-289), with libvpx's count of an hp bit
// that is not coded (vp9mvs.c:263-266).
__device__ int read_mv_comp(Bools& rd, const uint8_t* pr, int* cnt,
                            bool counting, int comp, bool hp) {
  const int sign = rd.get(pr[kPMvSign + comp]);
  const int cl = rd.tree(kMvClassTree, pr + kPMvClasses + comp * 10);
  if (counting) {
    ++cnt[kCntMvSign + comp * 2 + sign];
    ++cnt[kCntMvClasses + comp * 11 + cl];
  }
  int n;
  if (cl) {
    n = 0;
    for (int m = 0; m < cl; ++m) {
      const int bit = rd.get(pr[kPMvBits + comp * 10 + m]);
      n |= bit << m;
      if (counting) ++cnt[kCntMvBits + comp * 20 + m * 2 + bit];
    }
    const int fp = rd.tree(kMvFpTree, pr + kPMvFp + comp * 3);
    const int hpb = hp ? rd.get(pr[kPMvHp + comp]) : 1;
    n = ((n << 3) | (fp << 1) | hpb) + (8 << cl);
    if (counting) {
      ++cnt[kCntMvFp + comp * 4 + fp];
      ++cnt[kCntMvHp + comp * 2 + hpb];
    }
  } else {
    const int n0 = rd.get(pr[kPMvClass0 + comp]);
    const int fp = rd.tree(kMvFpTree, pr + kPMvC0Fp + (comp * 2 + n0) * 3);
    const int hpb = hp ? rd.get(pr[kPMvC0Hp + comp]) : 1;
    n = (n0 << 3) | (fp << 1) | hpb;
    if (counting) {
      ++cnt[kCntMvClass0 + comp * 2 + n0];
      ++cnt[kCntMvClass0Fp + comp * 8 + n0 * 4 + fp];
      ++cnt[kCntMvClass0Hp + comp * 2 + hpb];
    }
  }
  return sign ? -(n + 1) : n + 1;
}

// find_ref_mvs (vp9mvs.c:37-234) over the 32 candidate slots: the
// predicted (x, y) of reference `refz` (mv slot z of the block's earlier
// sub-blocks), NEARMV's second distinct candidate when idxn, for
// sub-block sbp (-1: the whole block), with the reference decoder's
// quirks: RETURN_MV's two-stage compare past the first sub-block and its
// zero return (vp9mvs.c:95-124), the different-reference second mv taken
// whether or not the first was (vp9mvs.c:206-208).
__device__ int2 find_ref_mv(const Params& P, const Grids& G, const Ctx& X,
                            const int (*b_mv)[2][2], int bs, int br, int bc,
                            int c0, int refz, int z, bool idxn, int sbp) {
  const int minx = -(128 + bc * 64), miny = -(128 + br * 64);
  const int maxx = 128 + (P.cols - bc - kBwh[1][bs][0]) * 64;
  const int maxy = 128 + (P.rows - br - kBwh[1][bs][1]) * 64;
  const int sbc = clampi(sbp, 0, 3), col = bc - c0, row7 = br & 7;
  const int pi = br * G.C8 + bc;
  const int sb_ref = P.hf[kSignBias0 + refz];
  bool msets = false, m8s = false;
  int mx = 0, my = 0, m8x = 0, m8y = 0;
  for (int j = 0; j < 32; ++j) {
    const int kind = kSlotKind[j], par = kSlotPar[j];
    int vx, vy, other = -1;
    if (kind == 0) {
      if (!(par == 0 ? sbp >= 1 : sbp == 3)) continue;
      vx = b_mv[par][z][0];
      vy = b_mv[par][z][1];
    } else if (kind <= 2) {
      if (sbp < 0 || (kind == 1 ? br == 0 : bc <= c0)) continue;
      const int gi = kind == 1 ? (br - 1) * G.C8 + bc : br * G.C8 + bc - 1;
      const int g0 = G.ref[2 * gi], g1 = G.ref[2 * gi + 1];
      if (g0 != refz && g1 != refz) continue;
      const int16_t* m = kind == 1 ? X.a_mv[2 * col + (sbc & 1)][g0 != refz]
                                   : X.l_mv[2 * row7 + (sbc >> 1)][g0 != refz];
      vx = m[0];
      vy = m[1];
    } else {
      int g0, g1;
      const int16_t* v;
      if (kind == 3 || kind == 5 || kind == 6) {
        if (kind == 3 && sbp >= 0 && par < 2) continue;
        const int nc = bc + kMvRef[bs][par][0], nr = br + kMvRef[bs][par][1];
        if (nc < c0 || nc >= P.cols || nr < 0 || nr >= P.rows) continue;
        const int gi = nr * G.C8 + nc;
        g0 = G.ref[2 * gi];
        g1 = G.ref[2 * gi + 1];
        v = G.mv + 4 * gi;
      } else {
        if (!P.hf[kUsePrev]) continue;
        g0 = __ldg(G.pref + 2 * pi);
        g1 = __ldg(G.pref + 2 * pi + 1);
        v = G.pmv + 4 * pi;
      }
      const int v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3];
      if (kind == 3 || kind == 4) {
        if (g0 != refz && g1 != refz) continue;
        vx = g0 == refz ? v0 : v2;
        vy = g0 == refz ? v1 : v3;
      } else if (kind == 5 || kind == 7) {
        if (g0 < 0 || g0 == refz) continue;
        vx = v0;
        vy = v1;
        other = g0;
      } else {
        if (g1 < 0 || g1 == refz || (v0 == v2 && v1 == v3)) continue;
        vx = v2;
        vy = v3;
        other = g1;
      }
    }
    if (other >= 0 && P.hf[kSignBias0 + other] != sb_ref) {
      vx = -vx;
      vy = -vy;
    }
    if (kind == 0) {
      // RETURN_DIRECT_MV: unclamped
      if (!idxn) return make_int2(vx, vy);
      if (!msets) {
        msets = true;
        mx = vx;
        my = vy;
      } else if (vx != mx || vy != my) {
        return make_int2(vx, vy);
      }
      continue;
    }
    // RETURN_MV: clamped
    const int cx = clampi(vx, minx, maxx), cy = clampi(vy, miny, maxy);
    if (sbp > 0) {
      const bool memdif = !msets || cx != mx || cy != my;
      if (!m8s) {
        if (memdif) return make_int2(cx, cy);
        m8s = true;
        m8x = vx;
        m8y = vy;
      } else if (vx != m8x || vy != m8y) {
        return memdif ? make_int2(cx, cy) : make_int2(0, 0);
      }
    } else if (!idxn) {
      return make_int2(cx, cy);
    } else if (!msets) {
      msets = true;
      mx = vx;
      my = vy;
    } else if (vx != mx || vy != my) {
      return make_int2(cx, cy);
    }
  }
  return make_int2(clampi(0, minx, maxx), clampi(0, miny, maxy));
}

// The walk of one lane by one thread: the phase machine of
// ops/passa_device.py _walk_lane. Returns the err word; mv_cycles gets
// the clock64 cycles of the lane's MV quanta.
__device__ int walk(const Params& P, Bools& rd, Ctx& X, const Grids& G,
                    const uint8_t* __restrict__ pr, const int32_t* qmul,
                    const uint8_t* bands, const int16_t* __restrict__ scans,
                    const uint32_t* __restrict__ nbs, int* cnt,
                    long long tile_bits, int r0, int r1, int c0, int c1,
                    int bcap, int ccap, int ecap, int32_t* __restrict__ blocks,
                    int2* __restrict__ cpairs, int2* __restrict__ epairs,
                    int& nblk, int& ncp, int& nep, long long& mv_cycles) {
  const int rows = P.rows, cols = P.cols, ss_h = P.ss_h, ss_v = P.ss_v;
  const int W64 = P.sb_cols * 64, W64uv = W64 >> ss_h;
  const int c16 = P.sb_cols * 16, c16uv = c16 >> ss_h;
  const int H64 = P.sb_rows * 64;
  const int ysz = H64 * W64, usz = (H64 >> ss_v) * W64uv;
  const int eysz = (H64 / 4) * c16, eusz = ((H64 >> ss_v) / 4) * c16uv;
  const bool counting = P.want_counts != 0;
  const bool inter = P.inter != 0;
  const int* const hf = P.hf;
  const int cat6n = P.bpp + 6;
  const uint8_t* cat6 = kCat6 + (12 - P.bpp);
  const int mode0 = inter ? 10 : 2;

  int phase = kPart;
  int sb_r = r0, sb_c = c0;
  int* const stk_bl = X.stk_bl;
  int* const stk_r = X.stk_r;
  int* const stk_c = X.stk_c;
  int* const stk_bp = X.stk_bp;
  int* const stk_em = X.stk_em;
  int sp = 0;
  // the current block; on inter frames its fields that a block does not
  // write keep the last block's values, as the reference's one Block
  int br = 0, bc = 0, bs = 0, seg_id = 0, skip = 0, intra = 1, tx = 0,
      uvtx = 0;
  int modes[4] = {2, 2, 2, 2};
  int b_uvmode = 0, b_comp = 0, b_ref[2] = {0, 0}, b_filter = 0,
      b_filterid = 0, b_modectx = 0;
  int b_mv[4][2][2] = {};
  int mv_k = 0, mv_z = 0;

  // the record (the native 34-column layout); false when it is full
  auto emit = [&]() -> bool {
    if (nblk >= bcap) return false;
    int32_t* rec = blocks + static_cast<int64_t>(nblk++) * 34;
    rec[0] = br;
    rec[1] = bc;
    rec[2] = c0;
    rec[3] = bs;
    rec[4] = seg_id;
    rec[5] = skip;
    rec[6] = intra;
    rec[7] = tx;
    rec[8] = uvtx;
    for (int k = 0; k < 4; ++k) rec[9 + k] = modes[k];
    rec[13] = b_uvmode;
    if (inter) {
      rec[14] = b_comp;
      rec[15] = b_ref[0];
      rec[16] = b_ref[1];
      rec[17] = b_filter;
      for (int q = 0; q < 4; ++q)
        for (int z = 0; z < 2; ++z)
          for (int c = 0; c < 2; ++c)
            rec[18 + q * 4 + z * 2 + c] = b_mv[q][z][c];
    } else {
      for (int k = 14; k < 34; ++k) rec[k] = 0;
    }
    return true;
  };
  // a skipped block zeroes its nnz contexts (vp9block.c:1316)
  auto zero_nnz = [&]() {
    const int col = bc - c0, row7 = br & 7;
    const int bw4 = kBwh[1][bs][0], bh4 = kBwh[1][bs][1];
    fill8(X.a_nnz[0] + col * 2, 0, bw4 * 2);
    fill8(X.l_nnz[0] + row7 * 2, 0, bh4 * 2);
    for (int p = 1; p < 3; ++p) {
      fill8(X.a_nnz[p] + ((col * 2) >> ss_h), 0, (bw4 * 2) >> ss_h);
      fill8(X.l_nnz[p] + ((row7 * 2) >> ss_v), 0, (bh4 * 2) >> ss_v);
    }
  };
  // the non-keyframe SET_CTXS and the write-back of the block's mvs and
  // references into the frame grid (vp9block.c:682-801)
  auto set_ctxs_nonkf = [&]() {
    const int col = bc - c0, row7 = br & 7;
    const int nw = kBwh[1][bs][0], nh = kBwh[1][bs][1];
    const int w4c = min(cols - bc, nw), h4c = min(rows - br, nh);
    fill8(X.a_intra + col, intra, nw);
    fill8(X.a_comp + col, b_comp, nw);
    fill8(X.a_mode + col, modes[3], nw);
    fill8(X.l_intra + row7, intra, nh);
    fill8(X.l_comp + row7, b_comp, nh);
    fill8(X.l_mode + row7, modes[3], nh);
    if (!intra) {
      const int vref = b_comp ? b_ref[hf[kSignBias0 + hf[kVarRef0]]] : b_ref[0];
      fill8(X.a_ref + col, vref, nw);
      fill8(X.l_ref + row7, vref, nh);
      if (hf[kFilterMode] == 4) {
        fill8(X.a_filter + col, b_filterid, nw);
        fill8(X.l_filter + row7, b_filterid, nh);
      }
      auto put = [&](int16_t (*dst)[2], int q) {
        for (int z = 0; z < 2; ++z)
          for (int c = 0; c < 2; ++c)
            dst[z][c] = static_cast<int16_t>(b_mv[q][z][c]);
      };
      if (bs > 9) {
        put(X.l_mv[2 * row7], 1);
        put(X.l_mv[2 * row7 + 1], 3);
        put(X.a_mv[2 * col], 2);
        put(X.a_mv[2 * col + 1], 3);
      } else {
        for (int n = 0; n < 2 * w4c; ++n) put(X.a_mv[2 * col + n], 3);
        for (int n = 0; n < 2 * h4c; ++n) put(X.l_mv[2 * row7 + n], 3);
      }
    }
    const int g0 = intra ? -1 : b_ref[0];
    const int g1 = !intra && b_comp ? b_ref[1] : -1;
    for (int y = 0; y < h4c; ++y) {
      for (int x = 0; x < w4c; ++x) {
        const int gi = (br + y) * G.C8 + bc + x;
        G.ref[2 * gi] = static_cast<int8_t>(g0);
        G.ref[2 * gi + 1] = static_cast<int8_t>(g1);
        if (!intra) {
          G.mv[4 * gi] = static_cast<int16_t>(b_mv[3][0][0]);
          G.mv[4 * gi + 1] = static_cast<int16_t>(b_mv[3][0][1]);
          if (b_comp) {
            G.mv[4 * gi + 2] = static_cast<int16_t>(b_mv[3][1][0]);
            G.mv[4 * gi + 3] = static_cast<int16_t>(b_mv[3][1][1]);
          }
        }
      }
    }
  };

  while (phase != kDone) {
    if (phase == kPart) {
      if (sp == 0) {
        if (sb_r >= r1) {
          phase = kDone;
          continue;
        }
        // the end test before each superblock (vp9.c:1413,
        // vpx_rac_is_end: more than 10 bits read past the end)
        if (rd.consumed() > tile_bits + 10) return kErrEnd;
        stk_bl[0] = 0;
        stk_r[0] = sb_r;
        stk_c[0] = sb_c;
        stk_bp[0] = -1;
        stk_em[0] = 0;
        sp = 1;
      }
      const int top = sp - 1;
      const int bl = stk_bl[top], r = stk_r[top], c = stk_c[top];
      int bp = stk_bp[top];
      const int em = stk_em[top];
      const int hbs = 4 >> bl;
      const bool col_in = c + hbs < cols, row_in = r + hbs < rows;
      if (bp < 0) {
        const int pctx = ((X.a_part[c - c0] >> (3 - bl)) & 1) |
                         (((X.l_part[r & 7] >> (3 - bl)) & 1) << 1);
        // an inter frame's partition probabilities are its own
        const uint8_t* pp =
            pr + (inter ? kPPartI : kPKfPart) + (bl * 4 + pctx) * 3;
        if (bl == 3 || (col_in && row_in))
          bp = rd.tree(kPartTree, pp);
        else if (col_in)
          bp = rd.get(pp[1]) ? 3 : 1;
        else if (row_in)
          bp = rd.get(pp[2]) ? 3 : 2;
        else
          bp = 3;
        stk_bp[top] = bp;
        if (counting) ++cnt[kCntPartition + (bl * 4 + pctx) * 4 + bp];
      }
      const bool split = bp == 3 && bl < 3;
      int n_items;
      if (split)
        n_items = 1 + col_in + row_in + (col_in && row_in);
      else if (bl == 3 || bp == 0)
        n_items = 1;
      else
        n_items = 1 + (bp == 1 ? row_in : col_in);
      if (em >= n_items) {
        // the node's items are exhausted: pop; the root's pop takes
        // the next superblock, a new row resets the left contexts
        if (--sp == 0) {
          sb_c += 8;
          if (sb_c >= c1) {
            sb_c = c0;
            sb_r += 8;
            fill8(X.l_part, 0, 8);
            fill8(X.l_skip, 0, 8);
            fill8(X.l_mode, mode0, 16);
            for (int p = 0; p < 3; ++p) fill8(X.l_nnz[p], 0, 16);
            fill8(X.l_segpred, 0, 8);
          }
        }
        continue;
      }
      stk_em[top] = em + 1;
      if (split) {
        // the em'th child that lies in the frame, in DFS pre-order
        int k = em, dr = 0, dc = 0;
        const bool ok[4] = {true, col_in, row_in, col_in && row_in};
        for (int j = 0; j < 4; ++j) {
          if (!ok[j]) continue;
          if (k-- == 0) {
            dr = j >> 1;
            dc = j & 1;
            break;
          }
        }
        stk_bl[sp] = bl + 1;
        stk_r[sp] = r + dr * hbs;
        stk_c[sp] = c + dc * hbs;
        stk_bp[sp] = -1;
        stk_em[sp] = 0;
        ++sp;
        continue;
      }
      br = r + (bp == 1 && em == 1 ? hbs : 0);
      bc = c + (bp == 2 && em == 1 ? hbs : 0);
      bs = bl == 3 ? 9 + bp : (bp == 0 ? bl * 3 : bl * 3 + bp);
      phase = kMode;
      continue;
    }

    if (phase == kMode) {
      const int row7 = br & 7, col = bc - c0;
      const int bw4 = kBwh[1][bs][0], bh4 = kBwh[1][bs][1];
      const bool have_a = br > 0, have_l = bc > c0;
      // seg id; on inter frames with temporal prediction from the
      // previous frame's map (vp9block.c:101-142)
      if (inter) {
        bool use_pred = false, m_tree = false;
        if (hf[kSegEn]) {
          int pbit = 0;
          if (hf[kSegUpd] && hf[kSegTmp])
            pbit = rd.get(pr[kPSegPred + X.a_segpred[col] + X.l_segpred[row7]]);
          use_pred = !hf[kSegUpd] || (hf[kSegTmp] && pbit);
          m_tree = hf[kSegUpd] && !(hf[kSegTmp] && pbit);
        }
        const int w4c = min(cols - bc, bw4), h4c = min(rows - br, bh4);
        if (use_pred) {
          // the least id of the previous map over the clipped block
          // (vp9block.c:115-127)
          seg_id = 0;
          if (hf[kHavePseg]) {
            seg_id = 8;
            for (int y = 0; y < h4c; ++y)
              for (int x = 0; x < w4c; ++x)
                seg_id = min(seg_id,
                             static_cast<int>(__ldg(
                                 G.pseg + (br + y) * G.C8 + bc + x)));
          }
        } else if (m_tree) {
          seg_id = rd.tree(kSegTree, pr + kPSeg);
        } else {
          seg_id = 0;
        }
        if (hf[kSegEn]) {
          fill8(X.a_segpred + col, use_pred, w4c);
          fill8(X.l_segpred + row7, use_pred, h4c);
        }
      } else {
        seg_id = P.seg ? rd.tree(kSegTree, pr + kPSeg) : 0;
      }
      // skip
      const bool forced_skip = pr[kPSkipSeg + seg_id] != 0;
      if (forced_skip) {
        skip = 1;
      } else {
        const int sctx = X.l_skip[row7] + X.a_skip[col];
        skip = rd.get(pr[kPSkip + sctx]);
        if (counting) ++cnt[kCntSkip + sctx * 2 + skip];
      }
      // the intra/inter flag (vp9block.c:283-298); the seg REF feature
      // sets it without a bool
      int rs_en = 0, rs_val = 0, a_in = 0, l_in = 0;
      if (inter) {
        rs_en = pr[kPRefSegEn + seg_id];
        rs_val = pr[kPRefSegVal + seg_id];
        a_in = X.a_intra[col];
        l_in = X.l_intra[row7];
        if (rs_en) {
          intra = rs_val == 0;
        } else {
          const int ctx = have_a && have_l ? a_in + l_in + (a_in + l_in == 2)
                          : have_a         ? 2 * a_in
                          : have_l         ? 2 * l_in
                                           : 0;
          const int ibit = rd.get(pr[kPIntra + ctx]);
          intra = !ibit;
          if (counting) ++cnt[kCntIntra + ctx * 2 + ibit];
        }
      } else {
        intra = 1;
      }
      // tx size: coded when switchable, on an inter frame only for intra
      // blocks and blocks that are not skipped
      const int mtx = kMaxTx[bs];
      if (P.txfmmode == 4 && (intra || !skip)) {
        const int a_sk = X.a_skip[col], l_sk = X.l_skip[row7];
        const int a_t = a_sk ? mtx : X.a_txfm[col];
        const int l_t = l_sk ? mtx : X.l_txfm[row7];
        int txctx;
        if (have_a && have_l)
          txctx = a_t + l_t > mtx;
        else if (have_a)
          txctx = a_sk ? 1 : a_t * 2 > mtx;
        else if (have_l)
          txctx = l_sk ? 1 : l_t * 2 > mtx;
        else
          txctx = 1;
        int cidx = -1;
        if (mtx == 3) {
          const uint8_t* p = pr + kPTx32 + txctx * 3;
          tx = rd.get(p[0]);
          if (tx) {
            tx += rd.get(p[1]);
            if (tx == 2) tx += rd.get(p[2]);
          }
          cidx = kCntTx32 + txctx * 4 + tx;
        } else if (mtx == 2) {
          const uint8_t* p = pr + kPTx16 + txctx * 2;
          tx = rd.get(p[0]);
          if (tx) tx += rd.get(p[1]);
          cidx = kCntTx16 + txctx * 3 + tx;
        } else if (mtx == 1) {
          tx = rd.get(pr[kPTx8 + txctx]);
          cidx = kCntTx8 + txctx * 2 + tx;
        } else {
          tx = 0;
        }
        if (counting && cidx >= 0) ++cnt[cidx];
      } else {
        tx = min(mtx, P.txfmmode);
      }
      uvtx = tx - ((ss_h && bw4 * 2 == (1 << tx)) ||
                   (ss_v && bh4 * 2 == (1 << tx)));
      if (!inter) {
        // keyframe modes: the context-coupled trees
        const int a0 = col * 2, a1 = a0 + 1, l0 = row7 * 2, l1 = l0 + 1;
        const uint8_t* kf_y = pr + kPKfY;
        if (bs > 9) {  // sub-8x8: a mode a 4x4 slot
          const int m0 = rd.tree(kModeTree,
                                 kf_y + (X.a_mode[a0] * 10 + X.l_mode[l0]) * 9);
          X.a_mode[a0] = m0;
          const int m1 = bs == 10 ? m0
                                  : rd.tree(kModeTree,
                                            kf_y + (X.a_mode[a1] * 10 + m0) * 9);
          X.l_mode[l0] = X.a_mode[a1] = m1;
          int m2 = m0;
          if (bs != 11) {
            m2 = rd.tree(kModeTree,
                         kf_y + (X.a_mode[a0] * 10 + X.l_mode[l1]) * 9);
            X.a_mode[a0] = m2;
          }
          const int m3 =
              bs == 11 ? m1
                       : bs == 10 ? m2
                                  : rd.tree(kModeTree,
                                            kf_y + (X.a_mode[a1] * 10 + m2) * 9);
          X.l_mode[l1] = X.a_mode[a1] = m3;
          modes[0] = m0;
          modes[1] = m1;
          modes[2] = m2;
          modes[3] = m3;
        } else {
          const int m = rd.tree(kModeTree,
                                kf_y + (X.a_mode[a0] * 10 + X.l_mode[l0]) * 9);
          fill8(X.a_mode + a0, m, kBwh[0][bs][0]);
          fill8(X.l_mode + l0, m, kBwh[0][bs][1]);
          modes[0] = modes[1] = modes[2] = modes[3] = m;
        }
        b_uvmode = rd.tree(kModeTree, pr + kPKfUv + modes[3] * 9);
      } else if (intra) {
        // an intra block of an inter frame: the frame's fixed tables, no
        // above/left coupling (vp9block.c:380-411)
        const uint8_t* yp0 = pr + kPYMode;
        if (bs > 9) {
          modes[0] = rd.tree(kModeTree, yp0);
          if (counting) ++cnt[kCntYMode + modes[0]];
          if (bs != 10) {
            modes[1] = rd.tree(kModeTree, yp0);
            if (counting) ++cnt[kCntYMode + modes[1]];
          } else {
            modes[1] = modes[0];
          }
          if (bs != 11) {
            modes[2] = rd.tree(kModeTree, yp0);
            if (counting) ++cnt[kCntYMode + modes[2]];
            if (bs != 10) {
              modes[3] = rd.tree(kModeTree, yp0);
              if (counting) ++cnt[kCntYMode + modes[3]];
            } else {
              modes[3] = modes[2];
            }
          } else {
            modes[2] = modes[0];
            modes[3] = modes[1];
          }
        } else {
          const int szg = kSzGroup[bs];
          const int m = rd.tree(kModeTree, pr + kPYMode + szg * 9);
          if (counting) ++cnt[kCntYMode + szg * 10 + m];
          modes[0] = modes[1] = modes[2] = modes[3] = m;
        }
        b_uvmode = rd.tree(kModeTree, pr + kPUvMode + modes[3] * 9);
        if (counting) ++cnt[kCntUvMode + modes[3] * 10 + b_uvmode];
        b_comp = 0;
      } else {
        // an inter block: compound flag and references
        // (vp9block.c:331-575), the whole-block inter mode, the
        // interpolation filter
        const int a_cm = X.a_comp[col], l_cm = X.l_comp[row7];
        const int a_rf = X.a_ref[col], l_rf = X.l_ref[row7];
        const int fixref = hf[kFixRef], var0 = hf[kVarRef0],
                  var1 = hf[kVarRef1];
        if (rs_en) {
          b_comp = 0;
          b_ref[0] = rs_val - 1;
          b_ref[1] = 0;
        } else {
          if (hf[kCompPred] == 2) {
            int ctx;
            if (have_a && have_l) {
              if (a_cm && l_cm)
                ctx = 4;
              else if (a_cm)
                ctx = 2 + (l_in == 1 || l_rf == fixref);
              else if (l_cm)
                ctx = 2 + (a_in == 1 || a_rf == fixref);
              else
                ctx = (a_in == 0 && a_rf == fixref) !=
                      (l_in == 0 && l_rf == fixref);
            } else if (have_a) {
              ctx = a_cm ? 3 : (a_in == 0 && a_rf == fixref);
            } else if (have_l) {
              ctx = l_cm ? 3 : (l_in == 0 && l_rf == fixref);
            } else {
              ctx = 1;
            }
            b_comp = rd.get(pr[kPComp + ctx]);
            if (counting) ++cnt[kCntComp + ctx * 2 + b_comp];
          } else {
            b_comp = hf[kCompPred] == 1;
          }
          if (b_comp) {
            const int ctx = comp_ref_ctx(have_a, have_l, a_in, l_in, a_cm,
                                         l_cm, a_rf, l_rf, fixref, var0, var1);
            const int bit = rd.get(pr[kPCompRef + ctx]);
            if (counting) ++cnt[kCntCompRef + ctx * 2 + bit];
            const int var = bit ? var1 : var0;
            const int fix_idx = hf[kSignBias0 + fixref];
            b_ref[fix_idx] = fixref;
            b_ref[!fix_idx] = var;
          } else {
            int ctx = single_ref_ctx1(have_a, have_l, a_in, l_in, a_cm, l_cm,
                                      a_rf, l_rf, fixref);
            const int bit0 = rd.get(pr[kPSingleRef + ctx * 2]);
            if (counting) ++cnt[kCntSingleRef + ctx * 4 + bit0];
            int ref0 = 0;
            if (bit0) {
              ctx = single_ref_ctx2(have_a, have_l, a_in, l_in, a_cm, l_cm,
                                    a_rf, l_rf, fixref);
              const int bit1 = rd.get(pr[kPSingleRef + ctx * 2 + 1]);
              if (counting) ++cnt[kCntSingleRef + ctx * 4 + 2 + bit1];
              ref0 = 1 + bit1;
            }
            b_ref[0] = ref0;
            b_ref[1] = 0;
          }
        }
        // the mode context reads into a 64x64 or 32x32 block
        const int moff = kModeOff[bs];
        b_modectx = kInterModeCtx[X.a_mode[col + moff]][X.l_mode[row7 + moff]];
        if (bs <= 9) {
          int m = 12;  // the seg SKIP feature: ZEROMV
          if (!forced_skip) {
            m = rd.tree(kInterModeTree, pr + kPMvMode + b_modectx * 3);
            if (counting) ++cnt[kCntMvMode + b_modectx * 4 + m - 10];
          }
          modes[0] = modes[1] = modes[2] = modes[3] = m;
        }
        if (hf[kFilterMode] == 4) {
          const bool ca = have_a && X.a_mode[col] >= 10;
          const bool cl = have_l && X.l_mode[row7] >= 10;
          const int af = X.a_filter[col], lf = X.l_filter[row7];
          const int ctx = ca ? (cl ? (af == lf ? lf : 3) : af) : cl ? lf : 3;
          b_filterid = rd.tree(kFilterTree, pr + kPFilter + ctx * 2);
          if (counting) ++cnt[kCntFilter + ctx * 3 + b_filterid];
          b_filter = kFilterLut[b_filterid];
        } else {
          b_filter = hf[kFilterMode];
          b_filterid = 0;
        }
      }
      // SET_CTXS splats
      fill8(X.a_skip + col, skip, bw4);
      fill8(X.a_txfm + col, tx, bw4);
      fill8(X.a_part + col, kActx[bs], bw4);
      fill8(X.l_skip + row7, skip, bh4);
      fill8(X.l_txfm + row7, tx, bh4);
      fill8(X.l_part + row7, kLctx[bs], bh4);
      if (inter && !intra) {
        // an inter block's mvs come next, a quantum a (sub-block,
        // reference)
        mv_k = mv_z = 0;
        phase = kMv;
        continue;
      }
      if (inter) set_ctxs_nonkf();
      // the record; then a skipped block zeroes its nnz contexts and
      // takes the next node, the others walk their coefficients
      if (!emit()) return kErrOverflow;
      if (skip) {
        zero_nnz();
        phase = kPart;
      } else {
        phase = kCoef;
      }
      continue;
    }

    if (phase == kMv) {
      // one (sub-block mv_k, reference mv_z) of an inter block
      const long long t0 = clock64();
      const bool sub8 = bs > 9;
      if (sub8 && mv_z == 0) {
        const int m = rd.tree(kInterModeTree, pr + kPMvMode + b_modectx * 3);
        if (counting) ++cnt[kCntMvMode + b_modectx * 4 + m - 10];
        modes[mv_k] = m;
      }
      const int mode_k = modes[mv_k];
      if (mode_k == 12) {
        // ZEROMV zeroes both references' mvs
        for (int z = 0; z < 2; ++z) b_mv[mv_k][z][0] = b_mv[mv_k][z][1] = 0;
      } else {
        const int2 p = find_ref_mv(P, G, X, b_mv, bs, br, bc, c0,
                                   b_ref[mv_z], mv_z, mode_k == 11,
                                   mode_k == 13 || !sub8 ? -1 : mv_k);
        int rx = p.x, ry = p.y;
        const bool hp = hf[kHighPrec] && abs(rx) < 64 && abs(ry) < 64;
        if ((mode_k == 13 || !sub8) && !hp) {
          // odd components rounded toward zero (vp9mvs.c:300-321)
          if (ry & 1) ry += ry < 0 ? 1 : -1;
          if (rx & 1) rx += rx < 0 ? 1 : -1;
        }
        if (mode_k == 13) {
          const int j = rd.tree(kMvJointTree, pr + kPMvJoint);
          if (counting) ++cnt[kCntMvJoint + j];
          if (j >= 2) ry += read_mv_comp(rd, pr, cnt, counting, 0, hp);
          if (j & 1) rx += read_mv_comp(rd, pr, cnt, counting, 1, hp);
        }
        b_mv[mv_k][mv_z][0] = rx;
        b_mv[mv_k][mv_z][1] = ry;
      }
      bool last = false;
      if (b_comp && mv_z == 0 && mode_k != 12) {
        mv_z = 1;
      } else {
        mv_z = 0;
        const int nk = mv_k + (bs == 10 ? 2 : 1);
        if (sub8 && nk <= (bs == 12 ? 3 : bs == 11 ? 1 : 2))
          mv_k = nk;
        else
          last = true;
      }
      if (last) {
        // the shared sub-block slots, then the deferred contexts and
        // grids
        int mv2[4][2][2], md2[4];
        for (int q = 0; q < 4; ++q) {
          const int s = kSubSrc[bs][q];
          md2[q] = modes[s];
          for (int z = 0; z < 2; ++z)
            for (int c = 0; c < 2; ++c) mv2[q][z][c] = b_mv[s][z][c];
        }
        for (int q = 0; q < 4; ++q) {
          modes[q] = md2[q];
          for (int z = 0; z < 2; ++z)
            for (int c = 0; c < 2; ++c) b_mv[q][z][c] = mv2[q][z][c];
        }
        set_ctxs_nonkf();
      }
      mv_cycles += clock64() - t0;
      if (last) {
        if (skip) {
          zero_nnz();
          if (!emit()) return kErrOverflow;
          phase = kPart;
        } else {
          phase = kCoef;
        }
      }
      continue;
    }

    // COEF: every transform block of the block, plane by plane, a
    // transform block's scan positions in one loop (vp9block.c:805-923)
    const int col = bc - c0, row7 = br & 7;
    int modeidx = 0;
    bool anycoef = false;
    for (int pl = 0; pl < 3; ++pl) {
      const bool is_y = pl == 0;
      const int sshp = is_y ? 0 : ss_h, ssvp = is_y ? 0 : ss_v;
      const int tx_p = is_y ? tx : uvtx;
      const int step = 1 << tx_p;
      const int end_x = min(2 * (cols - bc), kBwh[1][bs][0] * 2) >> sshp;
      const int end_y = min(2 * (rows - br), kBwh[1][bs][1] * 2) >> ssvp;
      uint8_t* a_arr = X.a_nnz[pl] + (is_y ? col * 2 : (col * 2) >> ss_h);
      uint8_t* l_arr = X.l_nnz[pl] + (is_y ? row7 * 2 : (row7 * 2) >> ss_v);
      if (step > 1) {
        // the nnz pre-merge once a plane: every step-anchor entry
        // becomes any() of its range
        for (int apos = 0; apos < end_x; apos += step) {
          int any = 0;
          for (int k = 0; k < step; ++k) any |= a_arr[apos + k];
          a_arr[apos] = any != 0;
        }
        for (int apos = 0; apos < end_y; apos += step) {
          int any = 0;
          for (int k = 0; k < step; ++k) any |= l_arr[apos + k];
          l_arr[apos] = any != 0;
        }
      }
      // the coefficient rows (tx * 2 + plane type) * 2 + is_inter
      const int prow = tx_p * 2 + !is_y;
      const int prow16 = prow * 2 + !intra;
      const int n_tot = 16 << (2 * tx_p);
      const int shift = 2 + tx_p;
      const int32_t* qs = qmul + seg_id * 4 + (is_y ? 0 : 2);
      const int Wp = is_y ? W64 : W64uv;
      const int cbase = is_y ? 0 : pl == 1 ? ysz : ysz + usz;
      const int ebase = is_y ? 0 : pl == 1 ? eysz : eysz + eusz;
      const int ec16 = is_y ? c16 : c16uv;
      const int py0 = is_y ? br * 8 : (br * 8) >> ss_v;
      const int px0 = is_y ? bc * 8 : (bc * 8) >> ss_h;
      const int ey0 = is_y ? br * 2 : (br * 2) >> ss_v;
      const int ex0 = is_y ? bc * 2 : (bc * 2) >> ss_h;
      const uint8_t* band_t = bands + tx_p * 1024;
      const uint8_t* coef_p = pr + (intra ? kPCoef : kPCoefI) + prow * 36 * 11;
      int* cnt_eob = cnt + kCntEob + prow16 * 36 * 2;
      int* cnt_coef = cnt + kCntCoef + prow16 * 36 * 3;
      for (int cy = 0; cy < end_y; cy += step) {
        for (int cx = 0; cx < end_x; cx += step) {
          const int txtp =
              is_y ? kItx[modes[bs > 9 && tx == 0 ? modeidx : 0]] : 0;
          const int scan_o = ((4 * P.lossless + tx_p) * 4 + txtp) * 1024;
          const int16_t* scan = scans + scan_o;
          const uint32_t* nb = nbs + scan_o;
          int nnz = a_arr[cx] + l_arr[cy];
          // the block's positions (every neighbour read is one of them)
          for (int k = 0; k < n_tot; k += 16)
            *reinterpret_cast<uint4*>(X.cache + k) = make_uint4(0, 0, 0, 0);
          const int cpos0 = cbase + (py0 + cy * 4) * Wp + px0 + cx * 4;
          int count = 0;
          bool skipeob = false;
          for (int i = 0; i < n_tot; ++i) {
            const int bc36 = band_t[i] * 6 + nnz;
            const uint8_t* tp = coef_p + bc36 * 11;
            if (!skipeob) {
              const int bb = rd.get(tp[0]);
              if (counting) ++cnt_eob[bc36 * 2 + bb];
              if (!bb) break;
            }
            const int sc = __ldg(scan + i);
            int tok, energy;
            if (!rd.get(tp[1])) {
              tok = energy = 0;
              skipeob = true;
            } else {
              skipeob = false;
              int val;
              tok = 2;
              if (!rd.get(tp[2])) {
                val = energy = tok = 1;
              } else if (!rd.get(tp[3])) {
                if (!rd.get(tp[4])) {
                  val = energy = 2;
                } else {
                  val = 3 + rd.get(tp[5]);
                  energy = 3;
                }
              } else {
                int cls;
                if (!rd.get(tp[6])) {
                  cls = 1 + rd.get(tp[7]);
                  energy = 4;
                } else {
                  energy = 5;
                  cls = !rd.get(tp[8]) ? 3 + rd.get(tp[9])
                                       : 5 + rd.get(tp[10]);
                }
                int eb = 0;
                if (cls == 6) {
                  for (int k = 0; k < cat6n; ++k)
                    eb = (eb << 1) | rd.get(cat6[k]);
                } else {
                  for (int k = 0; k < cls; ++k)
                    eb = (eb << 1) | rd.get(kCatProbs[cls][k]);
                }
                val = kCatBase[cls] + eb;
              }
              if (rd.get(128)) val = -val;
              // int32 products, as the reference's (they wrap); 32x32
              // coefficients halve toward zero
              int prod = static_cast<int>(static_cast<uint32_t>(val) *
                                          static_cast<uint32_t>(
                                              i == 0 ? qs[0] : qs[1]));
              if (tx_p == 3) prod = prod < 0 ? neg32(neg32(prod) >> 1)
                                             : prod >> 1;
              if (P.bpp == 8) prod = static_cast<int16_t>(prod);
              if (prod) {
                if (ncp >= ccap) return kErrOverflow;
                cpairs[ncp++] = make_int2(
                    cpos0 + (sc >> shift) * Wp + (sc & ((1 << shift) - 1)),
                    prod);
              }
            }
            if (counting) ++cnt_coef[bc36 * 3 + tok];
            X.cache[sc] = static_cast<uint8_t>(energy);
            count = i + 1;
            const uint32_t two = __ldg(nb + i);
            nnz = (1 + X.cache[two & 0xffff] + X.cache[two >> 16]) >> 1;
          }
          // the transform block's finish: the nnz writeback (the anchor
          // and its step range, cut at the visible edge), the eob pair
          const int nz = count > 0;
          fill8(a_arr + cx, nz, min(step, end_x - cx));
          fill8(l_arr + cy, nz, min(step, end_y - cy));
          if (count) {
            anycoef = true;
            if (nep >= ecap) return kErrOverflow;
            epairs[nep++] = make_int2(
                ebase + (ey0 + cy) * ec16 + ex0 + cx, count);
          }
          if (is_y) modeidx += step * step;
        }
      }
    }
    if (inter && !intra) {
      // an inter block of 8x8 or more without a coefficient is skipped
      // after the fact (vp9block.c:1310-1314); its record follows its
      // coefficients
      if (bs <= 9 && !anycoef) {
        skip = 1;
        fill8(X.a_skip + col, 1, min(cols - bc, int{kBwh[1][bs][0]}));
        fill8(X.l_skip + row7, 1, min(rows - br, int{kBwh[1][bs][1]}));
      }
      if (!emit()) return kErrOverflow;
    }
    phase = kPart;
  }
  return 0;
}

// One block of one warp a lane (a tile): the tables staged and the
// contexts zeroed by the warp, the walk by its thread 0, the counts
// written out by the warp.
__global__ void __launch_bounds__(32) passa_kernel(
    const uint8_t* __restrict__ packet, const int64_t* __restrict__ tile_off,
    const int32_t* __restrict__ tile_len, const int32_t* __restrict__ bounds,
    const int32_t* __restrict__ caps, const uint8_t* __restrict__ probs8,
    int nprobs, const int32_t* __restrict__ qmul_g,
    const int16_t* __restrict__ scans, const uint32_t* __restrict__ nbs,
    const uint8_t* __restrict__ bands_g, Grids G, Params P, int bmax,
    int cmax, int emax, int32_t* __restrict__ blocks,
    int32_t* __restrict__ nblk_o, int2* __restrict__ cpairs,
    int32_t* __restrict__ ncp_o, int2* __restrict__ epairs,
    int32_t* __restrict__ nep_o, int32_t* __restrict__ counts,
    int32_t* __restrict__ err_o, long long* __restrict__ stats) {
  __shared__ uint8_t pr[kProbBytesInter];
  __shared__ int32_t qmul[32];
  __shared__ uint8_t bands[4 * 1024];
  __shared__ int cnt[kCntTotal];
  __shared__ Ctx X;
  const int s = blockIdx.x, t = threadIdx.x;
  const uint8_t mode0 = P.inter ? 10 : 2;
  for (int j = t; j < nprobs; j += 32) pr[j] = probs8[j];
  if (t < 32) qmul[t] = qmul_g[t];
  for (int j = t; j < 4 * 1024; j += 32) bands[j] = bands_g[j];
  for (int j = t; j < kCntTotal; j += 32) cnt[j] = 0;
  for (int j = t; j < kAbove; j += 32) {
    X.a_part[j] = X.a_skip[j] = X.a_txfm[j] = 0;
    X.a_intra[j] = X.a_comp[j] = X.a_ref[j] = X.a_filter[j] =
        X.a_segpred[j] = 0;
  }
  for (int j = t; j < 2 * kAbove; j += 32) {
    X.a_mode[j] = mode0;
    X.a_nnz[0][j] = X.a_nnz[1][j] = X.a_nnz[2][j] = 0;
    X.a_mv[j][0][0] = X.a_mv[j][0][1] = X.a_mv[j][1][0] = X.a_mv[j][1][1] = 0;
  }
  if (t < 8) {
    X.l_part[t] = X.l_skip[t] = X.l_txfm[t] = 0;
    X.l_intra[t] = X.l_comp[t] = X.l_ref[t] = X.l_filter[t] =
        X.l_segpred[t] = 0;
  }
  if (t < 16) {
    X.l_mode[t] = mode0;
    X.l_nnz[0][t] = X.l_nnz[1][t] = X.l_nnz[2][t] = 0;
    X.l_mv[t][0][0] = X.l_mv[t][0][1] = X.l_mv[t][1][0] = X.l_mv[t][1][1] = 0;
  }
  __syncthreads();
  if (t == 0) {
    const int* b = bounds + s * 4;
    const int* cp = caps + s * 3;
    Bools rd;
    rd.n = 0;
    rd.w.init(packet, tile_off[s], tile_len[s]);
    int nblk = 0, ncp = 0, nep = 0, err;
    long long mv_cycles = 0;
    const long long t0 = clock64();
    if (rd.get(128)) {
      err = kErrMarker;
    } else {
      rd.n = 0;
      err = walk(P, rd, X, G, pr, qmul, bands, scans, nbs, cnt,
                 8ll * tile_len[s], b[0], b[1], b[2], b[3], cp[0], cp[1],
                 cp[2], blocks + static_cast<int64_t>(s) * bmax * 34,
                 cpairs + static_cast<int64_t>(s) * cmax,
                 epairs + static_cast<int64_t>(s) * emax, nblk, ncp, nep,
                 mv_cycles);
    }
    stats[s * 3 + 1] = clock64() - t0;
    stats[s * 3] = rd.n;
    stats[s * 3 + 2] = mv_cycles;
    nblk_o[s] = nblk;
    ncp_o[s] = ncp;
    nep_o[s] = nep;
    err_o[s] = err;
  }
  __syncthreads();
  for (int j = t; j < kCntTotal; j += 32)
    counts[static_cast<int64_t>(s) * kCntTotal + j] = cnt[j];
}

}  // namespace

extern "C" {

// The walk of S tiles of one frame, a block a tile, on `stream`.
// packet: the frame's bytes; tile_off int64 [S], tile_len int32 [S]:
// each tile's place in it; bounds int32 [S, 4] (r0, r1, c0, c1 in 8x8
// units, each tile at most kMaxTileB8 columns wide); caps int32 [S, 3]:
// the rows each lane may write (records, coefficient pairs, eob pairs),
// at most bmax, cmax and emax, the outputs' row strides; probs8, nprobs:
// ops/passa_device.py probs8's bytes (kProbBytes, or kProbBytesInter on
// an inter frame); qmul int32 [8, 4]; scans int16 [20, 1024]; nbs int16
// [20, 1024, 2]; bands uint8 [4, 1024]. On an inter frame (inter=1):
// hflags, a host array of prep_inter's 14 header flags; prev_mv int16
// [sb_rows * 8, sb_cols * 8, 2, 2], prev_ref int8 [.., 2], prev_seg
// uint8 [sb_rows * 8, sb_cols * 8]: the previous frame's grids, null
// where hflags say the frame reads none; grid_mv int16 [sb_rows * 8,
// sb_cols * 8, 2, 2] and grid_ref int8 [sb_rows * 8, sb_cols * 8, 2]:
// the frame's, filled with 0 and -1 before the launch (all may be null
// on an intra frame). Outputs: blocks int32 [S, bmax, 34], cpairs and
// epairs int32 [S, cmax or emax, 2], nblk, ncp, nep and err int32 [S],
// counts int32 [S, kCntTotal], stats int64 [S, 3] (bools after the
// marker, clock64 cycles of the walk and of its MV quanta), the grids.
int passa_walk(const uint8_t* packet, const int64_t* tile_off,
               const int32_t* tile_len, const int32_t* bounds,
               const int32_t* caps, const uint8_t* probs8,
               const int32_t* qmul, const int16_t* scans, const int16_t* nbs,
               const uint8_t* bands, const int16_t* prev_mv,
               const int8_t* prev_ref, const uint8_t* prev_seg,
               const int32_t* hflags, int nprobs, int S, int rows, int cols,
               int sb_cols, int sb_rows, int txfmmode, int seg, int lossless,
               int bpp, int ss_h, int ss_v, int want_counts, int inter,
               int bmax, int cmax, int emax, int32_t* blocks, int32_t* nblk,
               int32_t* cpairs, int32_t* ncp, int32_t* epairs, int32_t* nep,
               int32_t* counts, int32_t* err, long long* stats,
               int16_t* grid_mv, int8_t* grid_ref, cudaStream_t stream) {
  if (S <= 0 || bmax < 0 || cmax < 0 || emax < 0 ||
      (bpp != 8 && bpp != 10 && bpp != 12) ||
      nprobs != (inter ? kProbBytesInter : kProbBytes) ||
      (inter && (!hflags || !grid_mv || !grid_ref)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P{rows, cols, sb_cols, sb_rows, txfmmode, seg, lossless, bpp,
           ss_h, ss_v, want_counts, inter, {}};
  if (inter) {
    for (int k = 0; k < kNumHFlags; ++k) P.hf[k] = hflags[k];
    if ((P.hf[kUsePrev] && (!prev_mv || !prev_ref)) ||
        (P.hf[kHavePseg] && !prev_seg))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grids G{grid_mv, grid_ref, prev_mv, prev_ref, prev_seg, sb_cols * 8};
  passa_kernel<<<S, 32, 0, stream>>>(
      packet, tile_off, tile_len, bounds, caps, probs8, nprobs, qmul, scans,
      reinterpret_cast<const uint32_t*>(nbs), bands, G, P, bmax, cmax, emax,
      blocks, nblk, reinterpret_cast<int2*>(cpairs), ncp,
      reinterpret_cast<int2*>(epairs), nep, counts, err, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
