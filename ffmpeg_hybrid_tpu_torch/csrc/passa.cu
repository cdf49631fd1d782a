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
// vp9.c:1342) is a block of one warp. Its thread 0 walks the phase
// machine of the JAX walk (PART, MODE, COEF, DONE, MV), a quantum a turn,
// where a COEF quantum walks every transform block of a block and an MV
// quantum one (sub-block, reference) of an inter block. An MV quantum is
// the warp's: after a __syncwarp and thread 0's broadcast of the phase
// and the scan's arguments, each of the 32 find_ref_mvs candidate slots
// is a lane's, loaded and classified by code every lane runs (one round
// of loads) and selected in slot order by ballots and shuffles; the
// block's context splats and grid cells are then a lane's each, and a
// __syncwarp hands them back to thread 0. Thread 0 alone keeps the state
// in registers and shared memory, so no lane reads what another may
// still be writing. The above contexts of the tile's columns, the left
// contexts, the partition stack, the block's record, the coefficient
// cache, the probability tables and the symbol counts sit in dynamic
// shared memory (Smem, about 60 KB; one block an SM). Counting is a
// template parameter (kCount), so a frame without backward adaptation
// pays for no count.
//
// The token loop (measured first by the kSec instance's sections: it
// takes over 97% of an intra frame's cycles). Each scan position's packed
// word (its scan index and the two neighbours its context reads,
// ops/passa_device.py packed_scans) and each (band, context) row of
// coefficient probabilities padded to 16 bytes (coef16) are staged in
// shared memory once a launch; a position takes its row in one 128-bit
// load and its bools their probabilities from registers. The loop is
// pipelined: a position's neighbours' energies are loaded a position
// ahead (the two positions in flight patched from registers), and the
// next position's row is loaded before the current token's bools as if
// the token were ZERO, corrected under its sign and extra bits when it is
// not. A neighbour is always an earlier scan position of the same
// transform block (tests/test_torch_passa_device.py holds the tables to
// it), so the energy cache is never zeroed. Most positions are a ZERO
// after a ZERO (one bool): a run of them takes its own loop, four
// positions a lookahead fill and no branch taken but the loop's; a
// nonzero token's tree reads nodes 0-2 straight, then a machine of a
// bool a node whose next probability is selected, not branched to. Bools
// come from rac_window.cuh's Window (the byte-fed decoder of the stream
// kernels), started at the tile's first byte; the lane reads the marker
// bool itself. Outside the token loop a fill precedes each bool, and a
// tree symbol walks its tree table in constant memory, a bool a node,
// loading both children's probabilities while the node decodes: the
// walk's trees change their probabilities symbol by symbol (the
// context-coupled mode trees), so TreeWalk's staged transition tables do
// not fit them.
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
// drops a column left of the tile), in a cell its own warp wrote in an
// earlier quantum. The previous frame's grids and segmentation map are
// read-only inputs. MVs are int16 in the grid and the above/left
// contexts, as the reference's VP9mv.
//
// What bounds it. Every bool depends on the one before it (range and
// value carry), and so does every context decision: a lane is one serial
// chain, and the launch takes as long as its longest lane. The bytes
// moved (the tile bytes read, the records, pairs, counts and grids
// written) are far below what the card moves in that time, and so are
// the operations. Only more lanes than tiles would shorten it (later
// work). The instance with kSec times the walk's sections (Sec) for
// measurement.
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

// The coefficient token tree (vp9block.c decode_coeffs_b) as a machine
// of one bool a step: node k (0-10) reads probability k of its (band,
// context) row; its children, 5 bits each (kTokChild0 for a 0 bool,
// kTokChild1 for a 1), are nodes below 16 and leaves 16 + t, t = 0-10
// the tokens ZERO, ONE, TWO, THREE, FOUR, CAT1-CAT6 and 11 the end of
// block (the token loop reads nodes 0-2 straight and runs the machine
// from node 3). kTokEnergy: a token's energy (3 bits each).
constexpr uint64_t tok_pack(const int (&c)[11]) {
  uint64_t v = 0;
  for (int k = 10; k >= 0; --k) v = v << 5 | static_cast<uint64_t>(c[k]);
  return v;
}
constexpr int kTokEob = 11;
constexpr int kTokC0[11] = {16 + kTokEob, 16, 17, 4, 18, 19, 7, 21, 9, 23, 25};
constexpr int kTokC1[11] = {1, 2, 3, 6, 5, 20, 8, 22, 10, 24, 26};
constexpr uint64_t kTokChild0 = tok_pack(kTokC0);
constexpr uint64_t kTokChild1 = tok_pack(kTokC1);
constexpr uint64_t kTokEnergy = 0x16db23688ull;

// the band of positions 0-20 (BAND_COUNTS: 1, 2, 3 and 4 from positions
// 1, 3, 6 and 10), 3 bits each; band 5 starts at position 13 of a 4x4
// transform block and at 21 of the others (band5 in the token loop)
constexpr uint64_t kBands = 0x492492491b6d2448ull;

// probability k (0-10) of a padded row
__device__ __forceinline__ int row_prob(const uint4& r, int k) {
  const uint32_t lo = __byte_perm(r.x, r.y, k & 7);
  return static_cast<int>((k < 8 ? lo : __byte_perm(r.z, 0, k & 7)) & 0xff);
}

// the packed scan words staged a launch (ops/passa_device.py
// packed_scans: the distinct (scan, neighbour) rows, 2,032 words, and three
// words of padding read past a row's last position)
constexpr int kScanWords = 2048;
constexpr int kScanRows = 20;
// coefficient probability rows padded to 16 bytes: [intra, inter block]
// [tx * 2 + plane type][band * 6 + context]
constexpr int kCoefRows = 576;

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

// A lane's decoder: a Window over its tile and the bools it read. get
// tops the lookahead up before its bool (Window::fill, which loads a word
// once every 32 bits); get_filled trusts the caller's fill (the 28 bits a
// fill leaves cover 4 bools).
struct Bools {
  Window w;
  int n;  // bools read

  __device__ __forceinline__ int get(int prob) {
    w.fill();
    return get_filled(prob);
  }
  __device__ __forceinline__ int get_filled(int prob) {
    ++n;
    return w.get(prob, 256 - prob);
  }
  // vp89_rac_get_tree over a tree table in constant memory; both
  // children's probabilities are loaded while a node's bool decodes
  template <int N>
  __device__ __forceinline__ int tree(const int8_t (&t)[N][2],
                                      const uint8_t* probs) {
    int i = 0, p = probs[0];
    for (;;) {
      const int c0 = t[i][0], c1 = t[i][1];
      const int p0 = probs[max(c0, 0)], p1 = probs[max(c1, 0)];
      const bool bit = get(p);
      const int nxt = bit ? c1 : c0;
      if (nxt <= 0) return -nxt;
      p = bit ? p1 : p0;
      i = nxt;
    }
  }
  // bits consumed into the value since the tile's first byte
  __device__ __forceinline__ long long consumed() const {
    return 32ll * w.k - w.count;
  }
};

// the lane's state: above contexts (tile-relative columns), left
// contexts (the superblock row's), the partition stack (a node a level:
// bl, row, col, bp, items emitted), the current block's record (the
// native 34 columns: its modes at 9, its mvs at 18 as [4][2][2]; the
// fields a block does not write keep the last block's, as the
// reference's one Block) and the coefficient cache; an inter frame's
// contexts (its mode context takes one entry an 8x8 column, the
// keyframe's two), and its mv contexts, a 4x4 column's or row's two
// references' (x, y) packed as int16 pairs
struct Ctx {
  __align__(8) uint32_t a_mv[2 * kAbove][2];
  __align__(8) uint32_t l_mv[16][2];
  __align__(8) int rec[34];
  int stk_bl[4], stk_r[4], stk_c[4], stk_bp[4], stk_em[4];
  // byte contexts at 16-byte boundaries: fillb stores a block's splat
  // whole
  __align__(16) uint8_t a_part[kAbove];
  __align__(16) uint8_t a_skip[kAbove];
  __align__(16) uint8_t a_txfm[kAbove];
  __align__(16) uint8_t a_mode[2 * kAbove];
  __align__(16) uint8_t a_nnz[3][2 * kAbove];
  __align__(16) uint8_t a_intra[kAbove];
  __align__(16) uint8_t a_comp[kAbove];
  __align__(16) uint8_t a_ref[kAbove];
  __align__(16) uint8_t a_filter[kAbove];
  __align__(16) uint8_t a_segpred[kAbove];
  __align__(16) uint8_t l_part[16];
  __align__(16) uint8_t l_skip[16];
  __align__(16) uint8_t l_txfm[16];
  __align__(16) uint8_t l_mode[16];
  __align__(16) uint8_t l_nnz[3][16];
  __align__(16) uint8_t l_intra[16];
  __align__(16) uint8_t l_comp[16];
  __align__(16) uint8_t l_ref[16];
  __align__(16) uint8_t l_filter[16];
  __align__(16) uint8_t l_segpred[16];
  uint8_t cache[1024];
};

// The block's dynamic shared memory.
struct Smem {
  uint4 coef16[kCoefRows];
  uint32_t scanw[kScanWords];
  int cnt[kCntTotal];
  int scan_off[kScanRows];
  int32_t qmul[32];
  long long sec[16];
  int8_t mvref[13][8][2];
  uint8_t pr[kProbBytesInter];
  Ctx X;
};

// an inter frame's grids, all in the host layout (C8 cells a row): its
// own, a cell's two references' mvs one 8-byte word and its two
// references one 16-bit word, and the previous frame's (read-only; null
// where the frame reads none)
struct Grids {
  uint2* mv;                          // [R8 * C8] ([2][2] int16)
  uint16_t* ref;                      // [R8 * C8] ([2] int8)
  const uint2* __restrict__ pmv;      // [R8 * C8]
  const uint16_t* __restrict__ pref;  // [R8 * C8]
  const uint8_t* __restrict__ pseg;   // [R8 * C8]
  int C8;
};

// The debug sections of a lane (passa_walk's `sections`, int64 [S,
// kNumSec]): clock64 cycles of the PART quanta, the MODE quanta, the MV
// candidate scans (find_ref_mvs without a bool), the rest of the MV
// quanta, the COEF token loops outside and inside the runs of ZERO
// tokens, the rest of the COEF quanta, the records' emit and the warp's
// handovers (the __syncwarp and broadcasts around an MV quantum); then
// the bools read in PART, MODE, MV and COEF, the MV scans and the
// positions of the ZERO runs. Only the kernel instance with kSec reads
// the clock.
enum Sec {
  kSecPart, kSecMode, kSecMvScan, kSecMv, kSecCoefLoop, kSecCoefRun,
  kSecCoef, kSecEmit, kSecSync, kSecBPart, kSecBMode, kSecBMv, kSecBCoef,
  kSecScans, kSecRunPos, kNumSec
};

// The sections' sums lie in shared memory (v), lane 0's to update, so
// that a section chosen at run time costs no local memory.
template <bool kOn>
struct Sections {
  long long* v;
  long long last, bools;
  bool lead;

  __device__ __forceinline__ void start(long long* sums, long long n,
                                        bool is_lead) {
    if constexpr (kOn) {
      v = sums;
      lead = is_lead;
      if (lead)
        for (int k = 0; k < kNumSec; ++k) v[k] = 0;
      bools = n;
      last = clock64();
    }
  }
  // the cycles and bools since the last mark go to section s
  __device__ __forceinline__ void mark(int s, long long n) {
    if constexpr (kOn) {
      const long long t = clock64();
      if (lead) {
        v[s] += t - last;
        v[s == kSecPart                    ? kSecBPart
          : s == kSecMode || s == kSecEmit ? kSecBMode
          : s <= kSecMv || s == kSecSync   ? kSecBMv
                                           : kSecBCoef] += n - bools;
      }
      last = t;
      bools = n;
    }
  }
  __device__ __forceinline__ void count(int s, int n = 1) {
    if constexpr (kOn)
      if (lead) v[s] += n;
  }
};

// -x as a wrapping int32
__device__ __forceinline__ int neg32(int x) {
  return static_cast<int>(0u - static_cast<uint32_t>(x));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// an mv's (x, y) as an int16 pair and back
__device__ __forceinline__ uint32_t pack_mv(int x, int y) {
  return (static_cast<uint32_t>(x) & 0xffffu) |
         (static_cast<uint32_t>(y) << 16);
}
__device__ __forceinline__ int mv_x(uint32_t m) {
  return static_cast<int16_t>(m & 0xffffu);
}
__device__ __forceinline__ int mv_y(uint32_t m) {
  return static_cast<int16_t>(m >> 16);
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
template <bool kCount>
__device__ int read_mv_comp(Bools& rd, const uint8_t* pr, int* cnt, int comp,
                            bool hp) {
  const int sign = rd.get(pr[kPMvSign + comp]);
  const int cl = rd.tree(kMvClassTree, pr + kPMvClasses + comp * 10);
  if (kCount) {
    ++cnt[kCntMvSign + comp * 2 + sign];
    ++cnt[kCntMvClasses + comp * 11 + cl];
  }
  int n;
  if (cl) {
    n = 0;
    for (int m = 0; m < cl; ++m) {
      const int bit = rd.get(pr[kPMvBits + comp * 10 + m]);
      n |= bit << m;
      if (kCount) ++cnt[kCntMvBits + comp * 20 + m * 2 + bit];
    }
    const int fp = rd.tree(kMvFpTree, pr + kPMvFp + comp * 3);
    const int hpb = hp ? rd.get(pr[kPMvHp + comp]) : 1;
    n = ((n << 3) | (fp << 1) | hpb) + (8 << cl);
    if (kCount) {
      ++cnt[kCntMvFp + comp * 4 + fp];
      ++cnt[kCntMvHp + comp * 2 + hpb];
    }
  } else {
    const int n0 = rd.get(pr[kPMvClass0 + comp]);
    const int fp = rd.tree(kMvFpTree, pr + kPMvC0Fp + (comp * 2 + n0) * 3);
    const int hpb = hp ? rd.get(pr[kPMvC0Hp + comp]) : 1;
    n = (n0 << 3) | (fp << 1) | hpb;
    if (kCount) {
      ++cnt[kCntMvClass0 + comp * 2 + n0];
      ++cnt[kCntMvClass0Fp + comp * 8 + n0 * 4 + fp];
      ++cnt[kCntMvClass0Hp + comp * 2 + hpb];
    }
  }
  return sign ? -(n + 1) : n + 1;
}

// find_ref_mvs (vp9mvs.c:37-234) over the 32 candidate slots, a slot a
// lane (kind, par: the lane's kSlotKind and kSlotPar): the predicted
// (x, y) of reference `refz` (mv slot z of the block's earlier
// sub-blocks), NEARMV's second distinct candidate when idxn, for
// sub-block sbp (-1: the whole block). Each lane loads and classifies
// its candidate; the serial scan's choice is then read off the lanes in
// slot order by ballots, with the reference decoder's quirks: RETURN_MV's
// two-stage compare past the first sub-block and its zero return
// (vp9mvs.c:95-124), the different-reference second mv taken whether or
// not the first was (vp9mvs.c:206-208). ops/passa_device.py's
// _walk_lane has the serial scan; tests/test_torch_passa_inter.py holds
// a model of this selection to it.
__device__ int2 find_ref_mv(const Params& P, const Grids& G, const Smem& M,
                            int lane, int kind, int par, int sbmask, int bs,
                            int br, int bc, int c0, int refz, int z,
                            bool idxn, int sbp) {
  const Ctx& X = M.X;
  const int minx = -(128 + bc * 64), miny = -(128 + br * 64);
  const int maxx = 128 + (P.cols - bc - kBwh[1][bs][0]) * 64;
  const int maxy = 128 + (P.rows - br - kBwh[1][bs][1]) * 64;
  const int sbc = clampi(sbp, 0, 3), col = bc - c0, row7 = br & 7;
  // each lane's candidate, in code that every lane runs (one round of
  // loads for the warp): kind 0 an earlier sub-block's mv, 1/2 the
  // above/left mv context, 3/5/6 a grid cell, 4/7/8 the previous
  // frame's cell at the block
  const bool direct = kind == 0, ctx = kind == 1 || kind == 2;
  const bool prev = kind == 4 || kind == 7 || kind == 8;
  const bool first = kind == 5 || kind == 7, second = kind == 6 || kind == 8;
  const int nc = bc + M.mvref[bs][par][0], nr = br + M.mvref[bs][par][1];
  const int gi = kind == 1  ? (br - 1) * G.C8 + bc
                 : kind == 2 ? br * G.C8 + bc - 1
                 : prev      ? br * G.C8 + bc
                             : nr * G.C8 + nc;
  const bool have =
      direct ? (par == 0 ? sbp >= 1 : sbp == 3)
      : ctx  ? sbp >= 0 && (kind == 1 ? br > 0 : bc > c0)
      : prev ? P.hf[kUsePrev] != 0
             : !(kind == 3 && sbp >= 0 && par < 2) && nc >= c0 &&
                   nc < P.cols && nr >= 0 && nr < P.rows;
  const uint16_t* refs = prev ? G.pref : G.ref;
  const uint2* mvs = prev ? G.pmv : G.mv;
  uint32_t g = 0xffffu;
  uint2 v = make_uint2(0, 0);
  if (have && !direct) g = refs[gi];
  if (have && !direct && !ctx) v = mvs[gi];
  const int g0 = static_cast<int8_t>(g & 0xff);
  const int g1 = static_cast<int8_t>(g >> 8);
  const uint32_t* cm = kind == 1 ? X.a_mv[2 * col + (sbc & 1)]
                                 : X.l_mv[2 * row7 + (sbc >> 1)];
  const uint32_t cmv = cm[g0 != refz];
  const int* dmv = X.rec + 18 + (par & 3) * 4 + z * 2;
  const bool valid =
      have && (direct || (first    ? g0 >= 0 && g0 != refz
                          : second ? g1 >= 0 && g1 != refz && v.x != v.y
                                   : g0 == refz || g1 == refz));
  const uint32_t m = ctx      ? cmv
                     : first  ? v.x
                     : second ? v.y
                              : (g0 == refz ? v.x : v.y);
  const int other = first ? g0 : second ? g1 : -1;
  int vx = direct ? dmv[0] : mv_x(m), vy = direct ? dmv[1] : mv_y(m);
  if (valid && other >= 0 &&
      ((sbmask >> other) & 1) != ((sbmask >> refz) & 1)) {
    vx = -vx;
    vy = -vy;
  }
  // RETURN_MV's candidates are clamped, RETURN_DIRECT_MV's (kind 0,
  // lanes 0-2) are not
  const int cx = clampi(vx, minx, maxx), cy = clampi(vy, miny, maxy);
  constexpr unsigned kAll = 0xffffffffu;
  const int2 zero = make_int2(clampi(0, minx, maxx), clampi(0, miny, maxy));
  const unsigned V = __ballot_sync(kAll, valid);
  if (sbp <= 0) {
    // no direct candidate: the first, or NEARMV's first that differs
    if (!V) return zero;
    const int f = __ffs(V) - 1;
    if (!idxn)
      return make_int2(__shfl_sync(kAll, cx, f), __shfl_sync(kAll, cy, f));
    const int mx = __shfl_sync(kAll, vx, f), my = __shfl_sync(kAll, vy, f);
    const unsigned V2 =
        __ballot_sync(kAll, valid && lane > f && (vx != mx || vy != my));
    if (!V2) return zero;
    const int k = __ffs(V2) - 1;
    return make_int2(__shfl_sync(kAll, cx, k), __shfl_sync(kAll, cy, k));
  }
  if (!idxn) {
    // the first candidate, direct or clamped
    if (!V) return zero;
    const int f = __ffs(V) - 1;
    const int rx = __shfl_sync(kAll, f < 3 ? vx : cx, f);
    const int ry = __shfl_sync(kAll, f < 3 ? vy : cy, f);
    return make_int2(rx, ry);
  }
  // NEARMV past the first sub-block: the direct candidates' first (m)
  // and the first that differs from it; then the clamped ones against m
  // and the first of them (m8) in two stages
  const unsigned D = V & 7u, C = V & ~7u;
  int mx = 0, my = 0;
  if (D) {
    const int d1 = __ffs(D) - 1;
    mx = __shfl_sync(kAll, vx, d1);
    my = __shfl_sync(kAll, vy, d1);
    const unsigned D2 = __ballot_sync(
        kAll, valid && lane < 3 && lane > d1 && (vx != mx || vy != my));
    if (D2) {
      const int k = __ffs(D2) - 1;
      return make_int2(__shfl_sync(kAll, vx, k), __shfl_sync(kAll, vy, k));
    }
  }
  if (!C) return zero;
  const int k1 = __ffs(C) - 1;
  const int c1x = __shfl_sync(kAll, cx, k1), c1y = __shfl_sync(kAll, cy, k1);
  if (!D || c1x != mx || c1y != my) return make_int2(c1x, c1y);
  const int m8x = __shfl_sync(kAll, vx, k1), m8y = __shfl_sync(kAll, vy, k1);
  const unsigned C2 = __ballot_sync(
      kAll, valid && lane > k1 && (vx != m8x || vy != m8y));
  if (!C2) return zero;
  const int k = __ffs(C2) - 1;
  const int kx = __shfl_sync(kAll, cx, k), ky = __shfl_sync(kAll, cy, k);
  return kx != mx || ky != my ? make_int2(kx, ky) : make_int2(0, 0);
}

// n bytes from p set to v by one thread: n a power of two up to 16 at a
// multiple of n (a block's splat of its own width, which VP9's aligned
// partitions give) in one predicated store, no branch; another n (a
// block cut at the frame's edge) byte by byte
__device__ __forceinline__ void fillb(uint8_t* p, int v, int n) {
  const uint32_t b4 = static_cast<uint8_t>(v) * 0x01010101u;
  if (n & (n - 1)) {
    for (int k = 0; k < n; ++k) p[k] = static_cast<uint8_t>(v);
    return;
  }
  if (n == 1) *p = static_cast<uint8_t>(v);
  if (n == 2) *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(b4);
  if (n == 4) *reinterpret_cast<uint32_t*>(p) = b4;
  if (n == 8) *reinterpret_cast<uint2*>(p) = make_uint2(b4, b4);
  if (n == 16) *reinterpret_cast<uint4*>(p) = make_uint4(b4, b4, b4, b4);
}

// a block as the warp sees it where it works on it together
struct BlockPos {
  int bs, br, bc, intra, comp, ref0, ref1, filterid;
};

// The non-keyframe SET_CTXS and the write-back of the block's mvs and
// references into the frame grid (vp9block.c:682-801), the block's modes
// and mvs from its record: with kWarp an entry or a cell a lane (l the
// lane: every splat is at most 16 entries, the grid's 64 cells two a
// lane), else lane 0 alone (l = 0).
template <bool kWarp>
__device__ void set_ctxs_nonkf(const Params& P, const Grids& G, Ctx& X,
                               int c0, const BlockPos& b, int l) {
  const int col = b.bc - c0, row7 = b.br & 7;
  const int nw = kBwh[1][b.bs][0], nh = kBwh[1][b.bs][1];
  const int w4c = min(P.cols - b.bc, nw), h4c = min(P.rows - b.br, nh);
  const int m3 = X.rec[12];
  const int* hf = P.hf;
  const bool inter = !b.intra, filt = inter && hf[kFilterMode] == 4;
  const int vref = b.comp ? (hf[kSignBias0 + hf[kVarRef0]] ? b.ref1 : b.ref0)
                          : b.ref0;
  auto splat = [&](uint8_t* p, int v, int n) {
    if (kWarp) {
      if (l < n) p[l] = static_cast<uint8_t>(v);
    } else {
      fillb(p, v, n);
    }
  };
  splat(X.a_intra + col, b.intra, nw);
  splat(X.a_comp + col, b.comp, nw);
  splat(X.a_mode + col, m3, nw);
  splat(X.l_intra + row7, b.intra, nh);
  splat(X.l_comp + row7, b.comp, nh);
  splat(X.l_mode + row7, m3, nh);
  uint2 cell = make_uint2(0, 0);
  if (inter) {
    splat(X.a_ref + col, vref, nw);
    splat(X.l_ref + row7, vref, nh);
    if (filt) {
      splat(X.a_filter + col, b.filterid, nw);
      splat(X.l_filter + row7, b.filterid, nh);
    }
    const int* m = X.rec + 18;  // [4][2][2]
    auto mvq = [&](int q) {
      return make_uint2(pack_mv(m[q * 4], m[q * 4 + 1]),
                        pack_mv(m[q * 4 + 2], m[q * 4 + 3]));
    };
    const uint2 m3v = mvq(3);
    if (b.bs > 9) {
      if (l == 0) {
        *reinterpret_cast<uint2*>(X.l_mv[2 * row7]) = mvq(1);
        *reinterpret_cast<uint2*>(X.l_mv[2 * row7 + 1]) = m3v;
        *reinterpret_cast<uint2*>(X.a_mv[2 * col]) = mvq(2);
        *reinterpret_cast<uint2*>(X.a_mv[2 * col + 1]) = m3v;
      }
    } else if (kWarp) {
      if (l < 2 * w4c) *reinterpret_cast<uint2*>(X.a_mv[2 * col + l]) = m3v;
      if (l < 2 * h4c) *reinterpret_cast<uint2*>(X.l_mv[2 * row7 + l]) = m3v;
    } else {
      for (int k = 0; k < 2 * w4c; ++k)
        *reinterpret_cast<uint2*>(X.a_mv[2 * col + k]) = m3v;
      for (int k = 0; k < 2 * h4c; ++k)
        *reinterpret_cast<uint2*>(X.l_mv[2 * row7 + k]) = m3v;
    }
    // the grid keeps a single-reference block's second mv at 0
    cell = make_uint2(m3v.x, b.comp ? m3v.y : 0u);
  }
  const uint32_t g0 = static_cast<uint8_t>(inter ? b.ref0 : -1);
  const uint32_t g1 = static_cast<uint8_t>(inter && b.comp ? b.ref1 : -1);
  const uint16_t gref = static_cast<uint16_t>(g0 | g1 << 8);
  auto put = [&](int k) {
    const int y = k >> 3, x = k & 7;
    if (y < h4c && x < w4c) {
      const int gi = (b.br + y) * G.C8 + b.bc + x;
      G.ref[gi] = gref;
      G.mv[gi] = cell;
    }
  };
  if (kWarp) {
    put(l);
    put(l + 32);
  } else {
    for (int k = 0; k < h4c * 8; ++k) put(k);
  }
}

// The walk of one lane by its warp: the phase machine of
// ops/passa_device.py _walk_lane. Lane 0 walks the PART, MODE and COEF
// quanta; an MV quantum is the warp's (after a __syncwarp and lane 0's
// phase broadcast): the candidate scan a slot a lane, the block's
// contexts and grid cells a lane each.
// Returns lane 0's err word; mv_cycles gets the clock64 cycles of the
// lane's MV quanta, sec the debug sections. kCount: the frame's symbols
// are counted (want_counts).
template <bool kSec, bool kCount>
__device__ int walk(const Params& P, Bools& rd, Smem& M, const Grids& G,
                    int lane, int slot_kind, int slot_par, long long tile_bits,
                    int r0, int r1, int c0, int c1, int bcap, int ccap,
                    int ecap, int32_t* __restrict__ blocks,
                    int2* __restrict__ cpairs, int2* __restrict__ epairs,
                    int& nblk, int& ncp, int& nep, long long& mv_cycles,
                    Sections<kSec>& sec) {
  constexpr unsigned kAll = 0xffffffffu;
  Ctx& X = M.X;
  const uint8_t* const pr = M.pr;
  int* const cnt = M.cnt;
  const int rows = P.rows, cols = P.cols, ss_h = P.ss_h, ss_v = P.ss_v;
  const int W64 = P.sb_cols * 64, W64uv = W64 >> ss_h;
  const int c16 = P.sb_cols * 16, c16uv = c16 >> ss_h;
  const int H64 = P.sb_rows * 64;
  const int ysz = H64 * W64, usz = (H64 >> ss_v) * W64uv;
  const int eysz = (H64 / 4) * c16, eusz = ((H64 >> ss_v) / 4) * c16uv;
  const bool lead = lane == 0;
  const bool inter = P.inter != 0;
  const int* const hf = P.hf;
  const int sbmask = hf[kSignBias0] | hf[kSignBias1] << 1 | hf[kSignBias2] << 2;
  const int cat6n = P.bpp + 6;
  const uint8_t* cat6 = kCat6 + (12 - P.bpp);
  const int mode0 = inter ? 10 : 2;

  int phase = kPart, err = 0;
  int sb_r = r0, sb_c = c0;
  int* const stk_bl = X.stk_bl;
  int* const stk_r = X.stk_r;
  int* const stk_c = X.stk_c;
  int* const stk_bp = X.stk_bp;
  int* const stk_em = X.stk_em;
  int sp = 0;
  // the current block (lane 0's); its modes and mvs lie in its record
  // (X.rec), the rest in these registers, and the fields a block does
  // not write keep the last block's values, as the reference's one Block
  int br = 0, bc = 0, bs = 0, seg_id = 0, skip = 0, intra = 1, tx = 0,
      uvtx = 0;
  int* const modes = X.rec + 9;
  int(*const bmv)[2][2] = reinterpret_cast<int(*)[2][2]>(X.rec + 18);
  int b_uvmode = 0, b_comp = 0, b_ref0 = 0, b_ref1 = 0, b_filter = 0,
      b_filterid = 0, b_modectx = 0;
  int mv_k = 0, mv_z = 0;
  long long mv_t0 = 0;
  int cur = kSecPart;  // the section of the quantum under way

  // the record (the native 34-column layout) in 8-byte stores; false
  // when the lane's rows are full
  auto emit = [&]() -> bool {
    sec.mark(cur, rd.n);
    if (nblk >= bcap) return false;
    int2* out =
        reinterpret_cast<int2*>(blocks + static_cast<int64_t>(nblk++) * 34);
    out[0] = make_int2(br, bc);
    out[1] = make_int2(c0, bs);
    out[2] = make_int2(seg_id, skip);
    out[3] = make_int2(intra, tx);
    out[4] = make_int2(uvtx, modes[0]);
    out[5] = make_int2(modes[1], modes[2]);
    out[6] = make_int2(modes[3], b_uvmode);
    if (inter) {
      out[7] = make_int2(b_comp, b_ref0);
      out[8] = make_int2(b_ref1, b_filter);
      const int2* m = reinterpret_cast<const int2*>(X.rec + 18);
#pragma unroll
      for (int k = 0; k < 8; ++k) out[9 + k] = m[k];
    } else {
#pragma unroll
      for (int k = 7; k < 17; ++k) out[k] = make_int2(0, 0);
    }
    sec.mark(kSecEmit, rd.n);
    return true;
  };
  // a skipped block zeroes its nnz contexts (vp9block.c:1316)
  auto zero_nnz = [&]() {
    const int col = bc - c0, row7 = br & 7;
    const int bw4 = kBwh[1][bs][0], bh4 = kBwh[1][bs][1];
    fillb(X.a_nnz[0] + col * 2, 0, bw4 * 2);
    fillb(X.l_nnz[0] + row7 * 2, 0, bh4 * 2);
    for (int p = 1; p < 3; ++p) {
      fillb(X.a_nnz[p] + ((col * 2) >> ss_h), 0, (bw4 * 2) >> ss_h);
      fillb(X.l_nnz[p] + ((row7 * 2) >> ss_v), 0, (bh4 * 2) >> ss_v);
    }
  };
  auto pos = [&]() {
    return BlockPos{bs, br, bc, intra, b_comp, b_ref0, b_ref1, b_filterid};
  };

  // COEF: every transform block of the block, plane by plane, a
  // transform block's scan positions in one loop (vp9block.c:805-923);
  // returns an err word
  auto coef = [&]() -> int {
    const int col = bc - c0, row7 = br & 7;
    const uint4* const coef_rows = M.coef16 + (intra ? 0 : kCoefRows / 2);
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
      const int qdc = M.qmul[seg_id * 4 + (is_y ? 0 : 2)];
      const int qac = M.qmul[seg_id * 4 + (is_y ? 1 : 3)];
      const int Wp = is_y ? W64 : W64uv;
      const int cbase = is_y ? 0 : pl == 1 ? ysz : ysz + usz;
      const int ebase = is_y ? 0 : pl == 1 ? eysz : eysz + eusz;
      const int ec16 = is_y ? c16 : c16uv;
      const int py0 = is_y ? br * 8 : (br * 8) >> ss_v;
      const int px0 = is_y ? bc * 8 : (bc * 8) >> ss_h;
      const int ey0 = is_y ? br * 2 : (br * 2) >> ss_v;
      const int ex0 = is_y ? bc * 2 : (bc * 2) >> ss_h;
      // the first position of band 5 (BAND_COUNTS)
      const int band5 = tx_p == 0 ? 13 : 21;
      const uint4* const crow = coef_rows + prow * 36;
      int* cnt_eob = cnt + kCntEob + prow16 * 36 * 2;
      int* cnt_coef = cnt + kCntCoef + prow16 * 36 * 3;
      for (int cy = 0; cy < end_y; cy += step) {
        for (int cx = 0; cx < end_x; cx += step) {
          const int txtp =
              is_y ? kItx[modes[bs > 9 && tx == 0 ? modeidx : 0]] : 0;
          const uint32_t* words =
              M.scanw + M.scan_off[(4 * P.lossless + tx_p) * 4 + txtp];
          const int cpos0 = cbase + (py0 + cy * 4) * Wp + px0 + cx * 4;
          // position 0: band 0, its context from the above and left
          int b36 = a_arr[cx] + l_arr[cy];
          uint4 row = crow[b36];
          // the pipeline: position i's scan index (sc) and the words of
          // i + 1 and i + 2; position i - 1's scan index and energy; the
          // energies of i + 1's neighbours as loaded a position ago
          // (La1, Lb1: right for positions up to i - 2)
          int sc = static_cast<int>(words[0] & 0x3ff), sc_p = -1, e_p = 0;
          uint32_t w1 = words[1], w2 = words[2], w3 = 0;
          int La1 = 0, Lb1 = 0, La2 = 0, Lb2 = 0;
          int count = 0, i = 0;
          bool skipeob = false;
          // position i + 1's neighbours and band, its context as if
          // position i were a ZERO token (z36) and that context's row
          int na = 0, nb = 0, band1 = 0, ea = 0, eb = 0, z36 = 0, i1 = 1;
          uint4 row_z = row;
          // position i's pipeline work, read before its bools: position
          // i + 2's neighbours' energies loaded (right for positions up
          // to i - 1, used a position on), position i + 1's ZERO row
          auto pipe = [&](int i) {
            w3 = words[i + 3];
            i1 = i + 1;
            const int na2 = (w2 >> 10) & 0x3ff, nb2 = w2 >> 20;
            La2 = X.cache[na2];
            Lb2 = X.cache[nb2];
            na = (w1 >> 10) & 0x3ff;
            nb = w1 >> 20;
            band1 =
                i1 >= band5 ? 5 : static_cast<int>((kBands >> (3 * i1)) & 7);
            ea = na == sc_p ? e_p : La1;
            eb = nb == sc_p ? e_p : Lb1;
            z36 = band1 * 6 +
                  ((1 + (na == sc ? 0 : ea) + (nb == sc ? 0 : eb)) >> 1);
            row_z = crow[z36];
          };
          // position i done with energy e, its successor's row: to i + 1
          auto advance = [&](int e, int n36, const uint4& rown) {
            count = i1;
            b36 = n36;
            row = rown;
            sc_p = sc;
            e_p = e;
            sc = static_cast<int>(w1 & 0x3ff);
            w1 = w2;
            w2 = w3;
            La1 = La2;
            Lb1 = Lb2;
          };
          sec.mark(kSecCoef, rd.n);
          pipe(0);
          for (;;) {
            rd.w.fill();
            int t = -1;
            if (skipeob) {
              // after a ZERO token the next reads node 1 first: most
              // positions of a block are such a ZERO, one bool; a run of
              // them takes this loop, 4 positions a fill
              const int i0 = i;
              sec.mark(kSecCoefLoop, rd.n);
              for (;;) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  if (rd.get_filled((row.x >> 8) & 0xff)) goto nonzero;
                  X.cache[sc] = 0;
                  if (kCount) ++cnt_coef[b36 * 3];
                  advance(0, z36, row_z);
                  if (++i >= n_tot) {
                    sec.mark(kSecCoefRun, rd.n);
                    sec.count(kSecRunPos, i - i0);
                    goto block_end;
                  }
                  pipe(i);
                }
                rd.w.fill();
              }
            nonzero:
              sec.mark(kSecCoefRun, rd.n);
              sec.count(kSecRunPos, i - i0);
              rd.w.fill();
            } else if (!rd.get_filled(row.x & 0xff)) {
              t = kTokEob;  // node 0: the end of the block
            } else if (!rd.get_filled((row.x >> 8) & 0xff)) {
              t = 0;  // node 1: ZERO
            }
            if (t < 0) {
              // node 2: ONE, or the rest of the tree from node 3: a bool a
              // node, at most 4, the next node's probability chosen, not
              // branched to, after a fill
              if (!rd.get_filled((row.x >> 16) & 0xff)) {
                t = 1;
              } else {
                rd.w.fill();
                int node = 3, prob = static_cast<int>(row.x >> 24);
#pragma unroll
                for (int step = 0; step < 4; ++step) {
                  const int c0 =
                      static_cast<int>((kTokChild0 >> (5 * node)) & 31);
                  const int c1 =
                      static_cast<int>((kTokChild1 >> (5 * node)) & 31);
                  const int p0 = row_prob(row, c0), p1 = row_prob(row, c1);
                  const int bit = rd.get_filled(prob);
                  node = bit ? c1 : c0;
                  prob = bit ? p1 : p0;
                  if (node >= 16) break;
                }
                t = node - 16;
              }
            }
            if (kCount && !skipeob) ++cnt_eob[b36 * 2 + (t != kTokEob)];
            if (t == kTokEob) break;
            // the energy, and position i + 1's context and row (the ZERO
            // case's, or loaded under the token's extra bits and sign)
            const int e = static_cast<int>((kTokEnergy >> (3 * t)) & 7);
            X.cache[sc] = static_cast<uint8_t>(e);
            const int n36 = band1 * 6 + ((1 + (na == sc ? e : ea) +
                                          (nb == sc ? e : eb)) >> 1);
            const uint4 rown = n36 == z36 ? row_z : crow[n36];
            const int tok = t < 2 ? t : 2;
            skipeob = t == 0;
            if (t != 0) {
              // the sign: ONE to FOUR have read at most 3 bools since a
              // fill, a category's extra bits fill as they go
              int val = t, sign;
              if (t > 4) {
                const int cls = t - 4;
                int eb2 = 0;
                if (cls == 6) {
                  for (int k = 0; k < cat6n; ++k)
                    eb2 = (eb2 << 1) | rd.get(cat6[k]);
                } else {
                  for (int k = 0; k < cls; ++k)
                    eb2 = (eb2 << 1) | rd.get(kCatProbs[cls][k]);
                }
                val = kCatBase[cls] + eb2;
                sign = rd.get(128);
              } else {
                sign = rd.get_filled(128);
              }
              if (sign) val = -val;
              // int32 products, as the reference's (they wrap); 32x32
              // coefficients halve toward zero
              int prod = static_cast<int>(static_cast<uint32_t>(val) *
                                          static_cast<uint32_t>(
                                              i == 0 ? qdc : qac));
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
            if (kCount) ++cnt_coef[b36 * 3 + tok];
            advance(e, n36, rown);
            if (++i >= n_tot) break;
            pipe(i);
          }
        block_end:
          sec.mark(kSecCoefLoop, rd.n);
          // the transform block's finish: the nnz writeback (the anchor
          // and its step range, cut at the visible edge), the eob pair
          const int nz = count > 0;
          fillb(a_arr + cx, nz, min(step, end_x - cx));
          fillb(l_arr + cy, nz, min(step, end_y - cy));
          if (count) {
            anycoef = true;
            if (nep >= ecap) return kErrOverflow;
            epairs[nep++] = make_int2(ebase + (ey0 + cy) * ec16 + ex0 + cx,
                                      count);
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
        fillb(X.a_skip + col, 1, min(cols - bc, int{kBwh[1][bs][0]}));
        fillb(X.l_skip + row7, 1, min(rows - br, int{kBwh[1][bs][1]}));
      }
      if (!emit()) return kErrOverflow;
    }
    return 0;
  };

  for (;;) {
    // lane 0's quanta up to the next MV quantum or the end
    if (lead) {
      while (phase != kMv && phase != kDone) {
        sec.mark(cur, rd.n);
        cur = phase == kPart ? kSecPart : phase == kMode ? kSecMode : kSecCoef;
        if (phase == kPart) {
          if (sp == 0) {
            if (sb_r >= r1) {
              phase = kDone;
              continue;
            }
            // the end test before each superblock (vp9.c:1413,
            // vpx_rac_is_end: more than 10 bits read past the end)
            if (rd.consumed() > tile_bits + 10) {
              err = kErrEnd;
              phase = kDone;
              continue;
            }
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
            if (kCount) ++cnt[kCntPartition + (bl * 4 + pctx) * 4 + bp];
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
                fillb(X.l_part, 0, 8);
                fillb(X.l_skip, 0, 8);
                fillb(X.l_mode, mode0, 16);
                for (int p = 0; p < 3; ++p) fillb(X.l_nnz[p], 0, 16);
                fillb(X.l_segpred, 0, 8);
              }
            }
            continue;
          }
          stk_em[top] = em + 1;
          if (split) {
            // the em'th child that lies in the frame, in DFS pre-order
            int k = em, dr = 0, dc = 0;
            const bool ok[4] = {true, col_in, row_in, col_in && row_in};
    #pragma unroll
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
          // the block's above and left contexts in one round of loads,
          // then (an inter frame's) the probabilities they select in a
          // second, all before the block's first bool
          const int a_sk = X.a_skip[col], l_sk = X.l_skip[row7];
          const int a_tx = X.a_txfm[col], l_tx = X.l_txfm[row7];
          int a_in = 0, l_in = 0, a_cm = 0, l_cm = 0, a_rf = 0, l_rf = 0;
          int a_fl = 0, l_fl = 0, a_md = 0, l_md = 0, a_mo = 0, l_mo = 0;
          const int fixref = hf[kFixRef], var0 = hf[kVarRef0],
                    var1 = hf[kVarRef1];
          int ictx = 0, cctx = 0, crctx = 0, s1ctx = 0, s2ctx = 0, fctx = 0;
          int p_intra = 0, p_comp = 0, p_cref = 0, p_sref1 = 0, p_sref2 = 0;
          if (inter) {
            const int moff = kModeOff[bs];
            a_in = X.a_intra[col];
            l_in = X.l_intra[row7];
            a_cm = X.a_comp[col];
            l_cm = X.l_comp[row7];
            a_rf = X.a_ref[col];
            l_rf = X.l_ref[row7];
            a_fl = X.a_filter[col];
            l_fl = X.l_filter[row7];
            a_md = X.a_mode[col];
            l_md = X.l_mode[row7];
            a_mo = X.a_mode[col + moff];
            l_mo = X.l_mode[row7 + moff];
            // the intra/inter flag's context (vp9block.c:283-298)
            ictx = have_a && have_l ? a_in + l_in + (a_in + l_in == 2)
                   : have_a         ? 2 * a_in
                   : have_l         ? 2 * l_in
                                    : 0;
            // the compound flag's (vp9block.c:331-356)
            if (have_a && have_l) {
              if (a_cm && l_cm)
                cctx = 4;
              else if (a_cm)
                cctx = 2 + (l_in == 1 || l_rf == fixref);
              else if (l_cm)
                cctx = 2 + (a_in == 1 || a_rf == fixref);
              else
                cctx = (a_in == 0 && a_rf == fixref) !=
                       (l_in == 0 && l_rf == fixref);
            } else if (have_a) {
              cctx = a_cm ? 3 : (a_in == 0 && a_rf == fixref);
            } else if (have_l) {
              cctx = l_cm ? 3 : (l_in == 0 && l_rf == fixref);
            } else {
              cctx = 1;
            }
            crctx = comp_ref_ctx(have_a, have_l, a_in, l_in, a_cm, l_cm, a_rf,
                                 l_rf, fixref, var0, var1);
            s1ctx = single_ref_ctx1(have_a, have_l, a_in, l_in, a_cm, l_cm,
                                    a_rf, l_rf, fixref);
            s2ctx = single_ref_ctx2(have_a, have_l, a_in, l_in, a_cm, l_cm,
                                    a_rf, l_rf, fixref);
            b_modectx = kInterModeCtx[a_mo][l_mo];
            // the filter's (with the neighbours' modes)
            const bool ca = have_a && a_md >= 10, cl = have_l && l_md >= 10;
            fctx = ca ? (cl ? (a_fl == l_fl ? l_fl : 3) : a_fl) : cl ? l_fl : 3;
            p_intra = pr[kPIntra + ictx];
            p_comp = pr[kPComp + cctx];
            p_cref = pr[kPCompRef + crctx];
            p_sref1 = pr[kPSingleRef + s1ctx * 2];
            p_sref2 = pr[kPSingleRef + s2ctx * 2 + 1];
          }
          // seg id; on inter frames with temporal prediction from the
          // previous frame's map (vp9block.c:101-142)
          if (inter) {
            bool use_pred = false, m_tree = false;
            if (hf[kSegEn]) {
              int pbit = 0;
              if (hf[kSegUpd] && hf[kSegTmp])
                pbit = rd.get(
                    pr[kPSegPred + X.a_segpred[col] + X.l_segpred[row7]]);
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
              fillb(X.a_segpred + col, use_pred, w4c);
              fillb(X.l_segpred + row7, use_pred, h4c);
            }
          } else {
            seg_id = P.seg ? rd.tree(kSegTree, pr + kPSeg) : 0;
          }
          // skip
          const bool forced_skip = pr[kPSkipSeg + seg_id] != 0;
          if (forced_skip) {
            skip = 1;
          } else {
            const int sctx = l_sk + a_sk;
            skip = rd.get(pr[kPSkip + sctx]);
            if (kCount) ++cnt[kCntSkip + sctx * 2 + skip];
          }
          // the intra/inter flag (vp9block.c:283-298); the seg REF feature
          // sets it without a bool
          int rs_en = 0, rs_val = 0;
          if (inter) {
            rs_en = pr[kPRefSegEn + seg_id];
            rs_val = pr[kPRefSegVal + seg_id];
            if (rs_en) {
              intra = rs_val == 0;
            } else {
              const int ibit = rd.get(p_intra);
              intra = !ibit;
              if (kCount) ++cnt[kCntIntra + ictx * 2 + ibit];
            }
          } else {
            intra = 1;
          }
          // tx size: coded when switchable, on an inter frame only for intra
          // blocks and blocks that are not skipped
          const int mtx = kMaxTx[bs];
          if (P.txfmmode == 4 && (intra || !skip)) {
            const int a_t = a_sk ? mtx : a_tx;
            const int l_t = l_sk ? mtx : l_tx;
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
            if (kCount && cidx >= 0) ++cnt[cidx];
          } else {
            tx = min(mtx, P.txfmmode);
          }
          uvtx = tx - ((ss_h && bw4 * 2 == (1 << tx)) ||
                       (ss_v && bh4 * 2 == (1 << tx)));
          if (!inter) {
            // keyframe modes: the context-coupled trees
            const int a0 = col * 2, a1 = a0 + 1, l0 = row7 * 2, l1 = l0 + 1;
            const uint8_t* kf_y = pr + kPKfY;
            // the tree of above mode a and left mode l
            auto kf_mode = [&](int a, int l) {
              return rd.tree(kModeTree, kf_y + (a * 10 + l) * 9);
            };
            if (bs > 9) {  // sub-8x8: a mode a 4x4 slot
              const int m0 = kf_mode(X.a_mode[a0], X.l_mode[l0]);
              X.a_mode[a0] = m0;
              const int m1 = bs == 10 ? m0 : kf_mode(X.a_mode[a1], m0);
              X.l_mode[l0] = X.a_mode[a1] = m1;
              int m2 = m0;
              if (bs != 11) {
                m2 = kf_mode(X.a_mode[a0], X.l_mode[l1]);
                X.a_mode[a0] = m2;
              }
              const int m3 = bs == 11   ? m1
                             : bs == 10 ? m2
                                        : kf_mode(X.a_mode[a1], m2);
              X.l_mode[l1] = X.a_mode[a1] = m3;
              modes[0] = m0;
              modes[1] = m1;
              modes[2] = m2;
              modes[3] = m3;
            } else {
              const int m = kf_mode(X.a_mode[a0], X.l_mode[l0]);
              fillb(X.a_mode + a0, m, kBwh[0][bs][0]);
              fillb(X.l_mode + l0, m, kBwh[0][bs][1]);
              modes[0] = modes[1] = modes[2] = modes[3] = m;
            }
            b_uvmode = rd.tree(kModeTree, pr + kPKfUv + modes[3] * 9);
          } else if (intra) {
            // an intra block of an inter frame: the frame's fixed tables, no
            // above/left coupling (vp9block.c:380-411)
            const uint8_t* yp0 = pr + kPYMode;
            if (bs > 9) {
              modes[0] = rd.tree(kModeTree, yp0);
              if (kCount) ++cnt[kCntYMode + modes[0]];
              if (bs != 10) {
                modes[1] = rd.tree(kModeTree, yp0);
                if (kCount) ++cnt[kCntYMode + modes[1]];
              } else {
                modes[1] = modes[0];
              }
              if (bs != 11) {
                modes[2] = rd.tree(kModeTree, yp0);
                if (kCount) ++cnt[kCntYMode + modes[2]];
                if (bs != 10) {
                  modes[3] = rd.tree(kModeTree, yp0);
                  if (kCount) ++cnt[kCntYMode + modes[3]];
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
              if (kCount) ++cnt[kCntYMode + szg * 10 + m];
              modes[0] = modes[1] = modes[2] = modes[3] = m;
            }
            b_uvmode = rd.tree(kModeTree, pr + kPUvMode + modes[3] * 9);
            if (kCount) ++cnt[kCntUvMode + modes[3] * 10 + b_uvmode];
            b_comp = 0;
          } else {
            // an inter block: compound flag and references
            // (vp9block.c:331-575), the whole-block inter mode, the
            // interpolation filter
            if (rs_en) {
              b_comp = 0;
              b_ref0 = rs_val - 1;
              b_ref1 = 0;
            } else {
              if (hf[kCompPred] == 2) {
                b_comp = rd.get(p_comp);
                if (kCount) ++cnt[kCntComp + cctx * 2 + b_comp];
              } else {
                b_comp = hf[kCompPred] == 1;
              }
              if (b_comp) {
                const int bit = rd.get(p_cref);
                if (kCount) ++cnt[kCntCompRef + crctx * 2 + bit];
                const int var = bit ? var1 : var0;
                const int fix_idx = hf[kSignBias0 + fixref];
                b_ref0 = fix_idx ? var : fixref;
                b_ref1 = fix_idx ? fixref : var;
              } else {
                const int bit0 = rd.get(p_sref1);
                if (kCount) ++cnt[kCntSingleRef + s1ctx * 4 + bit0];
                int ref0 = 0;
                if (bit0) {
                  const int bit1 = rd.get(p_sref2);
                  if (kCount) ++cnt[kCntSingleRef + s2ctx * 4 + 2 + bit1];
                  ref0 = 1 + bit1;
                }
                b_ref0 = ref0;
                b_ref1 = 0;
              }
            }
            // the mode context (b_modectx) reads into a 64x64 or 32x32
            // block
            if (bs <= 9) {
              int m = 12;  // the seg SKIP feature: ZEROMV
              if (!forced_skip) {
                m = rd.tree(kInterModeTree, pr + kPMvMode + b_modectx * 3);
                if (kCount) ++cnt[kCntMvMode + b_modectx * 4 + m - 10];
              }
              modes[0] = modes[1] = modes[2] = modes[3] = m;
            }
            if (hf[kFilterMode] == 4) {
              b_filterid = rd.tree(kFilterTree, pr + kPFilter + fctx * 2);
              if (kCount) ++cnt[kCntFilter + fctx * 3 + b_filterid];
              b_filter = kFilterLut[b_filterid];
            } else {
              b_filter = hf[kFilterMode];
              b_filterid = 0;
            }
          }
          // SET_CTXS
          fillb(X.a_skip + col, skip, bw4);
          fillb(X.a_txfm + col, tx, bw4);
          fillb(X.a_part + col, kActx[bs], bw4);
          fillb(X.l_skip + row7, skip, bh4);
          fillb(X.l_txfm + row7, tx, bh4);
          fillb(X.l_part + row7, kLctx[bs], bh4);
          if (inter && !intra) {
            // an inter block's mvs come next, a quantum a (sub-block,
            // reference)
            mv_k = mv_z = 0;
            phase = kMv;
            continue;
          }
          if (inter) set_ctxs_nonkf<false>(P, G, X, c0, pos(), 0);
          // the record; then a skipped block zeroes its nnz contexts and
          // takes the next node, the others walk their coefficients
          if (!emit()) {
            err = kErrOverflow;
            phase = kDone;
            continue;
          }
          if (skip) {
            zero_nnz();
            phase = kPart;
          } else {
            phase = kCoef;
          }
          continue;
        }

        // COEF
        if ((err = coef()) != 0) {
          phase = kDone;
          continue;
        }
        phase = kPart;
      }
    }
    // what lane 0 wrote is every lane's from here
    sec.mark(cur, rd.n);
    cur = kSecSync;
    __syncwarp();
    if (__shfl_sync(kAll, phase, 0) == kDone) break;
    sec.mark(kSecSync, rd.n);
    cur = kSecMv;
    // one (sub-block mv_k, reference mv_z) of an inter block, the warp's:
    // lane 0 reads the sub-block's inter mode and hands the warp the
    // scan's arguments
    int args = 0;
    if (lead) {
      mv_t0 = clock64();
      const bool sub8 = bs > 9;
      if (sub8 && mv_z == 0) {
        const int m =
            rd.tree(kInterModeTree, pr + kPMvMode + b_modectx * 3);
        if (kCount) ++cnt[kCntMvMode + b_modectx * 4 + m - 10];
        modes[mv_k] = m;
      }
      const int mode_k = modes[mv_k];
      if (mode_k == 12) {
        // ZEROMV zeroes both references' mvs
        bmv[mv_k][0][0] = bmv[mv_k][0][1] = 0;
        bmv[mv_k][1][0] = bmv[mv_k][1][1] = 0;
      }
      const int sbp = mode_k == 13 || !sub8 ? -1 : mv_k;
      args = (mode_k != 12) | (mv_z ? b_ref1 : b_ref0) << 1 | mv_z << 3 |
             (mode_k == 11) << 4 | (sbp + 1) << 5 | bs << 8;
    }
    sec.mark(kSecMv, rd.n);
    __syncwarp();
    args = __shfl_sync(kAll, args, 0);
    const int w_br = __shfl_sync(kAll, br, 0);
    const int w_bc = __shfl_sync(kAll, bc, 0);
    sec.mark(kSecSync, rd.n);
    int2 p = make_int2(0, 0);
    if (args & 1) {
      p = find_ref_mv(P, G, M, lane, slot_kind, slot_par, sbmask,
                      args >> 8, w_br, w_bc, c0, (args >> 1) & 3,
                      (args >> 3) & 1, (args >> 4) & 1,
                      ((args >> 5) & 7) - 1);
      sec.mark(kSecMvScan, rd.n);
      sec.count(kSecScans);
    }
    int last = 0;
    if (lead) {
      const bool sub8 = bs > 9;
      const int mode_k = modes[mv_k];
      if (mode_k != 12) {
        int rx = p.x, ry = p.y;
        const bool hp = hf[kHighPrec] && abs(rx) < 64 && abs(ry) < 64;
        if ((mode_k == 13 || !sub8) && !hp) {
          // odd components rounded toward zero (vp9mvs.c:300-321)
          if (ry & 1) ry += ry < 0 ? 1 : -1;
          if (rx & 1) rx += rx < 0 ? 1 : -1;
        }
        if (mode_k == 13) {
          const int j = rd.tree(kMvJointTree, pr + kPMvJoint);
          if (kCount) ++cnt[kCntMvJoint + j];
          if (j >= 2) ry += read_mv_comp<kCount>(rd, pr, cnt, 0, hp);
          if (j & 1) rx += read_mv_comp<kCount>(rd, pr, cnt, 1, hp);
        }
        bmv[mv_k][mv_z][0] = rx;
        bmv[mv_k][mv_z][1] = ry;
      }
      if (b_comp && mv_z == 0 && mode_k != 12) {
        mv_z = 1;
      } else {
        mv_z = 0;
        const int nk = mv_k + (bs == 10 ? 2 : 1);
        if (sub8 && nk <= (bs == 12 ? 3 : bs == 11 ? 1 : 2))
          mv_k = nk;
        else
          last = 1;
      }
      if (last) {
        // the shared sub-block slots (each slot's source is one that
        // keeps its own)
        for (int q = 1; q < 4; ++q) {
          const int s = kSubSrc[bs][q];
          if (s == q) continue;
          modes[q] = modes[s];
          bmv[q][0][0] = bmv[s][0][0];
          bmv[q][0][1] = bmv[s][0][1];
          bmv[q][1][0] = bmv[s][1][0];
          bmv[q][1][1] = bmv[s][1][1];
        }
        last |= b_comp << 1 | b_ref0 << 2 | b_ref1 << 4 |
                b_filterid << 6;
      }
    }
    sec.mark(kSecMv, rd.n);
    __syncwarp();
    last = __shfl_sync(kAll, last, 0);
    sec.mark(kSecSync, rd.n);
    if (last) {
      // the deferred contexts and grids, the warp's
      const BlockPos b{args >> 8, w_br,  w_bc, 0, (last >> 1) & 1,
                       (last >> 2) & 3, (last >> 4) & 3, (last >> 6) & 3};
      set_ctxs_nonkf<true>(P, G, X, c0, b, lane);
    }
    // the warp's writes are lane 0's from here
    sec.mark(kSecMv, rd.n);
    __syncwarp();
    sec.mark(kSecSync, rd.n);
    if (lead) {
      mv_cycles += clock64() - mv_t0;
      if (last) {
        if (skip) {
          zero_nnz();
          if (!emit()) {
            err = kErrOverflow;
            phase = kDone;
            continue;
          }
          phase = kPart;
        } else {
          phase = kCoef;
        }
      }
    }
  }
  sec.mark(cur, rd.n);
  return err;
}

// One block of one warp a lane (a tile): the tables staged and the
// contexts zeroed by the warp, the walk by its lane 0 with the warp at
// the MV quanta, the counts written out by the warp; with kSec the debug
// sections too; kCount: the symbols counted.
template <bool kSec, bool kCount>
__global__ void __launch_bounds__(32, 1) passa_kernel(
    const uint8_t* __restrict__ packet, const int64_t* __restrict__ tile_off,
    const int32_t* __restrict__ tile_len, const int32_t* __restrict__ bounds,
    const int32_t* __restrict__ caps, const uint8_t* __restrict__ probs8,
    int nprobs, const uint4* __restrict__ coef16,
    const int32_t* __restrict__ qmul_g, const uint32_t* __restrict__ scanw,
    const int32_t* __restrict__ scan_off, Grids G, Params P, int bmax,
    int cmax, int emax, int32_t* __restrict__ blocks,
    int32_t* __restrict__ nblk_o, int2* __restrict__ cpairs,
    int32_t* __restrict__ ncp_o, int2* __restrict__ epairs,
    int32_t* __restrict__ nep_o, int32_t* __restrict__ counts,
    int32_t* __restrict__ err_o, long long* __restrict__ stats,
    long long* __restrict__ sections) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& M = *reinterpret_cast<Smem*>(smem_raw);
  Ctx& X = M.X;
  const int s = blockIdx.x, t = threadIdx.x;
  const uint8_t mode0 = P.inter ? 10 : 2;
  for (int j = t; j < nprobs; j += 32) M.pr[j] = probs8[j];
  for (int j = t; j < kCoefRows; j += 32) M.coef16[j] = coef16[j];
  for (int j = t; j < kScanWords; j += 32) M.scanw[j] = scanw[j];
  if (t < kScanRows) M.scan_off[t] = scan_off[t];
  M.qmul[t] = qmul_g[t];
  for (int j = t; j < 13 * 8 * 2; j += 32)
    (&M.mvref[0][0][0])[j] = (&kMvRef[0][0][0])[j];
  for (int j = t; j < kCntTotal; j += 32) M.cnt[j] = 0;
  for (int j = t; j < kAbove; j += 32) {
    X.a_part[j] = X.a_skip[j] = X.a_txfm[j] = 0;
    X.a_intra[j] = X.a_comp[j] = X.a_ref[j] = X.a_filter[j] =
        X.a_segpred[j] = 0;
  }
  for (int j = t; j < 2 * kAbove; j += 32) {
    X.a_mode[j] = mode0;
    X.a_nnz[0][j] = X.a_nnz[1][j] = X.a_nnz[2][j] = 0;
    X.a_mv[j][0] = X.a_mv[j][1] = 0;
  }
  // the cache once a launch: a position's context reads only earlier
  // positions of its own transform block, so its values are never stale
  // where they count, and always energies (0-5) where they do not
  for (int j = t; j < 1024; j += 32) X.cache[j] = 0;
  if (t < 8) {
    X.l_part[t] = X.l_skip[t] = X.l_txfm[t] = 0;
    X.l_intra[t] = X.l_comp[t] = X.l_ref[t] = X.l_filter[t] =
        X.l_segpred[t] = 0;
  }
  if (t < 16) {
    X.l_mode[t] = mode0;
    X.l_nnz[0][t] = X.l_nnz[1][t] = X.l_nnz[2][t] = 0;
    X.l_mv[t][0] = X.l_mv[t][1] = 0;
  }
  // the record before the first block: modes DC_PRED, the rest 0
  X.rec[t] = t >= 9 && t < 13 ? 2 : 0;
  if (t < 2) X.rec[32 + t] = 0;
  __syncthreads();
  const int* b = bounds + s * 4;
  const int* cp = caps + s * 3;
  Bools rd;
  rd.n = 0;
  rd.w.init(packet, tile_off[s], tile_len[s]);
  int nblk = 0, ncp = 0, nep = 0, err;
  long long mv_cycles = 0;
  Sections<kSec> sec;
  const long long t0 = clock64();
  if (rd.get(128)) {
    err = kErrMarker;
  } else {
    rd.n = 0;
    sec.start(M.sec, 0, t == 0);
    err = walk<kSec, kCount>(
        P, rd, M, G, t, kSlotKind[t], kSlotPar[t], 8ll * tile_len[s], b[0],
        b[1], b[2], b[3], cp[0], cp[1], cp[2],
        blocks + static_cast<int64_t>(s) * bmax * 34,
        cpairs + static_cast<int64_t>(s) * cmax,
        epairs + static_cast<int64_t>(s) * emax, nblk, ncp, nep, mv_cycles,
        sec);
  }
  const long long cycles = clock64() - t0;
  if (t == 0) {
    stats[s * 3] = rd.n;
    stats[s * 3 + 1] = cycles;
    stats[s * 3 + 2] = mv_cycles;
    nblk_o[s] = nblk;
    ncp_o[s] = ncp;
    nep_o[s] = nep;
    err_o[s] = err;
  }
  __syncthreads();
  if constexpr (kSec)
    for (int k = t; k < kNumSec; k += 32)
      sections[s * kNumSec + k] = M.sec[k];
  for (int j = t; j < kCntTotal; j += 32)
    counts[static_cast<int64_t>(s) * kCntTotal + j] = M.cnt[j];
}

// the dynamic shared memory of an instance, set once a device
template <bool kSec, bool kCount>
cudaError_t launch(int S, cudaStream_t stream, const uint8_t* packet,
                   const int64_t* tile_off, const int32_t* tile_len,
                   const int32_t* bounds, const int32_t* caps,
                   const uint8_t* probs8, int nprobs, const uint4* coef16,
                   const int32_t* qmul, const uint32_t* scanw,
                   const int32_t* scan_off, const Grids& G, const Params& P,
                   int bmax, int cmax, int emax, int32_t* blocks,
                   int32_t* nblk, int2* cpairs, int32_t* ncp, int2* epairs,
                   int32_t* nep, int32_t* counts, int32_t* err,
                   long long* stats, long long* sections) {
  const cudaError_t e = cudaFuncSetAttribute(
      passa_kernel<kSec, kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (e != cudaSuccess) return e;
  passa_kernel<kSec, kCount><<<S, 32, sizeof(Smem), stream>>>(
      packet, tile_off, tile_len, bounds, caps, probs8, nprobs, coef16, qmul,
      scanw, scan_off, G, P, bmax, cmax, emax, blocks, nblk, cpairs, ncp,
      epairs, nep, counts, err, stats, sections);
  return cudaGetLastError();
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
// an inter frame); coef16 uint8 [kCoefRows, 16]: the coefficient
// probability rows padded (coef16_rows); qmul int32 [8, 4]; scanw
// uint32 [kScanWords] and scan_off int32 [kScanRows]: the packed scan
// words and each scan row's first (packed_scans). On an inter frame
// (inter=1): hflags, a host array of prep_inter's 14 header flags;
// prev_mv int16 [sb_rows * 8, sb_cols * 8, 2, 2], prev_ref int8 [.., 2],
// prev_seg uint8 [sb_rows * 8, sb_cols * 8]: the previous frame's grids,
// null where hflags say the frame reads none; grid_mv int16 [sb_rows *
// 8, sb_cols * 8, 2, 2] and grid_ref int8 [sb_rows * 8, sb_cols * 8, 2]:
// the frame's, filled with 0 and -1 before the launch (all may be null
// on an intra frame). Outputs: blocks int32 [S, bmax, 34], cpairs and
// epairs int32 [S, cmax or emax, 2], nblk, ncp, nep and err int32 [S],
// counts int32 [S, kCntTotal], stats int64 [S, 3] (bools after the
// marker, clock64 cycles of the walk and of its MV quanta), the grids;
// sections int64 [S, kNumSec], the debug sections (Sec), or null: the
// kernel instance that reads no clock beyond stats'.
int passa_walk(const uint8_t* packet, const int64_t* tile_off,
               const int32_t* tile_len, const int32_t* bounds,
               const int32_t* caps, const uint8_t* probs8,
               const uint8_t* coef16, const int32_t* qmul,
               const uint32_t* scanw, const int32_t* scan_off,
               const int16_t* prev_mv, const int8_t* prev_ref,
               const uint8_t* prev_seg, const int32_t* hflags, int nprobs,
               int S, int rows, int cols, int sb_cols, int sb_rows,
               int txfmmode, int seg, int lossless, int bpp, int ss_h,
               int ss_v, int want_counts, int inter, int bmax, int cmax,
               int emax, int32_t* blocks, int32_t* nblk, int32_t* cpairs,
               int32_t* ncp, int32_t* epairs, int32_t* nep, int32_t* counts,
               int32_t* err, long long* stats, int16_t* grid_mv,
               int8_t* grid_ref, long long* sections, cudaStream_t stream) {
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
  const Grids G{reinterpret_cast<uint2*>(grid_mv),
                reinterpret_cast<uint16_t*>(grid_ref),
                reinterpret_cast<const uint2*>(prev_mv),
                reinterpret_cast<const uint16_t*>(prev_ref), prev_seg,
                sb_cols * 8};
  const auto* c16 = reinterpret_cast<const uint4*>(coef16);
  auto* cp = reinterpret_cast<int2*>(cpairs);
  auto* ep = reinterpret_cast<int2*>(epairs);
  auto go = [&](auto kernel_launch) {
    return kernel_launch(S, stream, packet, tile_off, tile_len, bounds, caps,
                         probs8, nprobs, c16, qmul, scanw, scan_off, G, P,
                         bmax, cmax, emax, blocks, nblk, cp, ncp, ep, nep,
                         counts, err, stats, sections);
  };
  const cudaError_t e =
      sections ? (want_counts ? go(launch<true, true>)
                              : go(launch<true, false>))
               : (want_counts ? go(launch<false, true>)
                              : go(launch<false, false>));
  return static_cast<int>(e);
}

}  // extern "C"
