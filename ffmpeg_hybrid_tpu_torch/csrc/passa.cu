// The on-device pass A for intra frames on Hopper (sm_90a): the keyframe
// block-syntax walk of every tile of a frame in one launch.
//
//   passa_walk  replaces the intra half of _decode_jit
//               (ffmpeg_hybrid_tpu/ops/passa_device.py:620-2420 with
//               inter=0), a jnp program with no Pallas kernel of its own
//
// Design. The JAX walk runs S tile streams in lockstep on the TPU's
// vector unit, one bounded quantum a lane per step of a while loop, every
// branch a predication mask; its docstring names the GPU form: one lane
// a tile stream with sequential loops. Here each lane (one VP9 tile,
// vp9.c:1342) is a block of one warp whose thread 0 walks the tile alone:
// the phase machine of the JAX walk (PART, MODE, COEF, DONE; MV, the
// inter walk's, keeps its number), a quantum a turn of its loop, where a
// COEF quantum walks every transform block of a block. The other 31
// threads stage the frame's probability tables and zero the contexts in
// shared memory before the walk, and write the lane's counts out after
// it. The above contexts of the tile's columns, the left contexts, the
// partition stack, the coefficient cache, the probability tables and
// the symbol counts all sit in shared memory (about 29 KB); the scan and
// neighbour tables are read through the read-only cache. Bools come from
// rac_window.cuh's Window (the byte-fed decoder of the stream kernels, a
// fill before every bool), started at the tile's first byte; the lane
// reads the marker bool itself. A tree symbol walks its tree table in
// constant memory, a bool a node: the walk's trees change their
// probabilities symbol by symbol (the context-coupled mode trees), so
// TreeWalk's staged transition tables do not fit them.
//
// What bounds it. Every bool depends on the one before it (range and
// value carry), and so does every context decision: a lane is one serial
// chain, and the launch takes as long as its longest lane. The bytes
// moved (the tile bytes read, the records, pairs and counts written) are
// far below what the card moves in that time, and so are the
// operations. Only more lanes than tiles would shorten it (later work).
//
// Outputs as the plain version's (ops/passa_device.py decode_frame_plain):
// records in the native 34-column layout, coefficient and eob pairs with
// their plane bases, counts in CNT_OFF's layout, and an err word per lane
// (1 an output full, 2 the stream's end before a superblock, 4 the marker
// bool set), after which the lane stops.
#include <cstdint>
#include <cuda_runtime.h>

#include "rac_window.cuh"

namespace {

constexpr int kPart = 0, kMode = 1, kCoef = 2, kDone = 3;
constexpr int kErrOverflow = 1, kErrEnd = 2, kErrMarker = 4;

// the widest tile (VP9: 64 superblocks) in 8x8 columns, and the above
// context arrays' entries
constexpr int kMaxTileB8 = 512;
constexpr int kAbove = kMaxTileB8 + 16;

// ops/passa_device.py CNT_OFF (checked by tests/test_torch_passa_device.py)
constexpr int kCntTotal = 3302;
constexpr int kCntTx32 = 228, kCntTx16 = 236, kCntTx8 = 242, kCntSkip = 246,
              kCntPartition = 256, kCntCoef = 320, kCntEob = 2048;

// ops/passa_device.py probs8: the offsets of its tables
constexpr int kPSkip = 0, kPTx8 = 3, kPTx16 = 5, kPTx32 = 9, kPSeg = 15,
              kPSkipSeg = 22, kPKfPart = 30, kPKfY = 78, kPKfUv = 978,
              kPCoef = 1068, kProbBytes = 4236;

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
// tables.py PARTITION_TREE, INTRAMODE_TREE, SEGMENTATION_TREE: an entry
// <= 0 is the leaf -entry
__constant__ int8_t kPartTree[3][2] = {{0, 1}, {-1, 2}, {-2, -3}};
__constant__ int8_t kModeTree[9][2] = {{-2, 1}, {-9, 2}, {0, 3}, {4, 6},
                                       {-1, 5}, {-4, -5}, {-3, 7}, {-7, 8},
                                       {-6, -8}};
__constant__ int8_t kSegTree[7][2] = {{1, 2}, {3, 4}, {5, 6}, {0, -1},
                                      {-2, -3}, {-4, -5}, {-6, -7}};
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

struct Params {
  int rows, cols, sb_cols, sb_rows, txfmmode, seg, lossless, bpp, ss_h,
      ss_v, want_counts;
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
  __device__ __forceinline__ int tree(const int8_t (*t)[2],
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
// block's cache
struct Ctx {
  uint8_t a_part[kAbove], a_skip[kAbove], a_txfm[kAbove];
  uint8_t a_mode[2 * kAbove], a_nnz[3][2 * kAbove];
  uint8_t l_part[8], l_skip[8], l_txfm[8], l_mode[16], l_nnz[3][16];
  int stk_bl[4], stk_r[4], stk_c[4], stk_bp[4], stk_em[4];
  __align__(16) uint8_t cache[1024];
};

// -x as a wrapping int32
__device__ __forceinline__ int neg32(int x) {
  return static_cast<int>(0u - static_cast<uint32_t>(x));
}

__device__ __forceinline__ void fill8(uint8_t* p, int v, int n) {
  for (int k = 0; k < n; ++k) p[k] = static_cast<uint8_t>(v);
}

// The walk of one lane by one thread: the phase machine of
// ops/passa_device.py _walk_lane. Returns the err word.
__device__ int walk(const Params& P, Bools& rd, Ctx& X,
                    const uint8_t* __restrict__ pr, const int32_t* qmul,
                    const uint8_t* bands, const int16_t* __restrict__ scans,
                    const uint32_t* __restrict__ nbs, int* cnt,
                    long long tile_bits, int r0, int r1, int c0, int c1,
                    int bcap, int ccap, int ecap, int32_t* __restrict__ blocks,
                    int2* __restrict__ cpairs, int2* __restrict__ epairs,
                    int& nblk, int& ncp, int& nep) {
  const int rows = P.rows, cols = P.cols, ss_h = P.ss_h, ss_v = P.ss_v;
  const int W64 = P.sb_cols * 64, W64uv = W64 >> ss_h;
  const int c16 = P.sb_cols * 16, c16uv = c16 >> ss_h;
  const int H64 = P.sb_rows * 64;
  const int ysz = H64 * W64, usz = (H64 >> ss_v) * W64uv;
  const int eysz = (H64 / 4) * c16, eusz = ((H64 >> ss_v) / 4) * c16uv;
  const bool counting = P.want_counts != 0;
  const int cat6n = P.bpp + 6;
  const uint8_t* cat6 = kCat6 + (12 - P.bpp);

  int phase = kPart;
  int sb_r = r0, sb_c = c0;
  int* const stk_bl = X.stk_bl;
  int* const stk_r = X.stk_r;
  int* const stk_c = X.stk_c;
  int* const stk_bp = X.stk_bp;
  int* const stk_em = X.stk_em;
  int sp = 0;
  // the current block
  int br = 0, bc = 0, bs = 0, seg_id = 0, tx = 0, uvtx = 0;
  int modes[4] = {2, 2, 2, 2};
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
        const uint8_t* pp = pr + kPKfPart + (bl * 4 + pctx) * 3;
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
            fill8(X.l_mode, 2, 16);
            for (int p = 0; p < 3; ++p) fill8(X.l_nnz[p], 0, 16);
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
      seg_id = P.seg ? rd.tree(kSegTree, pr + kPSeg) : 0;
      // skip
      int skip;
      if (pr[kPSkipSeg + seg_id]) {
        skip = 1;
      } else {
        const int sctx = X.l_skip[row7] + X.a_skip[col];
        skip = rd.get(pr[kPSkip + sctx]);
        if (counting) ++cnt[kCntSkip + sctx * 2 + skip];
      }
      // tx size
      const int mtx = kMaxTx[bs];
      if (P.txfmmode == 4) {
        const bool have_a = br > 0, have_l = bc > c0;
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
      const int uvmode = rd.tree(kModeTree, pr + kPKfUv + modes[3] * 9);
      // SET_CTXS splats
      fill8(X.a_skip + col, skip, bw4);
      fill8(X.a_txfm + col, tx, bw4);
      fill8(X.a_part + col, kActx[bs], bw4);
      fill8(X.l_skip + row7, skip, bh4);
      fill8(X.l_txfm + row7, tx, bh4);
      fill8(X.l_part + row7, kLctx[bs], bh4);
      // the record (the native 34-column layout)
      if (nblk >= bcap) return kErrOverflow;
      int32_t* rec = blocks + static_cast<int64_t>(nblk++) * 34;
      rec[0] = br;
      rec[1] = bc;
      rec[2] = c0;
      rec[3] = bs;
      rec[4] = seg_id;
      rec[5] = skip;
      rec[6] = 1;
      rec[7] = tx;
      rec[8] = uvtx;
      for (int k = 0; k < 4; ++k) rec[9 + k] = modes[k];
      rec[13] = uvmode;
      for (int k = 14; k < 34; ++k) rec[k] = 0;
      if (skip) {
        // a skipped block zeroes its nnz contexts (vp9block.c:1316)
        fill8(X.a_nnz[0] + col * 2, 0, bw4 * 2);
        fill8(X.l_nnz[0] + row7 * 2, 0, bh4 * 2);
        for (int p = 1; p < 3; ++p) {
          fill8(X.a_nnz[p] + ((col * 2) >> ss_h), 0, (bw4 * 2) >> ss_h);
          fill8(X.l_nnz[p] + ((row7 * 2) >> ss_v), 0, (bh4 * 2) >> ss_v);
        }
        phase = kPart;
      } else {
        phase = kCoef;
      }
      continue;
    }

    // COEF: every transform block of the block, plane by plane, a
    // transform block's scan positions in one loop (vp9block.c:805-923)
    const int col = bc - c0, row7 = br & 7;
    int modeidx = 0;
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
      const int prow = tx_p * 2 + !is_y;
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
      const uint8_t* coef_p = pr + kPCoef + prow * 36 * 11;
      int* cnt_eob = cnt + kCntEob + prow * 2 * 36 * 2;
      int* cnt_coef = cnt + kCntCoef + prow * 2 * 36 * 3;
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
            if (nep >= ecap) return kErrOverflow;
            epairs[nep++] = make_int2(
                ebase + (ey0 + cy) * ec16 + ex0 + cx, count);
          }
          if (is_y) modeidx += step * step;
        }
      }
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
    const int32_t* __restrict__ qmul_g, const int16_t* __restrict__ scans,
    const uint32_t* __restrict__ nbs, const uint8_t* __restrict__ bands_g,
    Params P, int bmax, int cmax, int emax, int32_t* __restrict__ blocks,
    int32_t* __restrict__ nblk_o, int2* __restrict__ cpairs,
    int32_t* __restrict__ ncp_o, int2* __restrict__ epairs,
    int32_t* __restrict__ nep_o, int32_t* __restrict__ counts,
    int32_t* __restrict__ err_o, long long* __restrict__ stats) {
  __shared__ uint8_t pr[kProbBytes];
  __shared__ int32_t qmul[32];
  __shared__ uint8_t bands[4 * 1024];
  __shared__ int cnt[kCntTotal];
  __shared__ Ctx X;
  const int s = blockIdx.x, t = threadIdx.x;
  for (int j = t; j < kProbBytes; j += 32) pr[j] = probs8[j];
  if (t < 32) qmul[t] = qmul_g[t];
  for (int j = t; j < 4 * 1024; j += 32) bands[j] = bands_g[j];
  for (int j = t; j < kCntTotal; j += 32) cnt[j] = 0;
  for (int j = t; j < kAbove; j += 32)
    X.a_part[j] = X.a_skip[j] = X.a_txfm[j] = 0;
  for (int j = t; j < 2 * kAbove; j += 32) {
    X.a_mode[j] = 2;
    X.a_nnz[0][j] = X.a_nnz[1][j] = X.a_nnz[2][j] = 0;
  }
  if (t < 8) X.l_part[t] = X.l_skip[t] = X.l_txfm[t] = 0;
  if (t < 16) {
    X.l_mode[t] = 2;
    X.l_nnz[0][t] = X.l_nnz[1][t] = X.l_nnz[2][t] = 0;
  }
  __syncthreads();
  if (t == 0) {
    const int* b = bounds + s * 4;
    const int* cp = caps + s * 3;
    Bools rd;
    rd.n = 0;
    rd.w.init(packet, tile_off[s], tile_len[s]);
    int nblk = 0, ncp = 0, nep = 0, err;
    const long long t0 = clock64();
    if (rd.get(128)) {
      err = kErrMarker;
    } else {
      rd.n = 0;
      err = walk(P, rd, X, pr, qmul, bands, scans, nbs, cnt,
                 8ll * tile_len[s], b[0], b[1], b[2], b[3], cp[0], cp[1],
                 cp[2], blocks + static_cast<int64_t>(s) * bmax * 34,
                 cpairs + static_cast<int64_t>(s) * cmax,
                 epairs + static_cast<int64_t>(s) * emax, nblk, ncp, nep);
    }
    stats[s * 2 + 1] = clock64() - t0;
    stats[s * 2] = rd.n;
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

// The walk of S tiles of one intra frame, a block a tile, on `stream`.
// packet: the frame's bytes; tile_off int64 [S], tile_len int32 [S]:
// each tile's place in it; bounds int32 [S, 4] (r0, r1, c0, c1 in 8x8
// units, each tile at most kMaxTileB8 columns wide); caps int32 [S, 3]:
// the rows each lane may write (records, coefficient pairs, eob pairs),
// at most bmax, cmax and emax, the outputs' row strides; probs8:
// ops/passa_device.py probs8's kProbBytes; qmul int32 [8, 4]; scans int16
// [20, 1024]; nbs int16 [20, 1024, 2]; bands uint8 [4, 1024]. Outputs:
// blocks int32 [S, bmax, 34], cpairs and epairs int32 [S, cmax or emax,
// 2], nblk, ncp, nep and err int32 [S], counts int32 [S, kCntTotal],
// stats int64 [S, 2] (bools after the marker, clock64 cycles).
int passa_walk(const uint8_t* packet, const int64_t* tile_off,
               const int32_t* tile_len, const int32_t* bounds,
               const int32_t* caps, const uint8_t* probs8,
               const int32_t* qmul, const int16_t* scans, const int16_t* nbs,
               const uint8_t* bands, int S, int rows, int cols, int sb_cols,
               int sb_rows, int txfmmode, int seg, int lossless, int bpp,
               int ss_h, int ss_v, int want_counts, int bmax, int cmax,
               int emax, int32_t* blocks, int32_t* nblk, int32_t* cpairs,
               int32_t* ncp, int32_t* epairs, int32_t* nep, int32_t* counts,
               int32_t* err, long long* stats, cudaStream_t stream) {
  if (S <= 0 || bmax < 0 || cmax < 0 || emax < 0 ||
      (bpp != 8 && bpp != 10 && bpp != 12))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P{rows, cols, sb_cols, sb_rows, txfmmode, seg, lossless, bpp,
                 ss_h, ss_v, want_counts};
  passa_kernel<<<S, 32, 0, stream>>>(
      packet, tile_off, tile_len, bounds, caps, probs8, qmul, scans,
      reinterpret_cast<const uint32_t*>(nbs), bands, P, bmax, cmax, emax,
      blocks, nblk, reinterpret_cast<int2*>(cpairs), ncp,
      reinterpret_cast<int2*>(epairs), nep, counts, err, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
