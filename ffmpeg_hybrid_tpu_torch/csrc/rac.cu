// VP9 boolean range decoder kernels for Hopper (sm_90a): the CUDA
// counterparts of the three Pallas kernels in
// ffmpeg_hybrid_tpu/ops/rac_pallas.py.
//
//   rac_decode_tree          replaces decode_tree_multi
//                            (rac_pallas.py:113-185)
//   rac_decode_bits          replaces decode_bits_multi
//                            (rac_pallas.py:188-222)
//   rac_decode_coeffs_frame  replaces decode_coeffs_multi
//                            (rac_pallas.py:522-559, body
//                            _coef_kernel_body :365-519), every lane of a
//                            frame in one launch
//   rac_bool_chain           a measurement: the cycles of one lane's
//                            bool chain
//
// Design. The Pallas kernels run all S lanes in lockstep on the TPU's
// vector unit: every branch is a predication mask, every byte fetch an
// O(L) masked compare-sum over the lane's buffer. Neither is needed on
// Hopper. Here each lane (one independent bool stream) is one thread
// that runs its own serial loop, reads its bytes or halfwords directly
// (reads past the end return 0, the spec's zero-extension), and stops
// at its own end. Each kernel makes one bool a step, its tables in
// shared memory or registers; the tree and bits steps branch only to
// fill their lookahead, once every 4 bools. Their lanes sit one to a
// block of one warp (kStreamLanes): lanes of a warp wait on each other's
// loads and depths (measured: tools/rac_streams_ab_torch.py).
//
// What bounds it. A bool decode depends on the previous one (range and
// value carry), so a lane is one serial dependency chain of a few
// integer operations per bool; the kernel's time is the longest lane's
// chain times the per-bool latency, plus the launch and, for the
// coefficient walk, the zeroing of its outputs (12.5 MB for a 1080p
// keyframe's blocks, 3.7 us at 3.35 TB/s). The other bytes moved and the
// operations are far below what the card does in that time. So the
// design keeps the chain short: the renormalization shift is one
// count-leading-zeros, not a loop; the stream is fed a word at a time,
// fetched before it is needed; no device-memory load and no branch of a
// tree sits inside a bool. On an H100 a tree or bits bool takes some 80
// cycles, six dependent operations with the find-leading-one among them,
// against 73 for the halfword chain alone (bool_chain_kernel). The
// byte-fed decoder (Row, Window) and the tree step (TreeWalk) live in
// rac_window.cuh, which csrc/passa.cu's walk shares.
//
// Integer semantics follow the JAX reference exactly: the byte-fed
// decoders' value is int32 and wraps (the Pallas _MultiRac's; it parts
// from the spec decoder's unbounded integer only on a stream whose first
// byte is 0xff, which no encoder writes), the halfword bit buffer is
// never masked and wraps (uint32 here, where signed overflow would be
// undefined), the dequant product wraps in int32, 32x32 coefficients
// halve toward zero with the reference's int32 negation, and 8-bit
// coefficients wrap to int16.
#include <cstdint>
#include <cuda_runtime.h>

#include "rac_window.cuh"

namespace {

// One bool under `prob` (P(0) = prob/256), before renormalization:
// the split compare of the halfword-fed decoder (vpx_rac.h:83-94).
__device__ __forceinline__ int bool_split(int& value, int& rng, int prob) {
  const int split = 1 + (((rng - 1) * prob) >> 8);
  if (value >= split) {
    value -= split;
    rng -= split;
    return 1;
  }
  rng = split;
  return 0;
}

// The halfword-fed decoder's renormalization (the Pallas _MultiRac16):
// one shift by 8 - bit_length(range), its bits taken from the bit
// buffer, which its caller refills with one big-endian 16-bit fetch
// whenever it holds fewer than 8 bits.
__device__ __forceinline__ void renorm16(int& value, int& rng,
                                         uint32_t bitbuf, int& nbits) {
  const int sh = __clz(rng) - 24;  // rng in [1, 255]
  value = (value << sh) |
          static_cast<int>((bitbuf >> (nbits - sh)) & ((1u << sh) - 1u));
  rng <<= sh;
  nbits -= sh;
}

// Lanes a block (of one warp) of the tree and bits kernels: 1 beat 8 and
// 32 on every input of tools/rac_streams_ab_torch.py, which varies it.
constexpr int kStreamLanes = 1;

// Stage the transition tables of a block's lanes (nl rows of NN
// probabilities from probs) for the tree [NN, 2]: entry (l, m) at byte
// 32 (l NN + m) is {tree[m][0], tree[m][1], the offsets of entries
// (l, max(tree[m][0], 0)) and (l, max(tree[m][1], 0))} and {the
// probabilities of those two nodes}; the whole block, off the chain.
__device__ void stage_tree(unsigned char* smem, const int32_t* tree, int NN,
                           const uint8_t* probs, int nl) {
  for (int j = threadIdx.x; j < nl * NN; j += blockDim.x) {
    const int l = j / NN, m = j - l * NN;
    const int e0 = tree[2 * m], e1 = tree[2 * m + 1];
    const int n0 = max(e0, 0), n1 = max(e1, 0);
    const int base = 32 * l * NN;
    *reinterpret_cast<int4*>(smem + 32 * j) =
        make_int4(e0, e1, base + 32 * n0, base + 32 * n1);
    *reinterpret_cast<int2*>(smem + 32 * j + 16) =
        make_int2(probs[l * NN + n0], probs[l * NN + n1]);
  }
}

// decode_bits_multi. A lane a thread, kStreamLanes lanes to a block of
// one warp. The probabilities are read 16 at a time as five aligned words,
// the next 16's loaded while these decode (Window::bits<4>); the
// outputs leave as four 16-byte stores (where the rows are 16-byte
// aligned, K % 4 == 0). Bools past K decode on zero probabilities and
// are not stored: each lane's outputs before them are already fixed.
template <bool kTimed>
__global__ void __launch_bounds__(32) decode_bits_kernel(
    const uint8_t* __restrict__ data, int S, int L,
    const uint8_t* __restrict__ probs, int K, int32_t* __restrict__ out,
    long long* __restrict__ cycles) {
  const int t = threadIdx.x;
  const int s = blockIdx.x * kStreamLanes + t;
  if (t >= kStreamLanes || s >= S) return;
  Window w;
  w.init(data, static_cast<int64_t>(s) * L, L);
  Row pr;
  pr.init(probs, static_cast<int64_t>(s) * K, K);
  int32_t* o = out + static_cast<int64_t>(s) * K;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  uint32_t q0 = pr.load(0), q1 = pr.load(1), q2 = pr.load(2),
           q3 = pr.load(3), q4 = pr.load(4);
  long long t0 = 0;
  if (kTimed) t0 = clock64();
  for (int i = 0; i < K; i += 16) {
    const int j = i >> 2;  // the aligned word of probability i
    const uint32_t n1 = pr.load(j + 5), n2 = pr.load(j + 6),
                   n3 = pr.load(j + 7), n4 = pr.load(j + 8);
    const uint32_t p4[4] = {pr.bytes4(q0, q1, j), pr.bytes4(q1, q2, j + 1),
                            pr.bytes4(q2, q3, j + 2),
                            pr.bytes4(q3, q4, j + 3)};
    const uint32_t v = w.bits<4>(p4);
    if (vec && i + 16 <= K) {
      int4* o4 = reinterpret_cast<int4*>(o + i);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        o4[m] = make_int4((v >> (15 - 4 * m)) & 1, (v >> (14 - 4 * m)) & 1,
                          (v >> (13 - 4 * m)) & 1, (v >> (12 - 4 * m)) & 1);
    } else {
#pragma unroll
      for (int m = 0; m < 16; ++m)
        if (i + m < K) o[i + m] = (v >> (15 - m)) & 1;
    }
    q0 = q4;
    q1 = n1;
    q2 = n2;
    q3 = n3;
    q4 = n4;
  }
  if (kTimed) cycles[s] = clock64() - t0;
}

// decode_tree_multi. A lane a thread, kStreamLanes lanes to a block of
// one warp. The block stages its lanes' transition tables (stage_tree);
// each lane then runs TreeWalk steps, 4 to a fill, every lane the same
// instructions, and leaves when its k symbols are written (the steps
// after the k-th of a group of 4 decode and are not stored).
template <bool kTimed, bool kCap>
__global__ void __launch_bounds__(32) decode_tree_kernel(
    const uint8_t* __restrict__ data, int S, int L,
    const uint8_t* __restrict__ probs, int NN,
    const int32_t* __restrict__ tree, int k, int max_depth,
    int32_t* __restrict__ out, long long* __restrict__ cycles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int lane0 = blockIdx.x * kStreamLanes;
  const int nl = min(kStreamLanes, S - lane0);
  stage_tree(smem, tree, NN, probs + static_cast<int64_t>(lane0) * NN, nl);
  __syncthreads();
  if (t >= nl) return;
  const int s = lane0 + t;
  int32_t* o = out + static_cast<int64_t>(s) * k;  // the next symbol's
  int32_t* const end = o + k;
  if (max_depth <= 0) {  // no bool is read: every symbol is 0
    for (; o < end; ++o) *o = 0;
    return;
  }
  Window w;
  w.init(data, static_cast<int64_t>(s) * L, L);
  TreeWalk<kCap> walk;
  walk.init(smem, 32 * t * NN, max_depth,
            probs[static_cast<int64_t>(s) * NN]);
  long long t0 = 0;
  if (kTimed) t0 = clock64();
  while (o < end) {
    w.fill();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int sym;
      const bool done = walk.step(w, sym);
      if (done && o < end) *o = sym;
      o += done;
    }
  }
  if (kTimed) cycles[s] = clock64() - t0;
}

// The coefficient walk: decode_coeffs_b (vp9block.c:805-923) for one
// transform block per lane, resumed from a host bool-decoder snapshot,
// every lane of a frame in one launch, whatever its size.
//
// Design. A warp is a block: lanes-per-block lanes (at most 32, set by
// the host so that the blocks cover every SM), each a thread. The host
// packs the frame (ops/rac.py pack_lanes): a lane table (one 16-int row
// a lane), a block table (its lanes and the ranges of the tables,
// probabilities and outputs they use), the halfword windows of all
// lanes end to end, the distinct scan/neighbour tables (one uint32 a
// position: scan | nb0 << 10 | nb1 << 20; every lane of one size and
// scan order shares one), the distinct probability rows (36 x 11 bytes;
// every lane of one size, plane type and reference shares one), and the
// token machine. Before its walk, a block stages its ranges of tables
// and probability rows and the machine in shared memory, zeroes its
// lanes' output rows (contiguous, int4 stores by the whole warp) and
// their energy caches (shared), all off the bool chain. The walk then
// makes one bool a step: the state (a token-tree node, an extra bit of
// a category, or the sign) names its probability (a byte of the lane's
// probability row, or a constant of the state) and its two transitions,
// both read from shared memory while the bool decodes; the decoded bit
// picks one, which sets the next state, the token's base value and
// energy, the extra bits it shifts in, and what ends with it: the walk
// (EOB), a zero token or a coefficient (then the cache, the context of
// the next position and its probability row). The next position's
// table word and the energies of its context's neighbours are loaded
// one position ahead, so no load waits inside that step. So every bool
// runs the same instructions, with selects in place of branches, and a
// lane leaves the warp only at its EOB. The halfword stream is read from device memory one
// word ahead of its use. The walk writes only nonzero coefficients.
//
// Token machine (pack_lanes builds it per bit depth): states 0-10 the
// tree nodes of the probability row (0 EOB, 1 zero, 2 one, ...), 11 the
// sign (probability 128), from 12 the extra bits of cat1-cat6, one state
// a bit with its constant probability (cat6: 14, 16 or 18 bits by bit
// depth). A transition word: bits 0-1 the action (kCont, kEob, kZero,
// kCoef), 2-7 the next state, bit 8 sets base (bits 16-23) and energy
// (bits 24-26) and clears the extra bits, bit 9 shifts the bit into the
// extra bits. The token's value is base + extra bits.
//
// Registers and shared memory: the ptxas report is kept beside the
// library (_build.py); shared memory per block is 576 B of machine, the
// block's tables (at most 2,032 words a frame) and probability rows
// (396 B each), and one energy byte per coefficient of its lanes (at
// most 32 KB).
constexpr int kLaneCols = 16;
constexpr int kBlockCols = 10;
constexpr int kStates = 64;
constexpr int kSign = 11;
constexpr int kMachineBytes = kStates * 8 + kStates;
enum { kCont = 0, kEob = 1, kZero = 2, kCoef = 3 };
constexpr uint32_t kLeaf = 1u << 8, kShiftIn = 1u << 9;
// lane table columns (pack_lanes' order)
enum {
  kHalfOff, kHalfLen, kOutOff, kTx, kTabOff, kProbOff, kNnz, kQdc, kQac,
  kValue, kRng, kBitbuf, kNbits, kCacheOff, kIs32
};
// block table columns
enum {
  kLane0, kNLanes, kTabLo, kTabHi, kProbLo, kProbHi, kOutLo, kOutHi,
  kCacheBytes
};

__device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

__global__ void __launch_bounds__(32) decode_coeffs_kernel(
    const int32_t* __restrict__ lanes, const int32_t* __restrict__ blocks,
    const int32_t* __restrict__ half16, const uint32_t* __restrict__ tables,
    const uint8_t* __restrict__ probs, const int32_t* __restrict__ machine,
    int bpp, int32_t* __restrict__ coef, int32_t* __restrict__ eob) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int32_t* blk = blocks + blockIdx.x * kBlockCols;
  const int lane0 = blk[kLane0], nl = blk[kNLanes];
  const int tlo = blk[kTabLo], ntab = blk[kTabHi] - tlo;
  const int plo = blk[kProbLo], nprob = blk[kProbHi] - plo;
  const int olo = blk[kOutLo], nout = blk[kOutHi] - olo;
  const int ncache = blk[kCacheBytes];
  uint2* s_trans = reinterpret_cast<uint2*>(smem);
  uint8_t* s_cprob = smem + kStates * 8;
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(smem + kMachineBytes);
  uint8_t* s_prob = smem + kMachineBytes + round16(4 * ntab);
  uint8_t* s_cache = s_prob + round16(nprob);
  const int t = threadIdx.x;
  // staging and zeroing: off the chain, the whole warp
  for (int k = t; k < kStates; k += 32) {
    s_trans[k] = make_uint2(static_cast<uint32_t>(machine[2 * k]),
                            static_cast<uint32_t>(machine[2 * k + 1]));
    s_cprob[k] = static_cast<uint8_t>(machine[2 * kStates + k]);
  }
  for (int k = t; k < ntab; k += 32) s_tab[k] = tables[tlo + k];
  for (int k = t; k < nprob / 4; k += 32)
    reinterpret_cast<uint32_t*>(s_prob)[k] =
        reinterpret_cast<const uint32_t*>(probs + plo)[k];
  int4* o4 = reinterpret_cast<int4*>(coef + olo);
  for (int k = t; k < nout / 4; k += 32) o4[k] = make_int4(0, 0, 0, 0);
  for (int k = t; k < ncache / 16; k += 32)
    reinterpret_cast<int4*>(s_cache)[k] = make_int4(0, 0, 0, 0);
  __syncthreads();
  if (t >= nl) return;

  const int32_t* L = lanes + static_cast<int64_t>(lane0 + t) * kLaneCols;
  const int32_t* half = half16 + L[kHalfOff];
  const int len = L[kHalfLen];
  const int tx = L[kTx];
  const int n = 16 << (2 * tx);
  const uint32_t* tab = s_tab + (L[kTabOff] - tlo);
  const uint8_t* prow = s_prob + (L[kProbOff] - plo);
  uint8_t* cache = s_cache + L[kCacheOff];
  int32_t* out = coef + L[kOutOff];
  const int q_dc = L[kQdc], q_ac = L[kQac], is32 = L[kIs32];
  const int b5 = tx ? 21 : 13;   // where band 5 starts (band_table)
  int value = L[kValue], rng = L[kRng], nbits = L[kNbits];
  uint32_t bitbuf = static_cast<uint32_t>(L[kBitbuf]);
  int pos = 0;
  uint32_t next_hw = len > 0 ? static_cast<uint32_t>(half[0]) : 0u;
  int ctx = L[kNnz];
  int i = 0, s = 0, base = 0, energy = 0, extra = 0, count = 0;
  // the position's table word, the next one's, and the energies of the
  // neighbours whose context follows this position, all loaded one
  // position ahead; a neighbour that is this position itself takes the
  // energy it gets here
  uint32_t w = tab[0], w_next = tab[n > 1 ? 1 : 0];
  int c0 = cache[(w >> 10) & 1023], c1 = cache[w >> 20];
  int row = ctx * 11;   // band 0
  for (;;) {
    const uint8_t* pp = s < kSign ? prow + row : s_cprob;
    const int prob = pp[s];
    const uint2 tr = s_trans[s];
    // one bool of the halfword-fed decoder (the Pallas _MultiRac16)
    if (nbits < 8) {
      bitbuf = (bitbuf << 16) | next_hw;
      nbits += 16;
      ++pos;
      next_hw = pos < len ? static_cast<uint32_t>(half[pos]) : 0u;
    }
    const int bit = bool_split(value, rng, prob);
    renorm16(value, rng, bitbuf, nbits);
    // the token machine
    const uint32_t tw = bit ? tr.y : tr.x;
    extra = (tw & kShiftIn) ? (extra << 1) | bit : extra;
    const bool leaf = tw & kLeaf;
    base = leaf ? static_cast<int>((tw >> 16) & 0xff) : base;
    energy = leaf ? static_cast<int>((tw >> 24) & 7) : energy;
    extra = leaf ? 0 : extra;
    s = (tw >> 2) & 63;
    const int act = tw & 3;
    if (act == kCont) continue;
    if (act == kEob) {
      count = i;
      break;
    }
    // a zero token or a coefficient (then bit is its sign)
    const int rc = w & 1023;
    const int e = act == kCoef ? energy : 0;
    const int val = base + extra;
    const uint32_t q = static_cast<uint32_t>(i == 0 ? q_dc : q_ac);
    int32_t prod =
        static_cast<int32_t>(static_cast<uint32_t>(bit ? -val : val) * q);
    if (is32)  // the reference's -((-prod) >> 1) in wrapping int32
      prod = prod < 0 ? static_cast<int32_t>(
                            0u - static_cast<uint32_t>(
                                     static_cast<int32_t>(
                                         0u - static_cast<uint32_t>(prod)) >>
                                     1))
                      : prod >> 1;
    if (bpp == 8) prod = static_cast<int16_t>(prod);
    if (act == kCoef) out[rc] = prod;
    cache[rc] = static_cast<uint8_t>(e);
    ctx = (1 + (((w >> 10) & 1023) == static_cast<uint32_t>(rc) ? e : c0) +
           ((w >> 20) == static_cast<uint32_t>(rc) ? e : c1)) >> 1;
    if (++i == n) {
      count = n;
      break;
    }
    w = w_next;
    w_next = tab[i + 1 < n ? i + 1 : i];
    c0 = cache[(w >> 10) & 1023];
    c1 = cache[w >> 20];
    const int band = (i >= 1) + (i >= 3) + (i >= 6) + (i >= 10) + (i >= b5);
    row = (band * 6 + ctx) * 11;
  }
  eob[lane0 + t] = count;
}

// The bool chain alone: one thread decodes K bools of a halfword stream
// staged in shared memory, with 8 probabilities held in registers, and
// times the loop with clock64 (cycles into cycles[0]). A bool of the
// walk cannot take fewer cycles than one of these.
constexpr int kChainHalf = 4096;

__global__ void bool_chain_kernel(const int32_t* __restrict__ half, int len,
                                  int value, int rng, uint32_t bitbuf,
                                  int nbits, const int32_t* __restrict__ p8,
                                  int K, long long* __restrict__ cycles,
                                  int32_t* __restrict__ sink) {
  __shared__ uint32_t s_half[kChainHalf];
  const int m = len < kChainHalf ? len : kChainHalf;
  for (int k = threadIdx.x; k < m; k += blockDim.x)
    s_half[k] = static_cast<uint32_t>(half[k]);
  __syncthreads();
  if (threadIdx.x) return;
  int p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = p8[j];
  int pos = 0, acc = 0;
  uint32_t next_hw = m > 0 ? s_half[0] : 0u;
  const long long t0 = clock64();
  for (int k = 0; k < K; k += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (nbits < 8) {
        bitbuf = (bitbuf << 16) | next_hw;
        nbits += 16;
        ++pos;
        next_hw = pos < m ? s_half[pos] : 0u;
      }
      acc += bool_split(value, rng, p[j]);
      renorm16(value, rng, bitbuf, nbits);
    }
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = acc ^ value ^ rng;
}

}  // namespace

extern "C" {

// K bools of each of S streams (data [S, L] uint8) under probs [S, K]
// uint8 into out [S, K] int32 on `stream`; cycles: null, or int64 [S]
// that takes each lane's clock64 cycles from its first bool to its last
// store (an instance of the kernel that reads the clock; with null, one
// that does not).
int rac_decode_bits(const uint8_t* data, int S, int L, const uint8_t* probs,
                    int K, int32_t* out, long long* cycles,
                    cudaStream_t stream) {
  if (S < 0 || L < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!S || !K) return static_cast<int>(cudaSuccess);
  const int blocks = (S + kStreamLanes - 1) / kStreamLanes;
  if (cycles)
    decode_bits_kernel<true><<<blocks, 32, 0, stream>>>(data, S, L, probs, K,
                                                        out, cycles);
  else
    decode_bits_kernel<false><<<blocks, 32, 0, stream>>>(data, S, L, probs, K,
                                                         out, cycles);
  return static_cast<int>(cudaGetLastError());
}

// k symbols of the tree [NN, 2] int32 (every entry < NN; an entry <= 0
// is the leaf -entry) from each of S streams (data [S, L] uint8) under
// probs [S, NN] uint8 into out [S, k] int32 on `stream`; a symbol takes
// at most max_depth bools, and capped is 0 only where none can reach
// them (an acyclic tree no deeper than max_depth); cycles as
// rac_decode_bits'. Shared memory: 32 kStreamLanes NN bytes, at most
// 227 KB.
int rac_decode_tree(const uint8_t* data, int S, int L, const uint8_t* probs,
                    int NN, const int32_t* tree, int k, int max_depth,
                    int capped, int32_t* out, long long* cycles,
                    cudaStream_t stream) {
  if (S < 0 || L < 0 || NN < 1 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!S || !k) return static_cast<int>(cudaSuccess);
  const int64_t smem = 32 * static_cast<int64_t>(kStreamLanes) * NN;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = cycles ? (capped ? decode_tree_kernel<true, true>
                                 : decode_tree_kernel<true, false>)
                       : (capped ? decode_tree_kernel<false, true>
                                 : decode_tree_kernel<false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (S + kStreamLanes - 1) / kStreamLanes;
  kernel<<<blocks, 32, static_cast<int>(smem), stream>>>(
      data, S, L, probs, NN, tree, k, max_depth, out, cycles);
  return static_cast<int>(cudaGetLastError());
}

// Every lane of a packed frame (ops/rac.py pack_lanes) in one launch on
// `stream`: lanes [S, kLaneCols] and blocks [nblocks, kBlockCols] int32,
// half16 the lanes' halfword windows end to end, tables (uint32 words),
// probs (uint8 rows), machine [3 * kStates] int32, smem the largest
// block's shared bytes; coef gets every lane's [n] row (zeros included)
// at its output offset, eob one int a lane.
int rac_decode_coeffs_frame(const int32_t* lanes, const int32_t* blocks,
                            int nblocks, const int32_t* half16,
                            const uint32_t* tables, const uint8_t* probs,
                            const int32_t* machine, int bpp, int smem,
                            int32_t* coef, int32_t* eob, cudaStream_t stream) {
  if (nblocks < 0 || smem < kMachineBytes || (bpp != 8 && bpp != 10 &&
                                              bpp != 12))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!nblocks) return static_cast<int>(cudaSuccess);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_coeffs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_coeffs_kernel<<<nblocks, 32, smem, stream>>>(
      lanes, blocks, half16, tables, probs, machine, bpp, coef, eob);
  return static_cast<int>(cudaGetLastError());
}

// The bool chain's cycles (bool_chain_kernel): K (a multiple of 8) bools
// of the stream half [len] from the state (value, rng, bitbuf, nbits)
// under the 8 probabilities p8, one thread; cycles: one int64, sink: one
// int32 on the device.
int rac_bool_chain(const int32_t* half, int len, int value, int rng,
                   int bitbuf, int nbits, const int32_t* p8, int K,
                   long long* cycles, int32_t* sink, cudaStream_t stream) {
  if (len < 0 || K < 0 || K % 8) return static_cast<int>(cudaErrorInvalidValue);
  bool_chain_kernel<<<1, 32, 0, stream>>>(half, len, value, rng,
                                          static_cast<uint32_t>(bitbuf), nbits,
                                          p8, K, cycles, sink);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
