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
// at its own EOB. The tree and bits decoders branch on their own
// symbols; the coefficient walk is table-driven (below), with its
// tables, probabilities and energy cache in shared memory.
//
// What bounds it. A bool decode depends on the previous one (range and
// value carry), so a lane is one serial dependency chain of a few
// integer operations per bool; the kernel's time is the longest lane's
// chain times the per-bool latency, plus the launch and, for the
// coefficient walk, the zeroing of its outputs (12.5 MB for a 1080p
// keyframe's blocks, 3.7 us at 3.35 TB/s). The other bytes moved and the
// operations are far below what the card does in that time. So the
// design keeps the chain short: the renormalization shift is one
// count-leading-zeros, not a loop; the halfword feed refills once per
// ~5 bools; in the coefficient walk, no device-memory load and no
// branch of the token tree sits inside a bool.
//
// Integer semantics follow the JAX reference exactly: the halfword bit
// buffer is never masked and wraps (uint32 here, where signed overflow
// would be undefined), the dequant product wraps in int32, 32x32
// coefficients halve toward zero with the reference's int32 negation,
// and 8-bit coefficients wrap to int16.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// One bool under `prob` (P(0) = prob/256), before renormalization:
// the split compare shared by both feeds (vpx_rac.h:83-94).
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

// Byte-fed decoder: one bit per renormalization step, as the spec
// decoder (codecs/vp9/rac.py) and the Pallas _MultiRac read them.
struct Rac8 {
  const uint8_t* data;
  int len, pos, value, rng, cache, cache_n;

  __device__ int next_bit() {
    if (cache_n == 0) {
      cache = pos < len ? data[pos] : 0;
      cache_n = 8;
      ++pos;
    }
    --cache_n;
    return (cache >> cache_n) & 1;
  }

  __device__ void init(const uint8_t* d, int l) {
    data = d;
    len = l;
    pos = 0;
    value = 0;
    rng = 255;
    cache = 0;
    cache_n = 0;
    for (int i = 0; i < 8; ++i) value = (value << 1) | next_bit();
  }

  __device__ int get(int prob) {
    const int bit = bool_split(value, rng, prob);
    while (rng < 128) {
      value = (value << 1) | next_bit();
      rng <<= 1;
    }
    return bit;
  }
};

__global__ void decode_bits_kernel(const uint8_t* __restrict__ data, int S,
                                   int L, const uint8_t* __restrict__ probs,
                                   int K, int32_t* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  Rac8 rac;
  rac.init(data + static_cast<int64_t>(s) * L, L);
  const uint8_t* p = probs + static_cast<int64_t>(s) * K;
  int32_t* o = out + static_cast<int64_t>(s) * K;
  for (int i = 0; i < K; ++i) o[i] = rac.get(p[i]);
}

__global__ void decode_tree_kernel(const uint8_t* __restrict__ data, int S,
                                   int L, const uint8_t* __restrict__ probs,
                                   int NN, const int32_t* __restrict__ tree,
                                   int k, int max_depth,
                                   int32_t* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  Rac8 rac;
  rac.init(data + static_cast<int64_t>(s) * L, L);
  const uint8_t* p = probs + static_cast<int64_t>(s) * NN;
  for (int i = 0; i < k; ++i) {
    int node = 0, val = 0;
    for (int d = 0; d < max_depth; ++d) {
      const int nxt = tree[2 * node + rac.get(p[node])];
      if (nxt <= 0) {  // leaf: -value
        val = -nxt;
        break;
      }
      node = nxt;
    }
    out[static_cast<int64_t>(s) * k + i] = val;
  }
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

int blocks_for(int S) { return (S + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int rac_decode_bits(const uint8_t* data, int S, int L, const uint8_t* probs,
                    int K, int32_t* out, cudaStream_t stream) {
  decode_bits_kernel<<<blocks_for(S), kThreads, 0, stream>>>(data, S, L,
                                                             probs, K, out);
  return static_cast<int>(cudaGetLastError());
}

int rac_decode_tree(const uint8_t* data, int S, int L, const uint8_t* probs,
                    int NN, const int32_t* tree, int k, int max_depth,
                    int32_t* out, cudaStream_t stream) {
  decode_tree_kernel<<<blocks_for(S), kThreads, 0, stream>>>(
      data, S, L, probs, NN, tree, k, max_depth, out);
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
