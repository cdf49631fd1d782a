// The byte-fed VP9 bool decoder of the port's stream kernels, shared by
// csrc/rac.cu (the tree and bits kernels) and csrc/passa.cu (the
// on-device pass-A walk): a lane's byte row (Row), the decoder over it
// with its lookahead (Window), and a tree symbol over a Window on a
// transition table in shared memory (TreeWalk). See rac.cu's header for
// the design and its measurements.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// A lane's row of an [S, n] uint8 tensor in device memory, read as the
// aligned 32-bit words that hold it (a row may start at any byte). Only
// words that hold a byte of the row are loaded; a word is used as it was
// loaded, so nothing waits on a load until its bytes are taken, and
// bytes4 zeroes the bytes at or past the row's end there.
struct Row {
  const uint32_t* w;  // the aligned word that holds the row's byte 0
  int sh;             // bits of that word before byte 0
  int end;            // the row's end, in bytes from w; 0 for an empty row
  int n;              // the row's bytes

  __device__ void init(const uint8_t* base, int64_t off, int bytes) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(base + off);
    w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
    sh = static_cast<int>(a & 3) * 8;
    n = bytes;
    end = n > 0 ? static_cast<int>(a & 3) + n : 0;
  }
  // aligned word j as it lies in memory; 0, unloaded, past the row
  __device__ __forceinline__ uint32_t load(int j) const {
    uint32_t x = 0;
    if (4 * j < end) x = __ldg(w + j);
    return x;
  }
  // the row's bytes 4m..4m+3, little-endian, from its aligned words m
  // and m + 1 as loaded, the bytes at or past its end zeroed
  __device__ __forceinline__ uint32_t bytes4(uint32_t a, uint32_t b,
                                             int m) const {
    const uint32_t x = __funnelshift_r(a, b, sh);
    const int valid = n - 4 * m;
    return valid >= 4 ? x : valid <= 0 ? 0u : x & ((1u << (8 * valid)) - 1u);
  }
};

__device__ __forceinline__ uint32_t big_endian(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// The byte-fed decoder of decode_tree_multi and decode_bits_multi (the
// spec decoder, codecs/vp9/rac.py, and the Pallas _MultiRac), in a
// window: the BD_VALUE form of libvpx's vpx_dsp/bitreader.h, with the
// value kept apart so that it wraps in int32 as the Pallas kernel's.
// The bits after the value wait left-aligned in a 64-bit lookahead.
// fill, once every 4 bools, tops it up when it holds fewer than the 28
// bits 4 renormalizations may take (7 each): the next 32-bit word of the
// stream goes in below its bits, and the word after it is fetched then,
// a fill ahead of its use. A bool (get) is then the split compare and
// one shift of value and lookahead by 7 - top, top the range's highest
// set bit, with no branch; the range takes one shift after top's
// find-leading-one. Its reads are those of the Pallas
// ops/passa_device.py (there halfword-fed): get (_rac_get_prob), bits
// (_rac_bits) and TreeWalk::step below (_rac_tree, a bool a step).
struct Window {
  Row row;
  uint32_t a, b;  // aligned words k and k + 1 of the row, as loaded
  int k;          // the stream word the next fill takes
  uint64_t look;  // lookahead bits, left-aligned
  int count;      // lookahead bits held
  int value;      // the decoder's value (int32, wraps)
  int rng;        // its range, [128, 255] between bools

  // the spec decoder's init: the value is the stream's first byte
  __device__ void init(const uint8_t* base, int64_t off, int n) {
    row.init(base, off, n);
    const uint32_t a0 = row.load(0);
    a = row.load(1);
    b = row.load(2);
    const uint32_t w0 = big_endian(row.bytes4(a0, a, 0));
    value = static_cast<int>(w0 >> 24);
    look = static_cast<uint64_t>(w0 << 8) << 32;
    count = 24;
    k = 1;
    rng = 255;
  }

  // before every 4 bools: at least 28 lookahead bits
  __device__ __forceinline__ void fill() {
    if (count < 28) {
      look |= static_cast<uint64_t>(big_endian(row.bytes4(a, b, k)))
              << (32 - count);
      count += 32;
      a = b;
      b = row.load(++k + 1);
    }
  }

  // vpx_rac_get_prob: one bool with P(0) = prob/256, q = 256 - prob
  __device__ __forceinline__ int get(int prob, int q) {
    const int split = (rng * prob + q) >> 8;
    const int bit = value >= split;
    value = bit ? value - split : value;  // no overflow: value >= split
    const int r = bit ? rng - split : split;  // in [1, 255]
    const int top = 31 - __clz(r);
    const int sh = 7 - top;
    value = static_cast<int>(__funnelshift_l(
        static_cast<uint32_t>(look >> 32), static_cast<uint32_t>(value), sh));
    look <<= sh;
    count -= sh;
    rng = (r << 7) >> top;
    return bit;
  }

  // 4N bools, most significant first, bool m under byte m of the
  // little-endian words p4 (four probabilities a word, N words), a fill
  // before every 4
  template <int N>
  __device__ __forceinline__ uint32_t bits(const uint32_t* p4) {
    uint32_t v = 0;
#pragma unroll
    for (int m = 0; m < 4 * N; ++m) {
      if (m % 4 == 0) fill();
      const int p = static_cast<int>((p4[m >> 2] >> (8 * (m & 3))) & 0xff);
      v = (v << 1) | get(p, 256 - p);
    }
    return v;
  }
};

// A tree symbol over a Window, one bool a step (vp89_rac_get_tree with
// the Pallas kernel's depth cap), on a lane's transition table in shared
// memory (stage_tree): a node's entry (32 bytes) holds its two tree
// entries, the shared-memory offsets of both children's entries and
// both children's probabilities; a leaf's child is the root, node 0.
// While a bool decodes, step loads both children's entries, their
// offsets read straight from the node's; the bit picks one, and the
// next bool's probability is already in the node's entry. An entry <= 0
// is the leaf -entry (wrapping). With kCap, a symbol that reaches
// max_depth bools without a leaf is 0, and the next starts at the root;
// without, the caller knows that no symbol can (an acyclic tree no
// deeper than max_depth), and every step selects one of the two loaded
// entries, so the compiler cannot sink their loads past the bit.
template <bool kCap>
struct TreeWalk {
  const unsigned char* smem;  // the block's tables
  int max_depth, depth, prob, prob_root;
  int4 e, e_root;  // the node's entries and child offsets; the root's
  int2 p, p_root;  // the node's children's probabilities; the root's

  __device__ void init(const unsigned char* tables, int root, int md,
                       int root_prob) {
    smem = tables;
    max_depth = md;
    e_root = e = *reinterpret_cast<const int4*>(smem + root);
    p_root = p = *reinterpret_cast<const int2*>(smem + root + 16);
    prob_root = prob = root_prob;
    depth = 0;
  }

  // one bool (a fill every 4 is the caller's); true when it ends a
  // symbol, which is then in sym
  __device__ __forceinline__ bool step(Window& w, int& sym) {
    const int4 e0 = *reinterpret_cast<const int4*>(smem + e.z);
    const int4 e1 = *reinterpret_cast<const int4*>(smem + e.w);
    const int2 p0 = *reinterpret_cast<const int2*>(smem + e.z + 16);
    const int2 p1 = *reinterpret_cast<const int2*>(smem + e.w + 16);
    const int bit = w.get(prob, 256 - prob);
    const int c = bit ? e.y : e.x;
    sym = c <= 0 ? static_cast<int>(0u - static_cast<uint32_t>(c)) : 0;
    prob = bit ? p.y : p.x;
    e = bit ? e1 : e0;
    p = bit ? p1 : p0;
    if (!kCap) return c <= 0;
    const bool cap = ++depth == max_depth;
    depth = c <= 0 || cap ? 0 : depth;
    prob = cap ? prob_root : prob;
    e = cap ? e_root : e;
    p = cap ? p_root : p;
    return c <= 0 || cap;
  }
};

}  // namespace
