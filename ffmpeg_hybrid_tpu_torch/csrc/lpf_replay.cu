// VP9 loop filter by record replay for Hopper (sm_90a): the recorded edge
// calls of a frame replayed over the tile-column stripes of a plane set,
// with the stripes' halos kept equal to their neighbours' tails. The
// CUDA counterpart of the JAX package's _lf_scan (ffmpeg_hybrid_tpu/ops/
// lpf_tpu.py:115-162) with the sharded scan of its parallel/fullframe.py
// (_lf_apply_step, :163-200, and _lf_scan_sharded, :201-243). Those are
// XLA programs (a lax.scan under shard_map, halos over ppermute), not
// Pallas kernels. The port's plain versions are ops/lpf_replay.py's
// lf_scan_plain and lf_scan_sharded_plain.
//
//   lf_replay       T stripes (1-8) of a plane set, in place, one launch
//   lf_replay_from  the same for a segment of the steps (first > 0: the
//                   halos already mirror their tails, no copy)
//
// Semantics. planes: [T, B, H, Wb] int32, B = 1 (Y) or 2 (U and V: the
// chroma records apply to both). The recorded steps of each stripe (py,
// px, dir, wd, E, I, H in its buffer's coordinates; wd 0 a no-op) run in
// the global (wave, substep) order: step s of every stripe before step s
// + 1 of any. A record filters 8 lanes of 16 samples across its edge:
// dir 0 rows py..py+7, columns px-8..px+7; dir 1 columns px..px+7, rows
// py-8..py+7. Reads clamp to the buffer; the filter's written range
// (1..14, 5..10 or 6..9) is stored where it lies inside the buffer.
// With halo set (T > 1), columns 0..7 of stripe t > 0 mirror columns
// wreal[t-1] .. wreal[t-1]+7 of stripe t-1 (its last 8 real columns,
// its tail): first the halo takes a copy of the tail, then every store
// into a tail or a halo also goes to its mirror. The records of one step
// never touch the same pixel from two stripes (the wavefront's
// disjointness, fullframe.py's header), so the mirror of a pixel a step
// stored holds what the JAX merge gives: the side that changed it wins
// (:224-238), and where neither did both sides hold the old value.
//
// Dataflow. The host (ops/lpf_replay.py, build_tickets) turns the steps
// of a launch into tickets, one a superblock (SB) of the frame that has
// live records in the launch's steps: its records in recorded order,
// grouped into levels (records of one level touch disjoint samples: the
// V records of different 8-row groups, the H records of different
// 8-column groups), the bounding box of their footprints (the SB plus at
// most 8 samples all round) and of what they may write, and the tickets
// it waits for. SB (r, c) of the frame's columns (across stripes: the
// halo and the tail are the same samples) overlaps its 8 neighbours
// only; it waits for those of them that come before it in the wave
// order 2r + c and have a ticket in the launch: (r, c-1), (r-1, c-1),
// (r-1, c), (r-1, c+1). So every pair of tickets whose windows overlap
// runs in the reference's order, whichever tickets are missing, and all
// others commute. Tickets go wave by wave from an atomic counter to a
// persistent grid; a ticket waits only on earlier tickets, so the launch
// cannot deadlock whatever the residency (csrc/lpf.cu's argument). A
// launch that copies the halos (first == 0, halo set) takes a copy
// ticket first, and every SB in a column next to a stripe boundary also
// waits for it. Per ticket, one block:
//   1. loads its records and level bounds into shared memory and starts
//      the copy of its window but what its waits guard (cp.async through
//      L2: the rows the tickets above write and the columns the ticket on
//      the left and the halo copy write; the host finds them from their
//      write boxes), while threads 0-4 wait for the flags it depends on
//      (ld.acquire.gpu) to hold this launch's epoch;
//   2. copies the rest of its window (another SM wrote it), every copy in
//      flight at once, into shared memory with a row stride of 4 mod 8
//      words;
//   3. runs its levels in order: a thread a (record, plane, lane), the 16
//      samples in registers (compile-time indices; no clamps where the
//      record lies inside the buffer), a named barrier of the working
//      warps between levels;
//   4. writes back its write box once, with every tail or halo column
//      also stored to its mirror (the first and last stripe
//      of a launch mirror nothing across a process boundary);
//   5. publishes its flag after fence.acq_rel.gpu.
// The flags carry the launch's epoch (the wrapper passes a new one each
// call), so they need no reset; the last block resets the counter.
// Samples stay int32 in shared memory: at most 52 KB a block (a 4:4:4
// U+V window), and the dataflow keeps at most a few dozen tickets live
// at once against 2 blocks on each of the card's SMs, so int16 would buy
// no residency that is used.
//
// What bounds it. The work is small: the frame's planes read and
// written once, halos and padding not counted, and each record read once
// (1080p frame 0 of bench_1080p_lf: 18,936 Y and 7,646 U+V records, 25.8
// MB, 7.7 us at 3.35 TB/s), and ~100 integer operations a lane. It is a
// chain: 2 (sb_rows - 1) + sb_cols waves of tickets (62 at 1080p), each
// a few L2 round trips (the flag, the window's guarded part, the
// write-back before the release) and its levels in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "lpf_filter.cuh"

namespace {

constexpr int kHalo = 8;
constexpr int kMaxStripes = 8;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;
// int4 a ticket: (stripe, lv0, nlv, copy dep | nwork << 8), (dep0-3),
// load box (r0, c0, nr, nc), write box (r0, c0, nr, nc), (rec0, nrec,
// rt, cl: the rows and columns of the load box that the waits guard end)
constexpr int kTicketInt4 = 5;

struct Args {
  int32_t* pl;           // [T, B, H, Wb]
  const int4* tickets;   // [nt][kTicketInt4]
  const int* levels;     // record index at which each level starts
  const int4* recs;      // (py, px, dir | wd << 2, E | I << 8 | H << 16)
  int* flags;            // [nt + 1]: a ticket's, then the copy's
  unsigned* ctr;         // ticket, blocks done
  int wreal[kMaxStripes];
  int T, B, H, Wb, nt, copy, halo, bpp, epoch, max_recs, lv_ints;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Publish v at p after every write that happened before it, this
// block's other threads' included when they precede a __syncthreads()
// (the fence releases them too).
__device__ __forceinline__ void release(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\n\tst.relaxed.gpu.global.s32 [%0], %1;"
               ::"l"(p), "r"(v)
               : "memory");
}

// The barrier of the first n threads (a multiple of 32) between levels.
__device__ __forceinline__ void level_barrier(int n) {
  if (n <= 32)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// The halo copy: columns 0..7 of every stripe t > 0 take its left
// neighbour's tail (two int4 a row), then the copy's flag.
__device__ void copy_halos(const Args& a) {
  const size_t plane = static_cast<size_t>(a.H) * a.Wb;
  const size_t set = plane * a.B;
  const int rows = a.B * a.H;
  const int n = (a.T - 1) * rows * 2;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = 1 + i / (rows * 2);
    const int rem = i % (rows * 2);
    const size_t row = static_cast<size_t>(rem / 2) * a.Wb;
    int32_t* dst = a.pl + set * t + row;
    const int32_t* src = a.pl + set * (t - 1) + row + a.wreal[t - 1];
    __stcg(reinterpret_cast<int4*>(dst) + (rem & 1),
           __ldcg(reinterpret_cast<const int4*>(src) + (rem & 1)));
  }
  __syncthreads();
  if (threadIdx.x == 0) release(a.flags + a.nt, a.epoch);
}

// One lane of a record on the window w (shared memory, row stride S,
// buffer rows r0.., columns c0..): its 16 samples, clamped to the buffer,
// through the filter, and the written range stored where it lies inside
// the buffer. A record whose lanes lie inside the buffer (all but those
// at its edges) takes the path without clamps.
__device__ __forceinline__ void run_lane(int32_t* w, int S, int r0, int c0,
                                         int H, int Wb, int4 rec, int lane,
                                         int bpp) {
  const int wd = rec.z >> 2;
  if (wd <= 0) return;
  const int py = rec.x, px = rec.y, dir = rec.z & 3;
  const int E = rec.w & 255, I = (rec.w >> 8) & 255, Hev = rec.w >> 16;
  int x[16];
  if (dir == 0) {
    const int y = py + lane;
    if (y < 0 || y >= H) return;  // reads a clamped row, writes nothing
    int32_t* row = w + (y - r0) * S - c0;
    const bool inside = px >= 8 && px + 8 <= Wb;
    if (inside) {
      int32_t* e = row + px - 8;
#pragma unroll
      for (int j = 0; j < 16; ++j) x[j] = e[j];
      const int cls = filter_edge(x, wd, E, I, Hev, bpp);
      if (!cls) return;
      const int lo = cls == 16 ? 1 : cls == 8 ? 5 : 6;
      const int hi = cls == 16 ? 15 : cls == 8 ? 11 : 10;
#pragma unroll
      for (int j = 1; j < 15; ++j)
        if (j >= lo && j < hi) e[j] = x[j];
      return;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) x[j] = row[clampi(px - 8 + j, 0, Wb - 1)];
    const int cls = filter_edge(x, wd, E, I, Hev, bpp);
    if (!cls) return;
    const int lo = cls == 16 ? 1 : cls == 8 ? 5 : 6;
    const int hi = cls == 16 ? 15 : cls == 8 ? 11 : 10;
#pragma unroll
    for (int j = 1; j < 15; ++j) {
      const int c = px - 8 + j;
      if (j >= lo && j < hi && c >= 0 && c < Wb) row[c] = x[j];
    }
  } else {
    const int c = px + lane;
    if (c < 0 || c >= Wb) return;  // reads a clamped column, writes nothing
    int32_t* col = w + c - c0 - r0 * S;
    const bool inside = py >= 8 && py + 8 <= H;
    if (inside) {
      int32_t* e = col + (py - 8) * S;
#pragma unroll
      for (int j = 0; j < 16; ++j) x[j] = e[j * S];
      const int cls = filter_edge(x, wd, E, I, Hev, bpp);
      if (!cls) return;
      const int lo = cls == 16 ? 1 : cls == 8 ? 5 : 6;
      const int hi = cls == 16 ? 15 : cls == 8 ? 11 : 10;
#pragma unroll
      for (int j = 1; j < 15; ++j)
        if (j >= lo && j < hi) e[j * S] = x[j];
      return;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) x[j] = col[clampi(py - 8 + j, 0, H - 1) * S];
    const int cls = filter_edge(x, wd, E, I, Hev, bpp);
    if (!cls) return;
    const int lo = cls == 16 ? 1 : cls == 8 ? 5 : 6;
    const int hi = cls == 16 ? 15 : cls == 8 ? 11 : 10;
#pragma unroll
    for (int j = 1; j < 15; ++j) {
      const int y = py - 8 + j;
      if (j >= lo && j < hi && y >= 0 && y < H) col[y * S] = x[j];
    }
  }
}

// An asynchronous 16-byte copy from global (through L2, where another
// SM's writes are) to shared memory, and the wait for all of a thread's.
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The rows [ya, yb) x columns [xa, xb) (multiples of 4) of each of the B
// planes into the window (rows r0.., columns c0.., stride S): a flat
// index over the int4 of the rectangle (a warp a row left lanes idle and
// took longer), every copy in flight.
template <int B>
__device__ __forceinline__ void copy_rect(const int32_t* own, size_t plane,
                                          int Wb, int32_t* win, int S,
                                          int nr, int r0, int c0, int ya,
                                          int yb, int xa, int xb) {
  const int nq = (xb - xa) >> 2, rows = yb - ya;
  if (nq <= 0 || rows <= 0) return;
  const int n = B * rows * nq;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int b = i / (rows * nq), y = ya + i / nq % rows, q = i % nq;
    cp16(win + (b * nr + y - r0) * S + xa - c0 + 4 * q,
         own + plane * b + static_cast<size_t>(y) * Wb + xa + 4 * q);
  }
}

// Ticket k: steps 1-5 of the header, for sets of B planes.
template <int B>
__device__ void run_ticket(const Args& a, int k, int4* srec, int* slev,
                           int32_t* win) {
  const int tid = threadIdx.x;
  const int4* e = a.tickets + static_cast<size_t>(k) * kTicketInt4;
  const int4 e0 = __ldg(e), e1 = __ldg(e + 1), e2 = __ldg(e + 2),
             e3 = __ldg(e + 3), e4 = __ldg(e + 4);
  const int stripe = e0.x, lv0 = e0.y, nlv = e0.z;
  const int nwork = e0.w >> 8;
  const int rec0 = e4.x, nrec = e4.y;
  const size_t plane = static_cast<size_t>(a.H) * a.Wb;
  const size_t set = plane * B;
  int32_t* own = a.pl + set * stripe;
  const int r0 = e2.x, c0 = e2.y, nr = e2.z, nc = e2.w;
  // a row stride of 4 mod 8 words: the 8 rows a V record's lanes read
  // fall in 8 banks
  const int S = nc + ((nc & 4) ? 8 : 4);
  // what the waits guard: rows r0 .. rt (the tickets above write there)
  // and columns c0 .. cl (the ticket on the left, the halo copy)
  const int rt = e4.z, cl = e4.w;
  // 1. the records and level bounds and the window but what the waits
  // guard (no dependency), then the waits
  for (int i = tid; i < nrec; i += kThreads) srec[i] = __ldg(a.recs + rec0 + i);
  for (int i = tid; i <= nlv; i += kThreads)
    slev[i] = __ldg(a.levels + lv0 + i) - rec0;
  copy_rect<B>(own, plane, a.Wb, win, S, nr, r0, c0, rt, r0 + nr, cl,
               c0 + nc);
  if (tid < 4) {
    const int dep = tid == 0 ? e1.x : tid == 1 ? e1.y : tid == 2 ? e1.z : e1.w;
    if (dep >= 0) {
      while (ld_acquire(a.flags + dep) != a.epoch) {
      }
    }
  } else if (tid == 4 && a.copy && (e0.w & 1)) {
    while (ld_acquire(a.flags + a.nt) != a.epoch) {
    }
  }
  __syncthreads();
  // 2. the rest of the window
  copy_rect<B>(own, plane, a.Wb, win, S, nr, r0, c0, r0, rt, c0, c0 + nc);
  copy_rect<B>(own, plane, a.Wb, win, S, nr, r0, c0, rt, r0 + nr, c0, cl);
  cp_wait_all();
  __syncthreads();
  // 3. the levels: records of a level side by side, levels in order
  if (tid < nwork) {
    for (int l = 0; l < nlv; ++l) {
      const int first = slev[l], n = (slev[l + 1] - first) * 8 * B;
      for (int i = tid; i < n; i += nwork) {
        const int rb = i >> 3;
        run_lane(win + (rb % B) * nr * S, S, r0, c0, a.H, a.Wb,
                 srec[first + rb / B], i & 7, a.bpp);
      }
      level_barrier(nwork);
    }
  }
  __syncthreads();
  // 4. the write-back, with the mirrors of tail and halo columns (a
  // flat index over the box, as the copies)
  const bool has_left = a.halo && stripe > 0;
  const bool has_right = a.halo && stripe < a.T - 1;
  const int wr = a.wreal[stripe];
  const int wl = has_left ? a.wreal[stripe - 1] : 0;
  const int wr0 = e3.x, wc0 = e3.y, wnr = e3.z, wnc = e3.w;
  // the window's rows and the box's columns start on 16 bytes
  const int nq = wnc >> 2, n = B * wnr * nq;
  for (int i = tid; i < n; i += kThreads) {
    const int b = i / (wnr * nq), yy = i / nq % wnr, q = i % nq;
    const int gy = wr0 + yy, gx = wc0 + 4 * q;
    const int4 v = *reinterpret_cast<const int4*>(
        win + (b * nr + gy - r0) * S + gx - c0);
    int32_t* d = own + plane * b + static_cast<size_t>(gy) * a.Wb;
    __stcg(reinterpret_cast<int4*>(d + gx), v);
    if (has_right && gx >= wr && gx < wr + kHalo)
      __stcg(reinterpret_cast<int4*>(d + set + gx - wr), v);
    if (has_left && gx < kHalo)
      __stcg(reinterpret_cast<int4*>(d - set + wl + gx), v);
  }
  // 5. publish (and free the shared memory for the next ticket)
  __syncthreads();
  if (tid == 0) release(a.flags + k, a.epoch);
}

// The arguments stay in the parameter space (__grid_constant__): the
// stripes' widths are indexed at run time without a copy to the stack.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    lf_replay_kernel(const __grid_constant__ Args a) {
  extern __shared__ int4 smem4[];
  int4* srec = smem4;
  int* slev = reinterpret_cast<int*>(srec + a.max_recs);
  int32_t* win = slev + a.lv_ints;
  __shared__ int s_ticket;
  const int total = a.nt + a.copy;
  for (;;) {
    if (threadIdx.x == 0) s_ticket = static_cast<int>(atomicAdd(a.ctr, 1u));
    __syncthreads();
    const int k = s_ticket;
    if (k >= total) break;
    if (k < a.copy)
      copy_halos(a);  // ends with a barrier
    else if (a.B == 1)
      run_ticket<1>(a, k - a.copy, srec, slev, win);  // ends with a barrier
    else
      run_ticket<2>(a, k - a.copy, srec, slev, win);
  }
  // every block has taken its last ticket: reset for the next launch
  if (threadIdx.x == 0 && atomicAdd(a.ctr + 1, 1u) == gridDim.x - 1) {
    a.ctr[0] = 0;
    a.ctr[1] = 0;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Replay the tickets of a segment of the steps (ops/lpf_replay.py
// build_tickets: tickets [nt][20], levels, records [n][4], int32) over
// planes ([T, B, H, Wb] int32, in place) on `stream`: one launch of a
// persistent grid. wreal: T ints on the host, each stripe's real width
// (its tail at columns wreal .. wreal + 7); halo: whether the stripes
// keep halos (T > 1); the halos take their copies only when first is 0.
// max_recs, max_levels: the most records and levels of a ticket; sbw,
// sbh: the SB's size in the set's samples (32 or 64). Every load and
// store is an int4: planes on 16 bytes, Wb and (with halo) every wreal a
// multiple of 4, the tickets' boxes aligned to 4 columns; anything else
// is refused. state: 2 counters then nt + 1 flags, zero before the first
// call; epoch: larger than any flag holds. bpp: 8-12.
int lf_replay_from(int32_t* planes, const int32_t* tickets,
                   const int32_t* levels, const int32_t* records,
                   const int* wreal, int T, int B, int H, int Wb, int nt,
                   int max_recs, int max_levels, int sbw, int sbh, int first,
                   int halo, int bpp, int32_t* state, int epoch,
                   cudaStream_t stream) {
  if (!planes || !wreal || !state || T < 1 || T > kMaxStripes || B < 1 ||
      B > 2 || H < 1 || Wb < 1 || nt < 0 || (nt && (!tickets || !levels ||
      !records || !aligned16(tickets) || !aligned16(records))) ||
      max_recs < 0 || max_levels < 0 || (sbw != 32 && sbw != 64) ||
      (sbh != 32 && sbh != 64) || first < 0 || epoch < 1 || bpp < 8 ||
      bpp > 12 || (halo && T < 2) || Wb % 4 || !aligned16(planes))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.pl = planes;
  a.tickets = reinterpret_cast<const int4*>(tickets);
  a.levels = levels;
  a.recs = reinterpret_cast<const int4*>(records);
  a.ctr = reinterpret_cast<unsigned*>(state);
  a.flags = state + 2;
  for (int t = 0; t < T; ++t) {
    a.wreal[t] = wreal[t];
    if (halo && (wreal[t] < kHalo || wreal[t] + kHalo > Wb || wreal[t] % 4))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.T = T;
  a.B = B;
  a.H = H;
  a.Wb = Wb;
  a.nt = nt;
  a.copy = halo && first == 0;
  a.halo = halo != 0;
  a.bpp = bpp;
  a.epoch = epoch;
  a.max_recs = max_recs;
  a.lv_ints = (max_levels + 4) & ~3;
  const int smem = max_recs * static_cast<int>(sizeof(int4)) +
                   a.lv_ints * 4 + B * (sbh + 16) * (sbw + 16 + 8) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      lf_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = nt + a.copy;
  int grid = total < kBlocksPerSM * sms ? total : kBlocksPerSM * sms;
  if (grid < 1) grid = 1;  // an empty launch still runs (and is counted)
  lf_replay_kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The whole replay: lf_replay_from with first 0.
int lf_replay(int32_t* planes, const int32_t* tickets, const int32_t* levels,
              const int32_t* records, const int* wreal, int T, int B, int H,
              int Wb, int nt, int max_recs, int max_levels, int sbw, int sbh,
              int halo, int bpp, int32_t* state, int epoch,
              cudaStream_t stream) {
  return lf_replay_from(planes, tickets, levels, records, wreal, T, B, H, Wb,
                        nt, max_recs, max_levels, sbw, sbh, 0, halo, bpp,
                        state, epoch, stream);
}

}  // extern "C"
